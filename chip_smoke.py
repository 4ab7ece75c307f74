#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit, builds the hand-written kernels
   (one nvcc per source, in parallel) and prints the build time.
2. Generates the TPC-H Q18 extract J2 at scale 1 (R = orders, 15,000,000
   rows, int32 key and three int64 payloads; S = lineitem, 60,000,000 rows,
   int32 key and one int64 payload; seed 0) and puts it on the card.
3. Drives the port's main path: join(R, S, algorithm="phj", pattern="gftr")
   followed by group_aggregate(T, key="k", strategy="partition") with 15M
   groups, with every kernel launch counter set to 0 just before the run and
   read just after it. Prints the wall time of each phase and the peak device
   memory, then profiles one more warm query (device time by kernel, and the
   device's idle share).
4. Checks the result: (a) the same query with every arm forced to plain
   PyTorch on the card gives the same tables row for row; (b) a numpy
   reference in int64 gives the same per-key row counts, sums of s1 and
   maxima of r1, for the join and the group-by; (c) every kernel of the path
   was launched.
5. Drives two more paths on the same data, each with the launch counters
   set to 0 just before it and read just after:
   (d) the fused group-join, Q18's `group by l_orderkey`:
       phj_groupjoin(R, S, group_key="k", aggs={s1: sum, r1: sum, r2: count})
       with 15M groups (cold and warm wall times, peak memory, launches, a
       profiled warm run),
       checked against the numpy reference, against the torch arm with the
       sort strategy on the card, and against a second run bit for bit;
   (e) the sort group-bys over the join output: strategy="sort" with the
       query's aggregates (equal to the numpy reference), and
       strategy="sort_pallas" with {s1: sum, r2: count}, profiled warm, and
       one of its combines (`ops.groupby_sorted_sum` of s1) profiled alone.
   (f) the sort-merge join, SMJ-OM and SMJ-UM (one lower_bound launch
       each), equal to each other and to the plain lower-bound arm row for
       row, and to the numpy reference per key; a profiled warm SMJ-OM run;
   (g) the radix sort plan (4 + 4 rank-pass launches per sort) on S's and
       R's keys, equal to the stable sort exactly;
   (h) the non-partitioned hash join (no kernel), equal to the numpy
       reference per key, with no failed insertion, beside PHJ-OM alone
       (with its phase times) and SMJ.
   (m) the checked drivers: phj_join_checked naturally (one attempt, equal
       row for row to the join), under overflow:phj@0 (19 bits, equal to
       numpy per key) and under overflow:phj@0+1+2 (bits 18, 19, 20, then
       the strategy:smj rung, equal row for row to (f)'s SMJ-OM);
       groupjoin_checked from a quarter of the capacity (grown to the group
       count rounded up to 64, equal to (d)); groupby_partition_checked
       naturally and under overflow:groupby_partition@0 (equal to (b)'s
       group-by per key); with each report's summary and the resilience
       counters.
   (n) the scatter group-by over the join output with the query's
       aggregates, equal to the numpy reference.
   (o) Q18 through the engine (`repro_torch.engine`): Catalog({orders: R,
       lineitem: S}), scan("lineitem").join(scan("orders"), key="k")
       .group_by("k", s1=sum, r1=max, r2=count), optimized with the profile
       measured on the card (printed at 65,536 and at 16,777,216 rows, with
       the plan each gives), the stats sketch and optimize times; run warm,
       checked, with PHJ-OM and SMJ-OM forced, and in 4 morsels, each equal
       per key to (b)'s group-by and to numpy, with launches that fit the
       plan's nodes and no degradation; beside the same operators called
       directly. The calibration store is a file of this run alone. The
       untraced runs allocate no trace span.
   (q) a trace of (o)'s Q18 plan: `run(trace=True)` (per node the median of
       3 CUDA-event timed runs) equal to the untraced run; the span table,
       the spans' sum against the untraced run and the trace's overhead
       bound; the residuals fed into the run's calibration store and the
       Perfetto JSON written beside it (under TMPDIR).
   (r) the run auditor on Q18's plan: each node's priced contract against
       the ops its run dispatched (no violation), `explain(verify=True)`,
       and `plan_peak_bytes` within 5% of max_memory_allocated over one run
       of the plan (plus its inputs).
   (s) the query server on the card's memory budget: Q18 on J2, then on a
       second J2-shaped dataset (14,000,000 x 56,000,000 rows, seed 1) in
       the same capacity buckets (one signature, one plan optimized, a
       cache hit); two Q18 in one tick under 1.5x Q18's bytes ticket (one
       runs, one is deferred and runs); Q18 under 0.6x the ticket (morsels);
       each answer equal per key to numpy and to the same plan run
       directly; launches that fit the served plan; per request the plan,
       queue, run and total seconds, the path, the morsels and the ticket.
6. Holds each kernel against its plain PyTorch version on the card, at the
   shapes these paths give it (keys, layouts and counts exactly equal, float
   sums to a stated tolerance), and times the kernel, the plain version and
   the one PyTorch library call that computes the same function where there
   is one (median of CUDA-event timings), beside the least time the card
   could take. A kernel with a library call is also timed against it in 21
   alternating pairs (the median of each and the min-max of the per-pair
   ratio). The per-tile histograms have a row for each of the join plan's
   first pass (256 bins), the group-by's first pass (257) and the join
   plan's last pass (8); the rank kernel is also timed at 257 and 8 bins.
   The probe runs on the join's partitioned key columns, and again as a
   served query runs it (3s): both columns padded to their buckets, the
   padding's KEY_SENTINEL rows after the last partition. The partition
   plan's pass scatter runs at that padded probe side's 2^26 rows (its
   second pass), beside the two index_puts of its plain version and the
   gather and index_put it replaced. The partition digits run on both
   padded key columns (2^26 probe rows, 2^24 build rows), beside their
   plain version, which is the chain of ATen elementwise passes they
   replaced. The segmented
   sums must equal their plain version bit for bit (keys, sums, counts and
   the number of partials), and a second launch must give the same bytes.
   The gather has a row for each of PHJ-OM's two maps (build side, probe
   side), the lower bound a row for J2's sweep, for a short probe column
   whose tiles span far past its ring of build keys, and for int64 keys.
   (k) The global histogram is driven through its own entry point
   (`ops.histogram`) first; its full-fan-out counts must equal the join's
   partition plan's sizes.
7. Frees J2 and drives two more paths, with counters as above:
   (i) the m:n sort-merge join of the TPC-DS Q95 extract J5 at scale 1
       (72,000,000 x 72,000,000 rows, keys uniform in [0, 18,000,000), int64
       payloads), with out_size the exact match total from numpy's per-key
       counts; per-key output counts and payload sums equal numpy's;
   (l) the m:n partitioned hash join of J5, PHJ-OM and PHJ-UM (the plans'
       passes and, for OM, two gathers; no probe kernel), each equal to
       numpy per key and, as a multiset of (k, r1, s1) rows, to SMJ-OM
       m:n's, with its phase times beside SMJ-OM m:n's warm time;
   (j) join sequences over a star schema with J2's row counts (a 60,000,000
       row fact table, four 15,000,000 row dimensions): PHJ-OM and SMJ-OM with
       restore_order=True, equal to each other row for row and to numpy;
   (n) the partition_hash, scatter and sort group-bys over a 60,000,000-row
       table with keys (zipf(1.5) - 1) % 4096 and float32 values in [0, 1):
       keys and counts equal to numpy, float32 sums within 2 x rows x 2^-24
       relative of numpy's float64 sums, bit-identical from run to run, each
       profiled warm; and what choose_groupby_strategy picks for it and for
       J2's join output.
   (p) the star query through the engine: four joins of the fact table to
       its dimensions, group_by("fk0", p1_0=sum), the top 8 by that sum;
       its plans under both profiles, warm time and launches, and its top 8
       equal to numpy's; then (r) its audit and peak bytes as for Q18, and
       (s) the same query served by (s)'s server, its top 8 equal to numpy's
       and to its plan run directly; the server's p50 and p99 over the six
       requests.
8. (t) The chaos soak of the query server on the card at its smoke size
   (`serve.chaos.run_chaos(smoke=True)`: 48 mixed queries a pass; the
   overflow, raise and estimates families, the pressure and memory
   passes): every answer equal to its fault-free oracle, the blast radius
   confined; its baseline p50, p99 and throughput.
9. (u) The LM decode server: qwen2-moe-a2.7b at its published widths and
   depth (24 layers, 14,315,587,584 parameters) in bf16, drawn on the card
   from `torch.Generator("cuda").manual_seed(0)`; `ServeEngine(max_batch=8,
   max_len=128)` over 16 requests (prompts of 2 to 8 tokens from numpy seed
   0, 16 new tokens each), with the launch counters set to 0 just before
   and read just after: exactly 24 `block_histograms` and 24
   `partition_ranks` launches per decode step (the MoE routing plan of each
   layer), no request error, no `resilience.serve_*` counter moved; ticks,
   the step's median and p90 ms, generated tokens/s, peak memory. The same
   requests with the partition plan on its torch arm: token streams, every
   step's logits and layer 0's first dispatch plan equal bit for bit. One
   decode step profiled, and one layer's expert FFN timed alone; the two
   routing kernels' rows at the decode shape (32 digits, 60 bins); the
   model cut to 1 layer in float32 (TF32 off) on the card against the CPU
   (logits within 1e-3 of their largest magnitude, expert choices equal
   where the 4th and 5th router probabilities differ by more than 1e-5);
   `repro_torch.launch.serve.main(["--arch", "olmo-1b", "--full"])`.
10. (v) The LM trainer: qwen2-moe-a2.7b at its published widths cut to 4 of
   its 24 layers (2,904,541,184 parameters), float32 parameters, gradients
   and AdamW moments (cosine schedule to 3e-4, clipping at 1.0), drawn from
   `torch.Generator("cuda").manual_seed(0)`; 10 steps of
   `build_train_step(remat=True)` under `train_loop` on 4 x 512 tokens of
   `make_batch_fn(151936, 4, 512, seed=0)`, the launch counters set to 0
   just before and read just after: exactly 8 `block_histograms` and 8
   `partition_ranks` launches per step (4 in the forward, 4 in the
   recompute) and no other kernel; finite losses, the last below the first;
   step median and p90, trained tokens/s, model TFLOP/s (models/flops.py)
   and executed TFLOP/s (the padded expert slots), peak memory against the
   state's bytes. The same 10 steps on the partition plan's torch arm and
   once more on the kernels: losses, grad norms and final parameters equal
   bit for bit. One step profiled; the routing kernels' rows at the train
   shape (8,192 digits, 60 bins); loss and gradients at 1 layer, batch 1 x
   64, TF32 off, on the card against the CPU (loss within 1e-5 relative,
   every gradient leaf within 1e-4 of its max |g|); 20 steps of the reduced
   config straight against 10 + a resume through checkpoints, bit for bit;
   `repro_torch.launch.train.main(["--arch", "olmo-1b", "--full", "--steps",
   "10"])` with finite losses.
11. (w) The hybrid: zamba2-2.7b at its published widths and depth (9 groups
   of 6 Mamba2 layers and one shared attention block, 2,422,532,000
   parameters) in bf16 from seed 0, served as (u) serves (16 requests, 8
   slots, a 128-token cache): no request error and no kernel launched (SSD
   and the recurrent decode are plain torch ops); ticks, step median and
   p90, generated tokens/s, peak memory; one decode step profiled; a
   teacher-forced decode of 1 x 256 tokens against one forward of them
   (chunk 128: two chunks) through the served model's first group in
   float32, TF32 off, logits within 1e-3 of their largest magnitude, and
   the full depth's forward at chunk 128 beside chunk 64; one group in
   float32 on the card against the CPU (a forward of 2 x 16 tokens and 3
   decode steps, logits within 1e-3 of their largest magnitude).
12. (x) The feature-join pipeline feeding xlstm-125m at its published widths
   and depth (133,158,192 parameters, float32): U of 4,194,304 users and I
   of 1,048,576 items (three float32 features each, numpy seed 0) on the
   card, and 10 steps of `examples/ml_pipeline_torch.py`'s step on 8 x 512
   fact rows a step: F ⋈ U ⋈ I by PHJ-OM (restore_order), the features
   binned into the model's 50,304 ids, the partition_hash group-by over the
   step's users (num_groups 4,096), one AdamW step (cosine to 3e-3 after 2
   warm-up steps), the launch counters set to 0 just before and read just
   after: exactly 8 `block_histograms`, 8 `partition_ranks`, 2
   `hash_probe` and 11 `clustered_gather` launches a step and no other
   kernel; the ms of each step's join, group-by and train step, trained
   tokens/s, peak memory; finite losses. The joined features of the first
   and last step equal a numpy join row for row and the tokens numpy's
   float32 binning; the same 10 steps on the torch arms of the plan, the
   probe and the gather give the same tokens, losses, grad norms and final
   parameters bit for bit. One step's join and group-by profiled; one
   sLSTM layer (512 cell steps, also profiled) and one mLSTM layer (two
   chunks) timed alone; the four kernels' rows at the pipeline's shapes.
13. (y) The vision and audio families in bf16 from seed 0, served as (u)
   serves with 8 requests (the stub embeddings drawn from numpy seed 0
   before the prompts): llama-3.2-vision-11b at its published widths cut to
   10 of its 40 layers (two cross groups over 1,601 stub patches; the cross
   gates set to 1), whisper-large-v3 at its published widths and depth (32
   encoder layers over 1,500 stub frames, 32 decoder layers): no request
   error and no kernel launched; ticks, step median and p90, generated
   tokens/s, peak memory; one decode step profiled each; each at one group
   (or one layer a stack) in float32 on the card against the CPU as in
   (w), logits within 1e-2 of their largest magnitude (the random model's
   saturated softmax, FAMILY_CPU_LOGIT_RTOL).
14. (z) The launch-configuration lint on the card
   (`repro_torch.analysis.kernel_lint`): every registered shape's declared
   launch (threads, dynamic shared memory, grid) equals what the kernel's
   library says its launch would use (`<name>_launch_config`, the launch's
   own host helper), and every compiled instance of the ten kernels fits
   the H100 (threads, shared memory, registers) and spills no more than
   `DECLARED_SPILLS` allows it (nothing, for an instance it does not name);
   one line per instance with its threads, dynamic shared memory at J2's
   shape, registers, spills (and the declared ones) and static shared
   memory. Then both example twins,
   `examples/quickstart_torch.py` and `relational_analytics_torch.py`, as
   subprocesses with `--device cuda` and with `--device cpu` (the cost
   model's profile one for both, from a calibration store of the phase's
   own): each exits 0, the card's run launches the join kernels and the
   CPU's none, and both print the same lines with the same integers (the
   quickstart's float32 revenue within sqrt(rows) x 2^-24 relative).
15. (aa) The distributed layer (`repro_torch.dist`, the step builders on
   a mesh, `train.elastic`, `launch.dryrun`): (v)'s cell trained 3 steps by
   `build_train_step` on a (1, 1) ("data", "model") DeviceMesh over a
   one-rank NCCL group (an in-process store, no network), against 3
   one-card steps from the same seed-0 state: losses within 1e-5 relative,
   every parameter leaf within 5e-3 (and whether bit-identical), 8
   launches of each routing kernel a step (its MoE groups planned on the
   rank's local tensors); the step medians side by side.
   `compressed_psum_dp` over that group on one loss's float32 gradients:
   bit-equal to `ef_compress_decompress`, each leaf within one int8 step
   of its input, ms a call beside its bytes bound. `reshard_state` onto the
   mesh and back to plain tensors, bit for bit. The dry run
   (`python -m repro_torch.launch.dryrun`, a fake process group of 256
   ranks, meta tensors) of qwen2-moe-a2.7b train_4k and mixtral-8x7b
   decode_32k on the 16 x 16 mesh, each in a subprocess of its own started
   at the phase's start: status ok with collectives counted; live GB per
   rank beside the card's memory, the dominant roofline term, seconds.
Every phase prints its seconds; the card's name and power limit stand in
the JSON line of every new number.

Prints one JSON line {"kernels": [...]} before the last line, and as the last
line {"ok": true, "device": {...}}. Exits non-zero, before printing either,
when there is no CUDA device, when the repository's `src/repro_torch` is not
beside this file, or when any phase fails.
"""
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
# H100 SXM int32 compares: the 67 TFLOP/s float32 peak counts an FMA as two
# operations on 128 lanes per SM; int32 runs on 64 lanes per SM, one
# operation each, so a quarter of it
INT32_OPS_PER_S = 67e12 / 4
N_GROUPS = 15_000_000
# kernel-against-library pairs per kernel row
PAIRS = 21
AGGS = {"s1": "sum", "r1": "max", "r2": "count"}
# the partition plan runs 3 passes per join side (2^18 + 1 partitions) and
# 2 for the group-by (2^16 + 1, top partition as a tail class); the join's
# digits once a side; one probe; one gather per payload column
EXPECTED_LAUNCHES = {"block_histograms": 8, "partition_ranks": 8, "pass_scatter": 8,
                     "partition_digits": 2, "hash_probe": 1,
                     "clustered_gather": 4, "lower_bound": 0, "histogram": 0}
# the group-join: the same two plans as the join, one fused probe pass, no
# gather and no group-by partition
GJ_AGGS = {"s1": "sum", "r1": "sum", "r2": "count"}
GJ_LAUNCHES = {"block_histograms": 6, "partition_ranks": 6, "pass_scatter": 6,
               "partition_digits": 2, "hash_probe": 0,
               "clustered_gather": 0, "probe_agg": 1, "segsum_partials": 0,
               "lower_bound": 0, "histogram": 0}
# sort_pallas with a sum and a count: the hoisted count pass and one pass
# for s1
SP_AGGS = {"s1": "sum", "r2": "count"}
SP_LAUNCHES = {"block_histograms": 0, "partition_ranks": 0, "hash_probe": 0,
               "clustered_gather": 0, "probe_agg": 0, "segsum_partials": 2,
               "lower_bound": 0, "histogram": 0, "pass_scatter": 0}
# SMJ with pk_fk: one lower-bound sweep; the sort plans are stable sorts
SMJ_LAUNCHES = dict.fromkeys(SP_LAUNCHES, 0) | {"lower_bound": 1}
# the radix sort plan of int32 keys: four 8-bit rank passes, each moved by
# one scatter
RADIX_LAUNCHES = dict.fromkeys(SP_LAUNCHES, 0) | {"block_histograms": 4, "partition_ranks": 4,
                                                  "pass_scatter": 4}
NO_LAUNCHES = dict.fromkeys(SP_LAUNCHES, 0)
# the skewed group-by table: benchmarks/groupby_bench.py's skew shape (keys
# (zipf(1.5) - 1) % 4096, int32; float32 values uniform in [0, 1)) at
# lineitem's SF10 row count
SKEW_ROWS = 60_000_000
SKEW_KEYS = 4096
SKEW_GROUPS = 8192
SKEW_AGGS = {"v": "sum", "k": "count"}
# J2's row counts for the star schema (benchmarks/joins.py: n_dim = n_fact / 4)
STAR = dict(n_fact=60_000_000, n_dim=15_000_000, n_joins=4)
# float32 sums of int64 payloads below 2^31 against exact int64 sums: each
# value rounds by at most 2^-24 relative when it is converted, each add as
# much again, so |got - exact| <= 2 * rows * 2^-24 * |exact| for the
# non-negative payloads of J2
F32_ULP = 2.0 ** -24
# a kernel against its plain version, both adding a slot's rows in row
# order in float32: equal unless a compiler reorders an add; allowed one
# ulp of the sum
KERNEL_SUM_RTOL = 2.0 ** -23
# the LM decode server's cell: qwen2-moe-a2.7b at its published widths and
# depth in bf16, 16 requests over 8 slots (prompts of 2 to 8 tokens from
# numpy seed 0, 16 new tokens each), a 128-token cache
LM_ARCH = "qwen2-moe-a2.7b"
LM_PARAMS = 14_315_587_584
LM_REQUESTS, LM_MAX_TOKENS, LM_BATCH, LM_MAX_LEN = 16, 16, 8, 128
# the card against the CPU at full width cut to 1 layer, float32, TF32 off:
# logits within 1e-3 of their largest magnitude; expert choices equal where
# the 4th and 5th router probabilities differ by more than 1e-5
LM_CPU_LOGIT_RTOL, LM_CPU_ROUTE_GAP = 1e-3, 1e-5
# kernel-name substrings of the decode step's device time, by group
LM_KERNEL_GROUPS = {"matmuls": ("gemm", "cutlass", "xmma", "sm90_", "nvjet", "cublas"),
                    "routing kernels": ("block_histograms", "partition_ranks", "pass_scatter"),
                    "softmax": ("softmax",),
                    "gathers, scatters and copies": ("index", "gather", "scatter", "copy",
                                                     "cat", "Memcpy", "Memset")}
# the LM trainer's cell: qwen2-moe-a2.7b at its published widths cut to 4 of
# its 24 layers, float32 parameters, gradients and AdamW moments (as
# launch/train.py trains); 4 x 512 tokens a step from the synthetic stream
# (numpy seed 0), 10 steps, each layer recomputed in the backward
TRAIN_LAYERS, TRAIN_PARAMS = 4, 2_904_541_184
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 512, 10
TRAIN_PEAK_LR, TRAIN_WARMUP = 3e-4, 2
# the card against the CPU at 1 layer of the same widths, batch 1 x seq 64,
# float32, TF32 off: loss within 1e-5 relative, every gradient leaf within
# 1e-4 of its leaf's max |g|
TRAIN_CPU_LOSS_RTOL, TRAIN_CPU_GRAD_TOL = 1e-5, 1e-4
# kernel-name substrings of the train step's device time, by group (the
# first group whose substring a kernel's name holds)
TRAIN_KERNEL_GROUPS = {"matmuls": LM_KERNEL_GROUPS["matmuls"],
                       "routing kernels": ("block_histograms", "partition_ranks", "pass_scatter"),
                       "softmax": ("softmax",),
                       "reductions": ("reduce",),
                       "gathers, scatters and copies": LM_KERNEL_GROUPS[
                           "gathers, scatters and copies"],
                       "elementwise": ("elementwise",)}
# the distributed layer's cell (aa): (v)'s cell, 3 steps of the sharded
# step on a (1, 1) ("data", "model") DeviceMesh over a one-rank NCCL group,
# against 3 one-card steps from the same state: losses within 1e-5
# relative, every parameter leaf within the JAX package's bound of 5e-3;
# then the dry run's three cells on the 16 x 16 mesh of a fake process group
DIST_STEPS, DIST_LOSS_RTOL, DIST_PARAM_TOL = 3, 1e-5, 5e-3
# the dry run shards train and prefill activations' sequence over 'model'
DRYRUN_CELLS = (("qwen2-moe-a2.7b", "train_4k"), ("qwen2-moe-a2.7b", "prefill_32k"),
                ("mixtral-8x7b", "decode_32k"))
DRYRUN_TIMEOUT_S = 300  # each cell's subprocess, from the phase's start
# the hybrid's cell: zamba2-2.7b at its published widths and depth in bf16,
# served as (u) serves (16 requests over 8 slots, a 128-token cache)
HYB_ARCH, HYB_PARAMS = "zamba2-2.7b", 2_422_532_000
# a teacher-forced decode of 1 x 256 tokens against one forward of them
# (chunk 128: two chunks), float32, TF32 off, through the served model's
# first group (6 Mamba2 layers and the shared block at the published
# widths): logits within 1e-3 of their largest magnitude. At full depth the
# random weights amplify float32 rounding ~10x at each use of the shared
# block (the template's fan-in scales saturate its softmax), so 54 layers
# bound nothing: there the forward at chunk 64 is only set beside chunk 128
HYB_TF_TOKENS, HYB_TF_LOGIT_RTOL = 256, 1e-3
# each family on the card against the CPU at one group (or one layer a
# stack), float32, TF32 off: a forward of 2 x 16 tokens and 3 decode steps,
# logits within a bound of their largest magnitude: 1e-3 for the hybrid;
# 1e-2 where attention rules the cut (vision: 4 self-attention layers,
# whisper: an encoder and a decoder layer), since the template's fan-in
# scale of wq (1 / sqrt(heads)) saturates the random model's softmax and a
# near-tie of two keys moves a row by more than the devices' rounding (the
# vision cut read 1.7e-3 of its largest logit in its first run, when this
# bound was 1e-3)
FAMILY_CPU_LOGIT_RTOL = {"hybrid": 1e-3, "vlm": 1e-2, "audio": 1e-2}
# the feature-join pipeline's cell: F (8 x 512 events a step) joined to
# U (4,194,304 users) and I (1,048,576 items) by PHJ-OM, the partition_hash
# group-by over the step's users, and one AdamW step of xlstm-125m at its
# published widths and depth, float32, on the tokens binned into its
# vocabulary
PIPE_USERS, PIPE_ITEMS, PIPE_PARAMS = 4_194_304, 1_048_576, 133_158_192
PIPE_BATCH, PIPE_SEQ, PIPE_STEPS = 8, 512, 10
# per step: two joins; each takes both sides' digits and plans them in 2
# passes (2^16 + 1 partitions for U, the top one a tail class; 2^14 + 1 for
# I), probes once and gathers each payload column: U's 3 and the probe
# side's 1, then I's 3 and the probe side's 4
PIPE_LAUNCHES = {"block_histograms": 8, "partition_ranks": 8, "pass_scatter": 8,
                 "partition_digits": 4, "hash_probe": 2,
                 "clustered_gather": 11, "probe_agg": 0, "segsum_partials": 0,
                 "lower_bound": 0, "histogram": 0}
# the vision and audio cells, served in bf16 as (u) serves, with 8 requests:
# llama-3.2-vision-11b at its published widths cut to 10 of its 40 layers
# (two cross groups), whisper-large-v3 at its published widths and depth
VIS_ARCH, VIS_LAYERS, VIS_PARAMS = "llama-3.2-vision-11b", 10, 3_231_797_252
AUD_ARCH, AUD_PARAMS = "whisper-large-v3", 1_534_940_160
FAMILY_REQUESTS = 8
# the reference's code each kernel timed in 6. replaces (its source is
# src/repro_torch/csrc/<name>.cu)
KERNEL_REPLACES = {
    "block_histograms": "src/repro/kernels/radix_partition.py:49",
    "partition_ranks": "src/repro/kernels/radix_partition.py:79",
    "hash_probe": "src/repro/kernels/hash_probe.py:43",
    "clustered_gather": "src/repro/kernels/gather.py:40",
    "probe_agg": "src/repro/kernels/hash_probe.py:132",
    "segsum_partials": "src/repro/kernels/segsum.py:43",
    "lower_bound": "src/repro/kernels/merge_join.py:43",
    "histogram": "src/repro/kernels/histogram.py:34",
    "pass_scatter": "none: the LSD passes' ATen index and index_put glue",
    "partition_digits": "none: hash_join._digits' ATen elementwise chain (one XLA fusion "
                        "in the reference)",
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg: str) -> None:
    if not bool(cond):
        fail(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(torch, fn, reps: int = 7, warmup: int = 2) -> float:
    """Median milliseconds of fn() on the card, by CUDA events."""
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
    return float(np.median(times))


def check_f32_sums(got, exact, rows, what: str) -> float:
    """float32 sums against exact int64 ones within F32_ULP (see there);
    returns the largest relative error."""
    got = got.astype(np.float64)
    exact = exact.astype(np.float64)
    err = np.abs(got - exact)
    check((err <= 2 * rows * F32_ULP * np.abs(exact)).all(),
          f"{what}: float32 sums off by more than 2 * rows * 2^-24 relative "
          f"(max abs err {err.max()})")
    return float((err / np.maximum(np.abs(exact), 1)).max()) if err.size else 0.0


def paired_ms(torch, kernel_fn, library_fn, pairs: int = PAIRS, warmup: int = 3) -> dict:
    """A kernel and its library call timed in alternating pairs by CUDA
    events (the first of each pair swaps every pair), after warm-up: the
    median of each and the min, median and max of the per-pair ratio
    kernel / library."""
    for _ in range(warmup):
        kernel_fn()
        library_fn()
    k, lib = [], []
    for i in range(pairs):
        for fn, out in ((kernel_fn, k), (library_fn, lib))[::1 if i % 2 == 0 else -1]:
            out.append(cuda_ms(torch, fn, reps=1, warmup=0))
    ratio = np.array(k) / np.array(lib)
    return {"pairs": pairs, "pair_ms": float(np.median(k)),
            "pair_library_ms": float(np.median(lib)), "pair_ratio_min": float(ratio.min()),
            "pair_ratio_median": float(np.median(ratio)), "pair_ratio_max": float(ratio.max())}


class PhaseClock:
    """Prints the seconds each phase of the script took, and the total."""

    def __init__(self):
        self.start = self.last = time.perf_counter()

    def done(self, name: str) -> None:
        now = time.perf_counter()
        log(f"phase {name}: {now - self.last:.3f} s (total {now - self.start:.3f} s)")
        self.last = now


def timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# numpy reference
# ---------------------------------------------------------------------------
def per_key(keys: np.ndarray, n_keys: int, sum_col: np.ndarray, max_col: np.ndarray):
    """(rows, int64 sum of sum_col, max of max_col) per key in [0, n_keys),
    by a stable sort and int64 segment reductions; empty keys give 0, 0 and
    the int64 minimum."""
    order = np.argsort(keys, kind="stable")
    ks = keys[order]
    starts = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]]) if ks.size else np.array([], int)
    uk = ks[starts]
    rows = np.zeros(n_keys, np.int64)
    sums = np.zeros(n_keys, np.int64)
    maxs = np.full(n_keys, np.iinfo(np.int64).min, np.int64)
    rows[uk] = np.diff(np.r_[starts, ks.size])
    sums[uk] = np.add.reduceat(sum_col[order].astype(np.int64), starts)
    maxs[uk] = np.maximum.reduceat(max_col[order].astype(np.int64), starts)
    return rows, sums, maxs


def lm_phase(torch, card, record, record_hist, profile_run, results) -> None:
    """(u) The LM decode server: qwen2-moe-a2.7b at full width and depth in
    bf16 through `ServeEngine`, its MoE routing on the radix-partition
    kernels; the same requests on the partition plan's torch arm, bit for
    bit; one profiled decode step; the routing kernels' rows at the decode
    shape (appended to `results`); the card against the CPU at 1 layer; the
    serve launcher at full size."""
    import gc

    from repro_torch.configs.base import get_config
    from repro_torch.core import primitives as prim
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import radix_partition as krp
    from repro_torch.launch import serve as lm_launch
    from repro_torch.models import model as LM
    from repro_torch.models import moe as MOE
    from repro_torch.models.params import leaves, map_leaves
    from repro_torch.obs import metrics
    from repro_torch.serve.engine import Request, ServeEngine

    gc.collect()
    torch.cuda.empty_cache()
    live_before = torch.cuda.memory_allocated()
    log(f"before the LM phase: {live_before} bytes still allocated")
    lm_cfg = get_config(LM_ARCH)
    check(LM.num_params(lm_cfg) == LM_PARAMS,
          f"{LM_ARCH}: {LM.num_params(lm_cfg)} parameters, expected {LM_PARAMS}")
    lm_params, init_s = timed(torch, lambda: LM.init_params(
        lm_cfg, torch.Generator("cuda").manual_seed(0), torch.bfloat16, "cuda"))
    param_bytes = sum(t.numel() * t.element_size() for t in leaves(lm_params, torch.is_tensor))
    log(json.dumps({"lm_model": {"arch": LM_ARCH, "layers": lm_cfg.num_layers,
                                 "params": LM.num_params(lm_cfg), "param_bytes": param_bytes,
                                 "dtype": "bfloat16", "init_s": init_s, "card": card}}))
    lm_rng = np.random.default_rng(0)
    lm_prompts = [lm_rng.integers(3, lm_cfg.vocab_size, size=lm_rng.integers(2, 9)).tolist()
                  for _ in range(LM_REQUESTS)]
    serve_counters = ("resilience.serve_shed", "resilience.serve_retries",
                      "resilience.serve_evictions", "resilience.serve_deadline_evictions")
    routing = ("block_histograms", "partition_ranks", "pass_scatter")

    def lm_serve():
        """The 16 requests through a fresh engine; per step: host ms after a
        synchronize, its logits and its launches; the first dispatch plan
        (layer 0, step 1) and its digits."""
        eng = ServeEngine(lm_cfg, lm_params, max_batch=LM_BATCH, max_len=LM_MAX_LEN,
                          dtype=torch.bfloat16)
        steps, plans = [], []
        real_step, real_plan = eng._step, MOE._plan_sort

        def step_fn(p, c, tok, pos):
            torch.cuda.synchronize()
            before = ops.launch_counts()
            t0 = time.perf_counter()
            lg, cache = real_step(p, c, tok, pos)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            after = ops.launch_counts()
            steps.append({"ms": ms, "logits": lg,
                          "launches": {k: after[k] - before[k] for k in after}})
            return lg, cache

        def plan_fn(expert_idx, E, C):
            out = real_plan(expert_idx, E, C)
            if not plans:
                plans.append((expert_idx.reshape(-1).clone(), E, C, out))
            return out

        eng._step = step_fn
        MOE._plan_sort = plan_fn
        reqs = [Request(rid=i, prompt=list(pr), max_tokens=LM_MAX_TOKENS)
                for i, pr in enumerate(lm_prompts)]
        before = {k: metrics.counter(k).value for k in serve_counters}
        try:
            for r in reqs:
                eng.submit(r)
            ticks, wall = timed(torch, eng.run)
        finally:
            MOE._plan_sort = real_plan
        moved = {k: metrics.counter(k).value - v for k, v in before.items()}
        check(all(r.done and not r.error for r in reqs),
              f"LM server: request errors {[(r.rid, r.error) for r in reqs if r.error]}")
        check(not any(moved.values()), f"LM server: resilience counters moved {moved}")
        return eng, reqs, ticks, wall, steps, plans[0]

    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    eng, reqs, ticks, wall, steps, plan_k = lm_serve()
    lm_launches = ops.launch_counts()
    lm_peak = torch.cuda.max_memory_allocated()
    for i, st in enumerate(steps):
        want = {k: (lm_cfg.num_layers if k in routing else 0) for k in st["launches"]}
        check(st["launches"] == want, f"LM decode step {i}: launches {st['launches']}, "
              f"expected {lm_cfg.num_layers} of each routing kernel and nothing else")
    check(lm_launches == {k: (len(steps) * lm_cfg.num_layers if k in routing else 0)
                          for k in lm_launches},
          f"LM server: launches {lm_launches} over {len(steps)} steps")
    steady = [st["ms"] for st in steps[2:]]
    generated = sum(len(r.out) for r in reqs)
    lm_info = {"card": card, "requests": LM_REQUESTS, "max_batch": LM_BATCH,
               "max_len": LM_MAX_LEN, "ticks": ticks, "decode_steps": len(steps),
               "first_step_ms": steps[0]["ms"],
               "step_ms_median": float(np.median(steady)),
               "step_ms_p90": float(np.percentile(steady, 90)), "steady_steps": len(steady),
               "generated_tokens": generated, "serve_wall_s": wall,
               "generated_tokens_per_s": generated / wall,
               "slot_tokens_per_s_at_median": LM_BATCH * 1e3 / float(np.median(steady)),
               "peak_device_bytes": lm_peak,
               "peak_above_phase_start_bytes": lm_peak - live_before, "launches": lm_launches,
               "launches_per_decode_step": {k: lm_cfg.num_layers for k in routing}}
    log(json.dumps({"lm_serve": lm_info}))

    # the same requests with the partition plan on its torch arm
    os.environ[ops.PARTITION_PLAN_ENV] = "torch"
    try:
        ops.reset_launch_counts()
        _, reqs_t, ticks_t, wall_t, steps_t, plan_t = lm_serve()
        check(sum(ops.launch_counts().values()) == 0, "LM server: the torch arm launched a kernel")
    finally:
        del os.environ[ops.PARTITION_PLAN_ENV]
    check(ticks_t == ticks and [r.out for r in reqs_t] == [r.out for r in reqs],
          "LM server: token streams differ between the kernel and torch arms")
    check(torch.equal(plan_k[0], plan_t[0]) and plan_k[1:3] == plan_t[1:3]
          and all(torch.equal(a, b) for a, b in zip(plan_k[3], plan_t[3])),
          "LM server: layer 0's dispatch plan of step 1 differs between the arms")
    logit_diff = max(float((a["logits"].float() - b["logits"].float()).abs().max())
                     for a, b in zip(steps, steps_t))
    check(len(steps) == len(steps_t) and all(torch.equal(a["logits"], b["logits"])
                                             for a, b in zip(steps, steps_t)),
          f"LM server: logits differ between the kernel and torch arms (max {logit_diff})")
    log(f"(u) {LM_ARCH} at full size (bf16, {param_bytes} bytes of weights): {LM_REQUESTS} "
        f"requests in {ticks} ticks, no request error, no resilience counter moved; decode "
        f"step median {lm_info['step_ms_median']:.3f} ms, p90 {lm_info['step_ms_p90']:.3f} ms; "
        f"{lm_info['generated_tokens_per_s']:.1f} generated tokens/s; peak {lm_peak} bytes; "
        f"{lm_cfg.num_layers} launches of each routing kernel per step; the torch arm's run "
        f"equal bit for bit (streams, every step's logits, the first dispatch plan; torch arm "
        f"wall {wall_t:.3f} s against {wall:.3f} s) ({card})")
    del steps_t, reqs_t

    # one warm decode step profiled, and one layer's expert FFN alone
    tok = torch.as_tensor(eng.tokens, device="cuda")
    pos = torch.as_tensor(eng.slot_pos, device="cuda")
    lm_prof = profile_run(lambda: LM.decode_step(lm_cfg, lm_params, eng.cache, tok, pos),
                          groups=LM_KERNEL_GROUPS)
    lp0 = {k: lm_params["layers"]["moe"][k][0] for k in ("wg", "wu", "wd")}
    xin = torch.randn((lm_cfg.moe.num_experts, MOE._capacity(
        LM_BATCH, lm_cfg.moe.top_k, lm_cfg.moe.num_experts, lm_cfg.moe.capacity_factor),
        lm_cfg.d_model), dtype=torch.bfloat16, device="cuda")
    ffn_ms = cuda_ms(torch, lambda: MOE._expert_ffn(xin, lp0["wg"], lp0["wu"], lp0["wd"]))
    ffn_flop = 2 * 3 * xin.shape[0] * xin.shape[1] * lm_cfg.d_model * lm_cfg.moe.d_expert
    log(json.dumps({"lm_decode_step_profile": {
        "card": card, **lm_prof,
        "expert_ffn_one_layer_ms": ffn_ms, "expert_ffn_slots": list(xin.shape[:2]),
        "expert_ffn_flop": ffn_flop, "expert_ffn_tflop_per_s": ffn_flop / ffn_ms / 1e9,
        "expert_ffn_per_step_ms": ffn_ms * lm_cfg.num_layers}}))
    del xin, lp0, eng, tok, pos

    # the routing kernels at the decode shape: 32 digits, 60 bins
    rd = plan_k[0].to(torch.int32).contiguous()
    nbins = plan_k[1]
    per_step = {k: lm_cfg.num_layers for k in routing}
    shape = f"{nbins} bins, {rd.shape[0]} digits: the MoE routing plan of one decode step"
    record_hist(rd, nbins, shape, launches=lm_launches["block_histograms"])
    rbase = krp.tile_base(krp.block_histograms(rd, nbins))[0]
    record("partition_ranks", [krp.rank_with_base(rd, rbase, nbins)],
           [ref.partition_ranks(rd, nbins)], lambda: krp.rank_with_base(rd, rbase, nbins),
           lambda: ref.partition_ranks(rd, nbins), lambda: torch.sort(rd, stable=True),
           4 * rd.shape[0] + 4 * rbase.numel() + 4 * rd.shape[0], shape=shape,
           launches=lm_launches["partition_ranks"])
    for row in results[-2:]:
        row["launches_per_decode_step"] = per_step[row["name"]]
    # the whole routing plan as a layer calls it, on its kernel arm and on
    # its torch arm (one stable sort and a bincount)
    plan_pairs = paired_ms(torch, lambda: prim.plan_partition_permutation(rd, nbins, impl="cuda"),
                           lambda: prim.plan_partition_permutation(rd, nbins, impl="torch"))
    log(json.dumps({"lm_routing_plan_kernel_arm_against_torch_arm": {"card": card,
                                                                     **plan_pairs}}))
    del lm_params, plan_k, plan_t, steps
    gc.collect()
    torch.cuda.empty_cache()

    # the card against the CPU: full width cut to 1 layer, float32, TF32 off
    cfg1 = lm_cfg.replace(num_layers=1)
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    p_card = LM.init_params(cfg1, torch.Generator("cuda").manual_seed(1), torch.float32, "cuda")
    p_host = map_leaves(lambda t: t.cpu(), p_card, is_leaf=torch.is_tensor)
    toks = np.random.default_rng(1).integers(3, cfg1.vocab_size, (3, 2)).astype(np.int32)
    out = {}
    real_route = MOE._route
    try:
        for where, p in (("cuda", p_card), ("cpu", p_host)):
            routes = []

            def route_fn(p_, x2, k, routes=routes):
                r = real_route(p_, x2, k)
                routes.append((x2.float().cpu(), r[0].cpu()))
                return r

            MOE._route = route_fn
            cache = LM.init_cache(cfg1, p, 2, 8, None, torch.float32)
            logits = []
            for step in range(3):
                lg, cache = LM.decode_step(cfg1, p, cache, torch.from_numpy(toks[step]).to(where),
                                           step)
                logits.append(lg.cpu())
            out[where] = (torch.stack(logits), routes)
    finally:
        MOE._route = real_route
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    lc, lh = out["cuda"][0], out["cpu"][0]
    err = float((lc - lh).abs().max())
    scale = float(lh.abs().max())
    check(err <= LM_CPU_LOGIT_RTOL * scale,
          f"LM at 1 layer: card and CPU logits differ by {err} (max |logit| {scale})")
    exempt = 0
    router = p_host["layers"]["moe"]["router"][0]
    for (xc, ec), (xh, eh) in zip(out["cuda"][1], out["cpu"][1]):
        probs = torch.softmax(xh @ router, dim=-1).sort(dim=-1, descending=True).values
        sure = (probs[:, 3] - probs[:, 4]) > LM_CPU_ROUTE_GAP
        exempt += int((~sure).sum())
        check(torch.equal(ec.sort(dim=-1).values[sure], eh.sort(dim=-1).values[sure]),
              "LM at 1 layer: the card and the CPU chose different experts")
    log(json.dumps({"lm_card_against_cpu": {
        "card": card, "layers": 1, "dtype": "float32", "tf32": False, "steps": 3, "batch": 2,
        "max_abs_logit_diff": err, "max_abs_logit": scale, "rtol": LM_CPU_LOGIT_RTOL,
        "route_rows": 3 * 2, "route_rows_exempt": exempt}}))
    del p_card, p_host, out
    gc.collect()
    torch.cuda.empty_cache()

    # the launcher at full size: olmo-1b, float32, its own defaults
    launch_ticks, launch_s = timed(torch, lambda: lm_launch.main(["--arch", "olmo-1b",
                                                                  "--full"]))
    log(json.dumps({"lm_launcher": {"card": card, "argv": ["--arch", "olmo-1b", "--full"],
                                    "ticks": launch_ticks, "wall_s": launch_s}}))
    check(launch_ticks > 0, "the serve launcher ran no tick")


def train_phase(torch, card, record, record_hist, profile_run, results) -> None:
    """(v) The LM trainer: qwen2-moe-a2.7b at its published widths cut to 4
    layers, float32 with AdamW, 10 steps of `build_train_step(remat=True)`
    under `train_loop`, its MoE routing on the radix-partition kernels in
    every forward and every recompute; the same steps on the partition
    plan's torch arm and once more on the kernels, bit for bit; one profiled
    step; the routing kernels' rows at the train shape (appended to
    `results`); loss and gradients on the card against the CPU at 1 layer;
    checkpoint resume on the reduced config; the train launcher at full
    size (olmo-1b)."""
    import gc

    from repro_torch.configs.base import ShapeSpec, get_config, get_reduced_config
    from repro_torch.core import primitives as prim
    from repro_torch.data.synthetic import make_batch_fn
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import radix_partition as krp
    from repro_torch.launch import train as train_launch
    from repro_torch.models import flops as FL
    from repro_torch.models import model as LM
    from repro_torch.models import moe as MOE
    from repro_torch.models.params import leaves, map_leaves
    from repro_torch.train.loop import LoopConfig, train_loop
    from repro_torch.train.optimizer import AdamW, cosine_schedule
    from repro_torch.train.step import build_train_step

    dev = "cuda"

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    def tensors(tree):
        return leaves(tree, torch.is_tensor)

    free()
    live_before = torch.cuda.memory_allocated()
    log(f"before the train phase: {live_before} bytes still allocated")
    cfg = get_config(LM_ARCH).replace(num_layers=TRAIN_LAYERS)
    n_params = LM.num_params(cfg)
    check(n_params == TRAIN_PARAMS, f"{LM_ARCH} at {TRAIN_LAYERS} layers: {n_params} parameters, "
          f"expected {TRAIN_PARAMS}")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    state_bytes = 16 * n_params  # parameters, gradients and two moments in float32
    tokens = TRAIN_BATCH * TRAIN_SEQ
    cap = MOE._capacity(tokens, cfg.moe.top_k, cfg.moe.num_experts, cfg.moe.capacity_factor)
    model_flop = FL.estimate(cfg, ShapeSpec("train", TRAIN_SEQ, TRAIN_BATCH, "train"),
                             {}).model_flops
    # executed: every layer's forward four times (forward, recompute, and a
    # backward of twice its FLOPs) with each expert padded to `cap` slots;
    # the head's three times
    m = cfg.moe
    layer_flop = (FL._attn_flops(TRAIN_BATCH, TRAIN_SEQ, cfg)
                  + 2 * 3 * m.num_experts * cap * cfg.d_model * m.d_expert
                  + 2 * tokens * cfg.d_model * m.num_experts
                  + 2 * 3 * tokens * cfg.d_model * m.shared_d_ff)
    exec_flop = 4 * cfg.num_layers * layer_flop + 3 * 2 * tokens * cfg.d_model * cfg.padded_vocab
    data = make_batch_fn(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, seed=0, cfg=cfg, device=dev)
    routing = ("block_histograms", "partition_ranks", "pass_scatter")
    per_step = {k: 2 * cfg.num_layers if k in routing else 0 for k in ops.launch_counts()}

    def run(steps=TRAIN_STEPS):
        """10 steps from the seed-0 weights through train_loop; per step:
        host ms from a synchronize to the loss on the host, loss, grad norm
        and launches; the first routing plan's digits."""
        params = LM.init_params(cfg, torch.Generator(dev).manual_seed(0), torch.float32,
                                dev)
        opt = AdamW(lr=cosine_schedule(TRAIN_PEAK_LR, warmup=TRAIN_WARMUP, total=steps),
                    clip_norm=1.0)
        state = opt.init(params)
        step, _, _ = build_train_step(cfg, None, None, opt, remat=True)
        rec, plans = [], []
        real_plan = MOE._plan_sort

        def plan_fn(expert_idx, E, C):
            if not plans:
                plans.append((expert_idx.reshape(-1).to(torch.int32).clone(), E, C))
            return real_plan(expert_idx, E, C)

        def timed_step(p, s_, b):
            torch.cuda.synchronize()
            before = ops.launch_counts()
            t0 = time.perf_counter()
            out = step(p, s_, b)
            loss, gnorm = float(out[2]["loss"]), float(out[2]["grad_norm"])
            ms = (time.perf_counter() - t0) * 1e3
            after = ops.launch_counts()
            rec.append({"ms": ms, "loss": loss, "grad_norm": gnorm,
                        "launches": {k: after[k] - before[k] for k in after}})
            return out

        MOE._plan_sort = plan_fn
        try:
            params, state, report = train_loop(timed_step, params, state, data,
                                               LoopConfig(total_steps=steps, log_every=steps),
                                               log=log)
        finally:
            MOE._plan_sort = real_plan
        check(report.steps_run == steps, f"train loop ran {report.steps_run} steps")
        return params, state, step, rec, plans[0]

    # the main path: the kernel arm, counts set to 0 just before
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    (params, state, step, rec_k, plan_k), wall_k = timed(torch, run)
    train_launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    for i, r in enumerate(rec_k):
        check(r["launches"] == per_step, f"train step {i}: launches {r['launches']}, expected "
              f"{2 * cfg.num_layers} of each routing kernel and nothing else")
    check(train_launches == {k: TRAIN_STEPS * v for k, v in per_step.items()},
          f"trainer: launches {train_launches} over {TRAIN_STEPS} steps")
    losses = [r["loss"] for r in rec_k]
    check(all(np.isfinite(losses)) and all(np.isfinite([r["grad_norm"] for r in rec_k])),
          f"trainer: a loss or grad norm is not finite ({losses})")
    check(losses[-1] < losses[0], f"trainer: the loss did not fall ({losses[0]} -> {losses[-1]})")
    steady = [r["ms"] for r in rec_k[2:]]
    med = float(np.median(steady))
    info = {"card": card, "arch": LM_ARCH, "layers": cfg.num_layers, "params": n_params,
            "dtype": "float32", "tf32": tf32, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
            "tokens_per_step": tokens, "steps": TRAIN_STEPS, "expert_capacity": cap,
            "first_step_ms": rec_k[0]["ms"], "step_ms_median": med,
            "step_ms_p90": float(np.percentile(steady, 90)), "steady_steps": len(steady),
            "trained_tokens_per_s": tokens * 1e3 / med,
            "model_flop_per_step": model_flop, "model_tflop_per_s": model_flop / med / 1e9,
            "executed_flop_per_step": exec_flop, "executed_tflop_per_s": exec_flop / med / 1e9,
            "state_bytes": state_bytes, "peak_device_bytes": peak,
            "peak_above_phase_start_bytes": peak - live_before, "run_wall_s": wall_k,
            "losses": losses, "grad_norms": [r["grad_norm"] for r in rec_k],
            "launches": train_launches, "launches_per_train_step": {k: per_step[k]
                                                                   for k in routing}}
    log(json.dumps({"lm_train": info}))
    final_k = [t.cpu() for t in tensors(params)]
    del params, state, step
    free()

    def same_run(rec, params, what):
        check([r["loss"] for r in rec] == losses
              and [r["grad_norm"] for r in rec] == info["grad_norms"],
              f"trainer: {what}: losses or grad norms differ from the kernel arm's")
        check(all(torch.equal(a, b.cpu()) for a, b in zip(final_k, tensors(params))),
              f"trainer: {what}: final parameters differ from the kernel arm's")

    # the same steps with the partition plan on its torch arm
    os.environ[ops.PARTITION_PLAN_ENV] = "torch"
    try:
        ops.reset_launch_counts()
        (params, _, _, rec_t, plan_t), wall_t = timed(torch, run)
        check(sum(ops.launch_counts().values()) == 0, "trainer: the torch arm launched a kernel")
    finally:
        del os.environ[ops.PARTITION_PLAN_ENV]
    check(torch.equal(plan_k[0], plan_t[0]), "trainer: the first plan's digits differ")
    same_run(rec_t, params, "the torch arm")
    del params
    free()
    # the kernel arm once more, then one more step profiled
    (params, state, step, rec_r, _), wall_r = timed(torch, run)
    same_run(rec_r, params, "a second kernel-arm run")
    prof = profile_run(lambda: float(step(params, state, data(TRAIN_STEPS))[2]["loss"]),
                       groups=TRAIN_KERNEL_GROUPS)
    log(json.dumps({"lm_train_step_profile": {"card": card, **prof}}))
    log(f"(v) {LM_ARCH} at {cfg.num_layers} of 24 layers ({n_params} parameters, float32, TF32 "
        f"{'on' if tf32 else 'off'}): {TRAIN_STEPS} steps of {tokens} tokens, step median "
        f"{med:.3f} ms, p90 {info['step_ms_p90']:.3f} ms; {info['trained_tokens_per_s']:.1f} "
        f"trained tokens/s; {info['model_tflop_per_s']:.2f} model and "
        f"{info['executed_tflop_per_s']:.2f} executed TFLOP/s; peak {peak} bytes against "
        f"{state_bytes} of state; loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
        f"{2 * cfg.num_layers} launches of each routing kernel per step; the torch arm and a "
        f"second kernel-arm run equal bit for bit (losses, grad norms, final parameters; runs "
        f"{wall_k:.3f}, {wall_t:.3f}, {wall_r:.3f} s) ({card})")
    del params, state, step, final_k
    free()

    # the routing kernels at the train shape: 8,192 digits, 60 bins
    rd, nbins = plan_k[0].contiguous(), plan_k[1]
    shape = f"{nbins} bins, {rd.shape[0]} digits: the MoE routing plan of one train step"
    record_hist(rd, nbins, shape, launches=train_launches["block_histograms"])
    rbase = krp.tile_base(krp.block_histograms(rd, nbins))[0]
    record("partition_ranks", [krp.rank_with_base(rd, rbase, nbins)],
           [ref.partition_ranks(rd, nbins)], lambda: krp.rank_with_base(rd, rbase, nbins),
           lambda: ref.partition_ranks(rd, nbins), lambda: torch.sort(rd, stable=True),
           4 * rd.shape[0] + 4 * rbase.numel() + 4 * rd.shape[0], shape=shape,
           launches=train_launches["partition_ranks"])
    for row in results[-2:]:
        row["launches_per_train_step"] = per_step[row["name"]]
    plan_pairs = paired_ms(torch, lambda: prim.plan_partition_permutation(rd, nbins, impl="cuda"),
                           lambda: prim.plan_partition_permutation(rd, nbins, impl="torch"))
    log(json.dumps({"lm_train_routing_plan_kernel_arm_against_torch_arm": {"card": card,
                                                                           **plan_pairs}}))

    # loss and gradients on the card against the CPU: 1 layer, batch 1 x 64
    cfg1 = cfg.replace(num_layers=1)
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        p_card = LM.init_params(cfg1, torch.Generator(dev).manual_seed(1), torch.float32,
                                dev)
        p_host = map_leaves(lambda t: t.cpu(), p_card, is_leaf=torch.is_tensor)
        toks = make_batch_fn(cfg1.vocab_size, 1, 64, seed=1, device="cpu")(0)["tokens"]
        out = {}
        for where, p in ((dev, p_card), ("cpu", p_host)):
            ps = [t.detach().requires_grad_() for t in tensors(p)]
            it = iter(ps)
            tree = map_leaves(lambda _: next(it), p, is_leaf=torch.is_tensor)
            loss, _m = LM.loss_fn(cfg1, tree, {"tokens": toks.to(where)})
            out[where] = (float(loss.detach()),
                          [g.cpu() for g in torch.autograd.grad(loss, ps)])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    loss_err = abs(out[dev][0] - out["cpu"][0]) / abs(out["cpu"][0])
    grad_err = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                   for a, b in zip(out[dev][1], out["cpu"][1]))
    log(json.dumps({"lm_train_card_against_cpu": {
        "card": card, "layers": 1, "batch": 1, "seq": 64, "dtype": "float32", "tf32": False,
        "loss_cuda": out[dev][0], "loss_cpu": out["cpu"][0], "loss_rel_err": loss_err,
        "grad_max_err_over_leaf_max": grad_err, "loss_rtol": TRAIN_CPU_LOSS_RTOL,
        "grad_tol": TRAIN_CPU_GRAD_TOL}}))
    check(loss_err <= TRAIN_CPU_LOSS_RTOL, f"trainer at 1 layer: card and CPU losses differ by "
          f"{loss_err} relative")
    check(grad_err <= TRAIN_CPU_GRAD_TOL, f"trainer at 1 layer: a gradient leaf differs by "
          f"{grad_err} of its max |g|")
    del p_card, p_host, out
    free()

    # checkpoint resume on the card (reduced config; the kernels launch)
    rcfg = get_reduced_config(LM_ARCH)
    rdata = make_batch_fn(rcfg.vocab_size, 4, 32, seed=0, cfg=rcfg, device=dev)

    def resume_run(total, ckpt_dir=None):
        opt = AdamW(lr=cosine_schedule(1e-3, warmup=2, total=20))
        params = LM.init_params(rcfg, torch.Generator(dev).manual_seed(0), torch.float32,
                                dev)
        step, _, _ = build_train_step(rcfg, None, None, opt)
        return train_loop(step, params, opt.init(params), rdata,
                          LoopConfig(total_steps=total, ckpt_dir=ckpt_dir, ckpt_every=5),
                          log=lambda *_: None)

    before = ops.launch_counts()["partition_ranks"]
    straight, _, _ = resume_run(20)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as ck:
        resume_run(10, ck)
        resumed, _, rep = resume_run(20, ck)
    check(rep.resumed_from == 10 and rep.steps_run == 10,
          f"trainer resume: resumed from {rep.resumed_from}, ran {rep.steps_run} steps")
    check(ops.launch_counts()["partition_ranks"] > before, "trainer resume: no kernel launched")
    check(all(torch.equal(a, b) for a, b in zip(tensors(straight), tensors(resumed))),
          "trainer resume: 10 + 10 steps through checkpoints differ from 20 straight")
    log(f"(v) resume on the reduced {LM_ARCH}: 20 steps straight equal 10 + a resume to 20 bit "
        f"for bit ({card})")
    del straight, resumed
    free()

    # the launcher at full size: olmo-1b, float32, its own defaults
    argv = ["--arch", "olmo-1b", "--full", "--steps", "10"]
    report, launch_s = timed(torch, lambda: train_launch.main(argv))
    log(json.dumps({"lm_train_launcher": {"card": card, "argv": argv, "wall_s": launch_s,
                                          "steps": report.steps_run,
                                          "first_loss": report.losses[0],
                                          "last_loss": report.losses[-1]}}))
    check(report.steps_run == 10 and all(np.isfinite(report.losses)),
          f"the train launcher: {report.steps_run} steps, losses {report.losses}")
    free()


def _serve(torch, cfg, params, prompts, max_tokens, dtype, stub=None):
    """The requests through a fresh `ServeEngine` (8 slots, a 128-token
    cache); per decode step the host ms after a synchronize and the launches.
    Fails on a request error or a moved `resilience.serve_*` counter.
    Returns (engine, requests, ticks, wall seconds, steps)."""
    from repro_torch.kernels import ops
    from repro_torch.obs import metrics
    from repro_torch.serve.engine import Request, ServeEngine

    eng = ServeEngine(cfg, params, max_batch=LM_BATCH, max_len=LM_MAX_LEN, dtype=dtype,
                      batch_stub=stub)
    steps, real_step = [], eng._step

    def step_fn(p, c, tok, pos):
        torch.cuda.synchronize()
        before = ops.launch_counts()
        t0 = time.perf_counter()
        lg, cache = real_step(p, c, tok, pos)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        after = ops.launch_counts()
        steps.append({"ms": ms, "launches": {k: after[k] - before[k] for k in after}})
        return lg, cache

    eng._step = step_fn
    counters = ("resilience.serve_shed", "resilience.serve_retries",
                "resilience.serve_evictions", "resilience.serve_deadline_evictions")
    reqs = [Request(rid=i, prompt=list(pr), max_tokens=max_tokens)
            for i, pr in enumerate(prompts)]
    before = {k: metrics.counter(k).value for k in counters}
    for r in reqs:
        eng.submit(r)
    ticks, wall = timed(torch, eng.run)
    moved = {k: metrics.counter(k).value - v for k, v in before.items()}
    check(all(r.done and not r.error for r in reqs),
          f"{cfg.name} server: request errors {[(r.rid, r.error) for r in reqs if r.error]}")
    check(not any(moved.values()), f"{cfg.name} server: resilience counters moved {moved}")
    return eng, reqs, ticks, wall, steps


def _serve_info(cfg, reqs, ticks, wall, steps, peak, live_before, card):
    steady = [st["ms"] for st in steps[2:]]
    generated = sum(len(r.out) for r in reqs)
    return {"card": card, "arch": cfg.name, "layers": cfg.num_layers,
            "requests": len(reqs), "max_batch": LM_BATCH, "max_len": LM_MAX_LEN,
            "ticks": ticks, "decode_steps": len(steps), "first_step_ms": steps[0]["ms"],
            "step_ms_median": float(np.median(steady)),
            "step_ms_p90": float(np.percentile(steady, 90)), "steady_steps": len(steady),
            "generated_tokens": generated, "serve_wall_s": wall,
            "generated_tokens_per_s": generated / wall, "peak_device_bytes": peak,
            "peak_above_phase_start_bytes": peak - live_before}


def _prompts(cfg, n, rng):
    """n prompts of 2 to 8 tokens, as (u) and the serve launcher draw them."""
    return [rng.integers(3, cfg.vocab_size, size=rng.integers(2, 9)).tolist() for _ in range(n)]


def _stub_np(cfg, b, rng):
    """The family's stub embeddings (vision patches or audio frames) as the
    launchers draw them: normal * 0.02, float32."""
    if cfg.family == "vlm":
        return {"vision_emb": (rng.normal(size=(b, cfg.vision_tokens, cfg.d_model))
                               * 0.02).astype(np.float32)}
    if cfg.family == "audio":
        return {"enc_emb": (rng.normal(size=(b, cfg.encoder_len, cfg.d_model))
                            * 0.02).astype(np.float32)}
    return {}


def _open_gates(torch, cfg, params):
    """The vision family's cross layers are gated by tanh of zero-initialized
    scalars: set them to 1 so that the cross attention reaches the logits."""
    if cfg.family == "vlm":
        params["groups"]["cross"]["gate_attn"].fill_(1.0)
        params["groups"]["cross"]["gate_mlp"].fill_(1.0)


def _card_against_cpu(torch, cfg, card, what):
    """`cfg` (one group or one layer a stack) drawn in float32 on the card
    and copied to the CPU; TF32 off: the logits of one forward of 2 x 16
    tokens and of 3 decode steps over the real vocabulary, card against
    CPU, within the family's FAMILY_CPU_LOGIT_RTOL of their largest
    magnitude."""
    import gc

    from repro_torch.models import model as LM
    from repro_torch.models.params import map_leaves

    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(1)
    toks = rng.integers(3, cfg.vocab_size, (2, 16)).astype(np.int32)
    stub = _stub_np(cfg, 2, rng)
    out = {}
    try:
        p_card = LM.init_params(cfg, torch.Generator("cuda").manual_seed(1), torch.float32,
                                "cuda")
        _open_gates(torch, cfg, p_card)
        p_host = map_leaves(lambda t: t.cpu(), p_card, is_leaf=torch.is_tensor)
        for where, p in (("cuda", p_card), ("cpu", p_host)):
            batch = {k: torch.from_numpy(v).to(where) for k, v in stub.items()}
            with torch.no_grad():
                fwd, _ = LM.forward(cfg, p, {**batch, "tokens": torch.from_numpy(toks).to(where)},
                                    remat=False)
            cache = LM.init_cache(cfg, p, 2, 16, batch, torch.float32)
            logits = []
            for step in range(3):
                lg, cache = LM.decode_step(cfg, p, cache,
                                           torch.from_numpy(toks[:, step]).to(where), step)
                logits.append(lg)
            # the real vocabulary's logits: the padding's are -1e30 on both
            V = cfg.vocab_size
            out[where] = (fwd[..., :V].float().cpu(), torch.stack(logits)[..., :V].float().cpu())
            del cache, fwd, logits
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    errs = [float((a - b).abs().max()) for a, b in zip(out["cuda"], out["cpu"])]
    scales = [float(b.abs().max()) for b in out["cpu"]]
    info = {"card": card, "what": what, "layers": cfg.num_layers, "dtype": "float32",
            "tf32": False, "batch": 2, "forward_tokens": 16, "decode_steps": 3,
            "forward_max_abs_logit_diff": errs[0], "forward_max_abs_logit": scales[0],
            "decode_max_abs_logit_diff": errs[1], "decode_max_abs_logit": scales[1],
            "rtol": FAMILY_CPU_LOGIT_RTOL[cfg.family]}
    log(json.dumps({f"{cfg.name}_card_against_cpu": info}))
    for e, sc, part in zip(errs, scales, ("forward", "decode")):
        check(e <= FAMILY_CPU_LOGIT_RTOL[cfg.family] * sc, f"{cfg.name} ({what}): card and "
              f"CPU {part} logits differ by {e} (max |logit| {sc})")
    del p_card, p_host, out
    gc.collect()
    torch.cuda.empty_cache()


def hybrid_phase(torch, card, profile_run) -> None:
    """(w) The hybrid: zamba2-2.7b at its published widths and depth in bf16
    through `ServeEngine` (no kernel of the port on its path: SSD and the
    shared attention are plain torch ops); one profiled decode step; a
    teacher-forced decode of 256 tokens against one forward through the
    first group, float32; the card against the CPU at one group."""
    import dataclasses
    import gc

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import model as LM
    from repro_torch.models.params import leaves, map_leaves

    gc.collect()
    torch.cuda.empty_cache()
    live_before = torch.cuda.memory_allocated()
    cfg = get_config(HYB_ARCH)
    check(LM.num_params(cfg) == HYB_PARAMS,
          f"{HYB_ARCH}: {LM.num_params(cfg)} parameters, expected {HYB_PARAMS}")
    params, init_s = timed(torch, lambda: LM.init_params(
        cfg, torch.Generator("cuda").manual_seed(0), torch.bfloat16, "cuda"))
    param_bytes = sum(t.numel() * t.element_size() for t in leaves(params, torch.is_tensor))
    prompts = _prompts(cfg, LM_REQUESTS, np.random.default_rng(0))
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    eng, reqs, ticks, wall, steps = _serve(torch, cfg, params, prompts, LM_MAX_TOKENS,
                                           torch.bfloat16)
    launches = ops.launch_counts()
    check(not any(launches.values()), f"{HYB_ARCH} server: a kernel launched ({launches})")
    info = _serve_info(cfg, reqs, ticks, wall, steps, torch.cuda.max_memory_allocated(),
                       live_before, card)
    info.update(params=HYB_PARAMS, param_bytes=param_bytes, dtype="bfloat16", init_s=init_s,
                launches=launches, chunk=cfg.ssm.chunk, groups=LM._n_groups(cfg))
    log(json.dumps({"hybrid_serve": info}))
    tok = torch.as_tensor(eng.tokens, device="cuda")
    pos = torch.as_tensor(eng.slot_pos, device="cuda")
    prof = profile_run(lambda: LM.decode_step(cfg, params, eng.cache, tok, pos),
                       groups=TRAIN_KERNEL_GROUPS)
    log(json.dumps({"hybrid_decode_step_profile": {"card": card, **prof}}))
    del eng, tok, pos

    # teacher-forced decode against one forward, float32, TF32 off: the
    # served model's first group at its published widths (the bound), and
    # the whole depth's forward at chunk 128 against chunk 64 (no bound)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        p32 = map_leaves(lambda t: t.float(), params, is_leaf=torch.is_tensor)
        del params
        toks = torch.from_numpy(np.random.default_rng(2).integers(
            3, cfg.vocab_size, (1, HYB_TF_TOKENS)).astype(np.int32)).cuda()
        with torch.no_grad():
            deep = [LM.forward(c, p32, {"tokens": toks}, remat=False)[0]
                    for c in (cfg, cfg.replace(ssm=dataclasses.replace(cfg.ssm, chunk=64)))]
        deep_diff = float((deep[0] - deep[1]).abs().max())
        deep_scale = float(deep[0].abs().max())
        del deep
        cfg1 = cfg.replace(num_layers=cfg.shared_attn_every)
        p1 = dict(p32, groups=map_leaves(lambda t: t[:1], p32["groups"],
                                         is_leaf=torch.is_tensor))
        with torch.no_grad():
            (fwd, _), fwd_s = timed(torch, lambda: LM.forward(cfg1, p1, {"tokens": toks},
                                                              remat=False))
        cache = LM.init_cache(cfg1, p1, 1, HYB_TF_TOKENS, None, torch.float32)
        t0 = time.perf_counter()
        err = 0.0
        for i in range(HYB_TF_TOKENS):
            lg, cache = LM.decode_step(cfg1, p1, cache, toks[:, i], i)
            err = max(err, float((lg - fwd[:, i]).abs().max()))
        dec_s = time.perf_counter() - t0
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    scale = float(fwd[..., :cfg.vocab_size].abs().max())
    log(json.dumps({"hybrid_decode_against_forward": {
        "card": card, "tokens": HYB_TF_TOKENS, "chunk": cfg.ssm.chunk,
        "chunks": HYB_TF_TOKENS // cfg.ssm.chunk, "dtype": "float32", "tf32": False,
        "layers": cfg1.num_layers, "forward_s": fwd_s, "decode_s": dec_s,
        "max_abs_logit_diff": err, "max_abs_logit": scale, "rtol": HYB_TF_LOGIT_RTOL,
        "full_depth_forward_chunk128_against_chunk64_max_abs_diff": deep_diff,
        "full_depth_max_abs_logit": deep_scale}}))
    check(err <= HYB_TF_LOGIT_RTOL * scale, f"{HYB_ARCH}: teacher-forced decode differs from "
          f"the forward by {err} (max |logit| {scale})")
    del p32, p1, cache, fwd, toks
    gc.collect()
    torch.cuda.empty_cache()
    log(f"(w) {HYB_ARCH} at full size (bf16, {param_bytes} bytes of weights): {LM_REQUESTS} "
        f"requests in {ticks} ticks, no request error, no kernel launched; decode step median "
        f"{info['step_ms_median']:.3f} ms, p90 {info['step_ms_p90']:.3f} ms; "
        f"{info['generated_tokens_per_s']:.1f} generated tokens/s; peak "
        f"{info['peak_device_bytes']} bytes; teacher-forced decode of {HYB_TF_TOKENS} tokens "
        f"through the first group within {err:.3g} of the forward (max |logit| {scale:.4g}, "
        f"float32); at full depth the forward at chunk 64 differs from chunk 128 by "
        f"{deep_diff:.3g} (max |logit| {deep_scale:.4g}) ({card})")
    _card_against_cpu(torch, cfg.replace(num_layers=cfg.shared_attn_every), card,
                      "one group: 6 Mamba2 layers and the shared block")


def pipeline_phase(torch, card, record, record_hist, profile_run, results) -> None:
    """(x) The feature-join pipeline feeding xlstm-125m: 10 steps of
    `examples/ml_pipeline_torch.py`'s step (F ⋈ U ⋈ I by PHJ-OM on the
    kernels, the partition_hash group-by, one float32 AdamW step), the
    launch counters set to 0 just before; the joined features against a
    numpy join; the same steps on the torch arms of the plan, the probe and
    the gather, bit for bit; one step's join and group-by profiled; the
    sLSTM and mLSTM layers alone; the four kernels' rows at the pipeline's
    shapes (appended to `results`)."""
    import functools
    import gc
    import importlib
    import importlib.util

    from repro_torch.configs.base import get_config
    from repro_torch.core import hash_join as hj
    from repro_torch.core import primitives as prim
    from repro_torch.data.pipeline import (FeatureJoinConfig, assemble_batch,
                                           history_aggregates, make_dim_tables,
                                           make_fact_batch)
    from repro_torch.kernels import gather as kgather
    from repro_torch.kernels import hash_probe as kprobe
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import radix_partition as krp
    from repro_torch.models import model as LM
    from repro_torch.models import xlstm as XL
    from repro_torch.models.params import leaves
    from repro_torch.train.optimizer import AdamW, cosine_schedule

    # the module, not the `join` function that repro_torch.core exports
    join_mod = importlib.import_module("repro_torch.core.join")
    spec = importlib.util.spec_from_file_location("ml_pipeline_torch",
                                                  ROOT / "examples" / "ml_pipeline_torch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)

    gc.collect()
    torch.cuda.empty_cache()
    live_before = torch.cuda.memory_allocated()
    mcfg = get_config("xlstm-125m")
    check(LM.num_params(mcfg) == PIPE_PARAMS,
          f"xlstm-125m: {LM.num_params(mcfg)} parameters, expected {PIPE_PARAMS}")
    pcfg = FeatureJoinConfig(n_users=PIPE_USERS, n_items=PIPE_ITEMS, algorithm="phj",
                             pattern="gftr", vocab=mcfg.vocab_size)
    rows = PIPE_BATCH * PIPE_SEQ
    (U, I), dims_s = timed(torch, lambda: make_dim_tables(pcfg, "cuda"))
    facts = [make_fact_batch(pcfg, PIPE_BATCH, PIPE_SEQ, i, "cuda") for i in range(PIPE_STEPS)]
    log(f"data: U {U!r}, I {I!r} ({dims_s:.3f} s); {PIPE_STEPS} fact batches of {rows} rows")

    def run():
        params = LM.init_params(mcfg, torch.Generator("cuda").manual_seed(0), torch.float32,
                                "cuda")
        opt = AdamW(lr=cosine_schedule(3e-3, 2, PIPE_STEPS), master_weights=False)
        state = opt.init(params)
        step = example.build_pipeline_step(pcfg, mcfg, U, I, opt, PIPE_BATCH, PIPE_SEQ)
        rec = []
        for fact in facts:
            times = {}
            torch.cuda.synchronize()
            before = ops.launch_counts()
            t0 = time.perf_counter()
            params, state, m = step(params, state, fact, times)
            loss = float(m["loss"])
            ms = (time.perf_counter() - t0) * 1e3
            after = ops.launch_counts()
            rec.append({"ms": ms, "parts_ms": {k: v * 1e3 for k, v in times.items()},
                        "loss": loss, "grad_norm": float(m["grad_norm"]),
                        "users": int(m["users"]), "tokens": m["tokens"].clone(),
                        "launches": {k: after[k] - before[k] for k in after}})
        return params, state, step, rec

    # the main path: the kernel arms, counts set to 0 just before
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    (params, state, step, rec_k), wall_k = timed(torch, run)
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    for i, r in enumerate(rec_k):
        check(r["launches"] == PIPE_LAUNCHES, f"pipeline step {i}: launches {r['launches']}, "
              f"expected {PIPE_LAUNCHES}")
    check(launches == {k: PIPE_STEPS * v for k, v in PIPE_LAUNCHES.items()},
          f"pipeline: launches {launches} over {PIPE_STEPS} steps")
    losses = [r["loss"] for r in rec_k]
    check(all(np.isfinite(losses)) and all(np.isfinite([r["grad_norm"] for r in rec_k])),
          f"pipeline: a loss or grad norm is not finite ({losses})")
    check(all(0 < r["users"] <= rows for r in rec_k), "pipeline: user counts out of range")
    steady = rec_k[2:]

    def med(key):
        return float(np.median([r["parts_ms"][key] for r in steady]))

    step_med = float(np.median([r["ms"] for r in steady]))
    info = {"card": card, "arch": mcfg.name, "params": PIPE_PARAMS, "dtype": "float32",
            "tf32": torch.backends.cuda.matmul.allow_tf32, "batch": PIPE_BATCH,
            "seq": PIPE_SEQ, "fact_rows_per_step": rows, "n_users": PIPE_USERS,
            "n_items": PIPE_ITEMS, "vocab": pcfg.vocab, "steps": PIPE_STEPS,
            "step_ms": [r["ms"] for r in rec_k],
            "parts_ms": [r["parts_ms"] for r in rec_k], "step_ms_median": step_med,
            "step_ms_p90": float(np.percentile([r["ms"] for r in steady], 90)),
            "join_ms_median": med("join"), "group_by_ms_median": med("group_by"),
            "train_ms_median": med("train"), "steady_steps": len(steady),
            "trained_tokens_per_s": rows * 1e3 / step_med, "peak_device_bytes": peak,
            "peak_above_phase_start_bytes": peak - live_before, "run_wall_s": wall_k,
            "losses": losses, "users": [r["users"] for r in rec_k], "launches": launches,
            "launches_per_step": {k: v for k, v in PIPE_LAUNCHES.items() if v}}
    log(json.dumps({"pipeline_train": info}))
    final_k = [t.cpu() for t in leaves(params, torch.is_tensor)]

    # the joined features against a numpy join, row for row; the tokens
    # against numpy's float32 binning
    Un = {c: U[c].cpu().numpy() for c in U.column_names}
    In = {c: I[c].cpu().numpy() for c in I.column_names}
    upos = np.empty(PIPE_USERS, np.int64)
    upos[Un["uid"]] = np.arange(PIPE_USERS)
    ipos = np.empty(PIPE_ITEMS, np.int64)
    ipos[In["iid"]] = np.arange(PIPE_ITEMS)
    for i in (0, PIPE_STEPS - 1):
        fn = {c: facts[i][c].cpu().numpy() for c in facts[i].column_names}
        lm_batch, joined, count = assemble_batch(pcfg, U, I, facts[i], PIPE_BATCH, PIPE_SEQ)
        check(int(count) == rows, f"pipeline join {i}: {int(count)} rows, expected {rows}")
        want = {"_fact_id": np.arange(rows, dtype=np.int32), "label": fn["label"]}
        for j in range(pcfg.user_features):
            want[f"uf{j}"] = Un[f"uf{j}"][upos[fn["fk_user"]]]
        for j in range(pcfg.item_features):
            want[f"if{j}"] = In[f"if{j}"][ipos[fn["fk_item"]]]
        check(sorted(joined.column_names) == sorted(want),
              f"pipeline join {i}: columns {joined.column_names}")
        for c, v in want.items():
            check(np.array_equal(joined[c].cpu().numpy(), v),
                  f"pipeline join {i}: column {c} differs from numpy's join")
        f = want["uf0"] + want["if0"]
        tok = ((np.clip(f, np.float32(-3), np.float32(3)) + np.float32(3)) / np.float32(6)
               * np.float32(pcfg.vocab - 2)).astype(np.int32) + 1
        tok = tok.reshape(PIPE_BATCH, PIPE_SEQ)
        tok = np.concatenate([tok, tok[:, :1]], axis=1)
        check(np.array_equal(lm_batch["tokens"].cpu().numpy(), tok)
              and torch.equal(lm_batch["tokens"], rec_k[i]["tokens"]),
              f"pipeline step {i}: tokens differ from numpy's binning or from the step's")
    del joined, lm_batch

    # the same steps on the torch arms of the plan, the probe and the gather
    del params, state
    gc.collect()
    real_phj = join_mod.phj_join
    os.environ[ops.PARTITION_PLAN_ENV] = "torch"
    join_mod.phj_join = functools.partial(hj.phj_join, probe_impl="torch", gather_impl="torch")
    try:
        ops.reset_launch_counts()
        (params, state, _, rec_t), wall_t = timed(torch, run)
        check(sum(ops.launch_counts().values()) == 0,
              "pipeline: the torch arms launched a kernel")
    finally:
        join_mod.phj_join = real_phj
        del os.environ[ops.PARTITION_PLAN_ENV]
    check(all(torch.equal(a["tokens"], b["tokens"]) for a, b in zip(rec_k, rec_t)),
          "pipeline: tokens differ between the kernel and torch arms")
    check([r["loss"] for r in rec_t] == losses
          and [r["grad_norm"] for r in rec_t] == [r["grad_norm"] for r in rec_k],
          "pipeline: losses or grad norms differ between the kernel and torch arms")
    check(all(torch.equal(a, b.cpu()) for a, b in zip(final_k, leaves(params, torch.is_tensor))),
          "pipeline: final parameters differ between the kernel and torch arms")
    log(f"(x) the feature-join pipeline: {PIPE_STEPS} steps of {rows} fact rows joined to "
        f"{PIPE_USERS} users and {PIPE_ITEMS} items, xlstm-125m ({PIPE_PARAMS} parameters, "
        f"float32) trained on the tokens: step median {step_med:.3f} ms (join "
        f"{info['join_ms_median']:.3f}, group-by {info['group_by_ms_median']:.3f}, train "
        f"{info['train_ms_median']:.3f}); {info['trained_tokens_per_s']:.1f} trained tokens/s; "
        f"peak {peak} bytes; loss {losses[0]:.4f} -> {losses[-1]:.4f}; per step "
        f"{PIPE_LAUNCHES['block_histograms']} block_histograms, "
        f"{PIPE_LAUNCHES['partition_ranks']} partition_ranks, {PIPE_LAUNCHES['hash_probe']} "
        f"hash_probe and {PIPE_LAUNCHES['clustered_gather']} clustered_gather launches; joins "
        f"equal to numpy's; the torch arms' run equal bit for bit (tokens, losses, grad norms, "
        f"final parameters; runs {wall_k:.3f} and {wall_t:.3f} s) ({card})")
    del final_k, rec_t

    # one step's join and group-by profiled (the kernel arms); the recurrent
    # layers alone at the step's shape: one sLSTM layer's loop of 512 cell
    # steps (timed and profiled), one chunked mLSTM layer (two chunks of
    # 256). A whole train step is ~10^6 profiler events, whose reading
    # takes minutes: the sLSTM layer stands for it.
    join_prof = profile_run(lambda: (assemble_batch(pcfg, U, I, facts[0], PIPE_BATCH, PIPE_SEQ),
                                     history_aggregates(pcfg, facts[0], num_groups=rows)),
                            groups=TRAIN_KERNEL_GROUPS)
    x = torch.randn((PIPE_BATCH, PIPE_SEQ, mcfg.d_model), device="cuda") * 0.5
    pair0 = LM._layer(params["pairs"], 0)
    with torch.no_grad():
        slstm_ms = cuda_ms(torch, lambda: XL.apply_slstm(pair0["slstm"], x, mcfg.xlstm),
                           reps=3, warmup=1)
        mlstm_ms = cuda_ms(torch, lambda: XL.apply_mlstm(pair0["mlstm"], x, mcfg.xlstm),
                           reps=3, warmup=1)
        slstm_prof = profile_run(lambda: XL.apply_slstm(pair0["slstm"], x, mcfg.xlstm),
                                 groups=TRAIN_KERNEL_GROUPS)
    log(json.dumps({"pipeline_join_and_group_by_profile": {"card": card, **join_prof}}))
    log(json.dumps({"pipeline_slstm_layer_profile": {
        "card": card, **slstm_prof, "slstm_layer_forward_ms": slstm_ms,
        "slstm_cell_steps_per_layer": PIPE_SEQ, "mlstm_layer_forward_ms": mlstm_ms,
        "mlstm_chunks_per_layer": -(-PIPE_SEQ // XL.MLSTM_CHUNK),
        "pairs": LM._n_pairs(mcfg)}}))
    del params, state, step, x, pair0
    gc.collect()
    torch.cuda.empty_cache()

    # the four kernels at the pipeline's shapes: the user join's plan pass
    # over U's 4,194,304 keys (the top partition ranked as a tail class),
    # its probe of 4,096 fact rows, and the gather of uf0 through id_r
    p_bits = hj.choose_partition_bits(PIPE_USERS, hj.BUILD_BLOCK)
    P = 1 << p_bits
    dig_r = hj._digits(U["uid"], p_bits, True)
    pd = torch.where(dig_r == P, 256, dig_r & 255).contiguous()
    shape = f"257 bins: the pipeline's user-join plan, first pass over U's {PIPE_USERS} keys"
    record_hist(pd, 257, shape, launches=launches["block_histograms"])
    base = krp.tile_base(krp.block_histograms(pd, 257))[0]
    record("partition_ranks", [krp.rank_with_base(pd, base, 257)],
           [ref.partition_ranks(pd, 257)], lambda: krp.rank_with_base(pd, base, 257),
           lambda: ref.partition_ranks(pd, 257), lambda: torch.sort(pd, stable=True),
           4 * pd.shape[0] + 4 * base.numel() + 4 * pd.shape[0], shape=shape,
           launches=launches["partition_ranks"])
    fk = facts[0]["fk_user"]
    dig_s = hj._digits(fk, p_bits, True)
    perm_r, off_r, sz_r = prim.plan_partition_permutation(dig_r, P + 1)
    perm_s, off_s, sz_s = prim.plan_partition_permutation(dig_s, P + 1)
    kr, ks = U["uid"][perm_r], fk[perm_s]
    probe_args = tuple(t.contiguous() for t in (kr, off_r[:P], sz_r[:P], ks, off_s[:P],
                                                sz_s[:P])) + (hj.BUILD_BLOCK,)
    vid, hit = kprobe.hash_probe(*probe_args)
    check(int(hit.sum()) == rows, "the pipeline's probe missed a row of a 100%-match join")
    # bytes the data needs: each probe key read and its vid and hit written,
    # the build keys of the partitions the probe rows fall in, and both
    # sides' offsets and sizes for those partitions; operations: one lookup
    # per probe row and one insert per build key read
    probed = torch.unique(dig_s)
    live_build = int(sz_r[probed].clamp(max=hj.BUILD_BLOCK).sum())
    probe_bytes = 4 * rows + (4 + 1) * rows + 4 * live_build + 4 * 4 * probed.numel()
    record("hash_probe", [vid, hit], list(ref.hash_probe(*probe_args)),
           lambda: kprobe.hash_probe(*probe_args), lambda: ref.hash_probe(*probe_args), None,
           probe_bytes, live_build + rows, plain_reps=3,
           shape=f"{rows} fact rows against {PIPE_USERS} users in {P} partitions",
           launches=launches["hash_probe"])
    vid_s = torch.arange(rows, dtype=torch.int32, device="cuda")
    (_, vr, _), c = prim.compact(hit, [ks, vid, vid_s], rows, fill=-1)
    id_r = torch.where(torch.arange(rows, device="cuda") < c, vr, -1)
    src = U["uf0"][perm_r]
    idx_long = id_r.clamp(min=0).long()
    record("clustered_gather", [kgather.clustered_gather(src, id_r)],
           [ref.clustered_gather(src, id_r)], lambda: kgather.clustered_gather(src, id_r),
           lambda: ref.clustered_gather(src, id_r), lambda: torch.take(src, idx_long),
           rows * (4 + 4 + 4),
           shape=f"uf0 through id_r: {rows} rows from U's {PIPE_USERS} partitioned rows",
           launches=launches["clustered_gather"])
    for row in results[-4:]:
        row["launches_per_pipeline_step"] = PIPE_LAUNCHES[row["name"]]
    del U, I, facts, pd, base, kr, ks, vid, hit, src, id_r, idx_long
    gc.collect()
    torch.cuda.empty_cache()


# runs an example with the launch counters read at its end (to stderr, so
# that its standard output is the example's own)
EXAMPLE_RUNNER = ("import json, runpy, sys\n"
                  "sys.argv = sys.argv[1:]\n"
                  "from repro_torch.kernels import ops\n"
                  "ops.reset_launch_counts()\n"
                  "runpy.run_path(sys.argv[0], run_name='__main__')\n"
                  "print(json.dumps({'launches': ops.launch_counts()}), file=sys.stderr)\n")
# the quickstart's total revenue (3,024,381, printed to the unit): a float32
# sum of 30,000 products, taken in another order on each device. Held at the
# random-walk size of 30,000 roundings, sqrt(30,000) x 2^-24 (1.03e-5, 31 of
# the total): one row lost or doubled (a product is 101 on average) moves it
# past that, where the worst-case 2 x 30,000 x 2^-24 (3.6e-3) let a hundred
# rows through. The card and the CPU printed the same total.
QUICKSTART_REVENUE_RTOL = 30_000 ** 0.5 * F32_ULP


def same_printed_numbers(want: list, got: list, rtol_lines=()) -> str | None:
    """None when two runs printed the same lines: the same text, the same
    integers, decimals within their printed digits, and the numbers of the
    lines starting with one of `rtol_lines` ({prefix: rtol}) within rtol
    relative; else what differs."""
    import re

    number = re.compile(r"-?\d+(?:\.\d+)?")
    if len(want) != len(got):
        return f"{len(got)} lines against {len(want)}"
    for w, g in zip(want, got):
        wn, gn = number.findall(w), number.findall(g)
        if number.sub("#", w) != number.sub("#", g) or len(wn) != len(gn):
            return f"{g!r} against {w!r}"
        rtol = next((t for p, t in dict(rtol_lines).items() if w.startswith(p)), None)
        for a, b in zip(wn, gn):
            if a == b:
                continue
            if rtol is not None:
                ok = abs(float(a) - float(b)) <= rtol * abs(float(a))
            else:
                ok = "." in a and abs(float(a) - float(b)) <= 10.0 ** -len(a.split(".")[1])
            if not ok:
                return f"{g!r} against {w!r}"
    return None


def lint_phase(torch, card) -> None:
    """(z) The launch-configuration lint on the card and the two example
    twins (see the module docstring)."""
    from repro_torch.analysis import kernel_lint as kl
    from repro_torch.core.planner import PrimitiveProfile
    from repro_torch.obs.calibration import CalibrationStore, backend_fingerprint

    t0 = time.perf_counter()
    reports = kl.lint_production_kernels("cuda")
    launched = [r for r in reports if r.launched]
    check({r.instance for r in launched} == {i for k in kl.KERNELS for i in kl.INSTANCES[k]},
          "(z) the registered shapes miss a kernel instance")
    check(all(r.c_config is not None and r.registers is not None for r in launched),
          "(z) a launch was not held against the C side and the compiled instance")
    bad = [f"{r.name}: {type(v).__name__}: {v}" for r in reports for v in r.violations]
    check(not bad, f"(z) the launch-configuration lint: {len(bad)} violation(s): {bad[:8]}")
    table = kl.instance_table(reports)
    for row in table:
        log(f"(z) {row['instance']}: {row['threads']} threads, {row['dynamic_smem']} B of "
            f"dynamic shared memory at {row['shape']!r}, {row['registers']} registers, "
            f"{row['spill_bytes']} B spills ({row['declared_spill_bytes']} B declared), "
            f"{row['static_smem']} B of static shared memory")
    sources = {r.kernel: r.atomics for r in reports if r.instance == "source"}
    log(json.dumps({"kernel_launch_lint": {
        "card": card, "shapes": len(reports) - len(sources), "launches_held": len(launched),
        "violations": 0, "atomics_by_source": sources, "instances": table,
        "seconds": time.perf_counter() - t0}}))
    log(f"(z) lint: {len(launched)} launches at {len(kl.production_kernel_specs())} registered "
        f"shapes equal the C side's, {len(table)} instances fit, "
        f"{sum(bool(r['spill_bytes']) for r in table)} spill as declared and the rest not at all, "
        f"{sum(sources.values())} atomics of {len(sources)} sources declared ({card})")

    # the example twins, on the card and on the CPU, priced by one profile
    with tempfile.TemporaryDirectory(prefix="chip_smoke_examples_") as tmp:
        store = CalibrationStore(os.path.join(tmp, "CALIBRATION.json"))
        for device in ("cuda", "cpu"):
            store.put_profile(backend_fingerprint(device), 1 << 16, PrimitiveProfile())
        store.save()
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), REPRO_CALIBRATION_PATH=store.path)
        for script, rtol in (("quickstart_torch.py", {"group-by:": QUICKSTART_REVENUE_RTOL}),
                             ("relational_analytics_torch.py", {})):
            runs = {}
            for device in ("cuda", "cpu"):
                t1 = time.perf_counter()
                p = subprocess.run([sys.executable, "-c", EXAMPLE_RUNNER,
                                    str(ROOT / "examples" / script), "--device", device],
                                   capture_output=True, text=True, env=env, cwd=tmp,
                                   timeout=300)
                check(p.returncode == 0, f"(z) {script} --device {device} exited "
                      f"{p.returncode}:\n{p.stderr[-3000:]}")
                launches = json.loads(p.stderr.strip().splitlines()[-1])["launches"]
                runs[device] = (p.stdout.splitlines(), launches, time.perf_counter() - t1)
            out_card, launches, wall = runs["cuda"]
            check(launches["hash_probe"] > 0 and launches["block_histograms"] > 0
                  and launches["partition_ranks"] > 0,
                  f"(z) {script} on the card launched no join kernel ({launches})")
            check(not any(runs["cpu"][1].values()),
                  f"(z) {script} on the CPU launched kernels ({runs['cpu'][1]})")
            diff = same_printed_numbers(runs["cpu"][0], out_card, rtol)
            check(diff is None, f"(z) {script}: the card's lines differ from the CPU's: {diff}")
            log(f"(z) {script} --device cuda: exit 0, {len(out_card)} lines, the same "
                f"integers as --device cpu ({wall:.3f} s against {runs['cpu'][2]:.3f} s); "
                f"launches {launches}")
            log("\n".join(f"    | {line}" for line in out_card))


def family_phase(torch, card, profile_run) -> None:
    """(y) The vision and audio families served in bf16 as (u) serves, with
    8 requests: llama-3.2-vision-11b at its published widths cut to 10
    layers (two cross groups, the cross K/V of 1,601 stub patches computed
    in `init_cache`), whisper-large-v3 at its published widths and depth
    (the encoder over 1,500 stub frames in `init_cache`); one profiled
    decode step each; each on the card against the CPU at one group or one
    layer a stack."""
    import gc

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import model as LM
    from repro_torch.models.params import leaves

    cells = ((get_config(VIS_ARCH).replace(num_layers=VIS_LAYERS), VIS_PARAMS,
              "one group: 4 self-attention layers and the cross layer"),
             (get_config(AUD_ARCH), AUD_PARAMS, "one encoder and one decoder layer"))
    for cfg, n_params, cut in cells:
        gc.collect()
        torch.cuda.empty_cache()
        live_before = torch.cuda.memory_allocated()
        check(LM.num_params(cfg) == n_params,
              f"{cfg.name}: {LM.num_params(cfg)} parameters, expected {n_params}")
        params, init_s = timed(torch, lambda: LM.init_params(
            cfg, torch.Generator("cuda").manual_seed(0), torch.bfloat16, "cuda"))
        _open_gates(torch, cfg, params)
        param_bytes = sum(t.numel() * t.element_size()
                          for t in leaves(params, torch.is_tensor))
        # the stub embeddings first, then the prompts, as the launchers draw them
        rng = np.random.default_rng(0)
        stub = {k: torch.from_numpy(v).cuda() for k, v in _stub_np(cfg, LM_BATCH, rng).items()}
        prompts = _prompts(cfg, FAMILY_REQUESTS, rng)
        ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        (eng, reqs, ticks, wall, steps), serve_s = timed(
            torch, lambda: _serve(torch, cfg, params, prompts, LM_MAX_TOKENS, torch.bfloat16,
                                  stub))
        launches = ops.launch_counts()
        check(not any(launches.values()), f"{cfg.name} server: a kernel launched ({launches})")
        info = _serve_info(cfg, reqs, ticks, wall, steps, torch.cuda.max_memory_allocated(),
                           live_before, card)
        info.update(params=n_params, param_bytes=param_bytes, dtype="bfloat16",
                    init_s=init_s, engine_and_serve_s=serve_s,
                    stub_tokens=next(iter(stub.values())).shape[1], launches=launches)
        log(json.dumps({f"{cfg.family}_serve": info}))
        tok = torch.as_tensor(eng.tokens, device="cuda")
        pos = torch.as_tensor(eng.slot_pos, device="cuda")
        prof = profile_run(lambda: LM.decode_step(cfg, params, eng.cache, tok, pos),
                           groups=TRAIN_KERNEL_GROUPS)
        log(json.dumps({f"{cfg.family}_decode_step_profile": {"card": card, **prof}}))
        log(f"(y) {cfg.name} at {cfg.num_layers} layers (bf16, {param_bytes} bytes of "
            f"weights): {FAMILY_REQUESTS} requests in {ticks} ticks, no request error, no "
            f"kernel launched; decode step median {info['step_ms_median']:.3f} ms, p90 "
            f"{info['step_ms_p90']:.3f} ms; {info['generated_tokens_per_s']:.1f} generated "
            f"tokens/s; peak {info['peak_device_bytes']} bytes ({card})")
        del params, eng, tok, pos, stub
        gc.collect()
        torch.cuda.empty_cache()
        one = (cfg.replace(num_layers=cfg.cross_attn_every) if cfg.family == "vlm"
               else cfg.replace(num_layers=1, encoder_layers=1))
        _card_against_cpu(torch, one, card, cut)


def dist_phase(torch, card) -> None:
    """(aa) The distributed layer on the card: (v)'s cell trained for 3
    steps by the sharded step on a (1, 1) DeviceMesh of a one-rank NCCL
    group, against 3 one-card steps from the same seed-0 state (losses,
    every parameter leaf, the routing kernels' launches); the int8
    error-feedback all-reduce over that group on one loss's gradients,
    bit for bit against `ef_compress_decompress`; `reshard_state` onto the
    mesh and back, bit for bit; the same 3 sharded steps again under
    `default_rules(seq_shard=True)`, against the same one-card steps (a
    repeat: a (1, 1) mesh has no second rank to split the sequence over,
    so no seq-sharded path runs; the CPU's 4-rank gloo world holds those);
    the dry run's three cells on the
    16 x 16 mesh of a fake process group, each in a subprocess of its
    own."""
    import gc

    import torch.distributed as dist

    from repro_torch.configs.base import get_config
    from repro_torch.data.synthetic import make_batch_fn
    from repro_torch.dist import collectives as COL
    from repro_torch.dist import sharding as SH
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as LM
    from repro_torch.models.params import leaves, map_leaves
    from repro_torch.train import elastic
    from repro_torch.train.optimizer import AdamW, cosine_schedule
    from repro_torch.train.step import build_train_step

    dev = "cuda"
    t_phase = time.perf_counter()

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    def tensors(tree):
        return leaves(tree, torch.is_tensor)

    # the dry run's cells start first: they need the CPU alone, and run
    # while the card trains
    out_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_dryrun_"))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    dry = []
    for arch, shape in DRYRUN_CELLS:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape",
               shape, "--mesh", "single", "--out", str(out_dir)]
        dry.append((arch, shape, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
            cwd=out_dir)))

    free()
    cfg = get_config(LM_ARCH).replace(num_layers=TRAIN_LAYERS)
    data = make_batch_fn(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, seed=0, cfg=cfg, device=dev)
    routing = ("block_histograms", "partition_ranks", "pass_scatter")

    def run(mesh, rules):
        """DIST_STEPS steps from the seed-0 weights; per step the loss, the
        host ms from a synchronize to the loss on the host, the launches."""
        params = LM.init_params(cfg, torch.Generator(dev).manual_seed(0), torch.float32, dev)
        opt = AdamW(lr=cosine_schedule(TRAIN_PEAK_LR, warmup=TRAIN_WARMUP, total=DIST_STEPS),
                    clip_norm=1.0)
        state = opt.init(params)
        step, psh, _ = build_train_step(cfg, mesh, rules, opt, remat=True)
        rec = []
        for i in range(DIST_STEPS):
            torch.cuda.synchronize()
            before = ops.launch_counts()
            t0 = time.perf_counter()
            params, state, m = step(params, state, data(i))
            loss = float(m["loss"])
            rec.append({"loss": loss, "ms": (time.perf_counter() - t0) * 1e3,
                        "launches": {k: v - before[k] for k, v in ops.launch_counts().items()}})
        return params, state, psh, rec

    # one card: the final parameters wait on the host
    p1, _s1, _, rec1 = run(None, None)
    final1 = [t.cpu() for t in tensors(p1)]
    del p1, _s1
    free()

    def held(params, rec, psh, seq_shard: bool):
        """The sharded run's parameters, losses and launches against the
        one-card run's."""
        what = "sharded step" + (" (seq_shard rules, nothing split on one rank)"
                                 if seq_shard else "")
        check(all(SH.is_dtensor(t) for t in tensors(params)),
              f"{what}: a parameter came back as a plain tensor")
        check(psh is not None, f"{what}: the builder returned no parameter shardings")
        per_step = {k: 2 * cfg.num_layers if k in routing else 0 for k in ops.launch_counts()}
        for i, r in enumerate(rec):
            check(r["launches"] == per_step, f"{what} {i}: launches {r['launches']}, "
                  f"expected {2 * cfg.num_layers} of each routing kernel and nothing else")
        loss_err = max(abs(a["loss"] - b["loss"]) / abs(b["loss"]) for a, b in zip(rec, rec1))
        check(loss_err <= DIST_LOSS_RTOL, f"{what}: losses {[r['loss'] for r in rec]} "
              f"against one card's {[r['loss'] for r in rec1]}")
        leaf_err, identical = 0.0, True
        sums = []
        for a, b in zip(final1, tensors(params)):
            loc = SH.local(b)
            leaf_err = max(leaf_err, float((loc - a.to(dev)).abs().max()))
            identical = identical and torch.equal(loc.cpu(), a)
            sums.append((float(loc.double().sum()), float(loc.abs().max())))
        check(leaf_err <= DIST_PARAM_TOL, f"{what}: a parameter leaf differs by {leaf_err}")
        med1 = float(np.median([r["ms"] for r in rec1[1:]]))
        med2 = float(np.median([r["ms"] for r in rec[1:]]))
        info = {"card": card, "arch": LM_ARCH, "layers": cfg.num_layers, "mesh": [1, 1],
                "seq_shard": seq_shard, "steps": DIST_STEPS, "losses": [r["loss"] for r in rec],
                "one_card_losses": [r["loss"] for r in rec1], "loss_rel_err": loss_err,
                "param_max_abs_err": leaf_err, "params_bit_identical": identical,
                "param_checksums_f64_sum_and_amax": sums[:4],
                "step_ms": [r["ms"] for r in rec], "one_card_step_ms": [r["ms"] for r in rec1],
                "step_ms_median": med2, "one_card_step_ms_median": med1,
                "launches_per_step": {k: per_step[k] for k in routing}}
        log(json.dumps({"dist_train_step": info}))
        log(f"(aa) {what} on a (1, 1) mesh (one-rank NCCL): {LM_ARCH} at "
            f"{cfg.num_layers} layers, {DIST_STEPS} steps, losses within {loss_err:.2e} "
            f"relative of one card's, parameters within {leaf_err:.2e} (bit-identical: "
            f"{identical}); step median {med2:.3f} ms against one card's {med1:.3f} ms; "
            f"{2 * cfg.num_layers} launches of each routing kernel a step ({card})")

    # the same steps on a (1, 1) mesh of a one-rank NCCL group
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device_type="cuda")
        rules = SH.default_rules()
        ops.reset_launch_counts()
        p2, s2, psh, rec2 = run(mesh, rules)
        held(p2, rec2, psh, seq_shard=False)

        # elastic: the state onto the mesh again and back to plain tensors
        before = [SH.local(t) for t in tensors(p2)] + [SH.local(t) for t in tensors(s2.mu)]
        p3, s3 = elastic.reshard_state(cfg, p2, s2, mesh)
        p4, s4 = elastic.reshard_state(cfg, p3, s3, None)
        after = tensors(p4) + tensors(s4.mu)
        check(not any(SH.is_dtensor(t) for t in after), "reshard: a leaf is still a DTensor")
        check(all(torch.equal(a, b) for a, b in zip(before, after)) and
              int(s4.step) == DIST_STEPS, "reshard: the round trip changed the state")
        log(f"(aa) reshard_state onto the (1, 1) mesh and back to plain tensors: "
            f"{len(after)} leaves bit-equal, step {int(s4.step)} ({card})")
        del p2, s2, p3, s3, before, after
        p_plain = p4
        del p4, s4
        free()

        # the int8 EF all-reduce on one loss's float32 gradients
        ps = [t.detach().requires_grad_() for t in tensors(p_plain)]
        it = iter(ps)
        tree = map_leaves(lambda _: next(it), p_plain, is_leaf=torch.is_tensor)
        loss, _m = LM.loss_fn(cfg, tree, data(0), remat=True)
        grads = list(torch.autograd.grad(loss, ps))
        del p_plain, ps, tree, loss, _m
        free()
        ef = COL.init_ef_state(grads)
        n_params = sum(g.numel() for g in grads)
        ms = cuda_ms(torch, lambda: COL.compressed_psum_dp(grads, ef, mesh, axis="data"),
                     reps=5, warmup=1)
        # each gradient and residual read once, the mean and the new residual written
        bound = 16 * n_params / HBM_BYTES_PER_S * 1e3
        worst, equal = 0.0, True
        for g, e in zip(grads, ef.error):
            got, gef = COL.compressed_psum_dp([g], COL.EFState([e]), mesh, axis="data")
            want, wef = COL.ef_compress_decompress([g], COL.EFState([e]))
            equal = equal and torch.equal(got[0], want[0]) and torch.equal(gef.error[0],
                                                                           wef.error[0])
            step_ = float(g.abs().max()) / 127
            worst = max(worst, float((got[0] - g).abs().max()) / max(step_, 1e-30))
            del got, gef, want, wef
        check(equal, "compressed all-reduce: differs from ef_compress_decompress")
        check(worst <= 1.0, f"compressed all-reduce: a leaf is {worst} int8 steps off its input")
        log(json.dumps({"dist_compressed_psum": {
            "card": card, "params": n_params, "leaves": len(grads), "ms": ms,
            "bound_ms": bound, "bound_by": "bytes", "bit_equal_to_ef": equal,
            "max_err_in_int8_steps": worst}}))
        log(f"(aa) compressed_psum_dp over the one-rank group on {n_params} float32 "
            f"gradients: bit-equal to ef_compress_decompress, within {worst:.3f} int8 steps; "
            f"{ms:.3f} ms a call against a {bound:.3f} ms bound ({card})")
        del grads, ef
        free()

        # the sharded steps again under the rules of the JAX package's train
        # and prefill cells; on one rank they split nothing, so this repeats
        # the first run through `default_rules(seq_shard=True)`
        ops.reset_launch_counts()
        p5, _s5, psh5, rec5 = run(mesh, SH.default_rules(seq_shard=True))
        held(p5, rec5, psh5, seq_shard=True)
        del p5, _s5, final1
        free()
    finally:
        dist.destroy_process_group()

    for arch, shape, t0, proc in dry:
        try:
            out, _ = proc.communicate(
                timeout=max(10.0, DRYRUN_TIMEOUT_S - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
            fail(f"dry run {arch} {shape}: no end within {DRYRUN_TIMEOUT_S} s: {out[-3000:]}")
        secs = time.perf_counter() - t0
        recs = list(out_dir.glob(f"{arch}__{shape}__single.json"))
        check(proc.returncode == 0 and len(recs) == 1,
              f"dry run {arch} {shape}: exit {proc.returncode}: {out[-3000:]}")
        rec = json.loads(recs[0].read_text())
        ncoll = sum(rec.get("collectives", {}).get("counts", {}).values())
        check(rec["status"] == "ok" and ncoll > 0,
              f"dry run {arch} {shape}: {rec['status']} {rec.get('error', '')} "
              f"{rec.get('traceback', '')[-1500:]}")
        mem = rec["memory"]
        log(json.dumps({"dryrun": {"card": card, "arch": arch, "shape": shape,
                                   "status": rec["status"], "seq_shard": rec["seq_shard"],
                                   "mesh": rec["mesh"], "chips": rec["chips"],
                                   "wall_s": secs, "trace_s": rec["trace_s"], "memory": mem,
                                   "card_total_memory": torch.cuda.get_device_properties(
                                       0).total_memory,
                                   "collectives": rec["collectives"],
                                   "flops_per_device": rec["cost_analysis"]["flops_per_device"],
                                   "roofline": rec["roofline"]}}))
        log(f"(aa) dry run {arch} {shape} on {rec['mesh']} ({rec['chips']} ranks of a fake "
            f"group): ok, {ncoll} collectives, {mem['live_bytes_per_device'] / 1e9:.3f} GB live "
            f"per rank against the card's "
            f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.3f} GB, dominant "
            f"{rec['roofline']['dominant']}, {secs:.1f} s ({card})")
    log(f"(aa) {time.perf_counter() - t_phase:.1f} s")


def main() -> None:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs an NVIDIA GPU")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from the repository")
    sys.path.insert(0, str(ROOT / "src"))
    import dataclasses

    from repro_torch.core import (choose_groupby_strategy, group_aggregate,
                                  groupby_partition_checked, groupjoin_checked, join,
                                  join_sequence, phj_groupjoin, phj_join_checked, phj_overflowed,
                                  table_from_numpy, table_to_numpy)
    from repro_torch.core import groupby as gb
    from repro_torch.core import groupjoin as gj
    from repro_torch.core import hash_join as hj
    from repro_torch.core import primitives as prim
    from repro_torch.core.table import Table
    from repro_torch.data.relgen import _payload, generate_star, generate_tpc
    from repro_torch.kernels import _build, common, ops, ref
    from repro_torch.kernels import digits as kdigits
    from repro_torch.kernels import gather as kgather
    from repro_torch.kernels import hash_probe as kprobe
    from repro_torch.kernels import histogram as khist
    from repro_torch.kernels import merge_join as kmj
    from repro_torch.kernels import radix_partition as krp
    from repro_torch.kernels import segsum as kseg
    from repro_torch.core.planner import PrimitiveProfile
    from repro_torch.analysis import dispatch_audit
    from repro_torch.data.relgen import JoinWorkload, generate
    from repro_torch.engine import (Catalog, calibrated_profile, detect_budget_bytes, optimize,
                                    run_morsels, scan)
    from repro_torch.engine import executor as EX
    from repro_torch.engine import physical as PH
    from repro_torch.obs import CalibrationStore, Span, backend_fingerprint, metrics, residuals_of
    from repro_torch.resilience import escalation, faults
    from repro_torch.serve import QueryRequest, QueryServer, bucket_rows
    from repro_torch.serve.chaos import run_chaos

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    card = smi[0] if smi else "nvidia-smi printed nothing"
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    clock = PhaseClock()
    # -- 1. build -----------------------------------------------------------
    t0 = time.perf_counter()
    _build.build_all()
    log(f"build: {time.perf_counter() - t0:.3f} s for {len(common.KERNELS)} kernels "
        f"({' '.join(_build.NVCC_FLAGS)}) into {_build.BUILD_DIR.relative_to(ROOT)}")
    clock.done("1 build")

    # -- 2. data ------------------------------------------------------------
    t0 = time.perf_counter()
    Rn, Sn, mode = generate_tpc("J2", scale=1, payload_bytes=8, seed=0)
    check(mode == "pk_fk", f"J2 mode {mode}")
    n_r, n_s = Rn["k"].shape[0], Sn["k"].shape[0]
    R, S = table_from_numpy(Rn), table_from_numpy(Sn)
    dev = R.device
    torch.cuda.synchronize()
    log(f"data: R {n_r} rows {R!r}, S {n_s} rows {S!r}; "
        f"{(R.nbytes() + S.nbytes()) / 1e9:.3f} GB on the card, "
        f"{time.perf_counter() - t0:.3f} s")
    over, p_bits = phj_overflowed(R)
    check(not over, "a build partition overflows its 256-row block")
    log(f"phj_overflowed: False at {p_bits} partition bits")
    clock.done("2 data")

    def query(phases=None, **arms):
        T, cnt = join(R, S, algorithm="phj", pattern="gftr", phases=phases, **arms)
        if phases is not None:
            torch.cuda.synchronize()
            t = time.perf_counter()
        G, gcnt = group_aggregate(T, key="k", aggs=AGGS, num_groups=N_GROUPS,
                                  strategy="partition")
        if phases is not None:
            torch.cuda.synchronize()
            phases["group-by"] = time.perf_counter() - t
        return T, cnt, G, gcnt

    # -- 3. the main path ---------------------------------------------------
    (T, cnt, G, gcnt), cold_s = timed(torch, query)
    del T, G
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    phases = {}
    (T, cnt, G, gcnt), warm_s = timed(torch, lambda: query(phases))
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    log(json.dumps({"j2_query": {"cold_s": cold_s, "warm_s": warm_s, "phases_s": phases,
                                 "peak_device_bytes": peak, "join_rows": int(cnt),
                                 "groups": int(gcnt), "launches": launches}}))
    for name, want in EXPECTED_LAUNCHES.items():
        check(launches[name] > 0 or want == 0, f"kernel {name} was not launched on the main "
              "path")
        check(launches[name] == want, f"kernel {name}: {launches[name]} launches, "
              f"expected {want}")
    check(int(cnt) == n_s, f"join rows {int(cnt)} != {n_s} (match ratio 1.0)")

    # -- where the time of a warm query goes --------------------------------
    def profile_run(fn, groups=None):
        """One profiled warm run: device time by kernel and the idle share;
        with `groups` ({group: name substrings}), every kernel's device time
        summed by the first group whose substring its name holds."""
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, wall = timed(torch, fn)
        # names are cut for the tables, and many kernels share a cut name:
        # their times add up under it
        kernel_us, host_us = {}, {}
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
                kernel_us[e.key[:90]] = kernel_us.get(e.key[:90], 0) + e.self_device_time_total
            elif e.device_type == DeviceType.CPU:
                host_us[e.key[:60]] = host_us.get(e.key[:60], 0) + e.self_cpu_time_total
        busy_s = sum(kernel_us.values()) / 1e6

        def top(us):
            return {k: v / 1e3 for k, v in sorted(us.items(), key=lambda kv: -kv[1])[:15]}

        out = {"profiled_wall_s": wall, "device_busy_s": busy_s if busy_s else "not measured",
               "device_idle_share": 1 - busy_s / wall if busy_s else "not measured",
               "top_kernels_ms": top(kernel_us), "top_host_ops_self_ms": top(host_us)}
        if groups:
            by_group = dict.fromkeys(list(groups) + ["other"], 0.0)
            for name, us in kernel_us.items():
                g = next((g for g, keys in groups.items() if any(k in name for k in keys)),
                         "other")
                by_group[g] += us / 1e3
            out["device_ms_by_group"] = by_group
        return out

    walls = sorted(timed(torch, query)[1] for _ in range(3))
    log(json.dumps({"j2_profile": {"query_s_median_of_3": walls[1], **profile_run(query)}}))
    clock.done("3 main path")

    # -- 4a. every arm forced to plain PyTorch, on the card -----------------
    os.environ[ops.PARTITION_PLAN_ENV] = "torch"
    try:
        ops.reset_launch_counts()
        (T0, cnt0, G0, gcnt0), torch_s = timed(
            torch, lambda: query(probe_impl="torch", gather_impl="torch"))
        check(sum(ops.launch_counts().values()) == 0, "the plain arms launched a kernel")
    finally:
        del os.environ[ops.PARTITION_PLAN_ENV]
    check(int(cnt0) == int(cnt) and int(gcnt0) == int(gcnt), "valid counts differ")
    for a, b, what in ((T, T0, "join"), (G, G0, "group-by")):
        check(a.column_names == b.column_names, f"{what} columns differ")
        for name in a.column_names:
            check(torch.equal(a[name], b[name]), f"{what} column {name} differs from the "
                  "all-torch run")
    log(f"(a) all-torch arms on the card: join and group-by equal row for row "
        f"({torch_s:.3f} s)")
    del T0, G0, a, b

    # -- 4b. numpy reference ------------------------------------------------
    t0 = time.perf_counter()
    r1_of_key = np.full(n_r, np.iinfo(np.int64).min, np.int64)
    r1_of_key[Rn["k"]] = Rn["r1"]
    rows_ref, s1_ref, _ = per_key(Sn["k"], n_r, Sn["s1"], Sn["s1"])
    present = rows_ref > 0
    r1_ref = np.where(present, r1_of_key, np.iinfo(np.int64).min)
    payload_of_key = {}
    for c in ("r2", "r3"):
        payload_of_key[c] = np.empty(n_r, Rn[c].dtype)
        payload_of_key[c][Rn["k"]] = Rn[c]

    def check_join(J, count, what):
        """A join of J2 against the numpy reference: its valid rows per key,
        their sums of s1 and maxima of r1, and r2, r3 of each row's key."""
        Th = table_to_numpy(J.head(int(count)))
        check(Th["k"].min() >= 0 and Th["k"].max() < n_r, f"{what}: join keys out of range")
        rows_t, s1_t, r1_t = per_key(Th["k"], n_r, Th["s1"], Th["r1"])
        check(np.array_equal(rows_t, rows_ref), f"{what}: rows per key differ from numpy")
        check(np.array_equal(s1_t, s1_ref), f"{what}: sum of s1 per key differs from numpy")
        check(np.array_equal(r1_t, r1_ref), f"{what}: max of r1 per key differs from numpy")
        for c, want in payload_of_key.items():
            check(np.array_equal(Th[c], want[Th["k"]]), f"{what}: {c} is not its key's payload")

    check_join(T, cnt, "join")
    Gh = table_to_numpy(G.head(int(gcnt)))
    check(int(gcnt) == int(present.sum()), f"groups {int(gcnt)} != {int(present.sum())}")
    order = np.argsort(Gh["k"], kind="stable")
    gk = Gh["k"][order]
    check(np.array_equal(gk, np.flatnonzero(present)), "group-by keys differ from numpy")
    check(np.array_equal(Gh["r2_count"][order], rows_ref[gk]), "group-by: counts differ")
    check(np.array_equal(Gh["s1_sum"][order], s1_ref[gk]), "group-by: sums of s1 differ")
    check(np.array_equal(Gh["r1_max"][order], r1_ref[gk]), "group-by: max of r1 differs")
    check(Gh["s1_sum"].dtype == np.int64 and Gh["r1_max"].dtype == np.int64,
          "aggregates lost the int64 payload type")
    del Gh
    log(f"(b) numpy int64 reference: join and group-by agree per key "
        f"({time.perf_counter() - t0:.3f} s)")
    log(f"(c) launches on the main path: {json.dumps(launches)}")
    clock.done("4 checks")

    def run_path(name, fn, expected):
        """One more path: cold run, then counters and peak reset, a warm run
        read at once, two more warm runs; returns (out, times, launches)."""
        cold = timed(torch, fn)[1]
        torch.cuda.synchronize()
        live = torch.cuda.memory_allocated()
        ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        out, warm = timed(torch, fn)
        got = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        walls = sorted([warm] + [timed(torch, fn)[1] for _ in range(2)])
        info = {"cold_s": cold, "warm_s": warm, "warm_s_median_of_3": walls[1],
                "peak_device_bytes": peak, "peak_above_live_bytes": peak - live,
                "launches": got}
        log(json.dumps({name: info}))
        for k, want in expected.items():
            check(got[k] == want, f"{name}: kernel {k} launched {got[k]} times, expected {want}")
        return out, info

    # -- 5d. the fused group-join: Q18's group by l_orderkey ----------------
    def groupjoin(**kw):
        return phj_groupjoin(R, S, key="k", group_key="k", aggs=GJ_AGGS, num_groups=N_GROUPS,
                             **kw)

    (Gj, gjc), gj_info = run_path("j2_groupjoin", groupjoin, GJ_LAUNCHES)
    log(json.dumps({"j2_groupjoin_profile": profile_run(groupjoin)}))
    log(f"fused group-join warm {gj_info['warm_s_median_of_3']:.6f} s against join -> "
        f"group-by warm {walls[1]:.6f} s (medians of 3)")
    Gj2, gjc2 = groupjoin()
    check(int(gjc2) == int(gjc) and all(torch.equal(Gj[c], Gj2[c]) for c in Gj.column_names),
          "group-join: a second run is not bit-identical")
    del Gj2
    m = int(gjc)
    check(m == int(present.sum()), f"group-join: {m} groups != {int(present.sum())}")
    Gjh = table_to_numpy(Gj.head(m))
    keys_ref = np.flatnonzero(present)
    check(np.array_equal(Gjh["k"], keys_ref), "group-join: keys differ from numpy")
    rows_k = rows_ref[keys_ref]
    check(np.array_equal(Gjh["r2_count"], rows_k), "group-join: counts differ from numpy")
    check(Gjh["s1_sum"].dtype == np.float32 and Gjh["r2_count"].dtype == np.int32,
          "group-join: the fused arm gives float32 sums and int32 counts")
    gj_err = {"s1_sum": check_f32_sums(Gjh["s1_sum"], s1_ref[keys_ref], rows_k, "group-join s1"),
              "r1_sum": check_f32_sums(Gjh["r1_sum"], r1_of_key[keys_ref] * rows_k, rows_k,
                                       "group-join r1")}
    (Gt, gtc), gt_s = timed(torch, lambda: groupjoin(probe_impl="torch", agg_strategy="sort"))
    check(int(gtc) == m and torch.equal(Gt["k"], Gj["k"])
          and torch.equal(Gt["r2_count"], Gj["r2_count"]),
          "group-join: keys or counts differ from the torch arm with the sort strategy")
    for c in ("s1_sum", "r1_sum"):
        check(Gt[c].dtype == torch.int64, f"torch arm: {c} lost the int64 payload type")
        check_f32_sums(Gjh[c], Gt[c][:m].cpu().numpy(), rows_k, f"group-join {c} vs torch arm")
    log(f"(d) fused group-join: {m} groups equal to numpy (keys, counts; float32 sums within "
        f"2 * rows * 2^-24 relative, max relative error {json.dumps(gj_err)}), to the torch "
        f"arm with the sort strategy ({gt_s:.3f} s), and bit-identical on a second run")
    del Gt, Gjh  # Gj stays for (m)
    clock.done("5d group-join")

    # -- 5e. the sort group-bys over the join output ------------------------
    (Gs, gsc), _ = run_path("j2_groupby_sort", lambda: group_aggregate(
        T, key="k", aggs=AGGS, num_groups=N_GROUPS, strategy="sort"),
        dict.fromkeys(ops.launch_counts(), 0))
    Gsh = table_to_numpy(Gs.head(int(gsc)))
    check(int(gsc) == m and np.array_equal(Gsh["k"], keys_ref), "sort: keys differ from numpy")
    check(np.array_equal(Gsh["r2_count"], rows_k), "sort: counts differ from numpy")
    check(np.array_equal(Gsh["s1_sum"], s1_ref[keys_ref]), "sort: sums of s1 differ")
    check(np.array_equal(Gsh["r1_max"], r1_ref[keys_ref]), "sort: max of r1 differs")
    check(Gsh["s1_sum"].dtype == np.int64, "sort: the sum lost the int64 payload type")
    del Gs, Gsh
    (Gp, gpc), sp_info = run_path("j2_groupby_sort_pallas", lambda: group_aggregate(
        T, key="k", aggs=SP_AGGS, num_groups=N_GROUPS, strategy="sort_pallas"), SP_LAUNCHES)
    # the path's device time by kernel, and one combine alone (the s1 pass:
    # per-tile partials and their merge into groups) on the same sorted rows
    psk, pperm = prim.plan_sort_permutation(T["k"])
    psv = T["s1"][pperm].to(torch.float32)
    del pperm
    log(json.dumps({"j2_groupby_sort_pallas_profile": {
        "path": profile_run(lambda: group_aggregate(T, key="k", aggs=SP_AGGS,
                                                    num_groups=N_GROUPS,
                                                    strategy="sort_pallas")),
        "one_combine": profile_run(lambda: ops.groupby_sorted_sum(psk, psv, N_GROUPS))}}))
    del psk, psv
    Gph = table_to_numpy(Gp.head(int(gpc)))
    check(int(gpc) == m and np.array_equal(Gph["k"], keys_ref),
          "sort_pallas: keys differ from numpy")
    check(np.array_equal(Gph["r2_count"], rows_k), "sort_pallas: counts differ from numpy")
    sp_err = check_f32_sums(Gph["s1_sum"], s1_ref[keys_ref], rows_k, "sort_pallas s1")
    log(f"(e) sort group-by equal to numpy (int64); sort_pallas keys and counts equal, "
        f"float32 sums within 2 * rows * 2^-24 relative (max {sp_err})")
    del Gp, Gph
    clock.done("5e sort group-bys")

    # -- 5f. the sort-merge join: SMJ-OM and SMJ-UM -------------------------
    def smj(pattern="gftr", **kw):
        return join(R, S, algorithm="smj", pattern=pattern, **kw)

    (Tm, cm), smj_info = run_path("j2_smj_om", smj, SMJ_LAUNCHES)
    (Tu, cu), smj_um_info = run_path("j2_smj_um", lambda: smj("gfur"), SMJ_LAUNCHES)
    ops.reset_launch_counts()
    (Tt, ct), smj_torch_s = timed(torch, lambda: smj(find_impl="torch"))
    check(sum(ops.launch_counts().values()) == 0, "find_impl='torch' launched a kernel")
    check(int(cm) == int(cu) == int(ct) == n_s, f"SMJ rows {int(cm)}, {int(cu)}, {int(ct)} != "
          f"{n_s} (match ratio 1.0)")
    for other, what in ((Tu, "SMJ-UM"), (Tt, "SMJ-OM with the plain lower bound")):
        check(other.column_names == Tm.column_names, f"{what}: columns differ")
        for name in Tm.column_names:
            check(torch.equal(Tm[name], other[name]), f"SMJ-OM column {name} differs from {what}")
    del Tu, Tt, other
    check_join(Tm, cm, "SMJ-OM")  # Tm stays for (m)
    smj_phases = {"om": {}, "um": {}}
    smj(phases=smj_phases["om"])
    smj("gfur", phases=smj_phases["um"])
    log(json.dumps({"j2_smj_phases_s": smj_phases}))
    log(json.dumps({"j2_smj_om_profile": profile_run(smj)}))
    log(f"(f) SMJ-OM and SMJ-UM: {n_s} rows, equal to each other and to the plain lower-bound "
        f"arm ({smj_torch_s:.3f} s) row for row, and to numpy per key")
    clock.done("5f sort-merge join")

    # -- 5g. the radix sort plan against the stable sort --------------------
    for side, keys in (("S", S["k"]), ("R", R["k"])):
        (rk, rperm), r_info = run_path(f"j2_radix_sort_plan_{side}",
                                       lambda k=keys: krp.sort_plan_radix(k), RADIX_LAUNCHES)
        (tk_, tperm), t_info = run_path(f"j2_stable_sort_plan_{side}",
                                        lambda k=keys: prim.plan_sort_permutation(k), NO_LAUNCHES)
        check(torch.equal(rk, tk_) and torch.equal(rperm, tperm),
              f"radix sort plan of {side}'s keys differs from the stable sort")
        log(f"(g) radix sort plan of {side}'s {keys.shape[0]} keys equal to the stable sort: "
            f"{r_info['warm_s_median_of_3']:.6f} s against {t_info['warm_s_median_of_3']:.6f} s")
        del rk, rperm, tk_, tperm, keys
    log(json.dumps({"j2_radix_sort_plan_S_profile": profile_run(
        lambda: krp.sort_plan_radix(S["k"]))}))
    clock.done("5g radix sort plan")

    # -- 5h. the non-partitioned hash join, beside PHJ-OM and SMJ-OM --------
    phj_launches = dict(NO_LAUNCHES, block_histograms=6, partition_ranks=6, pass_scatter=6,
                        hash_probe=1, clustered_gather=4)
    (_, _), phj_info = run_path("j2_phj_om", lambda: join(R, S, algorithm="phj"), phj_launches)
    # PHJ-OM's phases, warm, each edge a device synchronisation
    phj_phases = {}
    join(R, S, algorithm="phj", phases=phj_phases)
    log(json.dumps({"j2_phj_om_phases_s": phj_phases,
                    "warm_s_median_of_3": phj_info["warm_s_median_of_3"]}))
    nphj_stats = {}
    (Tn, cn), nphj_info = run_path(
        "j2_nphj", lambda: join(R, S, algorithm="nphj", stats=nphj_stats), NO_LAUNCHES)
    check(int(cn) == n_s, f"NPHJ rows {int(cn)} != {n_s}")
    check_join(Tn, cn, "NPHJ")
    del Tn
    log(json.dumps({"j2_nphj_profile": profile_run(lambda: join(R, S, algorithm="nphj"))}))
    failed = int(nphj_stats["failed"])  # of the last timed run
    check(failed == 0, f"NPHJ: {failed} build keys found no slot")
    log(f"(h) NPHJ equal to numpy per key, 0 failed insertions into "
        f"{nphj_stats['table_size']} slots; joins "
        f"warm (medians of 3): PHJ-OM {phj_info['warm_s_median_of_3']:.6f} s (probe phase "
        f"{phj_phases['probe']:.6f} s), SMJ-OM "
        f"{smj_info['warm_s_median_of_3']:.6f} s, SMJ-UM "
        f"{smj_um_info['warm_s_median_of_3']:.6f} s, NPHJ "
        f"{nphj_info['warm_s_median_of_3']:.6f} s")
    clock.done("5h non-partitioned hash join")

    # -- 5m. the checked drivers on J2 ---------------------------------------
    def resilience_counters():
        return {k: v for k, v in metrics.snapshot().items()
                if k.startswith(("resilience.", "core."))}

    def under(spec, fn):
        """fn() with the fault spec in force (none for an empty spec)."""
        def run():
            with faults.inject(spec):
                return fn()
        return run

    def same_rows(a, b, what):
        check(a.column_names == b.column_names, f"{what}: columns differ")
        for name in a.column_names:
            check(torch.equal(a[name], b[name]), f"{what}: column {name} differs")

    def by_key(G, count):
        """A group-by's valid rows sorted by key, column by column."""
        c = int(count)
        order = torch.sort(G["k"][:c]).indices
        return Table({n: G[n][:c][order] for n in G.column_names})

    base_counters = resilience_counters()
    ((Tc, cc), rep), _ = run_path("j2_phj_join_checked", lambda: phj_join_checked(
        R, S, with_report=True), phj_launches)
    check(len(rep.attempts) == 1 and rep.converged, f"phj_join_checked: {rep.summary()}")
    check(int(cc) == int(cnt), "phj_join_checked: valid count differs from the join's")
    same_rows(Tc, T, "phj_join_checked against join(algorithm='phj')")
    log(f"(m) {rep.summary()}: equal row for row to join(R, S, algorithm='phj')")
    ((Tc, cc), rep), _ = run_path("j2_phj_join_checked_overflow_at_0", under(
        "overflow:phj@0", lambda: phj_join_checked(R, S, with_report=True)), phj_launches)
    check(len(rep.attempts) == 2 and rep.final_knobs["partition_bits"] == p_bits + 1,
          f"phj_join_checked under overflow:phj@0: {rep.summary()} {rep.final_knobs}")
    check_join(Tc, cc, "phj_join_checked at 19 bits")
    log(f"(m) overflow:phj@0: {rep.summary()}, {rep.final_knobs['partition_bits']} bits; "
        f"equal to numpy per key")
    ((Tc, cc), rep), _ = run_path("j2_phj_join_checked_overflow_at_0_1_2", under(
        "overflow:phj@0+1+2", lambda: phj_join_checked(R, S, with_report=True)), SMJ_LAUNCHES)
    bits = [a.knobs["partition_bits"] for a in rep.attempts]
    steps = [a.step for a in rep.attempts]
    check(bits == [p_bits, p_bits + 1, p_bits + 2, p_bits + 2] and p_bits + 2 == 20
          and steps == ["partition_bits", "partition_bits", "strategy:smj", ""]
          and rep.final_knobs["algorithm"] == "smj",
          f"phj_join_checked under overflow:phj@0+1+2: {rep.summary()} bits {bits}")
    check(int(cc) == int(cm), "phj_join_checked's SMJ rung: valid count differs from SMJ-OM's")
    same_rows(Tc, Tm, "phj_join_checked's SMJ rung against SMJ-OM (f)")
    log(f"(m) overflow:phj@0+1+2: {rep.summary()}, bits {bits}; attempt 3 on the "
        f"strategy:smj rung, equal row for row to (f)'s SMJ-OM with one lower_bound launch")
    del Tc, Tm

    req_cap = -(-m // 64) * 64
    # the digits also feed each attempt's overflow check
    ((Gc, gcc), rep), _ = run_path("j2_groupjoin_checked", lambda: groupjoin_checked(
        R, S, key="k", group_key="k", aggs=GJ_AGGS, num_groups=N_GROUPS // 4,
        with_report=True), {k: v for k, v in GJ_LAUNCHES.items() if k != "partition_digits"})
    check(rep.final_knobs["num_groups"] == req_cap and rep.steps_applied == {"num_groups": 1},
          f"groupjoin_checked: {rep.summary()} {rep.final_knobs}, expected capacity {req_cap}")
    check(int(gcc) == m and Gc.num_rows == req_cap, "groupjoin_checked: groups differ")
    for name in Gj.column_names:
        check(torch.equal(Gc[name][:m], Gj[name][:m]),
              f"groupjoin_checked: column {name} differs from (d)'s group-join")
    log(f"(m) groupjoin_checked from capacity {N_GROUPS // 4}: {rep.summary()}, capacity "
        f"{req_cap} ({m} groups rounded up to 64); its {m} rows equal (d)'s")
    del Gc, Gj

    G_sorted = by_key(G, gcnt)
    for spec in ("", "overflow:groupby_partition@0"):
        ((Gq, gqc), rep), _ = run_path(
            f"j2_groupby_partition_checked{'_' + spec.replace(':', '_').replace('@', '_at_') if spec else ''}",
            under(spec, lambda: groupby_partition_checked(
                T, key="k", aggs=AGGS, num_groups=N_GROUPS, with_report=True)),
            dict(NO_LAUNCHES, block_histograms=2 if not spec else 3,
                 partition_ranks=2 if not spec else 3, pass_scatter=2 if not spec else 3))
        check(int(gqc) == int(gcnt), f"groupby_partition_checked {spec}: group count differs")
        if not spec:
            check(len(rep.attempts) == 1, f"groupby_partition_checked: {rep.summary()}")
            same_rows(Gq, G, "groupby_partition_checked against (b)'s group-by")
        else:
            check(len(rep.attempts) == 2 and rep.steps_applied == {"partition_bits": 1},
                  f"groupby_partition_checked {spec}: {rep.summary()}")
            same_rows(by_key(Gq, gqc), G_sorted, f"groupby_partition_checked {spec}, per key")
        log(f"(m) groupby_partition_checked {spec or 'natural'}: {rep.summary()}, "
            f"{rep.final_knobs}; equal {'row for row' if not spec else 'per key'} to (b)'s")
    del Gq, G_sorted
    moved = {k: v - base_counters.get(k, 0) for k, v in resilience_counters().items()}
    log(json.dumps({"j2_checked_counters": resilience_counters(), "moved_in_5m": moved}))
    clock.done("5m checked drivers")

    # -- 5n. the scatter group-by over J2's join output -----------------------
    (Gx, gxc), _ = run_path("j2_groupby_scatter", lambda: group_aggregate(
        T, key="k", aggs=AGGS, num_groups=N_GROUPS, strategy="scatter"), NO_LAUNCHES)
    Gxh = table_to_numpy(Gx.head(int(gxc)))
    check(int(gxc) == m and np.array_equal(Gxh["k"], keys_ref), "scatter: keys differ from numpy")
    check(np.array_equal(Gxh["r2_count"], rows_k), "scatter: counts differ from numpy")
    check(np.array_equal(Gxh["s1_sum"], s1_ref[keys_ref]), "scatter: sums of s1 differ")
    check(np.array_equal(Gxh["r1_max"], r1_ref[keys_ref]), "scatter: max of r1 differs")
    check(Gxh["s1_sum"].dtype == np.int64, "scatter: the sum lost the int64 payload type")
    del Gx, Gxh
    j2_pick = choose_groupby_strategy(n_s, m, key_min=0, key_max=n_r - 1)
    log(f"(n) scatter group-by over the join output: {m} groups equal to numpy (int64); "
        f"choose_groupby_strategy picks {json.dumps(j2_pick)}")
    clock.done("5n scatter group-by")
    # -- the engine's plans: which kernels each node may and must launch ------
    def plan_nodes(node):
        yield node
        for c in node.children():
            yield from plan_nodes(c)

    def check_plan_launches(name, plan, got, checked=False, reports=()):
        """Each node's kernels: a PHJ join launches its digits, the plan passes, one probe
        per pk_fk join and, for GFTR, gathers; a checked run's PHJ join may
        take the ladder's SMJ rung, and each report that ends there trades
        a probe for a lower bound; an SMJ pk_fk join one lower bound; a
        group-join the plan passes and the probe (the engine's accumulator
        arm, never probe_agg); a partition group-by its plan passes, a
        sort_pallas one the segmented sums. A kernel no node runs must not
        launch."""
        need, may = {}, set()

        def add(kernels, required):
            may.update(kernels)
            for k in required:
                need[k] = need.get(k, 0) + 1

        plan_passes = ("block_histograms", "partition_ranks", "pass_scatter")
        # a PHJ node's digits, then its plan passes
        phj_plans = ("partition_digits",) + plan_passes
        for node in plan_nodes(plan.root):
            if isinstance(node, PH.PJoin) and node.algorithm == "phj":
                add(phj_plans + ("hash_probe", "clustered_gather")
                    + (("lower_bound",) if checked else ()),
                    phj_plans + (("hash_probe",) if node.mode == "pk_fk" else ())
                    + (("clustered_gather",) if node.pattern == "gftr" else ()))
            elif isinstance(node, PH.PJoin) and node.algorithm == "smj":
                add(("lower_bound",), ("lower_bound",) if node.mode == "pk_fk" else ())
            elif isinstance(node, PH.PGroupJoin):
                add(phj_plans + ("hash_probe",), phj_plans + ("hash_probe",))
            if isinstance(node, (PH.PGroupBy, PH.PGroupJoin)):
                strategy = getattr(node, "strategy", None) or node.agg_strategy
                if strategy == "partition":
                    add(plan_passes, plan_passes)
                elif strategy == "sort_pallas":
                    add(("segsum_partials",), ("segsum_partials",))
        smj_rungs = sum(r.operator == "phj" and r.final_knobs.get("algorithm") == "smj"
                        for r in reports)
        if smj_rungs:
            need["lower_bound"] = need.get("lower_bound", 0) + smj_rungs
            need["hash_probe"] = max(need.get("hash_probe", 0) - smj_rungs, 0)
        for k, v in got.items():
            if k in need:
                check(v >= need[k], f"{name}: kernel {k} launched {v} times; the plan's nodes "
                      f"need at least {need[k]}")
            elif k not in may:
                check(v == 0, f"{name}: kernel {k} launched {v} times; no node of the plan "
                      "runs it")

    def plan_shape(node):
        """The optimizer's choices in a plan: node kinds, join order and
        orientation, algorithms, patterns and strategies."""
        own = {PH.PScan: lambda n: (n.table,),
               PH.PJoin: lambda n: (n.algorithm, n.pattern, n.mode, n.build_key),
               PH.PGroupBy: lambda n: (n.strategy, n.agg_kw),
               PH.PGroupJoin: lambda n: (n.agg_strategy, n.agg_kw)}.get(type(node))
        return (type(node).__name__, own(node) if own else (),
                tuple(plan_shape(c) for c in node.children()))

    def direct_run(plan, tables):
        """The plan's operators called directly, for a group-by over a join of
        two base tables or a group-join of two; None for other plans."""
        root = plan.root
        j = root.child if isinstance(root, PH.PGroupBy) else root
        if not (isinstance(j, (PH.PJoin, PH.PGroupJoin)) and isinstance(j.build, PH.PScan)
                and isinstance(j.probe, PH.PScan) and j.build_key == j.probe_key):
            return None
        bt, pt = tables[j.build.table], tables[j.probe.table]
        cols = tuple(c for c, _ in root.aggs)
        if isinstance(root, PH.PGroupJoin):
            def run():
                return phj_groupjoin(
                    bt.select(tuple(dict.fromkeys((j.build_key,) + tuple(c for c in cols
                                                                        if c in bt)))),
                    pt.select(tuple(dict.fromkeys((j.probe_key, root.probe_group_key)
                                                  + tuple(c for c in cols if c in pt)))),
                    key=j.probe_key, group_key=root.probe_group_key, aggs=dict(root.aggs),
                    num_groups=root.capacity, agg_strategy=root.agg_strategy,
                    agg_kw=dict(root.agg_kw) or None, fused=False)
            return run

        def run():
            T, _ = join(bt, pt, key=j.probe_key, algorithm=j.algorithm, pattern=j.pattern,
                        out_size=j.capacity, mode=j.mode)
            return group_aggregate(T.select((root.key,) + cols), key=root.key,
                                   aggs=dict(root.aggs), num_groups=root.capacity,
                                   strategy=root.strategy, **dict(root.agg_kw))
        return run

    # -- 5o. TPC-H Q18 through the engine ------------------------------------
    def degradations():
        return metrics.counter("resilience.plan_degradations").value

    def engine_path(name, plan, fn=None, runs=3, checked=False):
        """A plan's run (or fn()): cold, then counters, escalation reports and
        degradations read around one warm run, then the median of `runs`
        warm runs; the launches must fit the plan's nodes and nothing may
        degrade."""
        fn = fn or plan.run
        cold = timed(torch, fn)[1]
        deg0 = degradations()
        seq0 = escalation.current_seq()
        ops.reset_launch_counts()
        out, warm = timed(torch, fn)
        got = ops.launch_counts()
        reports = escalation.recent_reports(seq0)
        walls = sorted([warm] + [timed(torch, fn)[1] for _ in range(runs - 1)])
        check(degradations() == deg0, f"{name}: the executor degraded the plan "
              f"({escalation.recent_degradations()[-1:]})")
        check_plan_launches(name, plan, got, checked, reports)
        info = {"cold_s": cold, "warm_s": warm, f"warm_s_median_of_{runs}": walls[runs // 2],
                "launches": got}
        log(json.dumps({name: info}))
        return out, info

    def q18_equal(Ge, gce, what):
        """An engine result of Q18 against (b)'s group-by, per key and column,
        and against numpy's per-key rows, sums of s1 and maxima of r1."""
        check(int(gce) == m, f"{what}: {int(gce)} groups != {m}")
        a, b = by_key(Ge, gce), by_key(G, gcnt)
        for name in b.column_names:
            check(torch.equal(a[name], b[name]), f"{what}: column {name} differs from the "
                  "direct operators' group-by (per key)")
        h = table_to_numpy(a)
        check(np.array_equal(h["k"], keys_ref), f"{what}: keys differ from numpy")
        check(np.array_equal(h["r2_count"], rows_k), f"{what}: counts differ from numpy")
        check(np.array_equal(h["s1_sum"], s1_ref[keys_ref]), f"{what}: sums of s1 differ")
        check(np.array_equal(h["r1_max"], r1_ref[keys_ref]), f"{what}: max of r1 differs")
        check(h["s1_sum"].dtype == np.int64, f"{what}: the sum lost the int64 payload type")

    q18 = scan("lineitem").join(scan("orders"), key="k").group_by("k", **AGGS)
    # a calibration store of this run alone, so that the profile at 65,536
    # rows is measured here and not read from what an earlier run stored
    calib_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_calibration_")
    os.environ["REPRO_CALIBRATION_PATH"] = os.path.join(calib_dir.name, "CALIBRATION.json")
    prof16, prof16_s = timed(torch, lambda: calibrated_profile(device=dev))
    prof24 = PrimitiveProfile.measure(n=1 << 24, device=dev)
    log(json.dumps({"calibrated_profile": {"n_65536": dataclasses.asdict(prof16),
                                           "n_65536_measure_s": prof16_s,
                                           "n_16777216": dataclasses.asdict(prof24)}}))
    cat = Catalog({"orders": R, "lineitem": S})
    plan, cold_opt_s = timed(torch, lambda: optimize(q18, cat, measure_profile=True))
    _, warm_opt_s = timed(torch, lambda: optimize(q18, cat, measure_profile=True))
    plan24 = optimize(q18, cat, profile=prof24)
    log(f"(o) Q18 plan (profile at 65,536 rows), the plan the phase runs:\n{plan.explain()}")
    log(f"(o) Q18 plan (profile at 16,777,216 rows):\n{plan24.explain()}")
    log(json.dumps({"q18_optimize": {
        "cold_s": cold_opt_s, "warm_s": warm_opt_s, "stats_sketch_s": cold_opt_s - warm_opt_s,
        "plan_run": plan_shape(plan.root),
        "same_choice_at_both_profiles": plan_shape(plan.root) == plan_shape(plan24.root),
        "budget_bytes": detect_budget_bytes(dev)}}))
    span0 = Span.allocated
    (Ge, gce), q18_info = engine_path("q18_engine", plan)
    q18_equal(Ge, gce, "Q18 engine")
    log(json.dumps({"q18_engine_profile": profile_run(plan.run)}))
    d = direct_run(plan, {"orders": R, "lineitem": S})
    if d is not None:
        _, d_info = engine_path("q18_direct_operators", plan, d)
        log(f"(o) Q18 engine {q18_info['warm_s_median_of_3']:.6f} s against the same operators "
            f"called directly {d_info['warm_s_median_of_3']:.6f} s (medians of 3): overhead "
            f"{q18_info['warm_s_median_of_3'] - d_info['warm_s_median_of_3']:.6f} s")
    (Gk, gck), _ = engine_path("q18_engine_checked", plan, lambda: plan.run(checked=True),
                               checked=True)
    q18_equal(Gk, gck, "Q18 engine, checked")
    del Gk
    for force in (("phj", "gftr"), ("smj", "gftr")):
        fplan = optimize(q18, cat, measure_profile=True, force_join=force)
        log(f"(o) Q18 forced {force}:\n{fplan.explain()}")
        (Gf, gcf), _ = engine_path(f"q18_engine_{force[0]}_{force[1]}", fplan)
        q18_equal(Gf, gcf, f"Q18 engine forced {force}")
        del Gf
    (Gm, gcm), _ = engine_path("q18_engine_4_morsels", plan,
                               lambda: run_morsels(plan, factor=4), runs=1)
    q18_equal(Gm, gcm, "Q18 engine in 4 morsels")
    del Gm, Ge, cat
    log(f"(o) Q18 through the engine: the optimizer's plan, checked, forced PHJ-OM and SMJ-OM and "
        f"4 morsels equal the direct operators and numpy per key; no degradation")
    check(Span.allocated == span0, f"the untraced engine runs allocated "
          f"{Span.allocated - span0} trace spans")
    log(json.dumps({"q18_engine_untraced": {"card": card, "warm_s_median_of_3":
                                            q18_info["warm_s_median_of_3"],
                                            "spans_allocated": Span.allocated - span0}}))
    clock.done("5o Q18 through the engine")

    # -- 5q. a trace of Q18 ---------------------------------------------------
    q18_tabs = {"orders": R, "lineitem": S}
    Gt, gct, tr = plan.run(trace=True, trace_iters=3, trace_warmup=1)
    q18_equal(Gt, gct, "Q18 traced")
    Gu, gcu = plan.run()
    same_rows(by_key(Gt, gct), by_key(Gu, gcu), "Q18 traced against the untraced run")
    del Gt, Gu
    log(f"(q) Q18 traced, per node the median of 3 CUDA-event timed runs after 1 warm-up "
        f"({card}):\n{tr.table()}\n{plan.explain(actuals=tr)}")
    check(abs(tr.sum_wall_s - tr.e2e_wall_s) <= tr.overhead_bound_s,
          f"Q18 trace: the spans' sum {tr.sum_wall_s} s is not within its overhead bound "
          f"{tr.overhead_bound_s} s of the untraced run's {tr.e2e_wall_s} s")
    store = CalibrationStore()
    fp = backend_fingerprint(dev)
    residual_store = store.residual_store(fp)
    residual_store.update(residuals_of(tr))
    store.put_residuals(fp, residual_store)
    store.save()
    perfetto = os.path.join(calib_dir.name, "Q18.perfetto.json")
    tr.to_chrome_trace(perfetto)
    log(json.dumps({"q18_trace": {
        "card": card, "sum_wall_s": tr.sum_wall_s, "e2e_wall_s": tr.e2e_wall_s,
        "overhead_bound_s": tr.overhead_bound_s, "sync_floor_s": tr.sync_floor_s,
        "total_wall_s": tr.total_wall_s, "nodes": [sp.as_dict() for sp in tr.spans()],
        "escalations": [r.summary() for r in tr.escalations],
        "residuals": {fp: residual_store.as_dict()}, "calibration_store": store.path,
        "perfetto": perfetto, "perfetto_events": len(tr.chrome_trace())}}))
    clock.done("5q trace of Q18")

    # -- 5r. the run auditor and the peak bytes of Q18 ---------------------------
    def peak_against_allocator(name, plan_, tables):
        """plan_peak_bytes (each op's workspace included) against the
        allocator over one run of the plan: max_memory_allocated past what was
        allocated before it, plus the inputs. That run is audited for its
        storages alone (no per-op peak resets, so the allocator's peak over
        it stands)."""
        inputs = sum(t.nbytes() for t in tables.values())
        torch.cuda.synchronize()
        a0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        rep_, audit_s = timed(torch, lambda: dispatch_audit.audit(
            lambda tb: EX.execute(plan_.root, tb), tables, workspace=False))
        alloc = torch.cuda.max_memory_allocated() - a0 + inputs
        peak_, peak_s = timed(torch, lambda: EX.plan_peak_bytes(plan_, tables))
        info = {"card": card, "plan_peak_bytes": peak_, "allocator_peak_bytes": alloc,
                "relative_difference": (peak_ - alloc) / alloc,
                "storages_alone_bytes": rep_.peak_live_bytes, "peak_at": rep_.peak_live_at,
                "input_bytes": inputs, "audited_run_s": audit_s, "plan_peak_bytes_s": peak_s,
                "budget": rep_.budget.as_dict(), "launches": dict(rep_.launches)}
        log(json.dumps({name: info}))
        check(abs(peak_ - alloc) <= 0.05 * alloc, f"{name}: plan_peak_bytes {peak_} is not "
              f"within 5% of the allocator's {alloc}")
        return info

    def audit_plan(name, plan_):
        pa, audit_s = timed(torch, lambda: EX.audit(plan_))
        for e in pa.entries:
            log(f"(r) {name} audit {type(e.node).__name__}: priced[{e.contract.describe()}] "
                f"ran[{e.own_budget.describe() or 'none'}] subtree peak "
                f"{e.report.peak_live_bytes} B launches {json.dumps(dict(e.report.launches))}")
        check(not pa.violations, f"{name}: contract violations {pa.violations[:3]}")
        log(f"(r) {name} explain(verify=True) ({audit_s:.3f} s for the audit):\n"
            f"{plan_.explain(verify=True)}")

    audit_plan("Q18", plan)
    q18_peak = peak_against_allocator("q18_peak_bytes", plan, q18_tabs)
    log(f"(r) Q18's plan ({plan_shape(plan.root)[0]}) peaks at {q18_peak['plan_peak_bytes']} B "
        f"against the allocator's {q18_peak['allocator_peak_bytes']} B; PHJ-OM -> group-by "
        f"peaked at 12.38 GB (PR 18)")
    clock.done("5r audit and peak bytes of Q18")

    # -- 5s. the query server on the card: Q18 ----------------------------------
    def q18_numpy(Rn_, Sn_):
        """Per present key of a J2-shaped dataset: rows, int64 sum of s1 and
        r1 (R's key is unique, so the max of r1 is the key's r1)."""
        n = Rn_["k"].shape[0]
        rows = np.bincount(Sn_["k"], minlength=n)
        sums = np.bincount(Sn_["k"], weights=Sn_["s1"].astype(np.float64), minlength=n)
        check(sums.max() < 2 ** 53, "s1 sums past float64's exact range")
        r1_of = np.empty(n, np.int64)
        r1_of[Rn_["k"]] = Rn_["r1"]
        keys = np.flatnonzero(rows)
        return {"k": keys, "r2_count": rows[keys], "s1_sum": sums[keys].astype(np.int64),
                "r1_max": r1_of[keys]}

    def served_equal(req, ref_, direct, what):
        """A served Q18 against numpy per key and against the same plan run
        directly on the request's tables (rows sorted by key)."""
        check(req.done and not req.error and req.result is not None,
              f"{what}: {req.error} {req.detail}")
        G_, c_ = req.result
        a = by_key(G_, c_)
        check(int(c_) == ref_["k"].shape[0], f"{what}: {int(c_)} groups")
        h = table_to_numpy(a)
        for c in ref_:
            check(np.array_equal(h[c], ref_[c]), f"{what}: column {c} differs from numpy")
        same_rows(a, by_key(*direct), f"{what} against the same plan run directly")
        req.result = None

    served = []

    def request_row(srv, req, what, direct_s=None):
        row = {"card": card, "request": what, "qid": req.qid, "plan_s": req.plan_wall_s,
               "queue_s": req.queue_wall_s, "run_s": req.exec_wall_s,
               "total_s": req.total_wall_s, "path": req.path, "morsels": req.morsels,
               "ticket_bytes": srv.cache[req.signature].peak_bytes,
               "admit_tick": req.admit_tick, "ticks_deferred": req.ticks_deferred,
               "signature": req.signature}
        if direct_s is not None:
            row["direct_run_s"] = direct_s
            row["run_over_direct_s"] = req.exec_wall_s - direct_s
        served.append(row)
        log(json.dumps({"served": row}))

    ref1 = {"k": keys_ref, "r2_count": rows_k, "s1_sum": s1_ref[keys_ref],
            "r1_max": r1_ref[keys_ref]}
    R2n, S2n = generate(JoinWorkload("J2", 14_000_000, 56_000_000, r_payloads=3, s_payloads=1,
                                     payload_dtype="int64", seed=1))
    ref2 = q18_numpy(R2n, S2n)
    q18b_tabs = {"orders": table_from_numpy(R2n), "lineitem": table_from_numpy(S2n)}
    del R2n, S2n
    compiled0 = metrics.counter("qserve.plans_compiled").value
    hits0 = metrics.counter("qserve.plan_cache_hits").value
    server = QueryServer(device=dev)
    ops.reset_launch_counts()
    q18_reqs = []
    for qid, tabs in ((0, q18_tabs), (1, q18b_tabs)):
        req = QueryRequest(qid=qid, plan=q18, tables=tabs)
        server.submit(req)
        server.run()
        q18_reqs.append(req)
    got = ops.launch_counts()
    entry = server.cache[q18_reqs[0].signature]
    check(q18_reqs[0].signature == q18_reqs[1].signature, "the two Q18 datasets have two "
          "signatures")
    check(metrics.counter("qserve.plans_compiled").value - compiled0 == 1
          and metrics.counter("qserve.plan_cache_hits").value - hits0 >= 1,
          "the second Q18 did not reuse the cached plan")
    check_plan_launches("served Q18", entry.plan, got)
    for req, tabs, ref_, what in ((q18_reqs[0], q18_tabs, ref1, "served Q18 (J2)"),
                                  (q18_reqs[1], q18b_tabs, ref2, "served Q18 (14M x 56M)")):
        direct, direct_s = timed(torch, lambda t=tabs: entry.plan.run(t))
        direct, direct_s = timed(torch, lambda t=tabs: entry.plan.run(t))
        served_equal(req, ref_, direct, what)
        request_row(server, req, what, direct_s)
    del direct
    log(f"(s) served Q18 plan (optimized on the padded tables):\n{entry.plan.explain()}")
    log(json.dumps({"served_q18_launches": got, "card": card}))
    ticket = entry.peak_bytes

    # two Q18 in one tick under 1.5x the ticket: one runs, one is deferred
    srv2 = QueryServer(device=dev, slots_per_tick=2, mem_budget_bytes=int(1.5 * ticket))
    pair = [QueryRequest(qid=10 + i, plan=q18, tables=q18_tabs) for i in range(2)]
    for req in pair:
        srv2.submit(req)
    srv2.run()
    check(pair[0].admit_tick == 1 and pair[0].ticks_deferred == 0
          and pair[1].ticks_deferred >= 1 and pair[1].admit_tick > 1,
          f"contention: admit ticks {[r.admit_tick for r in pair]}, deferred "
          f"{[r.ticks_deferred for r in pair]}")
    check(srv2.budget.peak_reserved <= srv2.budget.total and srv2.budget.reserved == 0,
          "contention: the reservations overran the budget or leaked")
    direct = entry.plan.run(q18_tabs)
    for req in pair:
        served_equal(req, ref1, direct, f"served Q18, contention qid {req.qid}")
        request_row(srv2, req, f"Q18 under 1.5x the ticket, qid {req.qid}")
    del srv2, pair

    # Q18 under 0.6x the ticket: morsels
    srv3 = QueryServer(device=dev, mem_budget_bytes=int(0.6 * ticket))
    mreq = QueryRequest(qid=20, plan=q18, tables=q18_tabs)
    srv3.submit(mreq)
    srv3.run()
    check(mreq.morsels >= 2, f"Q18 under 0.6x the ticket ran in {mreq.morsels} morsel(s)")
    served_equal(mreq, ref1, direct, "served Q18 in morsels")
    request_row(srv3, mreq, "Q18 under 0.6x the ticket")
    del srv3, direct, q18b_tabs, q18_reqs
    clock.done("5s the query server: Q18")
    path_launches = dict(launches, probe_agg=gj_info["launches"]["probe_agg"],
                         segsum_partials=sp_info["launches"]["segsum_partials"],
                         lower_bound=smj_info["launches"]["lower_bound"])
    tk = T["k"]
    ts1 = T["s1"]
    del T, G
    # -- 6. each kernel against its plain version, at J2's shapes ------------
    results = []

    def record(name, kernel_out, plain_out, kernel_fn, plain_fn, library_fn, nbytes, nops=0,
               plain_reps=5, library=None, shape=None, launches=None):
        """Integer outputs must equal the plain version's; float outputs may
        differ by KERNEL_SUM_RTOL of their magnitude. A kernel timed at more
        than one shape has a row per shape, named by `shape`; `launches`
        (default: the J2 paths' count) is the count of the path that gives
        the kernel this shape."""
        for k, p in zip(kernel_out, plain_out):
            check(k.shape == p.shape and k.dtype == p.dtype, f"{name}: shape/dtype differ")
            if k.dtype.is_floating_point:
                check(((k.double() - p.double()).abs()
                       <= KERNEL_SUM_RTOL * p.double().abs()).all(),
                      f"{name}: kernel sums differ from its plain version by more than "
                      f"{KERNEL_SUM_RTOL} relative")
            else:
                check(torch.equal(k, p), f"{name}: kernel differs from its plain version")
        err = max(float((k.double() - p.double()).abs().max()) if k.numel() else 0.0
                  for k, p in zip(kernel_out, plain_out))
        bound_b, bound_o = nbytes / HBM_BYTES_PER_S * 1e3, nops / INT32_OPS_PER_S * 1e3
        row = {"name": name, "route": "cuda",
               "source": str((_build.CSRC / f"{name}.cu").relative_to(ROOT)),
               "replaces": KERNEL_REPLACES[name],
               "launches": path_launches[name] if launches is None else launches,
               "max_abs_err": err, "ms": cuda_ms(torch, kernel_fn),
               "plain_ms": cuda_ms(torch, plain_fn, reps=plain_reps, warmup=1),
               "bound_ms": max(bound_b, bound_o),
               "bound_by": "bytes" if bound_b >= bound_o else "operations",
               "library_ms": cuda_ms(torch, library_fn) if library_fn else None}
        if library_fn:
            row.update(paired_ms(torch, kernel_fn, library_fn))
        if library:
            row["library"] = library
        if shape:
            row["shape"] = shape
        results.append(row)
        log(f"kernel {name}{f' ({shape})' if shape else ''}: "
            f"{'exact' if err == 0 else f'max abs err {err}'}; "
            f"{json.dumps(row)} bytes={nbytes} ops={nops}")

    # the first plan pass of the probe side: 60M digits, 256 bins
    dig_s = hj._digits(S["k"], p_bits, True)
    pd = (dig_s & 255).contiguous()
    nb, tile = 256, krp.TILE
    hist = krp.block_histograms(pd, nb)

    def record_hist(d, bins, shape, launches=None):
        """block_histograms on digits d against its plain version; the library
        call is one bincount of (tile, digit) pairs made beforehand."""
        tiles = -(-d.shape[0] // tile)
        flat = torch.arange(d.shape[0], device=dev) // tile * bins + d
        record("block_histograms", [krp.block_histograms(d, bins)],
               [ref.block_histograms(d, bins, tile)], lambda: krp.block_histograms(d, bins),
               lambda: ref.block_histograms(d, bins, tile),
               lambda: torch.bincount(flat, minlength=tiles * bins),
               4 * d.shape[0] + 4 * tiles * bins, shape=shape, launches=launches)

    record_hist(pd, nb, "256 bins: the join plan's first pass over S's digits")
    base, _, _ = krp.tile_base(hist)
    record("partition_ranks", [krp.rank_with_base(pd, base, nb)],
           [ref.partition_ranks(pd, nb)], lambda: krp.rank_with_base(pd, base, nb),
           lambda: ref.partition_ranks(pd, nb), lambda: torch.sort(pd, stable=True),
           4 * n_s + base.numel() * 4 + 4 * n_s)
    del hist, base, pd

    # the group-by's first pass over the join output: 2^16 + 1 partitions,
    # ranked as 256 bit bins plus the sentinel partition as a tail class
    gbits, _ = gb._partition_layout(tk.shape[0], gb.PARTITION_ROW_BLOCK, None)
    gdig = gb._partition_digits(tk, gbits)
    gd = torch.where(gdig == 1 << gbits, 256, gdig & 255).contiguous()
    record_hist(gd, 257, "257 bins: the group-by's first pass over the join output")
    gh = krp.block_histograms(gd, 257)
    check(torch.equal(krp.rank_with_base(gd, krp.tile_base(gh)[0], 257),
                      ref.partition_ranks(gd, 257)), "257-bin ranks differ")
    gbase = krp.tile_base(gh)[0]
    log(f"kernels block_histograms and partition_ranks at the group-by's 257 bins: exact; "
        f"partition_ranks {cuda_ms(torch, lambda: krp.rank_with_base(gd, gbase, 257)):.6f} ms "
        f"on {gd.shape[0]} digits")
    # the join plan's narrow last pass: bits 16-18 of S's digits (8 bins), in
    # the order the two 8-bit passes before it leave
    nd = ((dig_s[torch.sort(dig_s & 0xFFFF, stable=True).indices] >> 16) & 7).int().contiguous()
    record_hist(nd, 8, "8 bins: the join plan's last pass over S's digits")
    nbase = krp.tile_base(krp.block_histograms(nd, 8))[0]
    check(torch.equal(krp.rank_with_base(nd, nbase, 8), ref.partition_ranks(nd, 8)),
          "8-bin ranks differ")
    log(f"kernel partition_ranks at the join plan's last pass (8 bins): exact; "
        f"{cuda_ms(torch, lambda: krp.rank_with_base(nd, nbase, 8)):.6f} ms")
    del gdig, gd, gh, gbase, nd, nbase

    # the probe and the gathers, on the join's own partitioned columns
    P = 1 << p_bits
    cap = hj.BUILD_BLOCK
    dig_r = hj._digits(R["k"], p_bits, True)
    perm_r, off_r, sz_r = prim.plan_partition_permutation(dig_r, P + 1)
    perm_s, off_s, sz_s = prim.plan_partition_permutation(dig_s, P + 1)
    kr, ks = R["k"][perm_r], S["k"][perm_s]
    probe_args = tuple(t.contiguous() for t in (kr, off_r[:P], sz_r[:P], ks, off_s[:P],
                                                sz_s[:P])) + (cap,)
    vid, hit = kprobe.hash_probe(*probe_args)
    # bytes the data needs: each probe key read and its vid (4 B) and hit
    # (1 B) written once, each live build key and both sides' offsets and
    # sizes read once; operations: one table insert per live build key and
    # one lookup per probe row
    live_build = int(sz_r[:P].clamp(max=cap).sum())
    probe_bytes = 4 * n_s + (4 + 1) * n_s + 4 * live_build + 4 * 4 * P
    log(f"hash_probe: {n_s} probe rows against {live_build} live build keys in {P} "
        f"partitions; bytes={probe_bytes}")
    record("hash_probe", [vid, hit], list(ref.hash_probe(*probe_args)),
           lambda: kprobe.hash_probe(*probe_args), lambda: ref.hash_probe(*probe_args), None,
           probe_bytes, live_build + n_s, plain_reps=3)
    check(int(hit.sum()) == n_s, "the probe missed rows of a match-ratio-1 join")
    del vid, hit

    # row 3s, the served probe: both key columns padded to their buckets
    # (`pad_table`) and the padding masked to KEY_SENTINEL, as the executor
    # masks it. Those rows form the sentinel partition, after the last of the
    # P partitions, and the kernel's whole grid answers them.
    pad_r, pad_s = bucket_rows(n_r) - n_r, bucket_rows(n_s) - n_s
    kr_pad, ks_pad = (torch.cat([k, torch.full((pad,), hj.KEY_SENTINEL, dtype=k.dtype,
                                               device=dev)])
                      for k, pad in ((R["k"], pad_r), (S["k"], pad_s)))
    check(hj.choose_partition_bits(kr_pad.shape[0], cap) == p_bits,
          "the served build side takes another partition count than J2's")
    served_args = ()
    for k in (kr_pad, ks_pad):
        perm, off, sz = prim.plan_partition_permutation(hj._digits(k, p_bits, True), P + 1)
        served_args += (k[perm], off[:P].contiguous(), sz[:P].contiguous())
    served_args += (cap,)
    outside = ks_pad.shape[0] - int(served_args[4][-1] + served_args[5][-1])
    check(outside == pad_s, f"{outside} probe rows after the last partition, not the {pad_s} "
                            f"padded ones")
    vid, hit = kprobe.hash_probe(*served_args)
    check(int(hit.sum()) == n_s, "the served probe missed rows of a match-ratio-1 join")
    # bytes as row 3's, with the padded rows' vid and hit written but no key
    # of theirs read
    served_bytes = 4 * n_s + (4 + 1) * (n_s + pad_s) + 4 * live_build + 4 * 4 * P
    log(f"hash_probe, served: {n_s + pad_s} probe rows, {pad_s} after the last of {P} "
        f"partitions, against {n_r + pad_r} build rows; bytes={served_bytes}")
    record("hash_probe", [vid, hit], list(ref.hash_probe(*served_args)),
           lambda: kprobe.hash_probe(*served_args), lambda: ref.hash_probe(*served_args), None,
           served_bytes, live_build + n_s, plain_reps=3,
           shape=f"3s: {n_s + pad_s} probe rows, {pad_s} after the last of {P} partitions, "
                 f"against {n_r + pad_r} build rows")
    del vid, hit, served_args, perm, off, sz

    # the partition digits of both padded key columns (2^26 probe rows, 2^24
    # build rows), int32 keys: 8 bytes a row. The plain version is the chain
    # of ATen elementwise passes over int64 copies that the kernel replaced
    for k in (ks_pad, kr_pad):
        record("partition_digits", [kdigits.partition_digits(k, p_bits)],
               [ref.partition_digits(k, p_bits, True)],
               lambda k=k: kdigits.partition_digits(k, p_bits),
               lambda k=k: ref.partition_digits(k, p_bits, True), None, 8 * k.shape[0],
               shape=f"{k.shape[0]} int32 keys, {p_bits} bits: a served side's digits")
    del kr_pad

    # the pass's scatter at the served probe side's 2^26 rows: the plan's
    # second pass (bits 8-15 of the digits in the order the first left), which
    # moves the first pass's permutation and the digits; 20 bytes a row. The
    # library is the plain version's two index_puts; the log adds the glue
    # this kernel replaced for the same pass: the digits gathered through the
    # permutation, then the permutation scattered
    sdig = hj._digits(ks_pad, p_bits, True)
    n_pad = sdig.shape[0]
    d1 = krp.partition_ranks((sdig & 255).contiguous(), 256)[0]
    perm1, keys1 = krp.pass_scatter(d1, sdig, shift=0, bits=8)
    d2 = krp.partition_ranks(((keys1 >> 8) & 255).contiguous(), 256)[0]
    second = dict(shift=8, bits=8)
    check(torch.equal(keys1, sdig[perm1]), "pass_scatter: the first pass's keys are not the "
                                           "digits in its permutation's order")

    def index_puts():
        return (torch.empty_like(perm1).index_put_((d2,), perm1),
                torch.empty_like(keys1).index_put_((d2,), keys1))

    def parent_glue():
        cur = sdig[perm1]
        new = torch.empty_like(perm1)
        new[d2] = perm1
        return cur, new

    record("pass_scatter", list(krp.pass_scatter(d2, keys1, perm1, **second)),
           list(ref.pass_scatter(d2, keys1, perm1)),
           lambda: krp.pass_scatter(d2, keys1, perm1, **second),
           lambda: ref.pass_scatter(d2, keys1, perm1), index_puts, 20 * n_pad,
           library="two index_put_", shape=f"{n_pad} rows: a served probe side's second pass")
    log(f"pass_scatter: the glue it replaced for the same pass (gather + index_put) "
        f"{cuda_ms(torch, parent_glue):.6f} ms; the first pass (no permutation read) "
        f"{cuda_ms(torch, lambda: krp.pass_scatter(d1, sdig, shift=0, bits=8)):.6f} ms, bound "
        f"{16 * n_pad / HBM_BYTES_PER_S * 1e3:.6f} ms")
    del ks_pad, sdig, d1, perm1, keys1, d2

    # the group-join's probe_agg on its padded layout: group key k, s1 from
    # the probe side, r1 from the build side (as phj_groupjoin lays them out)
    bkeys, _, _ = hj.build_blocks(kr, off_r[:P], sz_r[:P], cap)
    pk, part, src_idx = kprobe.layout_probe_blocks(ks, off_s[:P], sz_s[:P], cap,
                                                   -(-n_s // cap) + P)
    B = pk.shape[0]
    pad = src_idx >= 0
    safe = src_idx.clamp(min=0)
    gkb = torch.where(pad, ks[safe], -1)
    pvb = torch.where(pad, S["s1"][perm_s].to(torch.float32)[safe], 0.0)[:, None, :].contiguous()
    bvb = gj._value_blocks(R["r1"][perm_r], off_r[:P], sz_r[:P], cap)[:, None, :].contiguous()
    del safe, src_idx
    sides = (("probe", 0), ("build", 0))
    agg_args = (bkeys, bvb, pk, gkb, pvb, part, sides)
    agg_out = kprobe.probe_agg(*agg_args)
    agg_plain = ref.probe_agg_blocks(*agg_args)
    live = int((agg_out[2] > 0).sum())
    # bytes the data needs: each probe row's join key, group key and s1 read
    # once, each build row's key and r1 once, and one (key, two sums, count)
    # partial written per live slot; the padded layout moves every slot
    agg_bytes = n_s * (4 + 4 + 4) + n_r * (4 + 4) + live * (4 + 2 * 4 + 4)
    agg_padded = (bkeys.numel() * 4 + bvb.numel() * 4 + pk.numel() * (4 + 4 + 4) + B * 4
                  + pk.numel() * (4 + 2 * 4 + 4))
    # operations the data needs: one match lookup and one group lookup per
    # probe row, and one add per output column (the sums and the count) per
    # matched row
    probe_rows = int((pk != -1).sum())
    matched_rows = int(agg_out[2].sum())
    lookups, adds = 2 * probe_rows, matched_rows * (len(sides) + 1)
    agg_ops = lookups + adds
    log(f"probe_agg: {live} live partials; padded layout bytes={agg_padded} bound "
        f"{agg_padded / HBM_BYTES_PER_S * 1e3:.6f} ms; lookups {lookups}, adds {adds}")
    record("probe_agg", list(agg_out), list(agg_plain), lambda: kprobe.probe_agg(*agg_args),
           lambda: ref.probe_agg_blocks(*agg_args), None, agg_bytes, agg_ops, plain_reps=3)
    del pk, part, agg_out, agg_plain, agg_args, gkb, pvb, bvb, bkeys

    # PHJ-OM's gathers, as phj_join maps them: r1 from the partitioned build
    # side through id_r (clustered within partitions), s1 from the
    # partitioned probe side through id_s (perfectly clustered)
    vid_r, matched = ops.hash_probe(*probe_args, "cuda")
    vid_s = torch.arange(n_s, dtype=torch.int32, device=dev)
    (_, vr, vs), c = prim.compact(matched, [ks, vid_r, vid_s], n_s, fill=-1)
    valid = torch.arange(n_s, device=dev) < c
    id_r, id_s = torch.where(valid, vr, -1), torch.where(valid, vs, -1)
    for shape, src, idx in (("r1 through id_r", R["r1"][perm_r], id_r),
                            ("s1 through id_s", S["s1"][perm_s], id_s)):
        idx_long = idx.clamp(min=0).long()  # all valid here, so take computes the same
        record("clustered_gather", [kgather.clustered_gather(src, idx)],
               [ref.clustered_gather(src, idx)], lambda: kgather.clustered_gather(src, idx),
               lambda: ref.clustered_gather(src, idx), lambda: torch.take(src, idx_long),
               src.numel() * 8 + idx.numel() * 4 + idx.numel() * 8, shape=shape)
    del src, idx, idx_long, id_r, id_s, vr, vs, vid_r, vid_s, valid, matched

    # the sort_pallas group-by's s1 pass: the join output's keys in sorted
    # order and s1 as float32
    sk, perm = prim.plan_sort_permutation(tk)
    sv = ts1[perm].to(torch.float32)
    del perm, tk, ts1
    seg_out = kseg.segsum_partials(sk, sv)
    seg_plain = ref.segsum_partials(sk, sv, kseg.TILE)
    seg_again = kseg.segsum_partials(sk, sv)
    for k_, p_, a_, what in zip(seg_out, seg_plain, seg_again, ("keys", "sums", "counts")):
        check(k_.shape == p_.shape and torch.equal(k_, p_),
              f"segsum_partials: {what} differ from the plain version's (n_live {k_.shape[0]} "
              f"against {p_.shape[0]})")
        check(torch.equal(k_, a_), f"segsum_partials: a second launch gives other {what}")
    del seg_again, k_, p_, a_
    # the run lengths, for the one library call that sums the same runs
    # (sums only: no keys, no counts, no compaction)
    lengths = seg_out[2].to(torch.int64)
    check(int(lengths.sum()) == n_s, "segsum_partials: the runs do not cover the rows")
    # bytes the data needs: each sorted key and value read once, one (key,
    # sum, count) partial written per run
    seg_live = lengths.shape[0]
    log(f"segsum_partials: {seg_live} live partials of {n_s} rows, equal bit for bit to the "
        f"plain version's and to a second launch")
    record("segsum_partials", list(seg_out), list(seg_plain),
           lambda: kseg.segsum_partials(sk, sv), lambda: ref.segsum_partials(sk, sv, kseg.TILE),
           lambda: torch.segment_reduce(sv, "sum", lengths=lengths, unsafe=True),
           n_s * (4 + 4) + seg_live * (4 + 4 + 4),
           library="torch.segment_reduce over the tile-local run lengths (sums only)")
    del sk, sv, seg_out, seg_plain, lengths

    # -- 6k. the merge lower bound and the global histogram -------------------
    # SMJ-OM's sweep: S's sorted keys against R's sorted keys; 100,000 sorted
    # probe keys over R's range, whose tiles span far past the ring of build keys
    # (what smj_join gives when the probe side is much the smaller, e.g. after
    # a selective filter); and S's and R's keys as int64
    kr_sorted, ks_sorted = torch.sort(R["k"]).values, torch.sort(S["k"]).values
    gen = torch.Generator(device=dev).manual_seed(0)
    wide = torch.sort(torch.randint(-1, n_r + 5, (100_000,), generator=gen, device=dev,
                                    dtype=torch.int32)).values
    kr64, ks64 = kr_sorted.long() << 33, ks_sorted.long() << 33
    for shape, b, p in (("J2: S's sorted keys over R's", kr_sorted, ks_sorted),
                        ("wide spans: 100,000 sorted keys over R's", kr_sorted, wide),
                        ("int64 keys: S's over R's", kr64, ks64)):
        # bytes: each probe key read and its bound written once, and the build
        # keys the bounds need: at least one per probe key, at most the column
        kb = p.element_size()
        record("lower_bound", [kmj.lower_bound(b, p)], [ref.lower_bound(b, p)],
               lambda: kmj.lower_bound(b, p), lambda: ref.lower_bound(b, p),
               lambda: torch.searchsorted(b, p),
               kb * p.shape[0] + 4 * p.shape[0] + kb * min(b.shape[0], p.shape[0]),
               library="torch.searchsorted (int64 bounds; the plain version is the same call "
                       "with int32 bounds)", shape=shape)
    del kr_sorted, ks_sorted, wide, kr64, ks64, b, p

    # the histogram's own entry point as a path: S's first-pass digits and the
    # join's full digits, whose counts are the partition plan's sizes
    pd = (dig_s & 255).contiguous()
    ops.reset_launch_counts()
    h256 = ops.histogram(pd, 256)
    hfull = ops.histogram(dig_s, P + 1)
    path_launches["histogram"] = ops.launch_counts()["histogram"]
    check(path_launches["histogram"] == 2, f"histogram launched {path_launches['histogram']} "
          "times, expected 2")
    check(torch.equal(hfull, sz_s), "histogram of the join's digits differs from the partition "
          "plan's sizes")
    record("histogram", [h256], [ref.histogram(pd, 256)], lambda: khist.histogram(pd, 256),
           lambda: ref.histogram(pd, 256), lambda: torch.bincount(pd, minlength=256),
           4 * n_s + 4 * 256, library="torch.bincount (int64 counts)")
    check(torch.equal(hfull, ref.histogram(dig_s, P + 1)), "histogram: the full fan-out differs "
          "from its plain version")
    t_ = paired_ms(torch, lambda: khist.histogram(dig_s, P + 1),
                   lambda: torch.bincount(dig_s, minlength=P + 1))
    full_bound = (4 * n_s + 4 * (P + 1)) / HBM_BYTES_PER_S * 1e3
    log(f"kernel histogram, {P + 1} bins (device-memory counts): exact, equal to the plan's "
        f"sizes; {t_['pair_ms']:.6f} ms against torch.bincount {t_['pair_library_ms']:.6f} ms "
        f"(medians of {t_['pairs']} pairs; ratio {t_['pair_ratio_min']:.3f}-"
        f"{t_['pair_ratio_max']:.3f}), bound {full_bound:.6f} ms")
    clock.done("6 kernels")

    # -- 7. free J2 ---------------------------------------------------------
    del R, S, dig_s, pd, h256, hfull, perm_r, off_r, sz_r, perm_s, off_s, sz_s, kr, ks
    del probe_args, dig_r, pad, _
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"J2 freed: {torch.cuda.memory_allocated()} bytes still allocated")

    # -- 7i. the m:n sort-merge join of J5 at scale 1 -------------------------
    R5n, S5n, mode5 = generate_tpc("J5", scale=1, payload_bytes=8, seed=0)
    check(mode5 == "mn", f"J5 mode {mode5}")
    n5 = R5n["k"].shape[0]
    n_keys = n5 // 4  # keys uniform in [0, n_r // 4)
    cR = np.bincount(R5n["k"], minlength=n_keys)
    cS = np.bincount(S5n["k"], minlength=n_keys)
    # per-key payload sums: float64 holds them exactly below 2^53
    sum_r = np.bincount(R5n["k"], weights=R5n["r1"], minlength=n_keys)
    sum_s = np.bincount(S5n["k"], weights=S5n["s1"], minlength=n_keys)
    check(max(sum_r.max(), sum_s.max()) < 2 ** 53, "J5 payload sums past float64's exact range")
    total = int((cR * cS).sum())
    want5 = {"rows": cR * cS, "r1": sum_r.astype(np.int64) * cS, "s1": sum_s.astype(np.int64) * cR}
    R5, S5 = table_from_numpy(R5n), table_from_numpy(S5n)
    del R5n, S5n
    log(f"data: J5 R {n5} rows {R5!r}, S {S5.num_rows} rows; {n_keys} keys, {total} matches "
        f"(numpy per-key counts)")

    def smj_mn(phases=None):
        return join(R5, S5, algorithm="smj", pattern="gftr", mode="mn", out_size=total,
                    phases=phases)

    def check_j5(T5, c5, what):
        """A J5 m:n join against numpy: per-key rows and payload sums."""
        check(int(c5) == total, f"{what}: {int(c5)} rows != {total}")
        k5 = T5["k"][:total].long()
        check(bool((k5 >= 0).all()) and bool((k5 < n_keys).all()), f"{what}: keys out of range")
        got5 = {"rows": torch.bincount(k5, minlength=n_keys)}
        for c in ("r1", "s1"):
            got5[c] = torch.zeros(n_keys, dtype=torch.int64, device=k5.device).index_add_(
                0, k5, T5[c][:total])
            check(T5[c].dtype == torch.int64, f"{what}: {c} lost the int64 payload type")
        for c, want in want5.items():
            check(np.array_equal(got5[c].cpu().numpy(), want),
                  f"{what}: {c} per key differs from numpy")

    (T5, c5), j5_info = run_path("j5_smj_mn", smj_mn, NO_LAUNCHES)
    check_j5(T5, c5, "J5 SMJ-OM")
    j5_phases = {}
    smj_mn(phases=j5_phases)
    log(json.dumps({"j5_smj_mn_phases_s": j5_phases}))
    log(f"(i) J5 m:n SMJ-OM: {total} rows; rows, sums of r1 and of s1 per key equal to numpy "
        f"(cR * cS, sum(r1) * cS, sum(s1) * cR in int64)")
    clock.done("7i J5 m:n sort-merge join")

    # -- 7l. the m:n partitioned hash join of J5: PHJ-OM and PHJ-UM -----------
    over5, bits5 = phj_overflowed(R5)
    check(not over5, "J5: a build partition overflows its 256-row block at the default bits")
    log(f"phj_overflowed(J5's R): False at {bits5} partition bits")

    def lex_sorted(J, c):
        """The (k, r1, s1) columns of J's first c rows sorted by (k, r1, s1):
        three stable sorts, least significant first."""
        cols = [J[n][:c] for n in ("k", "r1", "s1")]
        perm = torch.arange(c, device=cols[0].device)
        for col in reversed(cols):
            perm = perm[torch.sort(col[perm], stable=True).indices]
        return [col[perm] for col in cols]

    smj_rows = lex_sorted(T5, total)
    del T5
    # 2^20 + 1 partitions: three plan passes per side, each one histogram,
    # one rank and one scatter launch; GFTR gathers r1 and s1; no probe kernel
    check(bits5 == 20, f"J5: {bits5} partition bits, expected 20")
    passes5 = 6
    phj5_launches = {"om": dict(NO_LAUNCHES, block_histograms=passes5, partition_ranks=passes5,
                                pass_scatter=passes5, clustered_gather=2),
                     "um": dict(NO_LAUNCHES, block_histograms=passes5, partition_ranks=passes5,
                                pass_scatter=passes5)}
    for mat, pattern in (("om", "gftr"), ("um", "gfur")):
        def phj_mn(phases=None, pattern=pattern):
            return join(R5, S5, algorithm="phj", pattern=pattern, mode="mn", out_size=total,
                        phases=phases)

        (P5, p5c), p5_info = run_path(f"j5_phj_{mat}_mn", phj_mn, phj5_launches[mat])
        check_j5(P5, p5c, f"J5 PHJ-{mat.upper()}")
        for a, b, name in zip(lex_sorted(P5, total), smj_rows, ("k", "r1", "s1")):
            check(torch.equal(a, b), f"J5 PHJ-{mat.upper()}: sorted column {name} differs from "
                  "SMJ-OM m:n's: the rows are not the same multiset")
        del P5, a, b
        p5_phases = {}
        phj_mn(phases=p5_phases)
        log(json.dumps({f"j5_phj_{mat}_mn_phases_s": p5_phases,
                        "launches": p5_info["launches"]}))
        log(f"(l) J5 m:n PHJ-{mat.upper()}: {total} rows, equal to numpy per key and to SMJ-OM "
            f"m:n as a multiset of (k, r1, s1) rows; warm {p5_info['warm_s_median_of_3']:.6f} s "
            f"against SMJ-OM m:n {j5_info['warm_s_median_of_3']:.6f} s (medians of 3); "
            f"launches {json.dumps(p5_info['launches'])}")
    del smj_rows
    del R5, S5
    torch.cuda.empty_cache()
    clock.done("7l J5 m:n partitioned hash join")

    # -- 7j. join sequences over a star schema -------------------------------
    fact_n, dims_n, fks, dks = generate_star(**STAR)
    fact = table_from_numpy(fact_n)
    dims = [table_from_numpy(d) for d in dims_n]
    log(f"data: star fact {fact!r}, {len(dims)} dimensions {dims[0]!r}")
    n_j = STAR["n_joins"]
    seq_launches = {
        # per join: three plan passes per side, one probe, a gather for the
        # dimension's payload and for each probe-side column
        "phj": dict(NO_LAUNCHES, block_histograms=6 * n_j, partition_ranks=6 * n_j,
                    pass_scatter=6 * n_j, hash_probe=n_j,
                    clustered_gather=sum(i + 2 for i in range(n_j))),
        "smj": dict(NO_LAUNCHES, lower_bound=n_j),
    }
    seqs = {}
    for alg in ("phj", "smj"):
        (seqs[alg], sc), _ = run_path(
            f"star_{alg}_om", lambda a=alg: join_sequence(fact, dims, fk_cols=fks, dim_keys=dks,
                                                          algorithm=a, pattern="gftr",
                                                          restore_order=True),
            seq_launches[alg])
        check(int(sc) == STAR["n_fact"], f"star {alg}: {int(sc)} rows != {STAR['n_fact']}")
    a, b = seqs["phj"], seqs["smj"]
    check(a.column_names == b.column_names and all(torch.equal(a[c], b[c])
                                                    for c in a.column_names),
          "join sequences: PHJ-OM and SMJ-OM differ")
    check(np.array_equal(a["payload"].cpu().numpy(), fact_n["payload"]),
          "join sequence: rows are not in fact order")
    for i, fk in enumerate(fks):
        check(np.array_equal(a[f"p{i}_0"].cpu().numpy(), _payload(fact_n[fk], 7 * i, np.int32)),
              f"join sequence: p{i}_0 is not its foreign key's payload")
    log(f"(j) join sequences of {n_j} joins over {STAR['n_fact']} fact rows: PHJ-OM and SMJ-OM "
        f"equal row for row and to numpy; columns {list(a.column_names)}")
    del a, b, seqs
    clock.done("7j join sequences")

    # -- 7p. the star query through the engine --------------------------------
    star_cat = Catalog({"fact": fact, **{f"dim{i}": d for i, d in enumerate(dims)}})
    sq = scan("fact")
    for i in range(n_j):
        sq = sq.join(scan(f"dim{i}"), left_key=fks[i], right_key=dks[i])
    sq = sq.group_by("fk0", p1_0="sum").order_by("p1_0_sum", limit=8, descending=True)
    splan, s_opt_s = timed(torch, lambda: optimize(sq, star_cat, measure_profile=True))
    splan24 = optimize(sq, star_cat, profile=prof24)
    log(f"(p) star query plan (profile at 65,536 rows), the plan the phase runs:\n"
        f"{splan.explain()}")
    log(f"(p) star query plan (profile at 16,777,216 rows):\n{splan24.explain()}")
    (St, stc), s_info = engine_path("star_engine", splan)
    log(json.dumps({"star_engine_profile": profile_run(splan.run)}))
    log(json.dumps({"star_optimize": {"cold_s": s_opt_s, "plan_run": plan_shape(splan.root),
                                      "same_choice_at_both_profiles":
                                      plan_shape(splan.root) == plan_shape(splan24.root)}}))
    # numpy: each fact row's p1_0 is its fk1's payload; int32 sums per fk0
    # wrap as the engine's int32 sums do
    p1 = _payload(fact_n["fk1"], 7, np.int32)
    sums = np.bincount(fact_n["fk0"], weights=p1.astype(np.float64),
                       minlength=STAR["n_dim"]).astype(np.int64).astype(np.int32)
    present_f = np.bincount(fact_n["fk0"], minlength=STAR["n_dim"]) > 0
    top8 = np.sort(sums[present_f])[::-1][:8]
    Sh = table_to_numpy(St.head(int(stc)))
    check(int(stc) == 8, f"star query: {int(stc)} rows, expected 8")
    check(np.array_equal(Sh["p1_0_sum"], top8), f"star query: top 8 sums {Sh['p1_0_sum']} "
          f"!= numpy's {top8}")
    check(present_f[Sh["fk0"]].all() and np.array_equal(sums[Sh["fk0"]], Sh["p1_0_sum"])
          and np.unique(Sh["fk0"]).size == 8, "star query: a top-8 key's sum differs from numpy")
    log(f"(p) star query through the engine: top 8 of {int(present_f.sum())} groups equal to "
        f"numpy (int32 sums); warm {s_info['warm_s_median_of_3']:.6f} s (median of 3), "
        f"launches {json.dumps(s_info['launches'])}")
    clock.done("7p star query through the engine")

    # -- 7r, 7s. the star query audited, its peak bytes, and served -------------
    star_tabs = dict(star_cat.tables)
    audit_plan("star query", splan)
    peak_against_allocator("star_peak_bytes", splan, star_tabs)
    ops.reset_launch_counts()
    sreq = QueryRequest(qid=2, plan=sq, tables=star_tabs)
    server.submit(sreq)
    server.run()
    got = ops.launch_counts()
    check(sreq.done and not sreq.error, f"served star query: {sreq.error} {sreq.detail}")
    sentry = server.cache[sreq.signature]
    check_plan_launches("served star query", sentry.plan, got)
    (Dt, dtc), direct_s = timed(torch, lambda: sentry.plan.run(star_tabs))
    (Dt, dtc), direct_s = timed(torch, lambda: sentry.plan.run(star_tabs))
    Sv, svc = sreq.result
    Svh = table_to_numpy(Sv.head(int(svc)))
    check(int(svc) == 8 and np.array_equal(Svh["p1_0_sum"], top8)
          and np.array_equal(sums[Svh["fk0"]], Svh["p1_0_sum"]),
          f"served star query: top 8 sums {Svh['p1_0_sum']} != numpy's {top8}")
    Dh = table_to_numpy(Dt.head(int(dtc)))
    check(sorted(zip(*[Svh[c].tolist() for c in sorted(Svh)]))
          == sorted(zip(*[Dh[c].tolist() for c in sorted(Dh)])),
          "served star query: rows differ from the same plan run directly")
    sreq.result = None
    request_row(server, sreq, "star query", direct_s)
    log(f"(s) served star plan:\n{sentry.plan.explain()}")
    log(json.dumps({"served_star_launches": got, "card": card}))
    totals = [r["total_s"] for r in served]
    check(len(served) == 6, f"{len(served)} served requests, expected 6")
    log(json.dumps({"server_latency": {"card": card, "requests": len(totals),
                                       **metrics.percentiles(totals, (50, 99))}}))
    del St, Sh, star_cat, fact, dims, p1, sums, present_f, Dt, Sv, server, star_tabs
    clock.done("7s the query server: star query")
    del os.environ["REPRO_CALIBRATION_PATH"]
    calib_dir.cleanup()

    # -- 7n. partition_hash, scatter and sort over a skewed 60M-row table -----
    # groupby_bench's skew shape at lineitem's SF10 row count
    rng = np.random.default_rng(0)
    gk_n = ((rng.zipf(1.5, SKEW_ROWS) - 1) % SKEW_KEYS).astype(np.int32)
    gv_n = rng.random(SKEW_ROWS, dtype=np.float32)
    skew = table_from_numpy({"k": gk_n, "v": gv_n})
    cnt_ref = np.bincount(gk_n, minlength=SKEW_KEYS)
    sum_ref = np.bincount(gk_n, weights=gv_n.astype(np.float64), minlength=SKEW_KEYS)
    keys_sk = np.flatnonzero(cnt_ref)
    del gk_n, gv_n
    skew_pick = choose_groupby_strategy(SKEW_ROWS, SKEW_KEYS, key_min=0, key_max=SKEW_KEYS - 1,
                                        zipf=1.5)
    skew_times = {}
    for strategy in ("partition_hash", "scatter", "sort"):
        def gby(strategy=strategy):
            return group_aggregate(skew, key="k", aggs=SKEW_AGGS, num_groups=SKEW_GROUPS,
                                   strategy=strategy)

        (Gs1, c1), info = run_path(f"skew_groupby_{strategy}", gby, NO_LAUNCHES)
        skew_times[strategy] = info["warm_s_median_of_3"]
        log(json.dumps({f"skew_groupby_{strategy}_profile": profile_run(gby)}))
        Gs2, c2 = gby()
        check(int(c1) == int(c2) and all(torch.equal(Gs1[n], Gs2[n]) for n in Gs1.column_names),
              f"{strategy} over the skewed table: a second run is not bit-identical")
        Gh = table_to_numpy(Gs1.head(int(c1)))
        check(int(c1) == keys_sk.shape[0] and np.array_equal(Gh["k"], keys_sk),
              f"{strategy} over the skewed table: keys differ from numpy")
        check(np.array_equal(Gh["k_count"], cnt_ref[keys_sk]),
              f"{strategy} over the skewed table: counts differ from numpy")
        check(Gh["v_sum"].dtype == np.float32, f"{strategy}: float32 sums expected")
        err = check_f32_sums(Gh["v_sum"], sum_ref[keys_sk], cnt_ref[keys_sk],
                             f"{strategy} over the skewed table")
        log(f"(n) {strategy} over {SKEW_ROWS} zipf(1.5) rows: {int(c1)} groups, keys and "
            f"counts equal to numpy, float32 sums within 2 * rows * 2^-24 relative of "
            f"numpy's float64 sums (max relative error {err}), bit-identical on a second run")
        del Gs1, Gs2, Gh
    log(json.dumps({"skew_groupby_warm_s_median_of_3": skew_times,
                    "choose_groupby_strategy": {"j2_join_output": j2_pick,
                                                "skewed_table": skew_pick}}))
    del skew
    clock.done("7n skewed group-bys")

    # -- 8t. the chaos soak on the card -----------------------------------------
    chaos_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_chaos_")
    os.environ["REPRO_CALIBRATION_PATH"] = os.path.join(chaos_dir.name, "CALIBRATION.json")
    ops.reset_launch_counts()
    try:
        chaos, chaos_s = timed(torch, lambda: run_chaos(smoke=True, device="cuda"))
    finally:
        del os.environ["REPRO_CALIBRATION_PATH"]
        chaos_dir.cleanup()
    got = ops.launch_counts()
    base = chaos["baseline"]
    log(json.dumps({"chaos": {
        "card": card, "ok": chaos["ok"], "failures": chaos["failures"][:20], "wall_s": chaos_s,
        "baseline": {k: base[k] for k in ("queries", "wall_s", "throughput_qps", "p50_s",
                                          "p95_s", "p99_s", "per_shape_p99_s",
                                          "plans_compiled", "plan_cache_hits")},
        "families": {f: {k: v for k, v in r.items() if k != "counters"}
                     for f, r in chaos["families"].items()},
        "pressure": {k: v for k, v in chaos["pressure"].items() if k != "counters"},
        "memory": {k: v for k, v in chaos["memory"].items() if k != "counters"},
        "launches": got}}))
    check(chaos["ok"], f"chaos soak: {chaos['failures'][:10]}")
    check(got["hash_probe"] > 0 and got["block_histograms"] > 0 and got["partition_ranks"] > 0,
          f"chaos soak: the queries launched no join kernel ({got})")
    log(f"(t) chaos soak ({base['queries']} queries a pass; families "
        f"{sorted(chaos['families'])}, pressure, memory): ok; baseline p50 {base['p50_s']:.6f} s, "
        f"p99 {base['p99_s']:.6f} s, {base['throughput_qps']:.1f} queries/s ({card})")
    clock.done("8t chaos soak")

    lm_phase(torch, card, record, record_hist, profile_run, results)
    clock.done("9u LM decode server")

    train_phase(torch, card, record, record_hist, profile_run, results)
    clock.done("10v LM trainer")

    hybrid_phase(torch, card, profile_run)
    clock.done("11w hybrid server")

    pipeline_phase(torch, card, record, record_hist, profile_run, results)
    clock.done("12x feature-join pipeline")

    family_phase(torch, card, profile_run)
    clock.done("13y vision and audio servers")

    lint_phase(torch, card)
    clock.done("14z launch-configuration lint and example twins")

    dist_phase(torch, card)
    clock.done("15aa distributed layer")

    log(json.dumps({"kernels": results}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
