"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; the script exits non-zero if any fails:

1. device    -- requires a CUDA device; prints the card's name and power
               limit as nvidia-smi reports them.
2. build     -- compiles ``pytorch_ps_mpi_tpu_torch/csrc/{sign,quant,
               topk,tern,attention,attention_tc}.cu`` with nvcc for sm_90a,
               one nvcc per source, all started together, and prints the
               seconds each took, ptxas's registers and spills of each
               tensor-core flash kernel, and the count of HGMMA/HMMA
               instructions in the attention libraries' SASS (where the
               toolkit has ``cuobjdump``).
3. kernels   -- each kernel against its plain PyTorch version on the card,
               at the main paths' leaf sizes and the sizes of their
               buckets at bucket_mb=16 (the plan over the JAX leaf
               order), with planted cases:
               - the sign kernels at ResNet-18's 20 kernel-path leaves and
                 its 2 kernel-layout buckets, at
                 one row below, at and above the rows one encode block
                 sums, and past the co-resident grid (bytes bit-exact, |x|
                 sum within rtol 1e-6, -0.0 and NaN); the unpack-sum
                 there at world 1 and 8 with zero, subnormal, +Inf and NaN
                 scales, sums below the smallest normal float and a view
                 one byte into its buffer (bit-exact, NaN by position),
                 timed over the 20 leaves at each world;
               - int8 quantize and dequantize-sum at ResNet-18's 62 leaves
                 and 4 buckets, world 1 and world 8, and quantize also one
                 below, at and
                 above its tile and past the co-resident grid (codes,
                 scales and floats bit-exact; NaN, ±Inf, ±0.0 and exact .5
                 ties);
               - for the one-launch quantize, sign encode and unpack-sum:
                 the grid each leaf size takes, one device row a call
                 (asserted), and the largest leaf's cold device ms against
                 its byte bound;
               - int8 dequantize-sum also at n % 16 == 0, n % 16 == 4,
                 odd n and a view that starts one byte in, and at the
                 largest leaf (2,359,296 codes) at world 8;
               - the top-k radix threshold and the whole exact top-k at
                 ResNet-50's 53 kernel-path leaves with k = round(0.01 n)
                 (histograms, thresholds, index arrays and values
                 bit-exact; heavy |x| ties, NaN, ±Inf, ±0.0, all ties, all
                 zeros, k = 1, k = n − 1, more NaNs than k, odd n from a
                 misaligned view, run-to-run identity);
               - TernGrad at BERT-base's 63 sublane-layout leaves and 15
                 such buckets as the codec calls it: the one-launch encode
                 (scale and pack) at every whole unit's size, the chunked
                 route (one scale launch, then a given-scale pack a chunk
                 of 2**20 into its slice; the two 23,440,896-element
                 units) and the encode there whole, in float32 and bf16,
                 the given-scale pack at the chunks' sizes, and the
                 unpack-sum at every unit at world 1 and 8 (bytes, scales
                 and floats bit-exact; ±0.0, |x| == s, u24 == p24, the top
                 random bit, a NaN or ±Inf element, max|x| < 1e-12, NaN
                 and Inf given scales); the codec's sublane encode of the
                 63 leaves and the 15 buckets against the parent's route
                 (a float32 copy, abs, amax, clamp, a pack a chunk, a cat)
                 on the same bits: payloads byte for byte, each route's
                 device rows (the new one's asserted: its TernGrad
                 launches alone), and both timed in turns (parent, new,
                 new, parent); each kernel timed per leaf and bucketed in
                 bf16, the encode also as two launches, the encode's
                 device µs a leaf size against its bound, and the
                 wrappers' host µs a call;
               - the flash forward and backward at [b=4, l=512, h=12, d=64]
                 in bf16 (tensor cores) and float32 (CUDA cores),
                 non-causal, causal, with a k offset that leaves rows
                 without a visible key, and an lse cotangent (float32 to
                 rtol 1e-5 forward and 1e-4 backward; bf16 to 2**-6 of
                 each output's largest magnitude, see
                 ``check_flash_kernels``); in bf16 also every head dim
                 (8–128, causal and not), a ragged length whose
                 neighbouring heads hold 1e4 (nothing may leak), and
                 run-to-run identity of o, lse, dq, dk and dv.
               Times each over the main path's calls in sequence: ``ms``
               is the wrapper's call (median of CUDA-event timings, host
               launch cost included), ``device_ms`` the kernels' own time
               in a profiler trace, ``plain_ms`` the plain version's call,
               ``bound_ms`` the larger of the bytes the function must move
               over 3.35 TB/s and its operations over 989 TFLOP/s (bf16
               tensor cores), ``library_ms`` one PyTorch call computing the
               same function where there is one (never called by the
               port; for flash each SDPA backend that takes the shape is
               timed too, forward and backward alone). ``attention`` then
               times the dense attention of ``attention="full"`` against
               flash at BERT-base's shape.
4. decode_sum -- 1 and 8 stacked sign payloads for every ResNet-18 leaf
               through ``SignCodec.decode_sum``: bit-exact against the
               plain fold, one device row a kernel-layout leaf (asserted),
               and its ms and device ms over the 20 kernel leaves.
5. reference -- grads-only steps on the card against the same steps on the
               CPU (the plain versions), rtol 1e-6: SGD(sign) and
               SGD(int8) on ResNet-18, SGD(sign) also at bucket_mb=16 and
               SGD(int8) at bucket_mb=16 in allgather and in leader mode
               (bit-exact), SGD(ef∘topk) on ResNet-50, and
               Adam(terngrad(use_pallas=True)) on BERT-base per leaf and at
               bucket_mb=16, with the same random numbers on both sides
               and the card's TernGrad launches asserted; then BERT-base's
               loss and
               gradients with the flash kernels against the same with their
               plain versions on the card (bf16, see ``check_bert_flash``).
               Then the codecs without a kernel, at the settings of
               ``benchmarks/bert_bench.py:156-162``: phase ``sync`` runs
               the encode and decode-sum of random-k, block top-k, block
               top-k int8 and threshold on every BERT-base leaf under
               ``torch.cuda.set_sync_debug_mode("error")`` (no host sync);
               ``reference`` holds each on the card against the CPU at
               BERT-base's own leaves (the embedding, an FFN kernel, an
               attention output kernel, the 30,522-element bias, a [768]
               bias; payloads and decode-sums bit-exact, PowerSGD's
               two-all-reduce protocol over three steps within 1e-4 of
               each tensor's largest magnitude); ``powersgd_qr`` times the
               51 QRs of PowerSGD's step and calls them, and the whole
               protocol, behind a spin kernel (does either wait on the
               device?); the powersgd-r4 run's ``profile`` line gives
               the QRs' device time and share of its step.
6. main path -- a one-rank NCCL process group, then 5 ``step(loss_fn=...)``
               calls and 1 ``step(grads=...)`` call of each of: identity
               (no kernel), sign, int8 and qsgd on ResNet-18 (CIFAR stem,
               GroupNorm, f32) at batch 256, and ef∘topk(fraction=0.01,
               pallas=True) on ResNet-50 (ImageNet stem, 1000 classes) at
               224x224, batch 128; then Adam(lr=1e-4) with identity and
               terngrad(use_pallas=True) on BERT-base MLM (132,361,530
               parameters in 150 leaves, bf16 compute, float32 parameters,
               attention="flash") at batch 4, sequence 512. Then the
               bucketed runs at bucket_mb=16, parameters in the JAX leaf
               order: ResNet-18 SGD with sign and int8 in allgather mode
               and int8 in leader mode (ZeRO-1, payload_gather at world
               1), BERT-base Adam with terngrad(use_pallas=True) in
               allgather mode and identity in leader mode (psum_scatter,
               the state kept a bucket at a time). Then BERT-base Adam with
               powersgd(rank=4), blocktopk and blocktopk8 (fraction 0.01),
               randomk(fraction=0.01) per leaf and at bucket_mb=16, and
               threshold(tau=2, max_fraction=0.05). Every kernel count and
               the collective counter (``comms.calls``) are set to 0 just
               before a run and read just after it; the kernel counts must
               equal the run's exact launches (flash only in loss steps:
               12 forward and 12 + 12 backward launches a step; a
               bucketed run's codec launches from its own bucket plan,
               which must give the JAX plan's), and the collective calls
               of the grads-only step a fixed table (62/124/124/124/322
               per leaf on the ResNets, 150/300 on BERT-base; 8, 8, 12,
               56 and 28 reduce-scatters + 28 all-gathers bucketed;
               PowerSGD 201 all-reduces, block top-k and random-k 300
               all-gathers, block top-k int8 and threshold 450, random-k
               bucketed 56), plus one all-reduce of the loss a loss step;
               the codecs without a kernel launch none.
               One more step then runs under torch.profiler (phase
               ``profile``): the device's busy time against the step's
               wall time and the kernels that take the most of it.

7. training -- in the same process group, with cuDNN deterministic, every
               run's kernel counts and collective calls asserted exactly:
               ResNet-18 (CIFAR stem, SyncBatchNorm, f32) SGD(sign) at
               batch 256 through ``Trainer.fit``, 8 steps in two
               ``run_steps`` calls, checkpointing every 4 (20 + 20 sign
               launches a step; 144 all-gathers and 22 all-reduces a step:
               the gradients' 124, one all-gather and one all-reduce a
               BatchNorm layer, the running statistics' all-reduce and the
               loss's); a fresh Trainer restored from the step-4
               checkpoint of a 4-step run (a directory of its own) and run
               4 more equals it bit for bit (parameters, running statistics,
               momentum), and ``run_steps(4)`` equals 4 ``step`` calls bit
               for bit (two rounds, the second in the other order, both
               wall times printed). BERT-base Adam(terngrad(use_pallas=True)) through
               ``step_accumulate`` over 2 microbatches of 4 x 512 (24 + 48
               flash launches; TernGrad's 61 encodes, 2 scales, 46 chunk
               packs and 63 unpack-sums a step; 300
               all-gathers + 1), then the same with ``instrument=True``
               (every stage timed, the stages within ``step_time``, the
               parameters the fused run's bit for bit). ResNet-18 SGD(int8):
               ``make_sync_train_step`` per leaf and at bucket_mb=16 equals
               ``MPI_PS.step`` bit for bit over 3 steps, and an
               ``instrument=True`` step equals the fused one (3 steps). Last,
               ``python -m pytorch_ps_mpi_tpu_torch.launch ... train.py
               --config resnet18_cifar10 --norm batch --codec int8 --steps
               3`` in a subprocess exits 0 with a finite ``final_loss``.
               Each path in this process prints its median step ms, peak
               GB and (one more step under torch.profiler) its idle share;
               the CLI its seconds and ``Trainer.fit``'s mean step ms.

7b. longcontext -- after ``training``, in a one-rank NCCL group of its
               own (``run_longcontext``): L1 ``train_longcontext`` through
               its ``main`` at BERT-base widths (GPT, hidden 768, 12
               layers, 12 heads of 64, vocab 30522, FFN 1536, sequence
               2048, batch 2, bf16 on the flash kernels, remat) for 3
               steps with ring and with Ulysses attention: 2 forward and 2
               backward flash launches a layer a step (remat reruns the
               forward), 149 all-reduces a step, Ulysses 6 all-to-alls a
               layer a step, asserted; median step ms, peak GB, finite
               losses. L2 the ring schedule at 8192 tokens on one card
               ([1, 8192, 12, 64] bf16 causal, 4 shards of 2048, each
               shard's 4 blocks in ring order with their offsets and
               ``return_lse=True``, folded by ``parallel.ring.ring_combine``):
               16 forward and 32 backward block launches, the output and
               the gradients of q, k and v against one flash call over the
               whole sequence and against the plain version within 2**-6
               of the largest magnitude; a block the mask covers whole,
               folded first into fresh accumulators, weighs 0; the three
               timed. L3 ``train --config gpt_lm`` and ``--config
               switch_mlm`` (batch 8, 3 steps; 4 + 8 flash launches a
               step, asserted), the first loss within 2e-3 and the first
               batch's logits within 5e-2 (gpt_lm) and 0.35 (switch_mlm,
               bf16 reroutes some tokens) relative L2 of the same port's
               on the CPU in float32, and a control (attention rows
               rolled on the CPU) beyond the logits bound.
               L4 ``train_tp`` at BERT-base widths (hidden 768, 12 heads,
               FFN 3072, sequence 512, batch 8) through
               ``MPI_PS(param_specs=)`` in allgather and leader mode, the
               collective calls asserted. Then the flash calls at gpt_lm's
               head dim 32 timed. The kernel line gives the launches of L1
               and L3 (``launches_longcontext``).

8. async    -- last, after ``torch.cuda.empty_cache()``: the asynchronous
               parameter server (``parallel/async_train.py``), the server in
               this process and the workers fresh interpreters on the same
               card, every one computing on it. A1: ResNet-50
               (``small_inputs``, 10 classes, 32x32, batch 32, seed 5, SGD
               lr 1e-4, as ``benchmarks/async_bench.py:94-107``), 4
               workers over shm, async, sign, max_staleness 4, worker 3 a
               200 ms straggler pushing twice and the others 6 times (as
               async_bench.py's async fleet), the server's updates under
               torch.profiler (its idle share); the loss must fall. A2:
               the same fleet under the sync barrier, 3 pushes a worker,
               int8, ``agg`` auto: agg_mode 1, one decode a publish, no
               fallback, the native fold armed.
               A3: ResNet-18 over TCP with frames, async, identity, 2
               workers, through the native batched ingest. Each prints its
               pushes, applied and dropped, the staleness histogram,
               updates/s and wall, the loss before and after, the per-push
               times of the workers (read, grad, encode with its D2H copy,
               push) and of the server (ingest with its decode, fold,
               update, publish), and every process's peak memory; the
               kernel launches are asserted exactly (A1: encode_signs a
               kernel-layout unit a push on the workers, unpack_signs_sum
               one a decoded kernel-layout unit on the server; A2:
               quantize_int8 a unit a push, no device decode; A3: none).
               Then the async-over-sync ratio of A1 and A2 (of the updates
               a second from the server's first update to its last, and
               of the JAX-style rate over the whole run), the device time
               of the workers' flax permutation of ResNet-50's kernels, and
               A4: ``AsyncPS`` in one program (ResNet-18, 4 workers, lags
               [0, 1, 2, 1], sign) two rounds on the card against the CPU
               (``check_async_ps``), then 3 rounds of sampled lags.

9. serving  -- after ``torch.cuda.empty_cache()``, cuDNN deterministic:
               the read tier (``serving/``) beside A1's ResNet-50 fleet
               (``run_serving``; the server and its native PSR1 read tier
               in this process, workers, readers and replicas fresh
               interpreters). V1: A1's fleet with
               ``ef(topk(fraction=0.01, pallas=True))``, ``read_port=0``,
               ring 8, checkpoints every 4; one reader process of 4 delta
               and 4 full ``ServingReader`` threads reads in a loop while
               it trains (every process of the phase with one intra-op
               thread; a delta reader reads once the server has
               pre-encoded a newer version's deltas): every version a
               reader held hashes to the server's CRC-32 of it, each delta
               reader applied a delta, the last read is the final flat bit
               for bit, the native tier armed, ``exact_topk`` 7 launches a
               kernel leaf a push on the workers; prints reads/s, read
               p50/p95 ms by kind, delta bytes over the 94 MB full read,
               ``coalesce_hits``, ``reads_shed`` and the publish's ms
               split (host array allocation, D2H, transport, ring put,
               pre-encode), then the same fleet unarmed, while V4's
               replica starts: updates/s of the pair (one run each, not a
               claim). V3 rides on V1: root -> replica 1 -> replica 2
               (``serve_readonly --follow-endpoint``), an edge reader at
               replica 2 holds the root's versions (CRCs) with FRS1
               ``hop_count`` 2; once the root stops the replicas' lag is
               at most 2; prints ``follower_bytes_relayed`` and the
               publish -> visible ms a hop. V4: ``serve_readonly
               --checkpoint-dir`` on V1's checkpoints; a reader here loads
               what it read into ResNet-50 on the card and its held-out
               loss equals the V1 server's bit for bit. V2: A1's fleet
               (sign) with ``delta_codec="int8"``: the server's
               ``quantize_int8`` launches equal its lossy sections (every
               section of every encode, by the plan), ``dequantize_int8``
               one a section of each probed encode, no lossy fallback, two
               delta readers apply on the card (one ``dequantize_int8`` a
               section a delta read) and stay within the bound the probe's
               ``max_rel_error`` gives, summed over their deltas. V5 rides
               on S2 (phase ``scale_out``). The kernel line gives each
               kernel's launches in this phase (``launches_serving``).

10. scale_out -- last, after ``torch.cuda.empty_cache()``: sharded
               servers, the aggregation tree and the supervisor
               (``run_scale_out``; every shard server, leader and worker a
               fresh interpreter on the card). S1: A1's ResNet-50, 2 shard
               servers over TCP, 4 workers, int8, async, max_staleness 4,
               shard 1 sleeping 50 ms after each update, 3 pushes a worker
               a shard, checkpoints a shard every 4: one ``quantize_int8``
               a slice a push on the workers and one ``dequant_sum`` a
               decoded push on each shard (asserted), every push received,
               the shards' versions diverging, ``assemble`` tiling the
               vector and the held-out loss falling. S2: identity, 1
               worker, 3 synchronous steps against 1 shard and against 2,
               side by side: the final parameters equal bit for bit; V5:
               the shards' read tiers armed, each shard's tenant read
               once the last update is in (then a zero push, no change
               under SGD without momentum, ends the run), the reads
               assembled equal the result bit for bit. T1:
               ``run_tree``, 4 workers in 2 groups, the leaf hop identity
               over TCP, the upstream hop int8 behind hop error feedback
               into a tree-mode root in this process, 3 pushes a worker:
               no decode at a leader, 161 quantizes and 161 hop-EF decodes
               a hop push, all 12 pushes composed at the root, no decode
               kernel there (host fold), the loss falling. T2: T1 with
               group 1's leader crashing at its round 2 and its workers
               paced: a respawn, fallback pushes, a rejoin, and every push
               composed or positively lost. R1: ResNet-18 sign over shm,
               2 workers under the ``Supervisor`` with checkpoints every 4
               and the fault plan ``R1_PLAN`` (corrupt, crash_worker, drop,
               duplicate, crash_server): every fault fired once, a worker
               respawn, one server restart, one ``corrupt`` rejection, 20
               ``encode_signs`` an encode and 20 ``unpack_signs_sum`` a
               decode, exit codes 0, the loss falling. Each run prints its
               timings, every role's peak GB and the idle share of the
               card under its server or root. The kernel line gives each
               kernel's launches in this phase (``launches_scale_out``).
               Phase ``control``'s O3 rides on S1 (the shards' fleet cards
               and a read tier's in one directory, its ``/fleet`` scraped
               while they run: 3 members, the shards' counters summed,
               the skew section) and R1 (the restarted server's card at a
               new endpoint, one card at a time, none left).

11. telemetry -- last, after ``torch.cuda.empty_cache()``: the per-process
               telemetry layer (``run_telemetry``). N1: ResNet-18 (CIFAR
               stem, b256) ``SGD(code=sign, numerics=True)`` per leaf and
               at bucket_mb=16, 3 loss steps: the sign launches unchanged
               (20 + 20, 2 + 2 a step), one device-to-host copy more in
               a profiled step than the same step unarmed, the statistics
               of a grads-only step against float64 on the host (rtol
               1e-5) and, with a NaN and two Infs planted in one leaf,
               ``nonfinite_total`` 3 and the finite part's norm; the step
               ms armed and unarmed (10 steps each in turns, medians and
               the median pair's difference) and the statistics alone
               (their vector and its copy between syncs). N2:
               ``step(profile=True)`` on ResNet-18 sign and on BERT-base
               b4 s512 bf16 ``Adam(terngrad(use_pallas=True))``:
               ``top_ops`` names ``sign_encode_kernel``,
               ``sign_unpack_sum_kernel``, ``flash_fwd_tc``,
               ``flash_bwd_dq_tc``, ``flash_bwd_dkv_tc``, ``tern_pack``
               and ``tern_unpack_sum``, and each profiled step's
               launches are a step's (20 + 20 sign; 12 + 24 flash, 61
               encodes, 2 scales, 46 chunk packs and 63 unpack-sums)
               times its takes; then one BERT
               step under
               ``utils.tracing.trace`` with the flight recorder on, merged
               by ``trace_export`` and read back. N3:
               ``CodecWire.probe_fidelity`` on a ResNet-50 gradient for
               sign, int8 and ef∘topk through the kernels, against the
               same probe with their plain versions on the card (rtol
               1e-5, the top-k index set exact), each probe's launches
               asserted. N4: A1's fleet armed (``telemetry_dir``,
               ``metrics_port=0``, ``health``, ``numerics`` skip with
               probes every 2, ``lineage``/``trace`` with the anatomy), 4
               pushes a worker, ``max_staleness`` 16 (no push is stale)
               and a ``nan`` on worker 1's third: ``/metrics`` and
               ``/health`` scraped while it runs, the nan push quarantined
               exactly once and never applied, worker 1's next push
               skipped, every other push applied, one lineage row and one
               anatomy round a version, the probe rows of the cadence,
               the recorder's JSONL read back, the loss falling, every
               launch asserted; prints the verdicts, the anatomy's top
               stage and steady updates/s armed over A1's. The kernel
               line gives every kernel launch of this phase
               (``launches_telemetry``): the script's process, no count
               set to 0 in the phase (so the kernel side of N3's
               comparisons and N1's profiled and timed steps are in it),
               and N4's workers.

12. control  -- last, after ``torch.cuda.empty_cache()``: the fleet
               observability plane and the controller (``run_control``).
               O1: A2's fleet with the history, SLO rules, the sampling
               profiler in every process, lineage, beacons and a fleet
               card: ``/history`` read while it runs (monotone), its
               ``push_e2e_p95_ms`` equal to lineage's exact p95 (1%), no
               verdict, serve-loop frames in the collapsed stacks, the
               ``wc_fold`` counters grown, 161 ``quantize_int8`` a push;
               prints the plane's self-timed cost and steady updates/s
               over A2's. O2: A1's fleet with a 600 ms straggler under
               ``max_staleness`` 5: exactly one latched ``stale_drops``
               verdict, re-derived by replaying ``timeseries-server.jsonl``.
               C (``tools/control_smoke.py``'s scenario at ResNet-50):
               boot codec identity, ladder identity -> int8, two workers
               wire-bound by delay faults, a 2.5 s straggler, a ``nan``
               worker, the Python read tier at depth 2 and ring 2 under
               pipelined storms, replicas armed. C1: one renegotiation and
               one retire, no healthy worker's frame rejected, each
               worker's frames on epoch 0 then 1 (``epoch_frames``), 0
               ``quantize_int8`` before its switch and 161 a push after,
               161 ``dequant_sum`` an int8 frame on the server. C2: only
               the straggler de-weighted, the ``nan`` worker readmitted
               and applied again. C3: a storm sheds, the depth rises
               until one runs shed-free, the ring grows on ageouts. C4:
               ``Controller.replay`` byte-identical, 0 flaps. C5: a
               replica out (its card appears) and in (its card goes); the
               same scenario uncontrolled for the loss (reported). C1tcp:
               A3's ResNet-18 over TCP, identity -> int8: native batches
               flat through the transition, growing after. C5 tree: T1's
               tree with ``topo_actions`` and a hot leader: a split behind
               a new leader, a merge once cold, every push composed or
               lost exactly once. The kernel line gives every launch of
               the phase (``launches_control``).

Phase ``done`` gives the seconds the whole run took. The line before the
last is a JSON object with one entry per kernel; the last line is
``{"ok": true, "device": {...}}``. This script imports
nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import socket
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
BF16_FLOPS = 989e12        # H100 SXM dense bf16 tensor cores (data sheet)
WORLD = 1
BATCH = 256          # ResNet-18, CIFAR-10
BATCH_IMAGENET = 128  # ResNet-50, ImageNet
LOSS_STEPS = 5
TOPK_FRACTION = 0.01
BERT_BATCH, BERT_SEQ = 4, 512
BERT_HEADS, BERT_HEAD_DIM = 12, 64


def phase(name: str, **fields) -> None:
    print(f"phase={name} " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def cuda_ms(fn, reps: int = 20, rounds: int = 5) -> float:
    """Median over ``rounds`` of the mean CUDA-event time of ``reps``
    back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def _device_events(prof) -> list:
    """The trace's kernel and memcpy rows (CPU operator rows also carry
    their kernels' time, so summing every row would count it twice)."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def _profiled(fn, cold: bool = False) -> list:
    """The device rows of one call of ``fn``, in launch order, after a
    warm-up call; ``cold``: with the 50 MB L2 flushed just before. Late
    in a long run of this script on an H100 the profiler dropped the
    first device rows of a trace (all of a one-kernel trace, the first of
    20 decode_sum calls, once 102 rows early in a run), while it still
    recorded every runtime launch call. So each trace goes through
    ``utils.tracing.profiled_rows``: it opens with ``tracing.LEAD`` spin
    kernels, is whole only when its other device rows match the launch
    calls made after them, and a trace short of rows is taken again,
    ``tracing.TAKES`` times in all, and then fails the run."""
    from pytorch_ps_mpi_tpu_torch.utils import tracing

    def flush():
        torch.empty(2**27, dtype=torch.int8, device="cuda").fill_(1)

    fn()
    return tracing.profiled_rows(fn, before=flush if cold else None,
                                 exact=True)[1]


def device_ms(fn, cold: bool = False) -> float:
    """Device time of the kernels one call of ``fn`` launches, summed
    from torch.profiler's trace (no host time between launches); ``cold``:
    with the L2 flushed, so the inputs come from device memory as the byte
    bound assumes."""
    return sum(e.self_device_time_total for e in _profiled(fn, cold)) / 1e3


def device_launches(fn) -> int:
    """The device rows (kernels and memsets) one call of ``fn`` makes."""
    return len(_profiled(fn))


def host_us(fn, calls: int = 20000) -> float:
    """Host microseconds a call of ``fn`` (best of 3 runs of ``calls``)."""
    best = math.inf
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, (time.perf_counter() - t0) / calls * 1e6)
    return best


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def check_device() -> str:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    phase("device", kind=repr(torch.cuda.get_device_name(0)),
          count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda)
    return smi


def build_kernels() -> None:
    """Build every source (0.00 s for a library that is up to date), then
    print ptxas's report of the tensor-core flash kernels and the
    attention libraries' counts of tensor-core instructions."""
    import re

    from pytorch_ps_mpi_tpu_torch.ops import _build

    import threading

    from pytorch_ps_mpi_tpu_torch.utils import native

    # the host libraries of the async wire, one g++ each, beside the nvccs
    failed = []

    def host():
        try:
            native.build("wirecodec", "psqueue", "tcpps")
        except Exception as e:  # raised below, in this thread
            failed.append(e)
    t0 = time.perf_counter()
    gxx = threading.Thread(target=host)
    gxx.start()
    seconds = _build.build(*_build.SOURCES)
    for name, s in seconds.items():
        phase("build", source=f"csrc/{name}.cu", nvcc_s=f"{s:.2f}")
    gxx.join()
    if failed:
        raise failed[0]
    phase("build", native="wirecodec psqueue tcpps",
          g_plus_plus_s=f"{time.perf_counter() - t0:.2f}")
    kernel = None
    for line in _build.ptxas_report("attention_tc").splitlines():
        found = re.search(r"(flash_\w+_tc)ILi(\d+)EE", line)
        if found:
            kernel, spills = f"{found[1]}<{found[2]}>", ""
        elif kernel and "spill" in line:
            spills = line.strip()
        elif kernel and "Used" in line:
            phase("build", ptxas=kernel,
                  registers=re.search(r"Used (\d+) registers", line)[1],
                  spills=repr(spills))
            kernel = None
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    for name in ("attention_tc", "attention"):
        lib = _build.BUILD_DIR / f"lib{name}.so"
        if not os.path.exists(cuobjdump):
            phase("build", sass=f"lib{name}.so", counts="not available")
            continue
        sass = subprocess.run([cuobjdump, "-sass", str(lib)],
                              capture_output=True, text=True).stdout
        phase("build", sass=f"lib{name}.so",
              HGMMA=len(re.findall(r"\bHGMMA\.", sass)),
              HMMA=len(re.findall(r"\bHMMA\.", sass)))


def timed(kern, plain, args, nbytes, library=None, reps=20, rounds=5,
          flops=None):
    """``ms``/``device_ms``/``plain_ms``/``bound_ms``/``bound_by``/
    ``library_ms`` of a kernel wrapper over one step's calls in sequence
    (``args``: one argument tuple per call; ``nbytes``/``flops``: the
    function's bytes and bf16 operations per call)."""
    def run_all(fn):
        for a in args:
            fn(*a)

    def total(fn):
        return sum(cuda_ms(lambda: fn(*a), reps, rounds) for a in args)

    by_bytes = sum(nbytes(*a) for a in args) / HBM_BYTES_PER_S * 1e3
    by_ops = (0.0 if flops is None
              else sum(flops(*a) for a in args) / BF16_FLOPS * 1e3)
    return dict(ms=total(kern), device_ms=device_ms(lambda: run_all(kern)),
                plain_ms=total(plain), bound_ms=max(by_bytes, by_ops),
                bound_by="operations" if by_ops > by_bytes else "bytes",
                library_ms=None if library is None else total(library))


def _kernel_names(fn) -> str:
    """The device kernels one call of ``fn`` launches, from a profiler
    trace (which backend a library call chose)."""
    return json.dumps(sorted({e.key[:60] for e in _profiled(fn)}))


def report(kernel: str, r: dict, **extra) -> None:
    phase("kernels", kernel=kernel, ms=f"{r['ms']:.4f}",
          device_ms=f"{r['device_ms']:.4f}", plain_ms=f"{r['plain_ms']:.4f}",
          bound_ms=f"{r['bound_ms']:.5f}", bound_by=r["bound_by"],
          library_ms=("null" if r["library_ms"] is None
                      else f"{r['library_ms']:.4f}"),
          max_abs_err=r["max_abs_err"], **extra)


# -- sign ------------------------------------------------------------------------

def kernel_sizes(model) -> list:
    from pytorch_ps_mpi_tpu_torch.ops.sign import GROUP

    sizes = [p.numel() for p in model.parameters() if p.numel() % GROUP == 0]
    if len(sizes) != 20:
        raise AssertionError(f"expected 20 kernel-path leaves, got {sizes}")
    return sizes


def bucket_sizes(model) -> list:
    """The element counts of ``model``'s buckets at ``BUCKET_MB``: the plan
    the bucketed main paths build over its parameters in JAX leaf order."""
    from pytorch_ps_mpi_tpu_torch.bucketing import plan_buckets

    plan = plan_buckets(ordered_params(model), BUCKET_MB)
    return [b.size for b in plan.buckets]


def check_kernels(sizes: list, buckets: list, also: list) -> dict:
    """Bit-exactness and timing of the three sign kernels, at the leaf
    ``sizes`` and the kernel-layout ``buckets`` of the main paths, and
    bit-exactness at the kernel-layout sizes of ``also`` (the async
    phase's ResNet-50 units)."""
    from pytorch_ps_mpi_tpu_torch.ops import sign as S

    gen = torch.Generator(device="cuda").manual_seed(0)
    one, past = sign_edge_rows()
    kernel_buckets = [n for n in buckets if n % S.GROUP == 0]
    if len(kernel_buckets) != PLAN_LAUNCHES["sign"]["encode_signs"]:
        raise AssertionError(f"sign: kernel-layout buckets {kernel_buckets}")
    kernel_also = [n for n in also if n % S.GROUP == 0]
    cases = sorted(set(sizes + kernel_buckets + kernel_also)) + [
        S.GROUP, 13 * S.GROUP] + [
        r * S.GROUP for r in (one - 1, one, one + 1, past) if r > 0]
    max_err = {"encode_signs": 0.0, "pack_signs": 0.0, "unpack_signs": 0.0}
    for n in cases:
        for planted in (False, True):
            x = torch.randn(n, generator=gen, device="cuda")
            if planted:
                x[0], x[1], x[128] = -0.0, float("nan"), 0.0
            packed, total = S.encode_signs(x)
            ref_packed, ref_total = S.encode_signs_ref(x)
            if not torch.equal(packed, ref_packed):
                raise AssertionError(f"encode_signs bytes differ at n={n}")
            if not torch.equal(S.pack_signs(x), ref_packed):
                raise AssertionError(f"pack_signs bytes differ at n={n}")
            out = S.unpack_signs(packed)
            if not torch.equal(out, S.unpack_signs_ref(packed)):
                raise AssertionError(f"unpack_signs differs at n={n}")
            if planted:
                # -0.0 packs as +, NaN as 0 (bit s of byte [r, lane])
                b0 = int(packed[0])
                if (b0 & 1, int(packed[1]) & 1, (b0 >> 1) & 1) != (1, 0, 1):
                    raise AssertionError("-0.0/NaN/+0.0 packed wrongly")
                if not (torch.isnan(total) and torch.isnan(ref_total)):
                    raise AssertionError("a planted NaN must reach the sum")
                continue
            err = abs(float(total) - float(ref_total))
            if err > 1e-6 * abs(float(ref_total)):
                raise AssertionError(
                    f"encode_signs sum at n={n}: {float(total)} vs "
                    f"{float(ref_total)}")
            max_err["encode_signs"] = max(max_err["encode_signs"], err)

    # times at the main path's shapes: one step's 20 leaves in sequence
    xs = [torch.randn(n, generator=gen, device="cuda") for n in sizes]
    args = [(x, S.pack_signs_ref(x)) for x in xs]
    fns = {
        "encode_signs": (lambda x, p: S.encode_signs(x),
                         lambda x, p: S.encode_signs_ref(x),
                         lambda x, p: 4 * x.numel() + x.numel() // 8 + 4),
        "pack_signs": (lambda x, p: S.pack_signs(x),
                       lambda x, p: S.pack_signs_ref(x),
                       lambda x, p: 4 * x.numel() + x.numel() // 8),
        "unpack_signs": (lambda x, p: S.unpack_signs(p),
                         lambda x, p: S.unpack_signs_ref(p),
                         lambda x, p: x.numel() // 8 + 4 * x.numel()),
    }
    results = {}
    for name, (kern, plain, nbytes) in fns.items():
        r = timed(kern, plain, args, nbytes)
        r["max_abs_err"] = max_err[name]
        results[name] = r
        report(name, r, leaves=len(sizes), cases=2 * len(cases),
               buckets_checked=len(kernel_buckets),
               async_r50_sizes_checked=len(set(kernel_also)))
    results["unpack_signs_sum"] = check_unpack_sum(sizes, cases, gen)
    sum_ms = sum(cuda_ms(lambda: torch.sum(x.abs())) for x in xs)
    phase("kernels", yardstick="torch.sum(x.abs()) over the 20 leaves",
          ms=f"{sum_ms:.4f}")
    lib = S._lib()
    one_launch_design(
        "encode_signs", S.encode_signs, xs,
        lambda n: lib.sign_encode_grid(n // S.GROUP, 1),
        lambda n: 4 * n + n // 8 + 4,
        rows_per_block_pass=S._rows_per_block(), one_block_rows=one,
        cases=len(cases))
    return results


def _unpack_sum_case(m: int, world: int, case: str, gen) -> tuple:
    """Packed bits [world, m] and float32 scales [world] on the card:
    ``planted``: rank 0's scale 0.0 (each -0 folds to +0), then a
    subnormal and scales within [1, 2) x the smallest normal float, whose
    sums fall below it (flushed); ``nonfinite``: +Inf, and NaN in rank 5;
    ``unaligned``: a view one byte into its buffer."""
    offset = 1 if case == "unaligned" else 0
    buf = torch.randint(0, 256, (world * m + offset,), generator=gen,
                        device="cuda", dtype=torch.uint8)
    scales = torch.rand(world, generator=gen, device="cuda") + 0.1
    tiny = torch.finfo(torch.float32).tiny
    planted = {"planted": [0.0, 3e-39] + [tiny * (1 + w / 16)
                                          for w in range(1, 7)],
               "nonfinite": [math.inf, 0.5, 0.25, 2.0, 1.0, math.nan, 0.5,
                             0.125]}
    if case in planted:
        scales = torch.tensor(planted[case][:world], device="cuda")
    return buf[offset:].view(world, m), scales


def _same_bits(got: torch.Tensor, want: torch.Tensor) -> bool:
    """NaN at the same places, every other element bit for bit."""
    nan = torch.isnan(want)
    return (torch.equal(torch.isnan(got), nan)
            and torch.equal(got[~nan].view(torch.int32),
                            want[~nan].view(torch.int32)))


def check_unpack_sum(sizes: list, cases: list, gen) -> dict:
    """``unpack_signs_sum`` at world 1 and 8: bit-exact against its plain
    version at every sign case size, plain, planted, non-finite and
    unaligned; then over the 20 leaves at each world its times, one
    device row a call and the largest leaf's cold share of its bound.
    Returns the world-1 row (the main path's world)."""
    from pytorch_ps_mpi_tpu_torch.ops import sign as S

    checked = 0
    for world in (1, 8):
        for n in cases:
            for case in ("plain", "planted", "nonfinite", "unaligned"):
                packed, scales = _unpack_sum_case(n // 8, world, case, gen)
                got = S.unpack_signs_sum(packed, scales)
                if not _same_bits(got, S.unpack_signs_sum_ref(packed,
                                                              scales)):
                    raise AssertionError(f"unpack_signs_sum differs at "
                                         f"n={n}, world={world}, {case}")
                if case == "planted" and world == 1 \
                        and torch.signbit(got).any():
                    raise AssertionError("a -0 survived the fold from +0")
                checked += 1
    rows = {}
    for world in (1, 8):
        args = [_unpack_sum_case(n // 8, world, "plain", gen)
                for n in sizes]
        r = timed(lambda p, s: S.unpack_signs_sum(p, s),
                  lambda p, s: S.unpack_signs_sum_ref(p, s), args,
                  lambda p, s: p.numel() + 4 * s.numel() + 32 * p.shape[1])
        r["max_abs_err"] = 0.0  # bit-exact, asserted above
        report("unpack_signs_sum", r, world=world, leaves=len(sizes),
               cases=checked)
        scales = args[0][1]
        one_launch_design(
            "unpack_signs_sum", lambda p: S.unpack_signs_sum(p, scales),
            [p for p, _ in args],
            lambda n: -(-n // world // S.LANE // 8),
            lambda n: n + 4 * world + 32 * n // world, world=world,
            sizes_in="packed bytes, world x m")
        rows[world] = r
    return rows[1]


def sign_edge_rows() -> tuple:
    """The most packed rows one encode block sums, and the rows one past
    the co-resident grid's first pass over them."""
    from pytorch_ps_mpi_tpu_torch.ops import sign as S

    lib = S._lib()
    one = next(r for r in range(1, 1 << 16)
               if lib.sign_encode_grid(r + 1, 1) != 1)
    return one, lib.sign_encode_grid(1 << 40, 1) * S._rows_per_block() + 3


def one_launch_design(kernel: str, fn, xs: list, grid, nbytes,
                      **tile) -> None:
    """The one-launch design of ``fn`` at the main path's leaves: for each
    leaf size the grid it chose and one call's device µs (warm), from one
    trace of one call a size, which must hold one device row a call (no
    memset, no second kernel), and the largest leaf's cold device ms
    against its byte bound."""
    by_size = {x.numel(): x for x in xs}
    sizes = sorted(by_size)
    rows = _profiled(lambda: [fn(by_size[n]) for n in sizes])
    if len(rows) != len(sizes):
        raise AssertionError(f"{kernel}: {len(rows)} device rows for "
                             f"{len(sizes)} calls, not 1 a call")
    n = sizes[-1]
    cold = device_ms(lambda: fn(by_size[n]), cold=True)
    bound = nbytes(n) / HBM_BYTES_PER_S * 1e3
    phase("kernels", kernel=kernel, design="one launch a call", **tile,
          block=256, device_rows_per_call=1,
          grids=json.dumps({m: grid(m) for m in sizes},
                           separators=(",", ":")),
          device_us=json.dumps(
              {m: round(e.self_device_time_total, 3)
               for m, e in zip(sizes, rows)}, separators=(",", ":")),
          largest_leaf=n, cold_device_ms=f"{cold:.4f}",
          bound_ms=f"{bound:.5f}", share_of_bound=f"{bound / cold:.3f}",
          alternative="programmatic dependent launch: not measured")


# -- int8 quantize / dequantize-sum --------------------------------------------

def _int8_planted(n: int, case: str, gen) -> torch.Tensor:
    x = torch.randn(n, generator=gen, device="cuda")
    if case == "ties":  # absmax 127 makes the scale 1.0: exact .5 ties
        x[0] = 127.0
        x[1:9] = torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5,
                               -126.5])
    elif case == "signed_zero":
        x[0], x[1] = -0.0, 0.0
    elif case == "nan":
        x[0], x[n // 2] = -0.0, float("nan")
    elif case == "inf":
        x[0], x[n - 1] = float("inf"), -2.5
    elif case == "neg_inf":
        x[n // 3] = float("-inf")
    elif case == "zeros":
        x.zero_()
    return x


def check_quant_kernels(model, also: list, slices: list,
                        sections: list) -> dict:
    """The int8 quantize and dequantize-sum kernels at ResNet-18's 62
    leaves and its buckets at ``BUCKET_MB``: bit-exact at world 1 and 8,
    planted cases, and timing (over the leaves). Both kernels also at the
    sizes ``also`` (the async and scale-out phases' ResNet-50 units: the
    workers' and leaders' quantize, hop EF's decode), ``slices`` (S1's
    shard slices: the workers' quantize, the shard servers' decode) and
    ``sections`` (the serving phase's int8 delta sections: the server's
    quantize and probe decode, the readers' decode), the decode at world
    1 as those paths run it."""
    from pytorch_ps_mpi_tpu_torch.ops import quant as Q

    sizes = [p.numel() for p in model.parameters()]
    if len(sizes) != 62:
        raise AssertionError(f"expected 62 leaves, got {len(sizes)}")
    buckets = bucket_sizes(model)
    if len(buckets) != PLAN_LAUNCHES["int8"]["quantize_int8"]:
        raise AssertionError(f"int8: buckets {buckets}")
    gen = torch.Generator(device="cuda").manual_seed(4)

    def same(a, b, what):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        if not torch.equal(a, b):
            raise AssertionError(f"{what} differs from its plain version")

    cases = 0
    tile = Q._tile()
    past = Q._lib().quant_int8_grid(1 << 40) * tile + 4099
    for n in sorted(set(sizes + buckets + also + slices + sections)) + [
            4099, 1000, tile - 1, tile, tile + 1, past]:
        for case in (("plain", "ties", "signed_zero", "nan", "inf",
                      "neg_inf", "zeros") if n >= 16 else ("plain",)):
            x = 1e-2 * _int8_planted(n, case, gen)
            q, s = Q.quantize_int8(x)
            rq, rs = Q.quantize_int8_ref(x)
            same(q, rq, f"quantize_int8 codes at n={n} ({case})")
            same(s, rs, f"quantize_int8 scale at n={n} ({case})")
            cases += 1
    # the dequantize-sum's three load widths: n % 16 == 0 (16 codes a
    # thread), n % 16 == 4 (4 codes), odd n, and codes that start one byte
    # into their buffer (so no row is aligned), at world 1 and 8
    dequant_cases = 0
    r18 = sorted(set(sizes + buckets)) + [4099, 1000, 1028, 2_359_296 + 4]
    for n in r18 + sorted(set(also + slices + sections) - set(r18)):
        for world in ((1, 8) if n in r18 else (1,)):
            for offset in (0, 1):
                buf = torch.randint(-127, 128, (world * n + offset,),
                                    generator=gen, device="cuda",
                                    dtype=torch.int8)
                qs = buf[offset:].view(world, n)
                ss = torch.rand(world, generator=gen, device="cuda")
                if n == 4099 and world == 8:
                    ss[3] = float("nan")  # a NaN scale poisons its sum
                same(Q.dequant_sum(qs, ss), Q.dequant_sum_ref(qs, ss),
                     f"dequant_sum at n={n}, world {world}, offset {offset}")
                if world == 1:
                    same(Q.dequantize_int8(qs[0], ss[0]),
                         Q.dequant_sum_ref(qs, ss),
                         f"dequantize_int8 at n={n}, offset {offset}")
                dequant_cases += 1
    phase("kernels", check="int8 bit-exact",
          sizes=len(set(sizes + buckets)) + 6,
          quantize_async_r50_sizes=len(set(also)),
          r50_units_and_s1_slices=len(set(also + slices)),
          r50_delta_sections=len(set(sections)),
          quantize_cases=cases, dequant_cases=dequant_cases,
          dequant_worlds="1,8 (R18); 1 (R50 units, S1 slices, sections)",
          dequant_widths="n%16==0,n%16==4,odd,offset 1")

    xs = [1e-2 * torch.randn(n, generator=gen, device="cuda") for n in sizes]
    quant_args = [(x,) for x in xs]
    payloads = [Q.quantize_int8_ref(x) for x in xs]
    results = {}
    r_q = timed(Q.quantize_int8, Q.quantize_int8_ref, quant_args,
                lambda x: 5 * x.numel() + 4)
    results["quantize_int8"] = dict(r_q, max_abs_err=0.0)
    report("quantize_int8", results["quantize_int8"], leaves=len(sizes))
    yard = sum(cuda_ms(lambda: torch.amax(x.abs())) for x in xs)
    phase("kernels", yardstick="torch.amax(x.abs()) over the 62 leaves",
          ms=f"{yard:.4f}")

    r = timed(Q.dequantize_int8,
              lambda q, s: Q.dequant_sum_ref(q.reshape(1, -1), s.reshape(1)),
              payloads, lambda q, s: 5 * q.numel() + 4,
              library=lambda q, s: torch.mul(q, s))
    results["dequantize_int8"] = dict(r, max_abs_err=0.0)
    report("dequantize_int8", results["dequantize_int8"], leaves=len(sizes),
           world=1, library="torch.mul(q, scale)")
    phase("kernels", host="quantize_int8 wrapper over dequantize_int8's",
          ratio=f"{r_q['ms'] / r['ms']:.3f}")
    one_launch_design("quantize_int8", Q.quantize_int8, xs,
                      Q._lib().quant_int8_grid, lambda n: 5 * n + 4,
                      tile_floats=tile)

    stacks = [(torch.stack([q] * 8), torch.stack([s] * 8))
              for q, s in payloads]
    r = timed(Q.dequant_sum, Q.dequant_sum_ref, stacks,
              lambda q, s: 12 * q.shape[1] + 4 * 8, reps=10, rounds=3)
    report("dequant_sum", dict(r, max_abs_err=0.0), leaves=len(sizes),
           world=8)
    n = max(sizes)
    big = [(torch.randint(-127, 128, (8, n), generator=gen, device="cuda",
                          dtype=torch.int8),
            torch.rand(8, generator=gen, device="cuda"))]
    r = timed(Q.dequant_sum, Q.dequant_sum_ref, big,
              lambda q, s: 12 * q.shape[1] + 4 * 8, reps=10, rounds=3)
    cold = device_ms(lambda: Q.dequant_sum(*big[0]), cold=True)
    report("dequant_sum", dict(r, max_abs_err=0.0), leaf=n, world=8,
           cold_device_ms=f"{cold:.4f}",
           cold_over_bound=f"{cold / r['bound_ms']:.2f}")
    from pytorch_ps_mpi_tpu_torch.ops import _build

    def current_stream():
        return torch.cuda.current_stream(0).cuda_stream

    phase("kernels", host="stream handle, us a call",
          raw_stream=f"{host_us(lambda: _build.raw_stream(0)):.3f}",
          current_stream=f"{host_us(current_stream):.3f}",
          launches_per_call=device_launches(
              lambda: Q.dequantize_int8(*payloads[0])))
    return results


# -- exact top-k ----------------------------------------------------------------

def topk_leaves(model) -> list:
    """(n, k) of ResNet-50's leaves that take the count kernel."""
    from pytorch_ps_mpi_tpu_torch.ops import topk as T

    leaves = []
    for p in model.parameters():
        n = p.numel()
        k = max(1, int(round(n * TOPK_FRACTION)))
        if 4 * 2048 <= n <= T.MAX_N and k < n:
            leaves.append((n, k))
    if len(leaves) != 53 or sum(n for n, _ in leaves) != 25_498_816:
        raise AssertionError(f"expected 53 kernel-path leaves of 25,498,816 "
                             f"elements, got {len(leaves)}")
    return leaves


def _topk_planted(case: str, gen):
    """(x, k) of a planted case at the largest leaf's size."""
    n, k = 2_359_296, 23_593
    x = torch.randn(n, generator=gen, device="cuda")
    if case == "heavy ties":
        x = 0.25 * torch.randint(0, 4, (n,), generator=gen,
                                 device="cuda").float()
        x[::5] *= -1
    elif case == "NaN, ±Inf, ±0.0":
        x[[3, 70, 900, 901, 5, 6]] = torch.tensor(
            [float("nan"), float("inf"), float("-inf"), float("nan"), -0.0,
             0.0], device="cuda")
    elif case == "all ties":
        x.fill_(-1.5)
    elif case == "all zeros":
        x.zero_()
    elif case == "k = 1":
        k = 1
    elif case == "k = n - 1":
        k = n - 1
    elif case == "more NaNs than k":
        # quiet, signalling, negative and payload NaNs: all above Inf
        nans = torch.tensor([0x7FC00000, 0x7F800001, -0x400000, 0x7FFFFFFF],
                            dtype=torch.int32, device="cuda")
        x[::40] = nans.repeat(n // 160 + 1)[:len(x[::40])].view(torch.float32)
        x[7] = float("inf")
    elif case == "odd n, misaligned":
        x = x[1:-2]  # starts 4 bytes in: the scalar loads
        n = x.numel()
        k = int(round(0.01 * n))
    return x, k


TOPK_PLANTED = ("heavy ties", "NaN, ±Inf, ±0.0", "all ties", "all zeros",
                "k = 1", "k = n - 1", "more NaNs than k", "odd n, misaligned")


def check_topk_kernels(leaves: list, also: list = ()):
    """The top-k radix threshold and the whole exact top-k against their
    plain versions at ResNet-50's 53 kernel-path leaves, at the (n, k)
    of ``also`` (the serving phase's ``small_inputs`` ResNet-50) and the
    planted cases, bit for bit, and timing (over ``leaves``). Returns
    (launches a call, results)."""
    from pytorch_ps_mpi_tpu_torch.ops import topk as T

    gen = torch.Generator(device="cuda").manual_seed(5)

    def check(x, k, what):
        t, hist = T.radix_threshold(x, k)
        rt, rhist = T.radix_threshold_ref(x, k)
        if not (torch.equal(hist, rhist) and torch.equal(t, rt)):
            raise AssertionError(f"radix histograms or t differ: {what}")
        v, i = T.exact_topk(x, k)
        rv, ri = T.exact_topk_ref(x, k)
        if not (torch.equal(i, ri)
                and torch.equal(v.view(torch.int32), rv.view(torch.int32))):
            raise AssertionError(f"exact_topk differs: {what}")
        for _ in range(2):
            if not torch.equal(T.exact_topk(x, k)[1], i):
                raise AssertionError(f"exact_topk changed from run to run: "
                                     f"{what}")

    for n, k in sorted(set(leaves) | set(also)):
        check(torch.randn(n, generator=gen, device="cuda"), k, f"n={n}")
    for case in TOPK_PLANTED:
        check(*_topk_planted(case, gen), case)
    x = torch.randn(2_359_296, generator=gen, device="cuda")
    launches = device_launches(lambda: T.exact_topk(x, 23_593))
    if launches != T.LAUNCHES:
        raise AssertionError(f"one exact_topk call made {launches} device "
                             f"launches, not {T.LAUNCHES}")
    phase("kernels", check="topk bit-exact", sizes=len(set(leaves)),
          serving_sizes=len(set(also) - set(leaves)),
          planted="; ".join(TOPK_PLANTED), run_to_run="identical",
          launches_per_call=launches)

    xs = [(torch.randn(n, generator=gen, device="cuda"), k)
          for n, k in leaves]
    r = timed(T.exact_topk, T.exact_topk_ref, xs,
              lambda x, k: 4 * x.numel() + 8 * k,
              library=lambda x, k: torch.topk(x.abs(), k), reps=5, rounds=3)
    threshold = timed(T.radix_threshold, T.radix_threshold_ref, xs,
                      lambda x, k: 4 * x.numel(), reps=5, rounds=3)
    design_ms = sum(24 * x.numel() + 8 * k
                    for x, k in xs) / HBM_BYTES_PER_S * 1e3
    results = {"exact_topk": dict(r, max_abs_err=0.0)}
    report("exact_topk", results["exact_topk"], leaves=len(leaves),
           library="torch.topk(x.abs(), k)",
           design_bound_ms=f"{design_ms:.5f}",
           threshold_ms=f"{threshold['ms']:.4f}",
           threshold_device_ms=f"{threshold['device_ms']:.4f}",
           threshold_plain_ms=f"{threshold['plain_ms']:.4f}",
           launches_per_call=T.LAUNCHES)
    big = [max(xs, key=lambda a: a[0].numel())]
    r = timed(T.exact_topk, T.exact_topk_ref, big,
              lambda x, k: 4 * x.numel() + 8 * k,
              library=lambda x, k: torch.topk(x.abs(), k), reps=10, rounds=3)
    (x, k), = big
    report("exact_topk", dict(r, max_abs_err=0.0), leaf=x.numel(), k=k,
           library="torch.topk(x.abs(), k)",
           design_bound_ms=f"{(24 * x.numel() + 8 * k) / HBM_BYTES_PER_S * 1e3:.5f}",
           cold_device_ms=f"{device_ms(lambda: T.exact_topk(x, k), True):.4f}")
    return T.LAUNCHES, results


# -- TernGrad encode / pack / unpack-sum ------------------------------------------

def tern_units(sizes) -> list:
    """Per sublane-layout unit (leaf or bucket) of these element counts,
    the element counts of its packs as ``TernGradCodec(use_pallas=True)``
    makes them: ``[n]`` for a unit below the scan threshold (one
    ``tern_encode``), its chunks at or above it (one ``tern_scale``, then
    one ``tern_pack`` a chunk)."""
    from pytorch_ps_mpi_tpu_torch.codecs import get_codec

    code = get_codec("terngrad", use_pallas=True)
    units = []
    for n in sizes:
        if not code._pallas_ok(n):
            continue
        if n < code.scan_threshold:
            units.append([n])
        else:
            full, tail = divmod(n, code.scan_block)
            units.append([code.scan_block] * full + ([tail] if tail else []))
    return units


def tern_launches(units) -> dict:
    """TernGrad's kernel launches a step over sublane-layout ``units``
    (:func:`tern_units`; a chunked unit has 4 chunks or more): an encode a
    whole unit, a scale and a pack a chunk for a chunked one, and an
    unpack-sum a unit."""
    chunked = [u for u in units if len(u) > 1]
    return {"tern_encode": len(units) - len(chunked),
            "tern_scale": len(chunked),
            "tern_pack": sum(len(u) for u in chunked),
            "tern_unpack": len(units)}


#: TernGrad's launches a per-leaf BERT-base step: 61 leaves whole, the two
#: 23,440,896-element leaves as a scale and 23 chunk packs each, and an
#: unpack-sum each of the 63 sublane-layout leaves
TERN_LEAF = {"tern_encode": 61, "tern_scale": 2, "tern_pack": 2 * 23,
             "tern_unpack": 63}


def tern_calls(model) -> list:
    """:func:`tern_units` of ``model``'s leaves: BERT-base's 63
    sublane-layout leaves, 61 whole and 2 in 23 chunks each
    (:data:`TERN_LEAF`)."""
    leaves = tern_units(p.numel() for p in model.parameters())
    got = tern_launches(leaves)
    if got != TERN_LEAF or sum(map(sum, leaves)) != 132_246_528:
        raise AssertionError(f"expected {TERN_LEAF} over 132,246,528 "
                             f"elements, got {got} over "
                             f"{sum(map(sum, leaves))}")
    return leaves


def _tern_planted(n: int, gen):
    """x, bits, scale with the planted cases of ``tests/test_torch_tern_ops``:
    ±0.0, NaN, ±Inf, |x| == s, u24 == p24 (drops), u24 == p24 − 1 (keeps),
    the top random bit set."""
    x = 0.5 * torch.randn(n, generator=gen, device="cuda")
    bits = torch.randint(-2**31, 2**31, (n,), generator=gen, device="cuda",
                         dtype=torch.int32)
    x[:8] = torch.tensor([-0.0, float("nan"), float("inf"), -float("inf"),
                          -4.0, 0.5, 0.5, 1.0])
    bits[4:8] = torch.tensor([-1, (2097152 << 8) | 0xFF,
                              ((2097152 - 1) << 8) | 0xFF, -2**31],
                             dtype=torch.int32)
    return x, bits, torch.tensor(4.0, device="cuda")


#: the encode's cases: ``planted`` the finite planted cases of
#: :func:`_tern_planted` (max|x| == 4 exactly), ``nan`` a NaN element (the
#: scale NaN, every digit 1), ``inf`` ±Inf (the scale Inf, every digit 1),
#: ``tiny`` max|x| < 1e-12 (the scale clamps)
TERN_CASES = ("plain", "planted", "nan", "inf", "tiny")


def _tern_case(n: int, dtype, case: str, gen):
    x, bits, _ = _tern_planted(n, gen)
    if case == "planted":
        x[1:4] = torch.tensor([0.25, 3.0, -3.0])
    else:
        x[:8] = 0.5 * torch.randn(8, generator=gen, device="cuda")
        if case == "nan":
            x[n // 3] = float("nan")
        elif case == "inf":
            x[1], x[n - 1] = float("inf"), -float("inf")
        elif case == "tiny":
            x = x * 1e-30
    return x.to(dtype), bits


def _same_scale(got: torch.Tensor, want: torch.Tensor) -> bool:
    return torch.equal(got.reshape(()).view(torch.int32),
                       want.reshape(()).view(torch.int32))


def _check_encode(what: str, packed, scale, x, bits, case: str) -> None:
    from pytorch_ps_mpi_tpu_torch.ops import tern as TG

    want_packed, want_scale = TG.tern_encode_ref(x, bits)
    if not (torch.equal(packed, want_packed)
            and _same_scale(scale, want_scale)):
        raise AssertionError(f"{what} differs from the plain encode")
    if case == "planted" and (float(scale) != 4.0 or TG.tern_digits(
            packed[:128])[4:8].tolist() != [-1, 0, 1, 0]):
        raise AssertionError(f"{what}: planted digits wrong")
    if case in ("nan", "inf") and (bool(torch.isfinite(scale))
                                   or not bool((packed == 0x55).all())):
        raise AssertionError(f"{what}: a {case} scale kept an element")
    if case == "tiny" and float(scale) != float(torch.tensor(1e-12)):
        raise AssertionError(f"{what}: the scale did not clamp")


def _parent_encode(x, bits: list, block: int) -> dict:
    """The sublane encode as the port made it before the one-launch
    encode: a float32 copy, ``abs().amax()`` and a clamp (a running
    ``maximum`` over the chunks of a chunked leaf), a given-scale pack a
    chunk and a ``cat`` of the chunks' packs."""
    from pytorch_ps_mpi_tpu_torch.ops import tern as TG

    g = x.to(torch.float32)
    if len(bits) == 1:
        scale = torch.clamp(g.abs().amax(), min=1e-12)
        return {"packed": TG.tern_pack(g, bits[0], scale), "scale": scale}
    chunks = torch.split(g, block)
    scale = torch.full((), 1e-12, device=g.device)
    for c in chunks:
        scale = torch.maximum(scale, c.abs().amax())
    return {"packed": torch.cat([TG.tern_pack(c, b, scale)
                                 for c, b in zip(chunks, bits)]),
            "scale": scale}


def check_tern_encode_route(leaves: list, buckets: list, gen) -> None:
    """The codec's sublane encode of BERT-base's 63 leaves and 15 buckets
    (bf16, the main path's type) against the parent's route on the same
    bits: payloads equal byte for byte, the device rows each route makes
    (the new route's asserted: the TernGrad launches alone), and the two
    routes' times, wall (CUDA events) and device (profiler), in turns,
    parent, new, new, parent."""
    from pytorch_ps_mpi_tpu_torch.codecs import get_codec

    code = get_codec("terngrad", use_pallas=True)
    for what, units in (("leaves", leaves), ("buckets", buckets)):
        data = []
        for unit in units:
            x = (1e-3 * torch.randn(sum(unit), generator=gen, device="cuda")
                 ).to(torch.bfloat16)
            data.append((x, [torch.randint(-2**31, 2**31, (c,), generator=gen,
                                           device="cuda", dtype=torch.int32)
                             for c in unit]))

        def new():
            return [code.ternarize(x, lambda i, size, b=b: b[i or 0])
                    for x, b in data]

        def parent():
            return [_parent_encode(x, b, code.scan_block) for x, b in data]

        for got, want in zip(new(), parent()):
            if not (torch.equal(got["packed"], want["packed"])
                    and _same_scale(got["scale"], want["scale"])):
                raise AssertionError(f"the encode of the {what} differs "
                                     f"from the parent's route")
        rows = {"new": device_launches(new), "parent": device_launches(parent)}
        want = tern_launches(units)
        want = sum(v for k, v in want.items() if k != "tern_unpack")
        if rows["new"] != want:
            raise AssertionError(f"the encode of the {what}: {rows['new']} "
                                 f"device rows, expected {want} TernGrad "
                                 f"launches and nothing else")
        packs = sum(len(u) for u in units)  # the parent's TernGrad launches
        ms = {"parent": [], "new": []}
        dev = {"parent": [], "new": []}
        for route in ("parent", "new", "new", "parent"):
            fn = parent if route == "parent" else new
            ms[route].append(cuda_ms(fn, reps=5, rounds=3))
            dev[route].append(device_ms(fn))
        phase("kernels", kernel="tern_encode", design="sublane encode A/B",
              units=f"{len(units)} {what}", dtype="bf16",
              turns="parent,new,new,parent",
              parent_ms=json.dumps([round(v, 4) for v in ms["parent"]]),
              new_ms=json.dumps([round(v, 4) for v in ms["new"]]),
              parent_device_ms=json.dumps([round(v, 4)
                                           for v in dev["parent"]]),
              new_device_ms=json.dumps([round(v, 4) for v in dev["new"]]),
              parent_device_rows=rows["parent"], new_device_rows=rows["new"],
              parent_pytorch_launches=rows["parent"] - packs,
              new_pytorch_launches=0,
              payloads="equal byte for byte")
        del data


def check_tern_kernels(model) -> dict:
    """TernGrad's kernels at BERT-base's units, per leaf (63) and at
    ``BUCKET_MB`` (15): the encode at every whole unit's size and the
    chunked route (scale, then a pack a chunk into its slice) at the
    chunked ones, in float32 and bf16 with the planted cases, and the
    given-scale pack and the unpack-sum (world 1 and 8) there, all
    bit-exact against the plain versions; the encode route against the
    parent's; then timing at a step's calls (bf16), per leaf and
    bucketed."""
    from pytorch_ps_mpi_tpu_torch.codecs import get_codec
    from pytorch_ps_mpi_tpu_torch.ops import tern as TG

    leaves = tern_calls(model)
    buckets = tern_units(bucket_sizes(model))
    if tern_launches(buckets) != PLAN_LAUNCHES["terngrad"]:
        raise AssertionError(f"terngrad buckets give "
                             f"{tern_launches(buckets)}")
    code = get_codec("terngrad", use_pallas=True)
    block = code.scan_block
    units = leaves + buckets
    whole = sorted({u[0] for u in units if len(u) == 1})
    chunked = sorted({sum(u) for u in units if len(u) > 1})
    pack_sizes = sorted({c for u in units if len(u) > 1 for c in u})
    gen = torch.Generator(device="cuda").manual_seed(6)
    cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        for n in whole + chunked:
            for case in TERN_CASES:
                x, bits = _tern_case(n, dtype, case, gen)
                packed, scale = TG.tern_encode(x, bits)
                _check_encode(f"tern_encode n={n} {dtype} {case}", packed,
                              scale, x, bits, case)
                if n in chunked:  # the codec's: a scale, a pack a chunk
                    p = code.ternarize(x, lambda i, size: bits[
                        i * block:i * block + size])
                    _check_encode(f"chunked route n={n} {dtype} {case}",
                                  p["packed"], p["scale"], x, bits, case)
                    if not _same_scale(scale, TG.tern_scale_ref(x)):
                        raise AssertionError(f"tern_scale differs at n={n}")
                cases += 1
        for n in pack_sizes:
            x, bits = _tern_case(n, dtype, "plain", gen)
            s = x.float().abs().amax()
            if not torch.equal(TG.tern_pack(x, bits, s),
                               TG.tern_pack_ref(x, bits, s)):
                raise AssertionError(f"tern_pack differs at n={n}, {dtype}")
    for n in (512, 372_224):
        x, bits, s = _tern_planted(n, gen)
        packed = TG.tern_pack(x, bits, s)
        if not torch.equal(packed, TG.tern_pack_ref(x, bits, s)):
            raise AssertionError(f"tern_pack differs on planted cases, n={n}")
        if TG.tern_digits(packed[:128])[:8].tolist() != [0, 0, 1, -1, -1, 0,
                                                       1, 0]:
            raise AssertionError("tern_pack planted digits wrong")
        for scale in (float("nan"), float("inf")):
            s = torch.tensor(scale, device="cuda")
            if not torch.equal(TG.tern_pack(x, bits, s),
                               TG.tern_pack_ref(x, bits, s)):
                raise AssertionError(f"tern_pack differs at scale {scale}")
    unit_sizes = sorted({sum(u) for u in units})
    for m in [n // 4 for n in unit_sizes]:
        for world in (1, 8):
            packed = torch.randint(0, 256, (world, m), generator=gen,
                                   device="cuda", dtype=torch.uint8)
            scales = torch.rand(world, generator=gen, device="cuda")
            got = TG.tern_unpack_sum(packed, scales)
            want = TG.tern_unpack_sum_ref(packed, scales)
            if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                raise AssertionError(f"tern_unpack_sum differs at m={m}, "
                                     f"world {world}")
    phase("kernels", check="terngrad bit-exact",
          encode_sizes=len(whole + chunked), chunked_route=len(chunked),
          pack_sizes=len(pack_sizes), unpack_sizes=len(unit_sizes),
          unpack_worlds="1,8", dtypes="f32,bf16", encode_cases=cases,
          units="leaves and buckets",
          planted="±0.0, |x|==s, u24==p24, top bit; NaN, ±Inf, max|x|<1e-12 "
                  "(encode); NaN/Inf given scale (pack)")
    check_tern_encode_route(leaves, buckets, gen)
    return tern_timings(leaves, buckets, gen)


def tern_timings(leaves: list, buckets: list, gen) -> dict:
    """Each TernGrad kernel over a step's calls at BERT-base's units in
    bf16 (the main path's gradients), per leaf, then bucketed; the encode
    also as two launches (scale, then pack); each wrapper's host µs a
    call; the encode's device µs a leaf size against its bound."""
    from pytorch_ps_mpi_tpu_torch.ops import tern as TG

    def encode_args(units):
        out = []
        for u in units:
            if len(u) == 1:
                x = (1e-3 * torch.randn(u[0], generator=gen, device="cuda")
                     ).to(torch.bfloat16)
                out.append((x, torch.randint(-2**31, 2**31, (u[0],),
                                             generator=gen, device="cuda",
                                             dtype=torch.int32)))
        return out

    def encode_bytes(x, b):  # x in its type, the bits, the packed, the scale
        return x.numel() * (x.element_size() + 4) + x.numel() // 4 + 4

    results = {}
    lines = {}
    for what, units in (("leaves", leaves), ("buckets", buckets)):
        args = encode_args(units)
        r = timed(TG.tern_encode, TG.tern_encode_ref, args, encode_bytes,
                  reps=10, rounds=3)

        def two_launches(x, b):
            return TG.tern_pack(x, b, TG.tern_scale(x))

        two = {"ms": sum(cuda_ms(lambda: two_launches(*a), 10, 3)
                         for a in args),
               "device_ms": device_ms(lambda: [two_launches(*a)
                                               for a in args])}
        lines[what] = (r, len(args), two)
        if what == "leaves":
            results["tern_encode"] = dict(r, max_abs_err=0.0)
            by_size = {x.numel(): (x, b) for x, b in args}
            sizes = sorted(by_size)
            rows = _profiled(lambda: [TG.tern_encode(*by_size[n])
                                      for n in sizes])
            if len(rows) != len(sizes):
                raise AssertionError(f"tern_encode: {len(rows)} device rows "
                                     f"for {len(sizes)} calls")
            bound = {n: encode_bytes(*by_size[n]) / HBM_BYTES_PER_S * 1e6
                     for n in sizes}
            n = sizes[-1]
            cold = device_ms(lambda: TG.tern_encode(*by_size[n]), cold=True)
            phase("kernels", kernel="tern_encode", dtype="bf16",
                  design="one launch a call, one block <= 4096, else a "
                         "cooperative grid",
                  device_us=json.dumps({m: round(e.self_device_time_total, 3)
                                        for m, e in zip(sizes, rows)},
                                       separators=(",", ":")),
                  bound_us=json.dumps({m: round(bound[m], 3) for m in sizes},
                                      separators=(",", ":")),
                  share_of_bound=json.dumps(
                      {m: round(bound[m] / e.self_device_time_total, 3)
                       for m, e in zip(sizes, rows)}, separators=(",", ":")),
                  largest_leaf=n, cold_device_ms=f"{cold:.4f}",
                  cold_share_of_bound=f"{bound[n] / 1e3 / cold:.3f}")
            small = by_size[sizes[0]]
            pack_small = (*small, TG.tern_encode(*small)[1])
            unpack_small = (TG.tern_encode(*small)[0].reshape(1, -1),
                            pack_small[2].reshape(1))
            phase("kernels", host="TernGrad wrappers, us a call",
                  n=sizes[0], dtype="bf16",
                  tern_encode=f"{host_us(lambda: TG.tern_encode(*small), 5000):.3f}",
                  tern_pack=f"{host_us(lambda: TG.tern_pack(*pack_small), 5000):.3f}",
                  tern_unpack_sum=f"{host_us(lambda: TG.tern_unpack_sum(*unpack_small), 5000):.3f}")
        del args
    # the chunked units are the same two 23,440,896-element leaves per
    # leaf and bucketed: their scales and chunk packs
    chunked = [u for u in leaves if len(u) > 1]
    xs = [(1e-3 * torch.randn(sum(u), generator=gen, device="cuda")
           ).to(torch.bfloat16) for u in chunked]
    r = timed(TG.tern_scale, TG.tern_scale_ref, [(x,) for x in xs],
              lambda x: x.numel() * x.element_size() + 4, reps=10, rounds=3)
    results["tern_scale"] = dict(r, max_abs_err=0.0)
    report("tern_scale", results["tern_scale"], calls=len(xs), dtype="bf16",
           units="leaves and buckets")
    pack_args = []
    for x, u in zip(xs, chunked):
        s = TG.tern_scale(x)
        for c in torch.split(x, u[0]):
            pack_args.append((c, torch.randint(-2**31, 2**31, (c.numel(),),
                                               generator=gen, device="cuda",
                                               dtype=torch.int32), s))
    del xs
    r = timed(TG.tern_pack, TG.tern_pack_ref, pack_args,
              lambda x, b, s: encode_bytes(x, b), reps=10, rounds=3)
    results["tern_pack"] = dict(r, max_abs_err=0.0)
    report("tern_pack", results["tern_pack"], calls=len(pack_args),
           dtype="bf16", units="leaves and buckets")
    del pack_args
    for what, (r, calls, two) in lines.items():
        report("tern_encode", dict(r, max_abs_err=0.0), calls=calls,
               dtype="bf16", units=what, two_launch_ms=f"{two['ms']:.4f}",
               two_launch_device_ms=f"{two['device_ms']:.4f}")

    for what, units in (("leaves", leaves), ("buckets", buckets)):
        unpack_args = []
        for u in units:
            m = sum(u) // 4
            unpack_args.append((torch.randint(0, 256, (1, m), generator=gen,
                                              device="cuda",
                                              dtype=torch.uint8),
                                torch.rand(1, generator=gen, device="cuda")))
        r = timed(TG.tern_unpack_sum, TG.tern_unpack_sum_ref, unpack_args,
                  lambda q, s: q.numel() + 16 * q.shape[1] + 4,
                  reps=10, rounds=3)
        if what == "leaves":
            results["tern_unpack"] = dict(r, max_abs_err=0.0)
        report("tern_unpack", dict(r, max_abs_err=0.0), units=what,
               calls=len(unpack_args), world=1)
        if what == "leaves":
            stacks = [(torch.cat([q] * 8), torch.cat([s] * 8))
                      for q, s in unpack_args]
            r = timed(TG.tern_unpack_sum, TG.tern_unpack_sum_ref, stacks,
                      lambda q, s: q.numel() + 16 * q.shape[1] + 4 * 8,
                      reps=3, rounds=3)
            report("tern_unpack_sum", dict(r, max_abs_err=0.0),
                   units=what, calls=len(stacks), world=8)
            del stacks
        del unpack_args
    return results


# -- flash attention -------------------------------------------------------------

def _flash_inputs(dtype, gen, b=BERT_BATCH, l=BERT_SEQ, h=BERT_HEADS,
                  d=BERT_HEAD_DIM):
    q, k, v, g = (torch.randn(b * h, l, d, generator=gen, device="cuda")
                  .to(dtype) for _ in range(4))
    return q, k, v, g, torch.randn(b * h, l, generator=gen, device="cuda")


def _flash_err(got, want, dtype, what: str, grad: bool) -> float:
    """max|got − want|, held to float32's tolerance (rtol 1e-5 forward,
    1e-4 backward, the same atol) or to bf16's: 2**-6 of the output's
    largest magnitude. Kernel and plain version round p and ds to bf16
    before their products and the results to bf16 (2**-9 relative each),
    but the kernel rounds p against the running max and the plain version
    against the final one, so a few bf16 ulps can differ."""
    got, want = got.float(), want.float()
    err = float((got - want).abs().max())
    if dtype == torch.float32:
        tol = 1e-4 if grad else 1e-5
        bad = (got - want).abs() > tol + tol * want.abs()
        if bool(bad.any()):
            raise AssertionError(f"{what}: max abs err {err}")
    elif err > 2 ** -6 * float(want.abs().max()):
        raise AssertionError(f"{what}: max abs err {err}")
    return err


def check_flash_kernels() -> dict:
    """The flash forward and backward against their plain versions at
    BERT-base's attention shape, then timing at the main path's 12
    launches a step (bf16, non-causal)."""
    from pytorch_ps_mpi_tpu_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(7)
    scale = BERT_HEAD_DIM ** -0.5
    worst = {"flash_fwd": 0.0, "flash_bwd": 0.0}
    cases = 0
    for dtype in (torch.bfloat16, torch.float32):
        for causal, (qo, ko) in ((False, (0, 0)), (True, (0, 0)),
                                 (True, (0, 100)), (True, (256, 0))):
            q, k, v, g, g_lse = _flash_inputs(dtype, gen)
            tag = f"{dtype} causal={causal} offsets={qo},{ko}"
            o, lse = A.flash_fwd(q, k, v, qo, ko, causal, scale)
            ro, rlse = A.flash_fwd_ref(q, k, v, qo, ko, causal, scale)
            err_f = max(_flash_err(o, ro, dtype, f"flash_fwd o, {tag}", False),
                        _flash_err(lse, rlse, torch.float32,
                                   f"flash_fwd lse, {tag}", False))
            grads = A.flash_bwd(q, k, v, o, lse, g, g_lse, qo, ko, causal,
                                scale)
            want = A.flash_bwd_ref(q, k, v, o, lse, g, g_lse, qo, ko, causal,
                                   scale)
            err_b = max(_flash_err(a, b, dtype, f"flash_bwd d{n}, {tag}", True)
                        for a, b, n in zip(grads, want, "qkv"))
            if dtype == torch.bfloat16 and not causal:  # the main path's
                worst = {"flash_fwd": err_f, "flash_bwd": err_b}
            if ko == 100 and o[:, :100].float().abs().any():
                raise AssertionError("rows with no visible key must give 0")
            cases += 1
    phase("kernels", check="flash within tolerance", cases=cases,
          shape=f"[{BERT_BATCH * BERT_HEADS},{BERT_SEQ},{BERT_HEAD_DIM}]",
          dtypes="bf16,f32", bf16_fwd_err=worst["flash_fwd"],
          bf16_bwd_err=worst["flash_bwd"])
    check_flash_tensor_cores(gen)

    layers = 12
    sets = [_flash_inputs(torch.bfloat16, gen) for _ in range(layers)]
    bh, l, d = sets[0][0].shape
    fwd_args = [(q, k, v) for q, k, v, _, _ in sets]
    attn = 4 * bh * l * l * d  # q k^T and p v
    results = {}
    r = timed(lambda q, k, v: A.flash_fwd(q, k, v, 0, 0, False, scale),
              lambda q, k, v: A.flash_fwd_ref(q, k, v, 0, 0, False, scale),
              fwd_args, lambda q, k, v: 4 * q.numel() * 2 + 4 * bh * l,
              library=lambda q, k, v: torch.nn.functional
              .scaled_dot_product_attention(q.view(-1, BERT_HEADS, l, d),
                                            k.view(-1, BERT_HEADS, l, d),
                                            v.view(-1, BERT_HEADS, l, d)),
              flops=lambda q, k, v: attn, reps=5, rounds=3)
    results["flash_fwd"] = dict(r, max_abs_err=worst["flash_fwd"])
    report("flash_fwd", results["flash_fwd"], calls=layers,
           library="scaled_dot_product_attention forward")
    sdpa_backends(sets)

    bwd_args = []
    for q, k, v, g, _ in sets:
        o, lse = A.flash_fwd(q, k, v, 0, 0, False, scale)
        qs, ks, vs = (t.view(-1, BERT_HEADS, l, d).detach().requires_grad_()
                      for t in (q, k, v))
        ref = torch.nn.functional.scaled_dot_product_attention(qs, ks, vs)
        bwd_args.append((q, k, v, o, lse, g, torch.zeros_like(lse),
                         (ref, (qs, ks, vs), g.view(-1, BERT_HEADS, l, d))))

    def sdpa_backward(*a):
        ref, inputs, grad = a[-1]
        torch.autograd.grad(ref, inputs, grad, retain_graph=True)

    phase("kernels", yardstick="scaled_dot_product_attention backends",
          forward=_kernel_names(
              lambda: torch.nn.functional.scaled_dot_product_attention(
                  *(t.view(-1, BERT_HEADS, l, d) for t in fwd_args[0]))),
          backward=_kernel_names(lambda: sdpa_backward(*bwd_args[0])))
    r = timed(lambda *a: A.flash_bwd(*a[:7], 0, 0, False, scale),
              lambda *a: A.flash_bwd_ref(*a[:7], 0, 0, False, scale),
              bwd_args, lambda q, *a: 8 * q.numel() * 2 + 2 * 4 * bh * l,
              library=sdpa_backward, flops=lambda *a: 2.5 * attn,
              reps=5, rounds=3)
    results["flash_bwd"] = dict(r, max_abs_err=worst["flash_bwd"])
    report("flash_bwd", results["flash_bwd"], calls=layers,
           library="scaled_dot_product_attention backward alone")

    flash_host(scale)

    # the "full" crossover: BERT's dense attention against the kernel, one
    # layer's [b, l, h, d] in bf16, forward and forward + backward
    from pytorch_ps_mpi_tpu_torch.models.bert import dense_attention

    q, k, v, g, _ = sets[0]
    q4, k4, v4, g4 = (t.view(BERT_BATCH, BERT_HEADS, l, d).transpose(1, 2)
                      for t in (q, k, v, g))

    def fwd_bwd(fn):
        def run():
            ins = [t.detach().requires_grad_() for t in (q4, k4, v4)]
            torch.autograd.grad(fn(*ins), ins, g4)
        return run

    def flash(a, b, c):
        return A.flash_attention(a, b, c)

    def dense(a, b, c):
        return dense_attention(a, b, c, False)

    phase("attention", shape=f"[{BERT_BATCH},{l},{BERT_HEADS},{d}] bf16",
          dense_fwd_ms=f"{cuda_ms(lambda: dense(q4, k4, v4), 5, 3):.4f}",
          flash_fwd_ms=f"{cuda_ms(lambda: flash(q4, k4, v4), 5, 3):.4f}",
          dense_fwd_bwd_ms=f"{cuda_ms(fwd_bwd(dense), 5, 3):.4f}",
          flash_fwd_bwd_ms=f"{cuda_ms(fwd_bwd(flash), 5, 3):.4f}")
    return results


def flash_host(scale: float) -> None:
    """Host µs a call of the flash wrappers and their pieces, at [1, 64,
    64] bf16 where the device's part is a few µs: the forward and
    backward wrappers, SDPA's forward, one ``torch.empty_like``, and the
    ctypes call of ``flash_fwd_bf16`` alone (with bh = 0, which it
    refuses at once)."""
    from pytorch_ps_mpi_tpu_torch.ops import _build
    from pytorch_ps_mpi_tpu_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(3)
    q, k, v, g, _ = _flash_inputs(torch.bfloat16, gen, b=1, l=64, h=1)
    o, lse = A.flash_fwd(q, k, v, 0, 0, False, scale)
    fn = A._kernels(torch.bfloat16)[0]
    ptrs = [t.data_ptr() for t in (q, k, v, o, lse)]
    q4, k4, v4 = (t.view(1, 1, 64, -1) for t in (q, k, v))
    calls = 5000
    us = {
        "fwd_wrapper": host_us(lambda: A.flash_fwd(q, k, v, 0, 0, False,
                                                   scale), calls),
        "bwd_wrapper": host_us(lambda: A.flash_bwd(q, k, v, o, lse, g, None,
                                                   0, 0, False, scale), calls),
        "sdpa_fwd": host_us(lambda: torch.nn.functional
                            .scaled_dot_product_attention(q4, k4, v4), calls),
        "empty_like": host_us(lambda: torch.empty_like(q), calls),
        "ctypes_call": host_us(lambda: fn(*ptrs, 0, 64, 64, 64, 0, 0, 0,
                                          scale, _build.raw_stream(0)),
                               calls),
    }
    phase("kernels", host_us="flash at [1,64,64] bf16",
          **{k: f"{v:.2f}" for k, v in us.items()})


def _flash_both(q, k, v, g, g_lse, causal=False):
    """o, lse, dq, dk, dv of the kernels (forward, then backward)."""
    from pytorch_ps_mpi_tpu_torch.ops import attention as A

    scale = q.shape[-1] ** -0.5
    o, lse = A.flash_fwd(q, k, v, 0, 0, causal, scale)
    return (o, lse) + A.flash_bwd(q, k, v, o, lse, g, g_lse, 0, 0, causal,
                                  scale)


def check_flash_tensor_cores(gen) -> None:
    """The bf16 (tensor-core) kernels at the phase's b, l and h: every head
    dim, causal and not, against the plain versions (2**-6 of each
    output's largest magnitude); a ragged length (500 = 7 tiles + 52
    rows) whose odd heads' k and v are then set to 1e4, after which the
    even heads' outputs must be the same bit for bit; and o, lse, dq, dk,
    dv bit for bit the same over 3 more runs at the main path's shape."""
    from pytorch_ps_mpi_tpu_torch.ops import attention as A

    worst, cases = 0.0, 0
    for d in A.HEAD_DIMS:
        for causal in (False, True):
            q, k, v, g, g_lse = _flash_inputs(torch.bfloat16, gen, d=d)
            got = _flash_both(q, k, v, g, g_lse, causal)
            scale = d ** -0.5
            tag = f"bf16 d={d} causal={causal}"
            ro, rlse = A.flash_fwd_ref(q, k, v, 0, 0, causal, scale)
            want = A.flash_bwd_ref(q, k, v, got[0], got[1], g, g_lse, 0, 0,
                                   causal, scale)
            _flash_err(got[1], rlse, torch.float32, f"lse, {tag}", False)
            for a, b, n in zip(got[:1] + got[2:], (ro,) + want,
                               ("o", "dq", "dk", "dv")):
                err = _flash_err(a, b, torch.bfloat16, f"{n}, {tag}", n != "o")
                worst = max(worst, err / float(b.float().abs().max()))
            cases += 1
    q, k, v, g, g_lse = _flash_inputs(torch.bfloat16, gen, l=500)
    clean = _flash_both(q, k, v, g, g_lse)
    k[1::2], v[1::2] = 1e4, 1e4
    poisoned = _flash_both(q, k, v, g, g_lse)
    for a, b in zip(clean, poisoned):
        if not (torch.equal(a[0::2], b[0::2])
                and bool(torch.isfinite(b.float()).all())):
            raise AssertionError("a ragged tile read its neighbouring head")
    q, k, v, g, g_lse = _flash_inputs(torch.bfloat16, gen)
    first = _flash_both(q, k, v, g, g_lse)
    for _ in range(3):
        if not all(torch.equal(a, b) for a, b in
                   zip(_flash_both(q, k, v, g, g_lse), first)):
            raise AssertionError("flash differs from run to run")
    phase("kernels", check="flash bf16 on the tensor cores",
          head_dims=",".join(map(str, A.HEAD_DIMS)), cases=cases,
          worst_rel_err=f"{worst:.3e}", tolerance="2**-6",
          ragged_neighbour="l=500, odd heads 1e4: even heads bit-equal",
          run_to_run="o,lse,dq,dk,dv bit-equal over 4 runs")


SDPA_BACKENDS = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION")


def sdpa_backends(sets) -> None:
    """The yardstick per SDPA backend: the 12 calls' forward and, alone,
    backward under ``torch.nn.attention.sdpa_kernel`` (CUDA-event ms,
    summed over the calls as ``timed`` does); "unsupported" where the
    backend does not take the shape. Never called by the port."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    sdpa = torch.nn.functional.scaled_dot_product_attention

    def total(calls) -> str:
        return f"{sum(cuda_ms(c, 5, 3) for c in calls):.4f}"

    fwd, bwd = {}, {}
    for name in SDPA_BACKENDS:
        try:
            with sdpa_kernel(getattr(SDPBackend, name)):
                fwd_calls, bwd_calls = [], []
                for q, k, v, g, _ in sets:
                    x = [t.view(BERT_BATCH, BERT_HEADS, *t.shape[1:])
                         for t in (q, k, v, g)]
                    ins = [t.detach().requires_grad_() for t in x[:3]]
                    out = sdpa(*ins)
                    fwd_calls.append(lambda x=x: sdpa(*x[:3]))
                    bwd_calls.append(lambda o=out, i=ins, g=x[3]:
                                     torch.autograd.grad(o, i, g,
                                                         retain_graph=True))
                fwd[name], bwd[name] = total(fwd_calls), total(bwd_calls)
        except RuntimeError as err:  # the backend does not take the shape
            fwd[name] = bwd[name] = "unsupported"
            phase("kernels", sdpa_backend=name,
                  unsupported=repr(str(err)[:80]))
    phase("kernels", yardstick="sdpa backends", direction="forward",
          calls=len(sets), **fwd)
    phase("kernels", yardstick="sdpa backends", direction="backward alone",
          calls=len(sets), **bwd)


# -- decode_sum and the reference steps -----------------------------------------

def check_decode_sum(model) -> None:
    """1 and 8 workers' sign payloads for every leaf through decode_sum:
    the kernel path bit-exact against the plain fold of ``unpack_signs_ref
    * scale``; one device row a kernel-layout leaf (the rank-by-rank fold
    made 1 + 3 x world); decode_sum's time over the 20 kernel leaves."""
    from pytorch_ps_mpi_tpu_torch.codecs import get_codec
    from pytorch_ps_mpi_tpu_torch.ops import sign as S

    code = get_codec("sign")
    gen = torch.Generator(device="cuda").manual_seed(1)
    for workers in (1, 8):
        calls = []
        for p in model.parameters():
            shape = tuple(p.shape)
            payloads = [code.encode(torch.randn(shape, generator=gen,
                                                device="cuda"))[0]
                        for _ in range(workers)]
            stacked = {k: torch.stack([pl[k] for pl in payloads])
                       for k in ("packed", "scale")}
            got = code.decode_sum(stacked, shape, torch.float32)
            if p.numel() % S.GROUP == 0:
                want = torch.zeros(shape, device="cuda")
                for r in range(workers):
                    want.add_((S.unpack_signs_ref(stacked["packed"][r])
                               * stacked["scale"][r]).reshape(shape))
                if not torch.equal(got, want):
                    raise AssertionError(f"decode_sum differs, shape {shape}"
                                         f", {workers} workers")
                calls.append((stacked, shape))

        def step():
            for stacked, shape in calls:
                code.decode_sum(stacked, shape, torch.float32)

        events = _profiled(step)
        rows = len(events)
        names = {e.name for e in events}
        if rows != len(calls) or not all("sign_unpack_sum" in k
                                         for k in names):
            raise AssertionError(f"decode_sum: {rows} device rows ({names}) "
                                 f"for {len(calls)} kernel leaves, not 1 a "
                                 f"leaf")
        nbytes = sum(st["packed"].numel() + 4 * workers
                     + 32 * st["packed"].shape[1] for st, _ in calls)
        busy = sum(e.self_device_time_total for e in events) / 1e3
        phase("decode_sum", workers=workers, kernel_leaves=len(calls),
              all_leaves=len(list(model.parameters())), bit_exact=True,
              device_rows=rows, ms=f"{cuda_ms(step):.4f}",
              device_ms=f"{busy:.4f}",
              bound_ms=f"{nbytes / HBM_BYTES_PER_S * 1e3:.5f}")


def make_codec(name: str):
    from pytorch_ps_mpi_tpu_torch.codecs import get_codec

    if name == "ef_topk":
        return get_codec("ef", inner=get_codec(
            "topk", fraction=TOPK_FRACTION, pallas=True))
    if name == "terngrad":
        return get_codec("terngrad", use_pallas=True)
    if name in BERT_CODECS:
        codec, kw = BERT_CODECS[name]
        return get_codec(codec, **kw)
    return get_codec(name)


def check_reference(model, code_name: str, model_name: str,
                    exact: bool = False, **opt_kw) -> None:
    """A grads-only step on the card against the same step on the CPU,
    where every wrapper takes its plain version; ``exact``: the same
    arithmetic on both devices, so equal bit for bit. ``opt_kw``
    (``bucket_mb``, ``mode``) go to both optimizers, whose parameters are
    in the JAX package's leaf order, as the main path's bucketed runs
    give them."""
    from pytorch_ps_mpi_tpu_torch import SGD
    from pytorch_ps_mpi_tpu_torch.utils.interop import jax_leaf_order

    gen = torch.Generator().manual_seed(2)
    named = dict(model.named_parameters())
    cpu = {k: named[k].detach().cpu().clone() for k in jax_leaf_order(model)}
    gpu = {k: p.cuda() for k, p in cpu.items()}
    grads = {k: 1e-2 * torch.randn((1,) + tuple(p.shape), generator=gen)
             for k, p in cpu.items()}
    opts = [SGD(params, lr=0.01, momentum=0.9, code=make_codec(code_name),
                device=dev, **opt_kw)
            for params, dev in ((cpu, "cpu"), (gpu, "cuda"))]
    for _ in range(2):
        opts[0].step(grads=grads)
        opts[1].step(grads={k: g.cuda() for k, g in grads.items()})
    worst = 0.0
    for k in cpu:
        a, b = cpu[k], gpu[k].cpu()
        torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-7)
        worst = max(worst, float((a - b).abs().max()))
    if exact and worst != 0.0:
        raise AssertionError(f"SGD({code_name}, {opt_kw}) on the card "
                             f"differs from the CPU by {worst}")
    phase("reference", step=f"grads-only SGD({code_name}) x2",
          model=model_name, **opt_kw,
          buckets=opts[1]._metrics["bucket_count"],
          wire_lowering=opts[1]._metrics["wire_lowering"], rtol=1e-6,
          max_abs_diff=worst)


def shared_noise_terngrad(seed: int):
    """``terngrad(use_pallas=True)`` whose encode draws its random numbers
    on the CPU from its own seeded generator and moves them to the leaf's
    device, so optimizers on two devices get the same numbers."""
    from pytorch_ps_mpi_tpu_torch.codecs import get_codec

    code = get_codec("terngrad", use_pallas=True)
    gen = torch.Generator().manual_seed(seed)

    def encode(grad, state=(), rng=None):
        sublane = code._pallas_ok(grad.numel())

        def noise(chunk, size):
            r = (torch.randint(-2**31, 2**31, (size,), generator=gen,
                               dtype=torch.int32) if sublane
                 else torch.rand(size, generator=gen))
            return r.to(grad.device)

        return code.ternarize(grad, noise), state

    code.encode = encode
    return code


def check_bert_reference(model, tern_launches: dict, **opt_kw) -> None:
    """One grads-only Adam(terngrad(use_pallas=True)) step of BERT-base on
    the card against the same step on the CPU (the plain versions), the
    same random numbers on both sides; rtol 1e-6. ``opt_kw``
    (``bucket_mb``) go to both optimizers, whose parameters are in the JAX
    leaf order; the card's step must launch the TernGrad kernels
    ``tern_launches`` times."""
    from pytorch_ps_mpi_tpu_torch import Adam

    gen = torch.Generator().manual_seed(8)
    gpu = {k: p.detach().clone() for k, p in ordered_params(model).items()}
    cpu = {k: p.cpu() for k, p in gpu.items()}
    grads = {k: 1e-3 * torch.randn((1,) + tuple(p.shape), generator=gen)
             for k, p in cpu.items()}
    opts = [Adam(params, lr=1e-4, code=shared_noise_terngrad(9), device=dev,
                 **opt_kw)
            for params, dev in ((cpu, "cpu"), (gpu, "cuda"))]
    counters = kernel_counters()
    before = {k: counters[k].launches for k in tern_launches}
    opts[0].step(grads=grads)
    opts[1].step(grads={k: g.cuda() for k, g in grads.items()})
    got = {k: counters[k].launches - before[k] for k in tern_launches}
    if got != tern_launches:
        raise AssertionError(f"BERT reference {opt_kw}: launches {got}, "
                             f"expected {tern_launches}")
    worst = 0.0
    for k in cpu:
        a, b = cpu[k], gpu[k].cpu()
        torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-7)
        worst = max(worst, float((a - b).abs().max()))
    phase("reference", step="grads-only Adam(terngrad(use_pallas=True)) x1",
          model="BERT-base", **opt_kw, leaves=len(cpu),
          buckets=opts[1]._metrics["bucket_count"],
          launches=json.dumps(got, separators=(",", ":")), rtol=1e-6,
          max_abs_diff=worst)


def check_bert_flash(model) -> None:
    """BERT-base's loss and gradients (b4 s512, bf16) with the flash
    kernels against the same with their plain versions on the card.
    Tolerance: the loss to 1e-2 relative and all gradients together to 5e-2
    relative L2. The kernels and the plain versions round p and ds to bf16
    at the same points but against other running maxima (a few bf16 ulps
    of 2**-9 in each attention output), and twelve layers of bf16
    activations carry that difference into every gradient."""
    from torch.func import functional_call

    from pytorch_ps_mpi_tpu_torch.data import synthetic_mlm
    from pytorch_ps_mpi_tpu_torch.models import mlm_loss
    from pytorch_ps_mpi_tpu_torch.ops import attention as A

    b = next(synthetic_mlm(BERT_BATCH, BERT_SEQ, model.cfg.vocab_size,
                           seed=1, device="cuda"))

    def loss_and_grads():
        params = {k: p.detach().requires_grad_()
                  for k, p in model.named_parameters()}
        loss = mlm_loss(functional_call(model, params, (b["tokens"],)),
                        b["targets"], b["mask"])
        return float(loss.detach()), torch.autograd.grad(
            loss, list(params.values()))

    before = (A.flash_fwd.launches, A.flash_bwd.launches)
    loss_k, g_k = loss_and_grads()
    if (A.flash_fwd.launches - before[0],
            A.flash_bwd.launches - before[1]) != (12, 24):
        raise AssertionError("a BERT-base loss step must launch 12 forward "
                             "and 24 backward flash kernels")
    kernels = A.flash_fwd, A.flash_bwd
    A.flash_fwd, A.flash_bwd = A.flash_fwd_ref, A.flash_bwd_ref
    try:
        loss_p, g_p = loss_and_grads()
    finally:
        A.flash_fwd, A.flash_bwd = kernels
    diff = math.sqrt(sum(float(((a - c) ** 2).sum()) for a, c in zip(g_k, g_p)))
    norm = math.sqrt(sum(float((c ** 2).sum()) for c in g_p))
    worst_leaf = max(float((a - c).norm() / c.norm().clamp(min=1e-30))
                     for a, c in zip(g_k, g_p))
    rel_loss = abs(loss_k - loss_p) / abs(loss_p)
    if rel_loss > 1e-2 or diff / norm > 5e-2:
        raise AssertionError(f"flash vs plain attention on BERT-base: loss "
                             f"{loss_k} vs {loss_p}, gradient rel L2 "
                             f"{diff / norm}")
    phase("reference", step="BERT-base loss+grads, flash kernels vs plain",
          loss_kernel=f"{loss_k:.6f}", loss_plain=f"{loss_p:.6f}",
          loss_rel=f"{rel_loss:.3e}", grad_rel_l2=f"{diff / norm:.3e}",
          worst_leaf_rel_l2=f"{worst_leaf:.3e}")


# -- the remaining codecs: random-k, block top-k (int8), threshold, PowerSGD --

#: the BERT-base codec runs, the settings of ``benchmarks/bert_bench.py:156-162``
BERT_CODECS = {
    "powersgd-r4": ("powersgd", {"rank": 4}),
    "blocktopk-1%": ("blocktopk", {"fraction": 0.01}),
    "blocktopk8-1%": ("blocktopk8", {"fraction": 0.01}),
    "randomk-1%": ("randomk", {"fraction": 0.01}),
    "threshold": ("threshold", {"tau": 2.0, "max_fraction": 0.05}),
}
SPARSE_CODECS = ("blocktopk-1%", "blocktopk8-1%", "randomk-1%", "threshold")
#: BERT-base leaves of the card-against-CPU phase: the embedding, an FFN
#: kernel, an attention output kernel, the 30,522-element bias (29 blocks
#: and 826 elements) and a [768] bias
REFERENCE_LEAVES = ("tok_emb.embedding", "layer_0.Dense_0.kernel",
                    "layer_0.SelfAttention_0.out.kernel", "mlm_head.bias",
                    "layer_0.Dense_0.bias")
POWERSGD_RTOL = 1e-4


def check_sparse_sync(model) -> None:
    """The sparse codecs' encode and decode-sum of every BERT-base leaf,
    one rank's payload stacked as the gather would stack it (the calls of
    a grads-only step, the collective left out), under
    ``torch.cuda.set_sync_debug_mode("error")``: a host sync raises."""
    shapes = [tuple(p.shape) for p in model.parameters()]
    gen = torch.Generator(device="cuda").manual_seed(4)
    grads = [1e-3 * torch.randn(s, generator=gen, device="cuda")
             for s in shapes]
    for name in SPARSE_CODECS:
        code = make_codec(name)
        states = [code.init_state(s, torch.float32, "cuda") for s in shapes]
        rng = torch.Generator(device="cuda").manual_seed(5)

        def run():
            for g, st, s in zip(grads, states, shapes):
                payload, _ = code.encode(g, st, rng)
                code.decode_sum({k: v.unsqueeze(0) for k, v in payload.items()},
                                s, torch.float32)

        run()  # first calls: the strata and the allocator's pools
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            t0 = time.perf_counter()
            run()
            host_ms = (time.perf_counter() - t0) * 1e3
        finally:
            torch.cuda.set_sync_debug_mode("default")
        phase("sync", codec=name, leaves=len(shapes),
              sync_debug_mode="error", host_syncs=0,
              ms=f"{cuda_ms(run, reps=1, rounds=3):.3f}",
              host_ms=f"{host_ms:.3f}")
    del grads


def _bits(t: torch.Tensor) -> torch.Tensor:
    """``t`` on the CPU as integers of its width, so -0.0 and NaN compare
    by their bits."""
    t = t.detach().cpu().contiguous()
    if t.dtype in (torch.float32, torch.int32):
        return t.view(torch.int32)
    return t


def _same_payload(a: dict, b: dict, what: str) -> None:
    if list(a) != list(b):
        raise AssertionError(f"{what}: payload keys {list(a)} and {list(b)}")
    for k in a:
        if a[k].dtype != b[k].dtype or not torch.equal(_bits(a[k]),
                                                       _bits(b[k])):
            raise AssertionError(f"{what}: payload {k!r} differs")


def check_codec_reference(model) -> None:
    """Each new codec on the card against the same calls on the CPU, at
    BERT-base's own leaves (:data:`REFERENCE_LEAVES`), two ranks' gradients
    drawn on the CPU: random-k (the same uniforms), block top-k and block
    top-k int8 payloads and decode-sums bit for bit; threshold's payload,
    length and decode-sum bit for bit; PowerSGD's two-all-reduce protocol
    (world 1, no process group) over three steps with the state carried,
    and its per-rank factors' decode-sum, within rtol
    :data:`POWERSGD_RTOL` of each tensor's largest magnitude (the card's
    matmuls and QR sum in another order than the CPU's)."""
    named = dict(model.named_parameters())
    gen = torch.Generator().manual_seed(7)
    leaves = {n: tuple(named[n].shape) for n in REFERENCE_LEAVES}
    grads = {n: [1e-3 * torch.randn(s, generator=gen) for _ in range(2)]
             for n, s in leaves.items()}
    for name in SPARSE_CODECS:
        code = make_codec(name)
        for leaf, shape in leaves.items():
            out = {}
            for dev in ("cpu", "cuda"):
                payloads = []
                for g in grads[leaf]:
                    g = g.to(dev)
                    if name.startswith("randomk"):
                        u = torch.rand(code._k_for(shape),
                                       generator=torch.Generator()
                                       .manual_seed(len(payloads)))
                        payloads.append(code.sample(g, u.to(dev)))
                    else:
                        payloads.append(code.encode(g, code.init_state(
                            shape, torch.float32, dev))[0])
                stacked = {k: torch.stack([p[k] for p in payloads])
                           for k in payloads[0]}
                out[dev] = (payloads, code.decode_sum(stacked, shape,
                                                      torch.float32))
            for r in range(2):
                _same_payload(out["cpu"][0][r], out["cuda"][0][r],
                              f"{name} {leaf} rank {r}")
            if not torch.equal(_bits(out["cpu"][1]), _bits(out["cuda"][1])):
                raise AssertionError(f"{name} {leaf}: decode_sum differs")
        phase("reference", codec=name, leaves=json.dumps(
            {n: list(s) for n, s in leaves.items()}, separators=(",", ":")),
            ranks=2, payload_bit_exact=True, decode_sum_bit_exact=True)

    code = make_codec("powersgd-r4")
    worst = {"summed": 0.0, "memory": 0.0, "decode_sum": 0.0}

    def rel(a, b) -> float:
        return float((a.cpu() - b).abs().max() / b.abs().max().clamp(
            min=1e-30))

    for leaf, shape in leaves.items():
        states = {dev: code.init_state(shape, torch.float32, dev)
                  for dev in ("cpu", "cuda")}
        for step in range(3):
            g = grads[leaf][step % 2] * (step + 1)
            got = {dev: code.fused_allreduce(g.to(dev), states[dev])
                   for dev in ("cpu", "cuda")}
            states = {dev: got[dev][1] for dev in got}
            worst["summed"] = max(worst["summed"],
                                  rel(got["cuda"][0], got["cpu"][0]))
            if states["cpu"]:
                worst["memory"] = max(worst["memory"], rel(
                    states["cuda"]["memory"], states["cpu"]["memory"]))
        sums = {}
        for dev in ("cpu", "cuda"):
            pls = [code.encode(g.to(dev), code.init_state(
                shape, torch.float32, dev))[0] for g in grads[leaf]]
            sums[dev] = code.decode_sum(
                {k: torch.stack([p[k] for p in pls]) for k in pls[0]},
                shape, torch.float32)
        worst["decode_sum"] = max(worst["decode_sum"],
                                  rel(sums["cuda"], sums["cpu"]))
    if max(worst.values()) > POWERSGD_RTOL:
        raise AssertionError(f"powersgd on the card against the CPU: {worst}")
    phase("reference", codec="powersgd-r4", steps=3,
          rtol_of_max=POWERSGD_RTOL,
          **{f"max_rel_{k}": f"{v:.3e}" for k, v in worst.items()})


def call_behind_spin(calls) -> tuple:
    """``(index of the first call that returned after half the spin, or
    None; the spin's ms)``: ``calls`` made back to back while a ~0.1 s
    spin kernel holds the stream. A call that waits on the device (a host
    sync, a library reading a result back, or a launch into a full
    launch queue) cannot return before the spin ends."""
    for c in calls:
        c()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(2 * 10**8)
    end.record()
    t0 = time.perf_counter()
    done = []
    for c in calls:
        c()
        done.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    spin_ms = start.elapsed_time(end)
    return next((i for i, t in enumerate(done) if t > spin_ms / 2),
                None), spin_ms


def check_powersgd_qr(model) -> None:
    """PowerSGD's QR on BERT-base: the 51 compressed leaves' [n, 4] QRs
    timed alone, and whether they, or the whole protocol of the 150
    leaves (no process group here), wait on the device: each is called
    behind a spin kernel. Where the protocol waits, the device launches
    made before the waiting leaf are set against the launch queue's
    depth, measured with one-kernel calls: a wait that comes only when
    the queue is full is backpressure, not a sync. Their share of the
    step is read from the powersgd-r4 main path's trace
    (``profile_step``)."""
    from pytorch_ps_mpi_tpu_torch.codecs.powersgd import _matrix_shape

    code = make_codec("powersgd-r4")
    params = ordered_params(model)
    shapes = [tuple(p.shape) for p in params.values()
              if code._compresses(tuple(p.shape))]
    if len(shapes) != 51:
        raise AssertionError(f"powersgd compresses {len(shapes)} leaves")
    gen = torch.Generator(device="cuda").manual_seed(6)
    factors = [torch.randn((_matrix_shape(s)[0], 4), generator=gen,
                           device="cuda") for s in shapes]
    qrs = [lambda p=p: torch.linalg.qr(p) for p in factors]
    grads = {k: 1e-3 * torch.randn(p.shape, generator=gen, device="cuda")
             for k, p in params.items()}
    states = {k: code.init_state(tuple(p.shape), p.dtype, "cuda")
              for k, p in params.items()}
    leaves = [lambda k=k: code.fused_allreduce(grads[k], states[k])
              for k in grads]

    def run(calls):
        return lambda: [c() for c in calls]

    one = torch.zeros(1, device="cuda")
    depth, _ = call_behind_spin([lambda: one.add_(1)] * 4096)
    qr_ms = cuda_ms(run(qrs), reps=5, rounds=5)
    qr_wait, spin_ms = call_behind_spin(qrs)
    leaf_wait, _ = call_behind_spin(leaves)
    fields = {}
    if leaf_wait is not None:
        before = device_launches(run(leaves[:leaf_wait])) if leaf_wait \
            else 0
        through = device_launches(run(leaves[:leaf_wait + 1]))
        # the spin and its two events hold a few entries of the queue
        full = depth is not None and before <= depth + 8 <= through + 16
        fields = dict(protocol_first_waiting_leaf=leaf_wait,
                      protocol_launches_before_it=before,
                      protocol_launches_through_it=through,
                      protocol_waits_for=("launch_queue" if full
                                          else "sync"))
    phase("powersgd_qr", qr_calls=len(shapes), qr_ms=f"{qr_ms:.4f}",
          spin_ms=f"{spin_ms:.4f}", launch_queue_depth=depth,
          qr_first_waiting_call=qr_wait,
          protocol_launches=device_launches(run(leaves)), **fields)


# -- the main paths -------------------------------------------------------------

def kernel_counters() -> dict:
    from pytorch_ps_mpi_tpu_torch.ops import quant as Q
    from pytorch_ps_mpi_tpu_torch.ops import sign as S
    from pytorch_ps_mpi_tpu_torch.ops import topk as T

    from pytorch_ps_mpi_tpu_torch.ops import attention as A
    from pytorch_ps_mpi_tpu_torch.ops import tern as TG

    return {"encode_signs": S.encode_signs, "pack_signs": S.pack_signs,
            "unpack_signs": S.unpack_signs,
            "unpack_signs_sum": S.unpack_signs_sum,
            "quantize_int8": Q.quantize_int8,
            "dequantize_int8": Q.dequant_sum, "exact_topk": T.exact_topk,
            "tern_encode": TG.tern_encode, "tern_scale": TG.tern_scale,
            "tern_pack": TG.tern_pack, "tern_unpack": TG.tern_unpack_sum,
            "flash_fwd": A.flash_fwd, "flash_bwd": A.flash_bwd}


#: bucket_mb of the bucketed and leader runs, and the kernel launches a
#: step that the JAX package's plan_buckets gives on these models' leaves
#: in its leaf order (ResNet-18: 4 buckets, 2 of n % 1024 == 0; BERT-base:
#: 28 buckets, 15 of n % 512 == 0: 13 encoded whole, and two of
#: 23,440,896 elements as a scale launch and 23 chunk packs each)
BUCKET_MB = 16.0
PLAN_LAUNCHES = {
    "sign": {"encode_signs": 2, "unpack_signs_sum": 2},
    "int8": {"quantize_int8": 4, "dequantize_int8": 4},
    "terngrad": {"tern_encode": 13, "tern_scale": 2, "tern_pack": 2 * 23,
                 "tern_unpack": 15},
}


def from_plan(code_name: str):
    """``per_step`` of a bucketed run: the launches the optimizer's own
    plan gives, which must equal :data:`PLAN_LAUNCHES`."""
    def per_step(opt) -> dict:
        got = plan_launches(opt, code_name)
        if got != PLAN_LAUNCHES[code_name]:
            raise AssertionError(f"{code_name}: the port's plan gives "
                                 f"{got}, the JAX plan "
                                 f"{PLAN_LAUNCHES[code_name]}")
        return got
    return per_step


def ordered_params(model) -> dict:
    """``model``'s parameters in the JAX package's leaf order, so a bucket
    plan holds the JAX package's buckets."""
    from pytorch_ps_mpi_tpu_torch.utils.interop import jax_leaf_order

    named = dict(model.named_parameters())
    return {n: named[n] for n in jax_leaf_order(model)}


def plan_launches(opt, code_name: str) -> dict:
    """Kernel launches a step of a bucketed codec, derived from the
    optimizer's own bucket plan: sign's kernels take a bucket of n % 1024
    == 0, int8's every bucket, TernGrad's each sublane-layout bucket
    (:func:`tern_launches`)."""
    sizes = [b.size for b in opt._bucket_plan.buckets]
    code = opt.code
    if code_name == "sign":
        n = sum(1 for m in sizes if code._kernel_ok(m))
        return {"encode_signs": n, "unpack_signs_sum": n}
    if code_name == "int8":
        return {"quantize_int8": len(sizes), "dequantize_int8": len(sizes)}
    if code_name == "terngrad":
        return tern_launches(tern_units(sizes))
    return {}


def run_main_path(model, code_name: str, dataset: str, batch: int,
                  per_step, calls: dict, model_name: str, **opt_kw) -> dict:
    """5 loss_fn steps and 1 grads-only step of SGD on a ResNet; the launch
    counts of the run must equal ``per_step`` (kernel -> launches a step)
    x 6, and its collective calls ``calls`` (kind -> calls a grads-only
    step). ``opt_kw`` (``bucket_mb``, ``mode``) go to the optimizer, whose
    parameters are in the JAX leaf order; ``per_step`` may be a callable
    of the optimizer (the counts its bucket plan gives)."""
    from torch.func import functional_call

    from pytorch_ps_mpi_tpu_torch import SGD
    from pytorch_ps_mpi_tpu_torch.data import (cross_entropy_loss,
                                               synthetic_images)

    opt = SGD(ordered_params(model), lr=0.01, momentum=0.9,
              code=make_codec(code_name), device="cuda", **opt_kw)
    if callable(per_step):
        per_step = per_step(opt)
    # drawn before the timed steps: the ImageNet generator makes a 602 MB
    # class-mean table and 77 MB per batch on the host
    stream = synthetic_images(dataset, batch, seed=0, device="cuda")
    batches = [next(stream) for _ in range(LOSS_STEPS + 1)]

    def loss_fn(params, b):
        x, y = b
        return cross_entropy_loss(functional_call(model, params, (x,)), y)

    return drive(opt, loss_fn, batches, per_step, per_step, calls, code_name,
                 model=model_name, batch=batch)


def run_bert_path(model, code_name: str, per_loss_step: dict,
                  per_grads_step: dict, calls: dict, **opt_kw) -> dict:
    """5 loss_fn steps and 1 grads-only step of Adam(lr=1e-4) on BERT-base
    MLM at batch 4, sequence 512; ``per_grads_step`` may be a callable
    of the optimizer, whose counts are then added to ``per_loss_step``."""
    from torch.func import functional_call

    from pytorch_ps_mpi_tpu_torch import Adam
    from pytorch_ps_mpi_tpu_torch.data import synthetic_mlm
    from pytorch_ps_mpi_tpu_torch.models import mlm_loss

    opt = Adam(ordered_params(model), lr=1e-4, code=make_codec(code_name),
               device="cuda", **opt_kw)
    if callable(per_grads_step):
        per_grads_step = per_grads_step(opt)
        per_loss_step = {**per_loss_step, **per_grads_step}
    stream = synthetic_mlm(BERT_BATCH, BERT_SEQ, model.cfg.vocab_size,
                           seed=0, device="cuda")
    batches = [next(stream) for _ in range(LOSS_STEPS + 1)]

    def loss_fn(params, b):
        logits = functional_call(model, params, (b["tokens"],))
        return mlm_loss(logits, b["targets"], b["mask"])

    return drive(opt, loss_fn, batches, per_loss_step, per_grads_step, calls,
                 code_name, model="BERT-base-mlm-bf16-flash",
                 batch=f"{BERT_BATCH}x{BERT_SEQ}")


def drive(opt, loss_fn, batches, per_loss_step: dict, per_grads_step: dict,
          calls: dict, code_name: str, **fields) -> dict:
    """``LOSS_STEPS`` loss_fn steps and 1 grads-only step; every kernel
    count and the collective counter are set to 0 just before and read
    just after, and must equal ``per_loss_step`` x ``LOSS_STEPS`` +
    ``per_grads_step``, and ``calls`` in the grads-only step (a loss step
    adds the loss's all-reduce)."""
    from pytorch_ps_mpi_tpu_torch import comms

    before = {k: p.detach().clone() for k, p in opt.params.items()}
    counters = kernel_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in counters.values():
        k.launches = 0
    comms.reset_calls()
    losses, step_ms = [], []
    for b in batches[:LOSS_STEPS]:
        loss, data = opt.step(loss_fn=loss_fn, batch=b)
        losses.append(float(loss))
        step_ms.append(data["step_time"] * 1e3)
    loss_calls = dict(comms.calls)
    comms.reset_calls()
    gen = torch.Generator(device="cuda").manual_seed(3)
    grads = {k: 1e-3 * torch.randn((WORLD,) + tuple(p.shape), generator=gen,
                                   device="cuda")
             for k, p in opt.params.items()}
    _, data = opt.step(grads=grads)
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in counters.items()}
    grads_calls = dict(comms.calls)
    del grads

    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if not all(torch.isfinite(p).all() for p in opt.params.values()):
        raise AssertionError("non-finite parameters")
    if all(torch.equal(before[k], p) for k, p in opt.params.items()):
        raise AssertionError("the parameters did not change")
    del before
    want = {name: per_loss_step.get(name, 0) * LOSS_STEPS
            + per_grads_step.get(name, 0) for name in counters}
    if launches != want:
        raise AssertionError(f"{code_name}: launches {launches}, expected "
                             f"{want}")
    want_grads = {k: calls.get(k, 0) for k in grads_calls}
    want_loss = {k: (calls.get(k, 0) + (k == "all_reduce")) * LOSS_STEPS
                 for k in loss_calls}
    if grads_calls != want_grads or loss_calls != want_loss:
        raise AssertionError(f"{code_name}: collective calls {loss_calls} "
                             f"in the loss steps and {grads_calls} in the "
                             f"grads-only step, expected {want_loss} and "
                             f"{want_grads}")
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    median = statistics.median(step_ms)
    profile_step(opt, loss_fn, batches[-1], code_name)
    phase("main_path", code=code_name, **fields,
          params=sum(p.numel() for p in opt.params.values()),
          leaves=len(opt.params), world=WORLD, mode=opt.mode,
          bucket_mb=opt.bucket_mb, bucket_count=int(data["bucket_count"]),
          agg_launches=int(data["agg_launches"]),
          wire_lowering=data["wire_lowering"],
          collectives_per_grads_step=json.dumps(
              {k: v for k, v in grads_calls.items() if v},
              separators=(",", ":")),
          losses=json.dumps([round(v, 5) for v in losses]),
          step_ms=json.dumps([round(v, 3) for v in step_ms]),
          median_step_ms=f"{median:.3f}",
          grads_step_ms=f"{data['step_time'] * 1e3:.3f}",
          peak_mem_gb=f"{peak_gb:.2f}",
          cudnn_tf32=torch.backends.cudnn.allow_tf32,
          matmul_tf32=torch.backends.cuda.matmul.allow_tf32,
          launches=json.dumps({k: v for k, v in launches.items() if v},
                              separators=(",", ":")))
    return launches


def profile_step(opt, loss_fn, batch, code_name: str) -> None:
    """One more loss_fn step under torch.profiler, after the launch counts
    were read: the device's busy time against the step's wall time, and
    the kernels that take the most of it."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, data = opt.step(loss_fn=loss_fn, batch=batch)
    rows = sorted(((e.key, e.self_device_time_total, e.count)
                   for e in _device_events(prof)), key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows) / 1e3
    wall_ms = data["step_time"] * 1e3
    top = [{"name": k[:48], "ms": round(t / 1e3, 4), "calls": c}
           for k, t, c in rows[:8]]
    # PowerSGD's QRs: the device time of the kernels aten::linalg_qr
    # launched (cuSOLVER's or MAGMA's), against the step's busy and wall
    qr = [(e.device_time_total / 1e3, e.count) for e in prof.key_averages()
          if e.key == "aten::linalg_qr"]
    qr_fields = {}
    if qr:
        qr_ms = sum(t for t, _ in qr)
        qr_fields = dict(qr_calls=sum(c for _, c in qr),
                         qr_device_ms=f"{qr_ms:.4f}",
                         qr_share_of_busy=f"{qr_ms / busy_ms:.4f}",
                         qr_share_of_wall=f"{qr_ms / wall_ms:.4f}")
    phase("profile", code=code_name, wall_ms=f"{wall_ms:.3f}",
          device_busy_ms=f"{busy_ms:.3f}",
          idle_share=f"{max(0.0, 1 - busy_ms / wall_ms):.3f}",
          top=json.dumps(top, separators=(",", ":")), **qr_fields)


# -- phase 7: the training layer -----------------------------------------

#: steps of the Trainer run (two run_steps calls of SCAN_CHUNK), and of
#: each equality run
TRAIN_STEPS, SCAN_CHUNK = 8, 4
EQ_STEPS = 3
#: ResNet-18 with SyncBatchNorm: 20 BatchNorm layers, each one all-gather
#: of its statistics in the forward and one all-reduce of their cotangent
#: in the backward; one all-reduce of the running statistics (one dtype)
#: and one of the loss a step
BN_LAYERS = 20
SYNCBN_CALLS = {"all_gather": 124 + BN_LAYERS,
                "all_reduce": 1 + BN_LAYERS + 1}


def _counted(fn):
    """``fn()`` with every kernel count and the collective counter set to
    0 just before and read just after: ``(result, launches, calls)``."""
    from pytorch_ps_mpi_tpu_torch import comms

    counters = kernel_counters()
    torch.cuda.synchronize()
    for k in counters.values():
        k.launches = 0
    comms.reset_calls()
    out = fn()
    torch.cuda.synchronize()
    return (out, {n: k.launches for n, k in counters.items() if k.launches},
            {n: c for n, c in comms.calls.items() if c})


def _expect(what: str, got: dict, per_step: dict, steps: int) -> None:
    want = {k: v * steps for k, v in per_step.items() if v}
    if got != want:
        raise AssertionError(f"{what}: {got}, expected {want}")


def _tensors(tree) -> list:
    from pytorch_ps_mpi_tpu_torch import comms

    out = []
    comms.tree_map(lambda t: out.append(t) if torch.is_tensor(t) else None,
                   tree)
    return out


def _assert_same_state(a, b, what: str) -> None:
    """Every tensor of ``a`` equals its twin in ``b`` bit for bit."""
    ta, tb = _tensors(a), _tensors(b)
    if len(ta) != len(tb) or not all(
            x.shape == y.shape and torch.equal(x, y) for x, y in zip(ta, tb)):
        raise AssertionError(f"{what}: not equal bit for bit")


def _idle(fn) -> dict:
    """``fn`` (one step) under torch.profiler: its wall, the device's busy
    time and the idle share."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = sum(e.self_device_time_total for e in _device_events(prof)) / 1e3
    return dict(profiled_wall_ms=f"{wall:.3f}", device_busy_ms=f"{busy:.3f}",
                idle_share=f"{max(0.0, 1 - busy / wall):.3f}")


def _peak_gb() -> str:
    return f"{torch.cuda.max_memory_allocated() / 2**30:.2f}"


def train_resnet_syncbn(tmp: str) -> None:
    """ResNet-18 (CIFAR stem) with SyncBatchNorm, SGD(sign) at batch 256:
    ``Trainer.fit`` of 8 steps in two ``run_steps`` calls, checkpointing
    every 4; a Trainer that checkpointed its first 4 steps into a
    directory of its own, then a fresh one restored from it and run 4
    more, equal it bit for bit; ``run_steps(4)`` equals 4 ``step`` calls
    bit for bit."""
    from pytorch_ps_mpi_tpu_torch import SGD
    from pytorch_ps_mpi_tpu_torch.data import (cross_entropy_loss,
                                               synthetic_images)
    from pytorch_ps_mpi_tpu_torch.models import ResNet18
    from pytorch_ps_mpi_tpu_torch.models.resnet import (apply_with_stats,
                                                        batch_stats_of)
    from pytorch_ps_mpi_tpu_torch.trainer import Trainer, stack_batches

    stream = synthetic_images("cifar10", BATCH, seed=0, device="cuda")
    batches = [next(stream) for _ in range(TRAIN_STEPS)]

    def build(**trainer_kw):
        model = ResNet18(num_classes=10, small_inputs=True, norm="batch",
                         bn_axis="data", seed=0, device="cuda")
        opt = SGD(ordered_params(model), lr=0.01, momentum=0.9,
                  code=make_codec("sign"), device="cuda")

        def loss_fn(p, aux, b):
            logits, new = apply_with_stats(model, p, aux, b[0])
            return cross_entropy_loss(logits, b[1]), new

        return Trainer(opt, loss_fn, aux_state=batch_stats_of(model),
                       **trainer_kw)

    per_step = {"encode_signs": 20, "unpack_signs_sum": 20}
    torch.cuda.reset_peak_memory_stats()
    straight = build(checkpoint_dir=tmp, checkpoint_every=SCAN_CHUNK,
                     scan_chunk=SCAN_CHUNK)
    out, launches, calls = _counted(
        lambda: straight.fit(iter(batches), TRAIN_STEPS))
    _expect("R18 SyncBN sign fit launches", launches, per_step, TRAIN_STEPS)
    _expect("R18 SyncBN sign fit collectives", calls, SYNCBN_CALLS,
            TRAIN_STEPS)
    if straight.ckpt.steps() != [SCAN_CHUNK, TRAIN_STEPS]:
        raise AssertionError(f"checkpoints {straight.ckpt.steps()}")
    if not math.isfinite(out["final_loss"]):
        raise AssertionError(f"non-finite loss {out['final_loss']}")
    first_dir = os.path.join(tmp, "first")
    first = build(checkpoint_dir=first_dir, checkpoint_every=SCAN_CHUNK,
                  scan_chunk=SCAN_CHUNK)
    first.fit(iter(batches[:SCAN_CHUNK]), SCAN_CHUNK)
    resumed = build(checkpoint_dir=first_dir, scan_chunk=SCAN_CHUNK)
    if not (resumed.maybe_restore() and resumed.step_count == SCAN_CHUNK):
        raise AssertionError("the restore of step 4 failed")
    resumed.fit(iter(batches[SCAN_CHUNK:]), TRAIN_STEPS - SCAN_CHUNK)
    a, b = straight.opt, resumed.opt
    _assert_same_state(a.params, b.params, "resumed parameters")
    _assert_same_state(a.aux_state, b.aux_state,
                       "resumed running statistics")
    _assert_same_state(a.opt_state.momentum_buf, b.opt_state.momentum_buf,
               "resumed momentum")

    scan, loop = build(), build()
    step_ms, scan_ms, loop_ms = [], [], []

    def run_scan(part):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses, _ = scan.opt.run_steps(scan.loss_fn, stack_batches(part),
                                       aux_state=scan.opt.aux_state)
        scan_ms.append((time.perf_counter() - t0) * 1e3)
        return losses

    def run_loop(part):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = []
        for x in part:
            loss, d = loop.opt.step(loss_fn=loop.loss_fn, batch=x,
                                    aux_state=loop.opt.aux_state)
            losses.append(loss)
            step_ms.append(d["step_time"] * 1e3)
        loop_ms.append((time.perf_counter() - t0) * 1e3)
        return torch.stack(losses)

    # two rounds of 4 steps, the second in the other order, so neither
    # side always runs first
    for i, part in enumerate((batches[:SCAN_CHUNK], batches[SCAN_CHUNK:])):
        if i == 0:
            got, want = run_scan(part), run_loop(part)
        else:
            want, got = run_loop(part), run_scan(part)
        _assert_same_state([got, scan.opt.params, scan.opt.aux_state],
                   [want, loop.opt.params, loop.opt.aux_state],
                   f"run_steps(4) against 4 step calls, round {i + 1}")
    idle = _idle(lambda: loop.opt.step(loss_fn=loop.loss_fn,
                                       batch=batches[-1],
                                       aux_state=loop.opt.aux_state))
    phase("training", path="trainer_fit", model="ResNet18-cifar-syncbn-f32",
          code="sign", batch=BATCH, steps=TRAIN_STEPS, scan_chunk=SCAN_CHUNK,
          checkpoints=json.dumps(straight.ckpt.steps()),
          resume_bit_exact=True, run_steps_bit_exact=True,
          final_loss=f"{out['final_loss']:.5f}",
          fit_step_ms=f"{out['step_time'] * 1e3:.3f}",
          run_steps4_ms=json.dumps([round(v, 3) for v in scan_ms]),
          step_calls4_ms=json.dumps([round(v, 3) for v in loop_ms]),
          median_step_ms=f"{statistics.median(step_ms):.3f}",
          peak_mem_gb=_peak_gb(), **idle,
          launches_per_step=json.dumps(per_step, separators=(",", ":")),
          collectives_per_step=json.dumps(SYNCBN_CALLS,
                                          separators=(",", ":")))


def train_bert_accumulate() -> None:
    """BERT-base MLM (bf16, flash) Adam(terngrad(use_pallas=True)) through
    ``step_accumulate`` over 2 microbatches of 4 x 512, then the same
    staged (``instrument=True``) from the same weights and generator seed:
    the same parameters bit for bit."""
    from torch.func import functional_call

    from pytorch_ps_mpi_tpu_torch import Adam
    from pytorch_ps_mpi_tpu_torch.data import synthetic_mlm
    from pytorch_ps_mpi_tpu_torch.models import (BertConfig, BertMLM,
                                                 mlm_loss)
    from pytorch_ps_mpi_tpu_torch.trainer import stack_batches

    def build(instrument: bool):
        model = BertMLM(BertConfig(dtype=torch.bfloat16, attention="flash"),
                        seed=0, device="cuda")
        opt = Adam(ordered_params(model), lr=1e-4, seed=0,
                   code=make_codec("terngrad"), instrument=instrument,
                   device="cuda")

        def loss_fn(params, b):
            logits = functional_call(model, params, (b["tokens"],))
            return mlm_loss(logits, b["targets"], b["mask"])

        return opt, loss_fn

    stream = synthetic_mlm(BERT_BATCH, BERT_SEQ, BertConfig().vocab_size,
                           seed=0, device="cuda")
    micro = [stack_batches([next(stream), next(stream)])
             for _ in range(EQ_STEPS)]
    # the flash kernels each microbatch (12 layers), TernGrad's once a step
    per_step = {"flash_fwd": 12 * 2, "flash_bwd": 24 * 2, **TERN_LEAF}
    calls_per_step = {"all_gather": 300, "all_reduce": 1}
    stages = ("grad_time", "code_wait", "isend_time", "comm_wait",
              "decode_time", "optim_step_time")
    opts, lines = {}, {}
    for instrument in (False, True):
        torch.cuda.reset_peak_memory_stats()
        opt, loss_fn = build(instrument)
        out, launches, calls = _counted(
            lambda: [opt.step_accumulate(loss_fn, m) for m in micro])
        what = f"BERT-base step_accumulate instrument={instrument}"
        _expect(f"{what} launches", launches, per_step, EQ_STEPS)
        _expect(f"{what} collectives", calls, calls_per_step, EQ_STEPS)
        losses = [float(loss) for loss, _ in out]
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"{what}: non-finite loss {losses}")
        data = out[-1][1]
        median_ms = statistics.median(d["step_time"] for _, d in out) * 1e3
        fields = {}
        if instrument:
            if not all(data[k] > 0 for k in stages):
                raise AssertionError(f"{what}: a stage was not timed: "
                                     f"{data}")
            staged = sum(data[k] for k in stages if k != "isend_time")
            if staged > data["step_time"]:
                raise AssertionError(f"{what}: the stages sum to {staged} s "
                                     f"> step_time {data['step_time']} s")
            fields = {k: f"{data[k] * 1e3:.3f}" for k in stages}
            per_micro = data["grad_time_per_microbatch"] * 1e3
            fields.update(stages_sum_ms=f"{staged * 1e3:.3f}",
                          grad_ms_per_microbatch=f"{per_micro:.3f}")
        opts[instrument] = (opt, loss_fn)
        lines[instrument] = dict(
            instrument=instrument, microbatches=2,
            batch=f"{BERT_BATCH}x{BERT_SEQ}", steps=EQ_STEPS,
            losses=json.dumps([round(v, 5) for v in losses]),
            median_step_ms=f"{median_ms:.3f}",
            peak_mem_gb=_peak_gb(), wire_lowering=data["wire_lowering"],
            **fields)
    _assert_same_state(opts[True][0].params, opts[False][0].params,
               "BERT-base staged against fused parameters")
    staged, staged_loss = opts[True]
    lines[True].update(_idle(lambda: staged.step_accumulate(staged_loss,
                                                            micro[-1])))
    opt, loss_fn = opts[False]
    # the fused steps again, after the staged ones: the first run of a
    # phase also pays warm-up
    again = [opt.step_accumulate(loss_fn, m)[1]["step_time"] * 1e3
             for m in micro]
    lines[False]["median_step_ms_again"] = f"{statistics.median(again):.3f}"
    lines[False].update(_idle(lambda: opt.step_accumulate(loss_fn,
                                                          micro[-1])))
    for instrument in (False, True):
        phase("training", path="step_accumulate",
              model="BERT-base-mlm-bf16-flash", code="terngrad",
              **lines[instrument], staged_equals_fused=True,
              launches_per_step=json.dumps(per_step, separators=(",", ":")),
              collectives_per_step=json.dumps(calls_per_step,
                                              separators=(",", ":")))


def train_resnet_dp() -> None:
    """ResNet-18 (GroupNorm) SGD(int8) at batch 256: the functional step
    ``make_sync_train_step`` per leaf and at bucket_mb=16 equals
    ``MPI_PS.step`` from the same state bit for bit over 3 steps; three
    ``instrument=True`` steps equal the fused ones."""
    from torch.func import functional_call

    from pytorch_ps_mpi_tpu_torch import SGD
    from pytorch_ps_mpi_tpu_torch.data import (cross_entropy_loss,
                                               synthetic_images)
    from pytorch_ps_mpi_tpu_torch.models import ResNet18
    from pytorch_ps_mpi_tpu_torch.parallel import make_sync_train_step

    stream = synthetic_images("cifar10", BATCH, seed=0, device="cuda")
    batches = [next(stream) for _ in range(EQ_STEPS)]

    def resnet():
        return ResNet18(num_classes=10, small_inputs=True, seed=0,
                        device="cuda")

    def loss_of(model):
        def loss_fn(p, b):
            return cross_entropy_loss(functional_call(model, p, (b[0],)),
                                      b[1])
        return loss_fn

    for bucket_mb in (0.0, BUCKET_MB):
        model = resnet()
        params = {k: p.detach().clone()
                  for k, p in ordered_params(model).items()}
        init_fn, step_fn = make_sync_train_step(
            loss_of(model), optim="sgd", code=make_codec("int8"), lr=0.01,
            momentum=0.9, bucket_mb=bucket_mb)
        opt_state, codec_state = init_fn(params)

        def run(p=params, o=opt_state, c=codec_state):
            step_ms = []
            for b in batches:
                t0 = time.perf_counter()
                p, o, c, loss = step_fn(p, o, c, b)
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
            return (p, o, c), step_ms

        torch.cuda.reset_peak_memory_stats()
        (state, step_ms), launches, calls = _counted(run)
        got = state[0]
        twin = resnet()
        opt = SGD(ordered_params(twin), lr=0.01, momentum=0.9,
                  code=make_codec("int8"), bucket_mb=bucket_mb,
                  device="cuda")
        for b in batches:
            opt.step(loss_fn=loss_of(twin), batch=b)
        _assert_same_state(got, opt.params,
                           f"make_sync_train_step at bucket_mb={bucket_mb}")
        idle = _idle(lambda: step_fn(*state, batches[-1]))
        per_step = (plan_launches(opt, "int8") if bucket_mb else
                    {"quantize_int8": 62, "dequantize_int8": 62})
        calls_per_step = {"all_gather": 8 if bucket_mb else 124,
                          "all_reduce": 1}
        _expect(f"dp int8 bucket_mb={bucket_mb} launches", launches,
                per_step, EQ_STEPS)
        _expect(f"dp int8 bucket_mb={bucket_mb} collectives", calls,
                calls_per_step, EQ_STEPS)
        phase("training", path="make_sync_train_step",
              model="ResNet18-cifar-gn-f32", code="int8", batch=BATCH,
              bucket_mb=bucket_mb, steps=EQ_STEPS, equals_mpi_ps=True,
              median_step_ms=f"{statistics.median(step_ms):.3f}",
              peak_mem_gb=_peak_gb(), **idle,
              launches_per_step=json.dumps(per_step, separators=(",", ":")),
              collectives_per_step=json.dumps(calls_per_step,
                                              separators=(",", ":")))
        del model, twin, opt, got, state

    fused_model, staged_model = resnet(), resnet()
    fused = SGD(ordered_params(fused_model), lr=0.01, momentum=0.9,
                code=make_codec("int8"), device="cuda")
    staged = SGD(ordered_params(staged_model), lr=0.01, momentum=0.9,
                 code=make_codec("int8"), instrument=True, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for b in batches:
        fused.step(loss_fn=loss_of(fused_model), batch=b)
        _, data = staged.step(loss_fn=loss_of(staged_model), batch=b)
        step_ms.append(data["step_time"] * 1e3)
    _assert_same_state(staged.params, fused.params,
                       "R18 int8 staged against fused parameters")
    idle = _idle(lambda: staged.step(loss_fn=loss_of(staged_model),
                                     batch=batches[-1]))
    phase("training", path="instrument", model="ResNet18-cifar-gn-f32",
          code="int8", batch=BATCH, steps=EQ_STEPS, staged_equals_fused=True,
          wire_lowering=data["wire_lowering"],
          median_step_ms=f"{statistics.median(step_ms):.3f}",
          peak_mem_gb=_peak_gb(), **idle,
          **{k: f"{data[k] * 1e3:.3f}" for k in (
              "grad_time", "code_wait", "isend_time", "comm_wait",
              "decode_time", "optim_step_time")})


def train_cli() -> None:
    """``train.py`` through the launcher in a subprocess (a one-process
    NCCL group of its own): ResNet-18 with SyncBatchNorm and int8, 3
    steps; its last line is a JSON of ``Trainer.fit``'s metrics."""
    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "pytorch_ps_mpi_tpu_torch.launch",
           "--coordinator", f"127.0.0.1:{free_port()}", "--num-processes",
           "1", "--process-id", "0",
           os.path.join(root, "pytorch_ps_mpi_tpu_torch", "train.py"),
           "--config", "resnet18_cifar10", "--norm", "batch", "--codec",
           "int8", "--steps", "3", "--log-every", "0"]
    env = {**os.environ, "PYTHONPATH": root}
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=root, env=env, capture_output=True,
                         text=True, timeout=600)
    seconds = time.perf_counter() - t0
    if out.returncode != 0:
        raise AssertionError(f"train.py through launch exited "
                             f"{out.returncode}: {out.stderr[-4000:]}")
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    if not math.isfinite(summary["final_loss"]):
        raise AssertionError(f"train.py: final_loss {summary['final_loss']}")
    phase("training", path="cli", config="resnet18_cifar10", norm="batch",
          code="int8", steps=3, seconds=f"{seconds:.1f}",
          final_loss=summary["final_loss"],
          step_ms=f"{summary['step_time'] * 1e3:.3f}",
          header=repr(out.stdout.strip().splitlines()[0]))


def run_training() -> None:
    """Phase 7 (``training``), after the main paths, in their process
    group; convolutions deterministic so that equal inputs give equal
    bits."""
    import shutil
    import tempfile

    torch.backends.cudnn.deterministic = True
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        train_resnet_syncbn(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    train_bert_accumulate()
    torch.cuda.empty_cache()
    train_resnet_dp()
    torch.cuda.empty_cache()
    train_cli()
    phase("training", seconds=f"{time.perf_counter() - t0:.1f}")


# -- phase 7b: model parallel and long context ------------------------------------

LC_LAYERS = 12
LC_STEPS = 3
#: train_longcontext at BERT-base widths (examples/train_longcontext.py's
#: flags): GPT, FFN 2 x hidden, bf16 on the flash kernels, remat on
LC_ARGS = ["--seq", "2048", "--sp", "1", "--dp", "1", "--hidden", "768",
           "--layers", str(LC_LAYERS), "--heads", "12", "--vocab", "30522",
           "--batch", "2", "--steps", str(LC_STEPS)]
#: the ring schedule at full width on one card: q, k, v [1, 8192, 12, 64]
#: bf16, causal, cut into 4 shards of 2048
RING_SEQ, RING_SHARDS, RING_HEADS, RING_HEAD_DIM = 8192, 4, 12, 64
#: train_tp at BERT-base widths, one rank
TP_ARGS = ["--dp", "1", "--sp", "1", "--tp", "1", "--hidden", "768",
           "--heads", "12", "--ffn", "3072", "--seq", "512", "--batch", "8",
           "--steps", "3"]
#: the relative distance allowed between the train CLI's first loss on the
#: card (bf16, flash) and the same port's on the CPU (float32, dense
#: attention), the same weights and batch. Set from the card's readings
#: (H100 80GB HBM3, 700 W: gpt_lm 1.06e-07, switch_mlm 4.10e-04); the
#: control (attention rows rolled) moves switch_mlm's loss by 8.98e-03 but
#: gpt_lm's by only 3.28e-04, its first loss sitting at log(vocab)
#: whatever attention does, so the logits bounds below hold gpt_lm
CLI_LOSS_RTOL = 2e-3
#: the relative L2 distance allowed between the first batch's logits on
#: the card and on the CPU, by config, each set between the card's reading
#: and the control's (the same card: gpt_lm 9.231e-03 and 6.194e-01;
#: switch_mlm 1.582e-01 and 1.001, bf16 sending some tokens to another
#: top-1 expert, whose output differs whole); the control must land above
CLI_LOGITS_RTOL = {"gpt_lm": 5e-2, "switch_mlm": 0.35}


def _zero_counts() -> None:
    from pytorch_ps_mpi_tpu_torch import comms

    for k in kernel_counters().values():
        k.launches = 0
    comms.reset_calls()


def _counts() -> tuple:
    from pytorch_ps_mpi_tpu_torch import comms

    return ({n: k.launches for n, k in kernel_counters().items()
             if k.launches}, {n: c for n, c in comms.calls.items() if c})


def longcontext_l1(attention: str, tally: dict) -> None:
    """L1: ``train_longcontext`` through its ``main``, 3 steps. Each step
    runs every layer's attention once forward, once more in the backward
    (remat recomputes the layer) and its backward once: 2 forward and 2
    backward flash launches a layer a step. One all-reduce a leaf and one
    for the loss a step; Ulysses two all-to-alls each time a layer's
    attention runs forward, and two in its backward."""
    from pytorch_ps_mpi_tpu_torch import train_longcontext as tl

    _zero_counts()
    t0 = time.perf_counter()
    summary = tl.main(LC_ARGS + ["--attention", attention])
    seconds = time.perf_counter() - t0
    launches, calls = _counts()
    leaves = 2 + 12 * LC_LAYERS + 2
    want = {"flash_fwd": 2 * LC_LAYERS * LC_STEPS,
            "flash_bwd": 2 * LC_LAYERS * LC_STEPS}
    want_calls = {"all_reduce": (leaves + 1) * LC_STEPS}
    if attention == "ulysses":
        want_calls["all_to_all"] = 6 * LC_LAYERS * LC_STEPS
    if launches != want or calls != want_calls:
        raise AssertionError(f"L1 {attention}: launches {launches} (want "
                             f"{want}), calls {calls} (want {want_calls})")
    if not summary["finite"]:
        raise AssertionError(f"L1 {attention}: losses {summary['losses']}")
    _tally(tally, launches)
    phase("longcontext", run="L1", attention=attention,
          model="GPT-768x12-h12-v30522-bf16-remat", seq=2048, batch=2,
          steps=LC_STEPS, step_ms_median=f"{summary['step_ms_median']:.3f}",
          peak_gb=f"{summary['peak_gb']:.2f}", finite=summary["finite"],
          losses=json.dumps([round(x, 5) for x in summary["losses"]]),
          launches=json.dumps(launches, sort_keys=True,
                              separators=(",", ":")),
          calls=json.dumps(calls, sort_keys=True, separators=(",", ":")),
          seconds=f"{seconds:.1f}")


def _ring_schedule(q, k, v):
    """Each shard's 4 blocks in the ring's order (src = i, i-1, ...) with
    their global offsets, folded by the port's ring combine: the whole
    sequence's output, shard by shard."""
    from pytorch_ps_mpi_tpu_torch.ops.attention import flash_attention
    from pytorch_ps_mpi_tpu_torch.parallel.ring import ring_combine, ring_init

    n, l = RING_SHARDS, RING_SEQ // RING_SHARDS
    outs = []
    for i in range(n):
        qi = q[:, i * l:(i + 1) * l]
        num, den, mx = ring_init(qi)
        for step in range(n):
            src = (i - step) % n
            o, lse = flash_attention(qi, k[:, src * l:(src + 1) * l],
                                     v[:, src * l:(src + 1) * l],
                                     causal=True, q_offset=i * l,
                                     k_offset=src * l, return_lse=True)
            num, den, mx = ring_combine(num, den, mx, o.transpose(1, 2), lse)
        outs.append((num / torch.clamp(den, min=1e-30)[..., None])
                    .transpose(1, 2).to(q.dtype))
    return torch.cat(outs, dim=1)


def _masked_block_weighs_nothing(q, k, v) -> dict:
    """Shard 0's q against shard 1's block (the causal mask covers it
    whole), folded first into fresh accumulators, while ``mx`` is still at
    its floor: only the combine's ``lse <= -1e29`` guard gives it weight 0
    (``exp(lse - mx)`` alone is 1 there). Then the diagonal block folded
    after it must equal that block's flash call alone."""
    from pytorch_ps_mpi_tpu_torch.ops.attention import flash_attention
    from pytorch_ps_mpi_tpu_torch.parallel.ring import ring_combine, ring_init

    l = RING_SEQ // RING_SHARDS
    qi = q[:, :l]
    num, den, mx = ring_init(qi)
    o, lse = flash_attention(qi, k[:, l:2 * l], v[:, l:2 * l], causal=True,
                             q_offset=0, k_offset=l, return_lse=True)
    num, den, mx = ring_combine(num, den, mx, o.transpose(1, 2), lse)
    lse_max = float(lse.max())
    weight = float(den.abs().max()) + float(num.abs().max())
    if not (lse_max <= -1e29 and weight == 0.0):
        raise AssertionError(f"L2 masked block: lse max {lse_max}, weight "
                             f"{weight} (want <= -1e29 and 0)")
    o_d, lse_d = flash_attention(qi, k[:, :l], v[:, :l], causal=True,
                                 return_lse=True)
    num, den, mx = ring_combine(num, den, mx, o_d.transpose(1, 2), lse_d)
    got = (num / den[..., None]).transpose(1, 2).to(q.dtype)
    err = _flash_err(got, o_d, torch.bfloat16, "L2 masked then diagonal",
                     False)
    return {"masked_lse_max": f"{lse_max:.4e}",
            "masked_weight": f"{weight:.1f}",
            "masked_then_diag_err": f"{err:.6f}"}


def longcontext_l2() -> dict:
    """L2: the ring schedule at 8192 tokens on one card, held against one
    flash call over the whole sequence and against the plain version
    (``attention_ref``, float32 scores), the output and the gradients of
    q, k and v through the lse path; 16 forward block launches (12 of
    them at least partly visible, 6 covered whole by the causal mask,
    whose lse sits at the mask's floor; one of them folded first, where
    only the combine's guard zeroes it). Timed: the schedule, the one
    call and the plain version, forward and forward + backward."""
    from pytorch_ps_mpi_tpu_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(11)
    shape = (1, RING_SEQ, RING_HEADS, RING_HEAD_DIM)
    q, k, v, g = (torch.randn(shape, generator=gen, device="cuda")
                  .to(torch.bfloat16) for _ in range(4))

    def grads(fn):
        ins = [t.detach().requires_grad_() for t in (q, k, v)]
        out = fn(*ins)
        return (out.detach(), *torch.autograd.grad(out, ins, g))

    _zero_counts()
    ring = grads(_ring_schedule)
    fwd, bwd = A.flash_fwd.launches, A.flash_bwd.launches
    if (fwd, bwd) != (RING_SHARDS ** 2, 2 * RING_SHARDS ** 2):
        raise AssertionError(f"L2: {fwd} forward and {bwd} backward block "
                             f"launches, want 16 and 32")
    whole = grads(lambda a, b, c: A.flash_attention(a, b, c, causal=True))
    plain = grads(lambda a, b, c: A.attention_ref(
        a, b, c, 0, 0, True, RING_HEAD_DIM ** -0.5)[0])
    errs = {}
    for name, r, w, p in zip(("o", "dq", "dk", "dv"), ring, whole, plain):
        grad = name != "o"
        errs[f"{name}_vs_flash"] = _flash_err(r, w, torch.bfloat16,
                                              f"L2 ring {name} vs flash", grad)
        errs[f"{name}_vs_plain"] = _flash_err(r, p, torch.bfloat16,
                                              f"L2 ring {name} vs plain", grad)
    del ring, whole, plain
    torch.cuda.empty_cache()
    masked = _masked_block_weighs_nothing(q, k, v)

    def fwd_bwd(fn):
        def run():
            ins = [t.detach().requires_grad_() for t in (q, k, v)]
            torch.autograd.grad(fn(*ins), ins, g)
        return run

    def one(a, b, c):
        return A.flash_attention(a, b, c, causal=True)

    def ref(a, b, c):
        return A.attention_ref(a, b, c, 0, 0, True, RING_HEAD_DIM ** -0.5)[0]

    times = dict(
        ring_fwd_ms=cuda_ms(lambda: _ring_schedule(q, k, v), 3, 3),
        one_call_fwd_ms=cuda_ms(lambda: one(q, k, v), 3, 3),
        plain_fwd_ms=cuda_ms(lambda: ref(q, k, v), 1, 3),
        ring_fwd_bwd_ms=cuda_ms(fwd_bwd(_ring_schedule), 2, 3),
        one_call_fwd_bwd_ms=cuda_ms(fwd_bwd(one), 2, 3),
        plain_fwd_bwd_ms=cuda_ms(fwd_bwd(ref), 1, 3))
    # causal: half the q·k and p·v products of the square
    flops = 4 * RING_HEADS * RING_SEQ * RING_SEQ * RING_HEAD_DIM / 2
    phase("longcontext", run="L2", shape="[1,8192,12,64] bf16 causal",
          shards=RING_SHARDS, block_launches_fwd=fwd, block_launches_bwd=bwd,
          tolerance="2**-6 of the largest |value| (bf16)",
          **{k: f"{v:.6f}" for k, v in errs.items()}, **masked,
          **{k: f"{v:.4f}" for k, v in times.items()},
          fwd_bound_ms=f"{flops / BF16_FLOPS * 1e3:.5f}",
          bound_by="operations")
    return times


def _first_batch(config: str, device: torch.device, rolled: bool = False):
    """``train.build``'s model and first batch for ``config`` on
    ``device`` (the CLI's own builder: bf16 and the flash kernels on the
    card, float32 and dense attention on the CPU): the tokens, the
    float32 logits and the loss before any step. ``rolled``, the control:
    every attention's output rows rolled one position along the
    sequence (CPU only). Also each MoE layer's top-1 expert a token
    (``[layers, tokens]``; None without MoE layers)."""
    from pytorch_ps_mpi_tpu_torch import train
    from pytorch_ps_mpi_tpu_torch.models import bert, moe

    args = train.parser().parse_args(["--config", config, "--batch", "8"])
    model, loss_fn, data, _ = train.build(args, device)
    batch = next(data)
    routes = []

    def route(mod, inp, out):
        x = inp[0].reshape(-1, inp[0].shape[-1]).float()
        routes.append((x @ mod.wr.float()).argmax(-1).cpu())

    hooks = [m.register_forward_hook(route) for m in model.modules()
             if isinstance(m, moe.MoEFFN)]
    dense = bert.dense_attention
    if rolled:
        bert.dense_attention = lambda *a: torch.roll(dense(*a), 1, dims=1)
    try:
        with torch.no_grad():
            logits = model(batch["tokens"]).float()
            loss = float(loss_fn(dict(model.named_parameters()), batch))
    finally:
        bert.dense_attention = dense
        for h in hooks:
            h.remove()
    return (batch["tokens"].cpu(), logits.cpu(), loss,
            torch.stack(routes[:len(hooks)]) if hooks else None)


def longcontext_l3(config: str, tally: dict) -> None:
    """L3: ``train --config gpt_lm|switch_mlm`` (4 layers, batch 8, seq
    128; gpt_lm's head dim 32, switch_mlm's 32) on the card, 3 steps: one
    forward and two backward flash launches a layer a step. Then, from
    the CLI's own builder, the first batch's logits and loss on the card
    against the same port on the CPU in float32, and a control (the CPU
    model with its attention rows rolled) that must fail the logits
    bound."""
    from pytorch_ps_mpi_tpu_torch import train

    _zero_counts()
    t0 = time.perf_counter()
    card = train.main(["--config", config, "--steps", str(LC_STEPS),
                       "--batch", "8", "--log-every", "0"])
    seconds = time.perf_counter() - t0
    launches, calls = _counts()
    want = {"flash_fwd": 4 * LC_STEPS, "flash_bwd": 8 * LC_STEPS}
    if launches != want:
        raise AssertionError(f"L3 {config}: launches {launches}, want {want}")
    _tally(tally, launches)
    cpu_dev = torch.device("cpu")
    toks, cpu_logits, cpu_loss, cpu_routes = _first_batch(config, cpu_dev)
    card_toks, card_logits, card_loss, card_routes = _first_batch(
        config, torch.device("cuda", torch.cuda.current_device()))
    _, ctl_logits, ctl_loss, _ = _first_batch(config, cpu_dev, rolled=True)
    if not torch.equal(toks, card_toks):
        raise AssertionError(f"L3 {config}: the card's batch is not the CPU's")

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    loss_rel = abs(card["first_loss"] - cpu_loss) / abs(cpu_loss)
    logits_rel = rel(card_logits, cpu_logits)
    ctl_logits_rel = rel(ctl_logits, cpu_logits)
    ctl_loss_rel = abs(ctl_loss - cpu_loss) / abs(cpu_loss)
    bound = CLI_LOGITS_RTOL[config]
    routed = {}
    if cpu_routes is not None:  # top-1 expert alike at every MoE layer
        alike = (cpu_routes == card_routes).all(0).float().mean()
        routed["tokens_routed_alike"] = f"{float(alike):.4f}"
    phase("longcontext", run="L3", config=config, steps=LC_STEPS,
          first_loss_card=card["first_loss"], first_loss_cpu_f32=cpu_loss,
          loss_rel_diff=f"{loss_rel:.2e}", loss_tolerance=CLI_LOSS_RTOL,
          logits_rel_l2=f"{logits_rel:.3e}",
          logits_tolerance=bound, **routed,
          control_rolled_rows_logits_rel_l2=f"{ctl_logits_rel:.3e}",
          control_rolled_rows_loss_rel_diff=f"{ctl_loss_rel:.2e}",
          card_forward_loss=card_loss, final_loss=card["final_loss"],
          step_ms=f"{card['step_time'] * 1e3:.3f}",
          launches=json.dumps(launches, sort_keys=True,
                              separators=(",", ":")),
          calls=json.dumps(calls, sort_keys=True, separators=(",", ":")),
          seconds=f"{seconds:.1f}")
    if not (math.isfinite(card["final_loss"]) and loss_rel <= CLI_LOSS_RTOL
            and logits_rel <= bound):
        raise AssertionError(f"L3 {config}: first loss {card['first_loss']} "
                             f"on the card, {cpu_loss} on the CPU; logits "
                             f"{logits_rel:.3e} apart")
    if ctl_logits_rel <= bound:
        raise AssertionError(f"L3 {config}: the control's logits are only "
                             f"{ctl_logits_rel:.3e} apart: the bound cannot "
                             "see wrong attention rows")


def longcontext_l4(mode: str) -> None:
    """L4: ``train_tp`` at BERT-base widths on one rank, through
    ``MPI_PS(param_specs=...)``, 3 steps. A step's collectives: allgather,
    one all-reduce a leaf (10), the loss's, the two row-parallel sums and
    the two column-parallel inputs' gradient sums; leader, a reduce-scatter
    and an all-gather a leaf and the same five all-reduces."""
    from pytorch_ps_mpi_tpu_torch import train_tp

    _zero_counts()
    summary = train_tp.main(TP_ARGS + ["--mode", mode])
    launches, calls = _counts()
    steps, leaves = 3, 10
    want = ({"all_reduce": steps * (leaves + 5)} if mode == "allgather" else
            {"all_reduce": steps * 5, "reduce_scatter": steps * leaves,
             "all_gather": steps * leaves})
    if calls != want or launches:
        raise AssertionError(f"L4 {mode}: calls {calls} (want {want}), "
                             f"kernel launches {launches}")
    if not summary["finite"]:
        raise AssertionError(f"L4 {mode}: losses {summary['losses']}")
    phase("longcontext", run="L4", mode=mode, model="TP block 768/12/3072",
          seq=512, batch=8, steps=steps,
          step_ms_median=f"{summary['step_ms_median']:.3f}",
          losses=json.dumps([round(x, 5) for x in summary["losses"]]),
          sharded_over=repr(summary["tp_leaves_sharded_over"]),
          calls=json.dumps(calls, sort_keys=True, separators=(",", ":")))


def flash_d32() -> dict:
    """The flash forward and backward at gpt_lm's attention, [8·8, 128,
    32] bf16 causal, 4 calls (its layers): times, bounds and SDPA's."""
    from pytorch_ps_mpi_tpu_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(5)
    b, h, l, d = 8, 8, 128, 32
    scale = d ** -0.5
    sets = [_flash_inputs(torch.bfloat16, gen, b=b, l=l, h=h, d=d)
            for _ in range(4)]
    attn = 4 * b * h * l * l * d / 2
    fwd = timed(lambda q, k, v: A.flash_fwd(q, k, v, 0, 0, True, scale),
                lambda q, k, v: A.flash_fwd_ref(q, k, v, 0, 0, True, scale),
                [(q, k, v) for q, k, v, _, _ in sets],
                lambda q, k, v: 4 * q.numel() * 2 + 4 * b * h * l,
                library=lambda q, k, v: torch.nn.functional
                .scaled_dot_product_attention(
                    q.view(b, h, l, d), k.view(b, h, l, d),
                    v.view(b, h, l, d), is_causal=True),
                flops=lambda *a: attn, reps=10, rounds=3)
    bwd_args = []
    for q, k, v, g, _ in sets:
        o, lse = A.flash_fwd(q, k, v, 0, 0, True, scale)
        bwd_args.append((q, k, v, o, lse, g, None))
    bwd = timed(lambda *a: A.flash_bwd(*a, 0, 0, True, scale),
                lambda *a: A.flash_bwd_ref(*a, 0, 0, True, scale),
                bwd_args, lambda q, *a: 8 * q.numel() * 2 + 2 * 4 * b * h * l,
                flops=lambda *a: 2.5 * attn, reps=10, rounds=3)
    for name, r in (("flash_fwd", fwd), ("flash_bwd", bwd)):
        phase("longcontext", kernel=name, shape=f"[{b * h},{l},{d}] bf16 "
              "causal x4", ms=f"{r['ms']:.4f}",
              device_ms=f"{r['device_ms']:.4f}",
              plain_ms=f"{r['plain_ms']:.4f}", bound_ms=f"{r['bound_ms']:.5f}",
              bound_by=r["bound_by"],
              library_ms=("null" if r["library_ms"] is None
                          else f"{r['library_ms']:.4f}"))
    return {"flash_fwd": fwd, "flash_bwd": bwd}


def run_longcontext() -> dict:
    """Phase 7b (``longcontext``), after ``training``, in a one-rank NCCL
    group of its own: L1 (ring and Ulysses), L2, L3 (gpt_lm, switch_mlm),
    L4 (allgather, leader) and the flash kernels at head dim 32. Returns
    the launches of the entry points' runs (L1, L3) by kernel."""
    from pytorch_ps_mpi_tpu_torch import mesh

    t0 = time.perf_counter()
    tally: dict = {}
    mesh.initialize_distributed(f"tcp://localhost:{free_port()}",
                                world_size=1, rank=0, backend="nccl")
    try:
        for attention in ("ring", "ulysses"):
            longcontext_l1(attention, tally)
            torch.cuda.empty_cache()
        longcontext_l2()
        torch.cuda.empty_cache()
        for config in ("gpt_lm", "switch_mlm"):
            longcontext_l3(config, tally)
            torch.cuda.empty_cache()
        for mode in ("allgather", "leader"):
            longcontext_l4(mode)
            torch.cuda.empty_cache()
        flash_d32()
    finally:
        torch.distributed.destroy_process_group()
    phase("longcontext", launches=json.dumps(tally, sort_keys=True,
                                             separators=(",", ":")),
          seconds=f"{time.perf_counter() - t0:.1f}")
    return tally



# -- phase 8: the asynchronous parameter server --------------------------------

ASYNC_STEPS = 6  # pushes a worker in A1-A3
ASYNC_WORKERS = 4
ASYNC_LIMIT = 300.0  # seconds a fleet may take, spawn to join


def async_cfg(model: str, stats: str, **kw) -> dict:
    """``benchmarks/async_bench.py:94-107``'s configuration: ``num_classes``
    10, (32, 32, 3) inputs, ``small_inputs``, seed 5, SGD lr 1e-4; batch
    32, ``ASYNC_STEPS`` pushes a worker, frames checked, the card in every
    process."""
    cfg = {"model": model, "model_kw": {"num_classes": 10},
           "in_shape": [32, 32, 3], "batch": 32, "seed": 5, "optim": "sgd",
           "hyper": {"lr": 1e-4}, "steps": ASYNC_STEPS,
           "open_timeout": ASYNC_LIMIT, "push_timeout": ASYNC_LIMIT,
           "device": "cuda", "frame_check": True, "stats_dir": stats}
    cfg.update(kw)
    return cfg


def run_fleet(label: str, cfg: dict, code_name: str, workers: int,
              sync_barrier: bool, card: str, max_staleness: int = 4,
              profile_server: bool = False) -> dict:
    """One fleet: the server in this process, ``workers`` fresh
    interpreters on the same card. Every count of this process is set to
    0 just before and read just after; the workers report their own
    (``stats_dir``). Prints the run's lines and returns its metrics;
    ``profile_server``: the card's idle share under the server's updates
    (``cfg["idle_share"]``, from its first update on)."""
    from pytorch_ps_mpi_tpu_torch.codecs import get_codec
    from pytorch_ps_mpi_tpu_torch.parallel import async_train as at

    cfg = {**cfg, "codec": code_name, "idle_share": profile_server}
    code = get_codec(code_name)
    template = at.make_problem(cfg, cfg["device"]).template
    kw = dict(max_staleness=max_staleness, code=code, frame=True,
              device=cfg["device"])
    if cfg.get("transport") == "tcp":
        from pytorch_ps_mpi_tpu_torch.parallel.tcp import TcpPSServer

        server = TcpPSServer(0, workers, template, **kw)
        name = f"127.0.0.1:{server.port}"
    else:
        from pytorch_ps_mpi_tpu_torch.parallel.dcn import ShmPSServer

        name = f"/psq_chip_smoke_{os.getpid()}_{label}"
        server = ShmPSServer(name, workers, template, **kw)
    counters = kernel_counters()
    for k in counters.values():
        k.launches = 0
    procs = []
    try:
        procs = [at.spawn_worker(name, i, cfg) for i in range(workers)]
        total = sum(at.worker_cfg(cfg, i)[1] for i in range(workers))
        _, m = at.serve(server, cfg, total_grads=0, total_received=total,
                        sync_barrier=sync_barrier, timeout=ASYNC_LIMIT)
        codes = at.join_workers(procs, timeout=ASYNC_LIMIT)
        if codes != [0] * workers:
            raise AssertionError(f"{label}: worker exit codes {codes}")
    finally:
        server.close()
        at.join_workers(procs, timeout=5.0)
    stats = [json.loads(open(os.path.join(cfg["stats_dir"],
                                          f"worker-{i}.json")).read())
             for i in range(workers)]
    pushes = sum(s["pushes"] for s in stats)
    if m["grads_received"] != pushes or pushes != total:
        raise AssertionError(f"{label}: {pushes} pushes, "
                             f"{m['grads_received']} received, {total} "
                             "expected")
    if m["applied"] + m["stale_drops"] != pushes:
        raise AssertionError(f"{label}: applied {m['applied']} + dropped "
                             f"{m['stale_drops']} != {pushes}")
    if m["frames_rejected"]:
        raise AssertionError(f"{label}: {m['frames_rejected']} frames "
                             "rejected")
    if not (math.isfinite(m["loss_final"]) and math.isfinite(
            m["loss_initial"])):
        raise AssertionError(f"{label}: non-finite loss {m}")
    # medians over every push of the fleet (a worker's first step pays
    # its cuDNN and allocator warm-up)
    per = {k: statistics.median(t for s in stats for t in s[k]) * 1e3
           for k in ("read_s", "grad_s", "encode_s", "push_s")}
    applied = max(m["applied"], 1.0)
    srv = {k: v / applied * 1e3 for k, v in m["server_times"].items()}
    phase("async", run=label, card=repr(card), model=cfg["model"],
          code=code_name, transport=cfg.get("transport", "shm"),
          discipline="sync_barrier" if sync_barrier else "async",
          workers=workers, pushes=pushes, applied=int(m["applied"]),
          stale_drops=int(m["stale_drops"]),
          staleness_hist=json.dumps(m["staleness_hist"], sort_keys=True,
                                    separators=(",", ":")),
          updates_per_sec=f"{m['updates_per_sec']:.3f}",
          steady_updates_per_sec=f"{m['steady_updates_per_sec']:.3f}",
          wall_s=f"{m['wall_s']:.3f}",
          loss_before=f"{m['loss_initial']:.6f}",
          loss_after=f"{m['loss_final']:.6f}",
          agg_mode=m["agg_mode"], decodes_per_publish=m["decodes_per_publish"],
          agg_fallbacks=m["agg_fallbacks"],
          wire_bytes=int(m["wire_bytes_per_grad"]),
          compression=f"{m['compression_ratio']:.2f}")
    phase("async", run=label, card=repr(card), what="per_push_ms",
          worker_read=f"{per['read_s']:.3f}", worker_grad=f"{per['grad_s']:.3f}",
          worker_encode_d2h=f"{per['encode_s']:.3f}",
          worker_push=f"{per['push_s']:.3f}",
          server_ingest_decode=f"{srv.get('ingest_s', 0.0):.3f}",
          server_fold=f"{srv.get('fold_s', 0.0):.3f}",
          server_update=f"{srv.get('update_s', 0.0):.3f}",
          server_publish=f"{srv.get('publish_s', 0.0):.3f}")
    phase("async", run=label, card=repr(card), what="peak_gb",
          server=f"{m['server_peak_bytes'] / 2**30:.2f}",
          workers=json.dumps([round(s["peak_bytes"] / 2**30, 2)
                              for s in stats]))
    m["worker_launches"] = [s["launches"] for s in stats]
    m["worker_pushes"] = [s["pushes"] for s in stats]
    if profile_server:
        phase("async", run=label, card=repr(card), what="server_profile",
              **_idle_fields(f"{label} server", m))
    return m


def _expect_launches(label: str, got: dict, want: dict) -> None:
    got = {k: v for k, v in got.items() if v}
    want = {k: v for k, v in want.items() if v}
    if got != want:
        raise AssertionError(f"{label}: launches {got}, expected {want}")


def async_sizes(model: str) -> list:
    """The element counts of a model's async wire units: its JAX leaves
    under ``async_cfg``."""
    from pytorch_ps_mpi_tpu_torch.parallel import async_train as at
    from pytorch_ps_mpi_tpu_torch.utils.serialization import tree_flatten

    leaves = tree_flatten(at.make_problem(async_cfg(model, ""),
                                          "cuda").template)[0]
    return [int(x.size) for x in leaves]


def flax_permute_ms(card: str) -> None:
    """The device time of the worker's flax permutation of ResNet-50's
    tagged gradients (one read and one write of each)."""
    from pytorch_ps_mpi_tpu_torch.parallel import async_train as at

    prob = at.make_problem(async_cfg("resnet50", ""), "cuda")
    grads = [torch.randn_like(p) for p in prob.params]
    tagged = [(g, v) for g, v in zip(grads, prob.perms) if v]
    nbytes = 2 * 4 * sum(g.numel() for g, _ in tagged)

    def permute():
        for g, v in tagged:
            g.permute(v).contiguous()

    phase("async", what="flax_permute", card=repr(card), model="resnet50",
          tensors=len(tagged), device_ms=f"{device_ms(permute):.4f}",
          bound_ms=f"{nbytes / HBM_BYTES_PER_S * 1e3:.5f}")


A4_L1_LIMIT = 0.03  # A4's end-to-end line, see check_async_ps
A4_FLIP = 0.02  # the share of packed sign bits the planted fault flips


def _flipping_sign():
    """The sign codec with ``A4_FLIP`` of its packed bits flipped in every
    payload, from a fixed seed: A4's planted fault."""
    from pytorch_ps_mpi_tpu_torch.codecs import get_codec

    class FlippedSign(type(get_codec("sign"))):
        def encode(self, grad, state=(), rng=None):
            payload, state = super().encode(grad, state, rng)
            packed = payload["packed"]
            gen = torch.Generator(device=packed.device).manual_seed(0)
            bits = (torch.rand(packed.numel(), 8, generator=gen,
                               device=packed.device) < A4_FLIP)
            weights = 1 << torch.arange(8, device=packed.device)
            mask = (bits.to(torch.int64) * weights).sum(1).to(torch.uint8)
            payload["packed"] = packed ^ mask.reshape(packed.shape)
            return payload, state

    return FlippedSign()


def check_async_ps(card: str) -> None:
    """A4: ``AsyncPS`` in one program, ResNet-18 (CIFAR stem, full width),
    4 workers, fixed lags [0, 1, 2, 1], ``max_staleness`` 2, sign; two
    rounds on the card, their launches counted. Every worker's gradient
    of both rounds, as the card computed it, then goes through the card's
    codec (the kernels) and the CPU's (the plain versions): the packed
    bits agree bit for bit, the scale (a float sum in another order, as
    ``check_kernels`` holds ``encode_signs``'s) within 1e-6 relative, and
    the card's decode of the card's payload equals the CPU's decode of the
    same payload bit for bit. A second, end-to-end line: the same two
    rounds on the CPU twin, which computes its own gradients (their
    rounding flips the signs of near-zero elements), TF32 off and cuDNN
    deterministic: the L1 norm of the two results' difference is at most
    ``A4_L1_LIMIT`` of the L1 norm of the CPU's move, and the card run
    with ``A4_FLIP`` of its packed bits flipped must exceed it, which
    shows the line can see such a fault. Then 3 rounds with lags sampled
    uniformly, and their histogram."""
    from pytorch_ps_mpi_tpu_torch.codecs import get_codec
    from pytorch_ps_mpi_tpu_torch.models import ResNet18
    from pytorch_ps_mpi_tpu_torch.ops import sign as S
    from pytorch_ps_mpi_tpu_torch.parallel.async_ps import AsyncPS

    workers, lr, batch = 4, 1e-4, 16
    rng = np.random.RandomState(9)
    xs = [rng.randn(workers, batch, 32, 32, 3).astype(np.float32)
          for _ in range(2)]
    ys = [rng.randint(0, 10, (workers, batch)) for _ in range(2)]

    def build(device):
        model = ResNet18(num_classes=10, small_inputs=True, seed=0,
                         device=device)

        def loss_fn(params, b):
            out = torch.func.functional_call(model, params, (b[0],))
            return torch.nn.functional.cross_entropy(out, b[1])
        return model, loss_fn

    def rounds(device, code, captured=None):
        """The two fixed-lag rounds: (start, end, the server, seconds)."""
        model, loss_fn = build(device)
        start = {k: p.detach().cpu().clone()
                 for k, p in model.named_parameters()}
        ps = AsyncPS(model, loss_fn, num_workers=workers, code=code,
                     max_staleness=2, staleness=[0, 1, 2, 1], lr=lr,
                     device=device)
        if captured is not None:
            wire = ps._wire

            def capture(grads, w):
                captured.append({k: g.clone() for k, g in grads.items()})
                return wire(grads, w)
            ps._wire = capture
        t0 = time.perf_counter()
        for x, y in zip(xs, ys):
            ps.step((torch.from_numpy(x).to(device),
                     torch.from_numpy(y).to(device)))
        seconds = time.perf_counter() - t0
        return start, {k: p.detach().cpu() for k, p in ps.params.items()}, \
            ps, seconds

    def l1_rel(got, want, start) -> float:
        diff = sum(float((got[k] - want[k]).abs().sum()) for k in want)
        return diff / sum(float((want[k] - start[k]).abs().sum())
                          for k in start)

    code = get_codec("sign")
    tf32 = torch.backends.cudnn.allow_tf32
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        captured = []
        S.encode_signs.launches = S.unpack_signs_sum.launches = 0
        start, after, ps, card_s = rounds("cuda", code, captured)
        launches = (S.encode_signs.launches, S.unpack_signs_sum.launches)
        units = sum(1 for p in ps.params.values() if p.numel() % S.GROUP == 0)
        if launches != (2 * workers * units,) * 2:
            raise AssertionError(f"A4: sign launches {launches}, expected "
                                 f"{2 * workers * units} each")
        hist = dict(ps.staleness_hist)
        # the same gradients through the card's codec and the CPU's
        checked, scale_err = 0, 0.0
        for grads in captured:
            for k, g in grads.items():
                perm = ps._views.get(k)
                unit = g.permute(perm).contiguous() if perm else g
                shape = tuple(unit.shape)
                got, _ = code.encode(unit)
                want, _ = code.encode(unit.cpu())
                if not torch.equal(got["packed"].cpu(), want["packed"]):
                    raise AssertionError(f"A4: {k}'s packed signs differ "
                                         "between the card and the CPU")
                err = abs(float(got["scale"]) - float(want["scale"]))
                if err > 1e-6 * abs(float(want["scale"])):
                    raise AssertionError(f"A4: {k}'s scale "
                                         f"{float(got['scale'])} vs "
                                         f"{float(want['scale'])}")
                scale_err = max(scale_err, err / abs(float(want["scale"])))
                on_card = code.decode(got, shape, unit.dtype)
                plain = code.decode({n: t.cpu() for n, t in got.items()},
                                    shape, unit.dtype)
                if not _same_bits(on_card.cpu().reshape(-1),
                                  plain.reshape(-1)):
                    raise AssertionError(f"A4: {k}'s decode differs between "
                                         "the card and the CPU")
                checked += 1
        del captured
        _, cpu, _, _ = rounds("cpu", code)
        _, planted, _, _ = rounds("cuda", _flipping_sign())
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
        torch.backends.cudnn.deterministic = deterministic
    l1, l1_planted = l1_rel(after, cpu, start), l1_rel(planted, cpu, start)
    apart = sum(int((after[k] != cpu[k]).sum()) for k in cpu) / sum(
        t.numel() for t in cpu.values())
    phase("async", run="A4", card=repr(card), model="resnet18",
          code="sign", workers=workers, lags="[0,1,2,1]", rounds=2,
          card_s=f"{card_s:.3f}", same_grads_units_checked=checked,
          packed="bit-exact", decode="bit-exact",
          scale_max_rel_err=f"{scale_err:.3e}", l1_rel=f"{l1:.4e}",
          l1_limit=A4_L1_LIMIT, planted_flip=A4_FLIP,
          planted_l1_rel=f"{l1_planted:.4e}", share_apart=f"{apart:.3e}",
          hist=json.dumps(hist),
          launches_per_round=json.dumps({"encode_signs": workers * units,
                                         "unpack_signs_sum": workers * units}))
    if l1 > A4_L1_LIMIT:
        raise AssertionError(f"A4: card and CPU twin differ: L1 {l1} > "
                             f"{A4_L1_LIMIT}")
    if l1_planted <= A4_L1_LIMIT:
        raise AssertionError(f"A4: the planted fault's L1 {l1_planted} is "
                             f"within the limit {A4_L1_LIMIT}")
    model, loss_fn = build("cuda")
    ps = AsyncPS(model, loss_fn, num_workers=workers, code=code,
                 max_staleness=2, lr=lr, seed=3, device="cuda")
    for _ in range(3):
        ps.step((torch.from_numpy(xs[0]).cuda(), torch.from_numpy(ys[0])
                 .cuda()))
    if sum(ps.staleness_hist.values()) != 3 * workers:
        raise AssertionError(f"A4: sampled lags {ps.staleness_hist}")
    phase("async", run="A4-sampled", card=repr(card), rounds=3,
          staleness_hist=json.dumps(ps.staleness_hist, sort_keys=True))


def run_async(card: str) -> dict:
    """Phase 8 (``async``): the async parameter server on the card, runs
    A1-A4 (``PERF.md`` §4). The server is this process; the workers are
    fresh interpreters on the same card (time-sliced). Returns A1's and
    A2's metrics (phases ``telemetry`` and ``control`` set their armed
    fleets beside them)."""
    import shutil
    import tempfile

    from pytorch_ps_mpi_tpu_torch.utils import native

    if native.fast_path_disabled():
        raise AssertionError("PS_NO_NATIVE is set: the async phase runs "
                             "the native folds and ingest")
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_async_")
    try:
        sizes = async_sizes("resnet50")
        # every unit quantizes; those whose size divides by 1024 take the
        # sign kernels' layout
        n50, k50 = len(sizes), sum(1 for n in sizes if n % 1024 == 0)
        last = str(ASYNC_WORKERS - 1)
        slow = {last: 200.0}
        # A1: shm, async, sign, a straggler; as async_bench.py's fleets,
        # the straggler pushes fewer times than the fast workers
        d = os.path.join(tmp, "a1")
        os.makedirs(d)
        steps = {str(i): ASYNC_STEPS for i in range(ASYNC_WORKERS)}
        a1 = run_fleet("A1", async_cfg("resnet50", d, slow_ms=slow,
                                       worker_steps={**steps, last: 2}),
                       "sign", ASYNC_WORKERS, sync_barrier=False, card=card,
                       profile_server=True)
        for i, got in enumerate(a1["worker_launches"]):
            _expect_launches(f"A1 worker {i}", got,
                             {"encode_signs": k50 * a1["worker_pushes"][i]})
        _expect_launches("A1 server", a1["server_launches"],
                         {"unpack_signs_sum": k50 * int(a1["decodes_done"])})
        if not a1["loss_final"] < a1["loss_initial"]:
            raise AssertionError(f"A1: the loss did not fall: "
                                 f"{a1['loss_initial']} -> "
                                 f"{a1['loss_final']}")
        # A2: the same fleet under the sync barrier, int8, agg auto
        d = os.path.join(tmp, "a2")
        os.makedirs(d)
        a2 = run_fleet("A2", async_cfg("resnet50", d, slow_ms=slow,
                                       steps=ASYNC_STEPS // 2), "int8",
                       ASYNC_WORKERS, sync_barrier=True, card=card)
        for i, got in enumerate(a2["worker_launches"]):
            _expect_launches(f"A2 worker {i}", got,
                             {"quantize_int8": n50 * a2["worker_pushes"][i]})
        # the rounds fold on the host (wc_fold_scaled_i8): no decode kernel
        _expect_launches("A2 server", a2["server_launches"], {})
        if (a2["agg_mode"], a2["decodes_per_publish"],
                a2["agg_fallbacks"]) != (1.0, 1.0, 0.0):
            raise AssertionError(f"A2: agg_mode {a2['agg_mode']}, "
                                 f"decodes_per_publish "
                                 f"{a2['decodes_per_publish']}, fallbacks "
                                 f"{a2['agg_fallbacks']}")
        if native.fold_lib() is None:
            raise AssertionError("A2: the native fold is not armed")
        # not the discipline alone: the fleets differ in codec (sign,
        # int8) and pushes a worker (A1's straggler makes 2, the others 6;
        # A2's workers 3 each)
        phase("async", what="async_over_sync", card=repr(card),
              model="resnet50", straggler_ms=200,
              compares="A1_sign_async_vs_A2_int8_sync_barrier",
              pushes_a_worker=json.dumps({"A1": a1["worker_pushes"],
                                          "A2": a2["worker_pushes"]},
                                         separators=(",", ":")),
              steady_ratio=f"{a1['steady_updates_per_sec'] / a2['steady_updates_per_sec']:.3f}",
              wall_ratio=f"{a1['updates_per_sec'] / a2['updates_per_sec']:.3f}")
        # A3: TCP with frames, async, identity, ResNet-18
        d = os.path.join(tmp, "a3")
        os.makedirs(d)
        a3 = run_fleet("A3", async_cfg("resnet18", d, transport="tcp"),
                       "identity", 2, sync_barrier=False, card=card)
        if not a3["native_batches"] > 0:
            raise AssertionError("A3: no native batched ingest")
        for i, got in enumerate(a3["worker_launches"]):
            _expect_launches(f"A3 worker {i}", got, {})
        phase("async", run="A3", card=repr(card),
              native_batches=int(a3["native_batches"]),
              native_batch_frames=int(a3["native_batch_frames"]))
        flax_permute_ms(card)
        check_async_ps(card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    phase("async", seconds=f"{time.perf_counter() - t0:.1f}")
    return a1, a2

# -- phase serving: the read tier beside the async fleet ----------------------

SERVING_LIMIT = 240.0  # seconds a serving run may take, spawn to join
SERVING_RING = 8
#: the V1 reader process's threads: delta readers, then full readers
V1_DELTA_READERS = V1_FULL_READERS = 4
V2_READERS = 2
READ_POLL_S = 0.001  # a reader's pause after a not-modified reply
#: the environment of the phase's fresh interpreters: one intra-op thread
#: each. Eight processes share the host's 8 cores, and an ef∘top-k wire's
#: payload layout comes from the codec's plain encode of zeros on the CPU
#: (``CodecWire``): 4 workers at 8 threads each took 64-87 s to their
#: first push on the H100's host
FLEET_ENV = {"OMP_NUM_THREADS": "1"}

#: a reader process: ``ServingReader`` threads that read in a loop until
#: the stop file names the final version and each holds it; prints
#: ``{"ready": true}`` once every root reader holds a version, then the
#: report (per thread: reads and latencies by kind, the bytes of each
#: full and delta read, the CRC-32 of every version held, the FRS1
#: trailer's publish and arrival walls with the read's own, the lossy
#: bound; its dequantize launches) as one JSON line
_READER_SRC = r'''
import json, os, sys, threading, time, zlib
import numpy as np
from pytorch_ps_mpi_tpu_torch.ops import quant
from pytorch_ps_mpi_tpu_torch.parallel import async_train as at
from pytorch_ps_mpi_tpu_torch.serving import ServingReader

a = json.loads(sys.argv[1])
tmpl = at.make_problem(a["model"], "cpu").template
rel = float(a["max_rel_error"])
first = threading.Barrier(sum(1 for s in a["readers"] if "port" in s) + 1)
reports = [None] * len(a["readers"])


def read_int(path):
    try:
        return int(open(path).read())
    except (OSError, ValueError):
        return None


def loop(i, spec):
    port = spec.get("port")
    while port is None:  # the edge reader: its replica's port, when up
        try:
            port = int(open(spec["port_file"]).read())
        except (OSError, ValueError):
            time.sleep(0.05)
    r = ServingReader("127.0.0.1", port, tmpl, timeout=60.0,
                      want_delta=spec["want_delta"],
                      serving_kw=a["serving_kw"], device=a["device"])
    lat = {"full": [], "delta": [], "not_modified": []}
    nbytes = {"full": [], "delta": []}
    held, hops, hop_counts, bound = {}, [], set(), 0.0
    t_first = None
    while True:
        while "ready_file" in spec and r.version:
            # read once the server's deltas to a newer version are in
            ready, stop = read_int(spec["ready_file"]), read_int(a["stop_file"])
            if (ready or 0) > r.version or (stop is not None
                                            and r.version >= stop):
                break
            time.sleep(a["poll_s"])
        b0, prev = r.bytes_received, r._flat
        c0 = (r.full_reads, r.delta_reads)
        t0 = time.perf_counter()
        _, ver = r.read_params()
        dt = time.perf_counter() - t0
        kind = ("full" if r.full_reads > c0[0] else "delta"
                if r.delta_reads > c0[1] else "not_modified")
        lat[kind].append(dt)
        if kind != "not_modified":
            nbytes[kind].append(r.bytes_received - b0)
            held[ver] = zlib.crc32(r._flat)
            if r.fresh is not None and r.fresh["version"] == ver:
                # one host, one clock: the publish and arrival walls, and
                # this read's, are comparable as they stand
                doc = r.fresh
                hops.append([doc["publish_wall"]]
                            + [h["arrival_wall"] for h in doc["hops"]]
                            + [r.fresh_recv_wall])
                hop_counts.add(doc["hop_count"])
            if kind == "full":
                bound = 0.0
            elif rel:
                bound += (rel / (1 - rel) * float(np.linalg.norm(r._flat - prev))
                          + 2.0 ** -23 * float(np.linalg.norm(r._flat)))
        if t_first is None:
            t_first = time.perf_counter()
            if "port" in spec:
                first.wait()
        stop = read_int(a["stop_file"])
        if stop is not None and ver >= stop:
            break
        if kind == "not_modified":
            time.sleep(a["poll_s"])
    if spec.get("save"):
        np.save(spec["save"], r._flat)
    reports[i] = {"name": spec["name"], "final": ver, "held": held,
                  "lat": lat, "bytes": nbytes, "hops": hops,
                  "hop_counts": sorted(hop_counts), "bound": bound,
                  "shed_retries": r.shed_retries,
                  "seconds": time.perf_counter() - t_first}
    r.close()


ts = [threading.Thread(target=loop, args=(i, s))
      for i, s in enumerate(a["readers"])]
for t in ts:
    t.start()
first.wait()
print(json.dumps({"ready": True}), flush=True)
for t in ts:
    t.join()
print(json.dumps({"readers": reports,
                  "dequantize_launches": quant.dequant_sum.launches}),
      flush=True)
'''


def _json_line(proc, what: str, timeout: float) -> dict:
    """The next JSON line a spawned process prints on its stdout."""
    import select

    deadline = time.time() + timeout
    while time.time() < deadline:
        r, _, _ = select.select([proc.stdout], [], [], 0.5)
        if r:
            line = proc.stdout.readline()
            if line.strip():
                return json.loads(line)
        if proc.poll() is not None:
            raise AssertionError(f"{what} exited early: {proc.returncode}")
    raise AssertionError(f"{what}: no line in {timeout} s")


def _serve_readonly(args: list):
    """``python -m pytorch_ps_mpi_tpu_torch.serve_readonly args`` in a
    fresh interpreter, its stdout piped."""
    from pytorch_ps_mpi_tpu_torch.parallel import async_train as at

    src = ("import sys\n"
           "from pytorch_ps_mpi_tpu_torch.serve_readonly import main\n"
           "sys.exit(main(sys.argv[1:]))\n")
    return at.spawn_python(src, [str(a) for a in args], FLEET_ENV,
                           stdout=subprocess.PIPE)


def _stop(proc, timeout: float = 60.0) -> dict:
    """SIGINT a ``serve_readonly`` process; its ``final_serving`` line."""
    import signal

    proc.send_signal(signal.SIGINT)
    out, _ = proc.communicate(timeout=timeout)
    if proc.returncode != 0:
        raise AssertionError(f"serve_readonly exited {proc.returncode}")
    return json.loads(out.strip().splitlines()[-1])["final_serving"]


def _ms_q(xs, q: float) -> str:
    if not xs:
        return "none"
    s = sorted(xs)
    return f"{s[min(len(s) - 1, int(round(q * (len(s) - 1))))] * 1e3:.3f}"


class _RingHasher:
    """CRC-32 of every version the server's core publishes: a thread
    walks the snapshot ring every 20 ms (a version stays in the 8-deep
    ring for 8 publishes) and hashes the versions it has not seen, the
    GIL free while ``zlib.crc32`` runs."""

    def __init__(self, server):
        import threading

        self.server = server
        self.crcs: dict = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _sweep(self) -> None:
        import zlib

        core = self.server.serving_core
        store = core._stores.get(core.default_tenant) if core else None
        for v in (store.versions() if store is not None else ()):
            if v not in self.crcs:
                snap = store.acquire(v)
                if snap is not None:
                    self.crcs[v] = zlib.crc32(snap.flat)
                    store.release(snap)

    def _run(self) -> None:
        while not self._stop.wait(0.02):
            self._sweep()

    def close(self) -> dict:
        self._stop.set()
        self._thread.join(timeout=30)
        self._sweep()
        return self.crcs


def serving_fleet(label: str, cfg: dict, card: str, readers=None,
                  replicas: int = 0, hash_versions: bool = False) -> dict:
    """One ResNet-50 fleet (A1's) with the read tier armed (``readers``:
    the reader process's threads) or not. The server is this process;
    the workers, the reader process and ``replicas`` chained
    ``serve_readonly --follow-endpoint`` replicas are fresh interpreters,
    all spawned at once (a worker's first push comes ~15 s after its
    spawn, the readers hold a version after ~10). The final version goes
    to the reader process through a stop file. Returns the server's metrics
    with the runs' reports; ``hash_versions``: the CRC-32 of every
    version published (``crcs``)."""
    import threading

    from pytorch_ps_mpi_tpu_torch.parallel import async_train as at
    from pytorch_ps_mpi_tpu_torch.parallel.dcn import (ShmPSServer,
                                                       flatten_params)

    workers = ASYNC_WORKERS
    template = at.make_problem(cfg, "cuda").template
    name = f"/psq_chip_smoke_{os.getpid()}_{label}"
    server = ShmPSServer(name, workers, template, max_staleness=4,
                         code=at._codec(cfg), frame=True, device="cuda")
    d = cfg["stats_dir"]
    stop_file = os.path.join(d, "stop")
    out = {"procs": [], "replicas": [], "reader": None, "errors": []}
    hasher = _RingHasher(server) if hash_versions else None
    t0 = time.perf_counter()
    timeline = {}

    def mark(what: str) -> None:
        timeline[what] = round(time.perf_counter() - t0, 3)

    done = threading.Event()

    def notify_ready() -> None:
        """Write the newest version whose publish (with the native tier's
        pre-encode of its deltas) has returned, for readers that read
        only then (a spec's ``ready_file``)."""
        seen = 0
        while not done.wait(0.002):
            core = server.serving_core
            n = core.publishes if core is not None else 0
            if n != seen:
                tmp = os.path.join(d, "ready.tmp")
                with open(tmp, "w") as f:
                    f.write(str(n))
                os.replace(tmp, os.path.join(d, "ready"))
                seen = n

    notifier = (threading.Thread(target=notify_ready, daemon=True)
                if any("ready_file" in s for s in readers or ()) else None)
    if notifier is not None:
        notifier.start()

    def start_workers() -> None:
        mark("workers_spawned_s")
        out["procs"] = [at.spawn_worker(name, i, cfg, FLEET_ENV)
                        for i in range(workers)]

    def arm() -> None:
        """The reader process and the chain of replicas."""
        try:
            deadline = time.time() + SERVING_LIMIT
            # the core attaches itself before it binds its read port
            while (server.serving_core is None
                   or server.serving_core.read_port is None):
                if time.time() > deadline:
                    raise AssertionError("the read tier never came up")
                time.sleep(0.01)
            up = server.serving_core.read_port
            specs = [dict(s) for s in readers]
            for s in specs:
                if s.pop("root", False):
                    s["port"] = up
            kw = {"ring": SERVING_RING, **cfg.get("serving_kw", {})}
            reader = at.spawn_python(_READER_SRC, [json.dumps({
                "model": cfg, "readers": specs, "serving_kw": kw,
                "device": "cuda", "stop_file": stop_file,
                "poll_s": READ_POLL_S,
                "max_rel_error": (kw.get("delta_max_rel_error", 0.05)
                                  if kw.get("delta_codec") else 0.0)})],
                FLEET_ENV, stdout=subprocess.PIPE)
            out["reader"] = reader
            for i in range(replicas):
                rep = _serve_readonly([
                    "--follow-endpoint", f"127.0.0.1:{up}", "--follow",
                    "0.05", "--model", cfg["model"], "--read-port", "0",
                    "--ring", SERVING_RING])
                out["replicas"].append(rep)
                up = _json_line(rep, f"{label} replica {i + 1}",
                                SERVING_LIMIT)["read_port"]
                mark(f"replica{i + 1}_up_s")
            with open(os.path.join(d, "edge_port"), "w") as f:
                f.write(str(up))
            _json_line(reader, f"{label} reader", SERVING_LIMIT)
            mark("readers_ready_s")
        except BaseException as e:  # noqa: BLE001 - raised below
            out["errors"].append(repr(e))

    counters = kernel_counters()
    for k in counters.values():
        k.launches = 0
    armer = None
    try:
        if readers:
            armer = threading.Thread(target=arm)
            armer.start()
        start_workers()
        total = sum(at.worker_cfg(cfg, i)[1] for i in range(workers))
        params, m = at.serve(server, cfg, total_grads=0,
                             total_received=total,
                             timeout=SERVING_LIMIT,
                             checkpoint_dir=cfg.get("checkpoint_dir"),
                             checkpoint_every=cfg.get("checkpoint_every",
                                                      0))
        mark("serve_returned_s")
        m["final_flat"] = flatten_params(params)
        if armer is not None:
            armer.join(timeout=SERVING_LIMIT)
        if out["errors"]:
            raise AssertionError(f"{label}: {out['errors']}")
        codes = at.join_workers(out["procs"], timeout=SERVING_LIMIT)
        if codes != [0] * workers:
            raise AssertionError(f"{label}: worker exit codes {codes}")
        m["final_version"] = server.version
        # close() folds the native tier's counters and turns it off
        m["read_native"] = server.serving_core.read_native
        if readers:
            with open(stop_file, "w") as f:
                f.write(str(server.version))
            m["reader"] = _json_line(out["reader"], f"{label} reader",
                                     SERVING_LIMIT)
            mark("readers_done_s")
            m["reader_dequantize_launches"] = m["reader"][
                "dequantize_launches"]
            m["crcs"] = hasher.close() if hasher is not None else {}
            m["core"] = server.serving_core
            m["delta_codec"] = server.serving_core._deltas.get("default")
    finally:
        done.set()
        if armer is not None:
            armer.join(timeout=SERVING_LIMIT)
        if hasher is not None:
            hasher.close()
        server.close()  # the root stops
        at.join_workers(out["procs"], timeout=5.0)
        if out["reader"] is not None:
            at.join_workers([out["reader"]], timeout=30.0)
        finals = []
        for p in out["replicas"]:
            try:
                finals.append(_stop(p))
            except (AssertionError, ValueError, IndexError,
                    subprocess.TimeoutExpired) as e:
                out["errors"].append(f"replica: {e!r}")
            finally:
                at.join_workers([p], timeout=5.0)
    if out["errors"]:
        raise AssertionError(f"{label}: {out['errors']}")
    mark("stopped_s")
    m["timeline"] = timeline
    m["replica_finals"] = finals
    m["worker_stats"] = [json.loads(open(os.path.join(
        d, f"worker-{i}.json")).read()) for i in range(workers)]
    m["worker_launches"] = [s["launches"] for s in m["worker_stats"]]
    m["worker_pushes"] = [s["pushes"] for s in m["worker_stats"]]
    if m["applied"] + m["stale_drops"] != total:
        raise AssertionError(f"{label}: applied {m['applied']} + dropped "
                             f"{m['stale_drops']} != {total}")
    return m


def serving_cfg(d: str, codec: str, codec_kw: dict, **kw) -> dict:
    """A1's fleet (``async_cfg``: ResNet-50, 4 workers, worker 3 a 200 ms
    straggler pushing twice and the others 6 times) with ``codec``."""
    last = str(ASYNC_WORKERS - 1)
    steps = {str(i): ASYNC_STEPS for i in range(ASYNC_WORKERS)}
    return async_cfg("resnet50", d, slow_ms={last: 200.0},
                     worker_steps={**steps, last: 2}, codec=codec,
                     codec_kw=codec_kw, **kw)


def async_topk_leaves() -> list:
    """(n, k) of A1's ResNet-50 (``small_inputs``) leaves that take the
    top-k kernel at fraction ``TOPK_FRACTION``."""
    from pytorch_ps_mpi_tpu_torch.ops import topk as T

    out = []
    for n in async_sizes("resnet50"):
        k = max(1, int(round(n * TOPK_FRACTION)))
        if 4 * 2048 <= n <= T.MAX_N and k < n:
            out.append((n, k))
    return out


def delta_sections(model: str) -> list:
    """The element counts of the read tier's delta sections on a model's
    async template (``serving/delta.py``, 4 MB)."""
    from pytorch_ps_mpi_tpu_torch.parallel import async_train as at
    from pytorch_ps_mpi_tpu_torch.parallel.dcn import flat_size
    from pytorch_ps_mpi_tpu_torch.serving.delta import (DELTA_KNOBS,
                                                        _flat_segments)

    tmpl = at.make_problem(async_cfg(model, ""), "cuda").template
    return [c for _, c in _flat_segments(
        tmpl, DELTA_KNOBS["delta_bucket_mb"], flat_size(tmpl))]


def _readers_check(label: str, rep: dict, crcs: dict, final: int) -> None:
    """Every version a reader held hashes to the server's CRC-32 of it,
    and each reader ended on the final version."""
    for r in rep["readers"]:
        if r["final"] != final:
            raise AssertionError(f"{label} {r['name']}: ended on "
                                 f"{r['final']}, not {final}")
        bad = {v: c for v, c in r["held"].items()
               if crcs.get(int(v)) != c}
        if bad:
            raise AssertionError(f"{label} {r['name']}: versions {sorted(bad)} "
                                 "differ from the server's")


def _kind_fields(readers: list) -> dict:
    out = {}
    for kind in ("full", "delta", "not_modified"):
        xs = [t for r in readers for t in r["lat"][kind]]
        out[f"{kind}_reads"] = len(xs)
        out[f"{kind}_p50_ms"] = _ms_q(xs, 0.50)
        out[f"{kind}_p95_ms"] = _ms_q(xs, 0.95)
    return out


def _run_fields(m: dict) -> dict:
    """A fleet's wall, its timeline from the server's construction, and
    its workers' medians a push (ms)."""
    first = (m["wall_s"] - (m["applied"] - 1) / m["steady_updates_per_sec"]
             if m["steady_updates_per_sec"] else m["wall_s"])
    return {"wall_s": f"{m['wall_s']:.3f}",
            "first_update_s": f"{first:.3f}",
            "timeline": json.dumps(m["timeline"], separators=(",", ":")),
            "worker_first_step_ms": json.dumps([round(sum(
                w[k][0] for k in ("read_s", "grad_s", "encode_s", "push_s")
                if w[k]) * 1e3, 1) for w in m["worker_stats"]],
                separators=(",", ":")),
            **{f"worker_{k[:-2]}_ms": _median_ms(m["worker_stats"], k)
               for k in ("read_s", "grad_s", "encode_s", "push_s")}}


def _publish_fields(m: dict) -> dict:
    """The serve loop's publish, ms a publish, split: the allocation of
    the version's own pinned array, the D2H copy into it, the transport's
    publish, the ring put (with the FRS1 stamp), the native tier's
    pre-encode of the ring's deltas."""
    t, n = m["server_times"], max(m["core"].publishes, 1)
    return {f"publish_{k}_ms": f"{t.get(f'publish_{k}_s', 0.0) / n * 1e3:.3f}"
            for k in ("alloc", "d2h", "transport", "ring_put", "pre_encode")}


def serving_v1(card: str, tmp: str, topk_launches: int, tally: dict):
    """V1 (exact deltas) with V3 (the follower chain) riding on it.
    Returns V1's cfg and metrics."""
    d = os.path.join(tmp, "v1")
    os.makedirs(d)
    kw = {"inner_name": "topk", "fraction": TOPK_FRACTION, "pallas": True}
    cfg = serving_cfg(d, "ef", kw, read_port=0,
                      serving_kw={"ring": SERVING_RING},
                      checkpoint_dir=os.path.join(d, "ckpt"),
                      checkpoint_every=4)
    save = os.path.join(d, "reader_final.npy")
    # a delta reader reads once a newer version's deltas are in: the native
    # tier answers in full until the serve thread has pre-encoded them, and
    # a reader in a tight loop reads in that window every version
    readers = ([{"name": f"delta{i}", "root": True, "want_delta": True,
                 "ready_file": os.path.join(d, "ready")}
                for i in range(V1_DELTA_READERS)]
               + [{"name": f"full{i}", "root": True, "want_delta": False}
                  for i in range(V1_FULL_READERS)]
               + [{"name": "edge", "port_file": os.path.join(d, "edge_port"),
                   "want_delta": True}])
    readers[0]["save"] = save
    t0 = time.perf_counter()
    m = serving_fleet("V1", cfg, card, readers=readers, replicas=2,
                      hash_versions=True)
    final, crcs, core = m["final_version"], m["crcs"], m["core"]
    if sorted(crcs) != list(range(1, final + 1)):
        raise AssertionError(f"V1: hashed versions {sorted(crcs)} of 1.."
                             f"{final}")
    rep = m["reader"]
    _readers_check("V1", rep, crcs, final)
    if not np.array_equal(np.load(save).view(np.uint32),
                          m["final_flat"].view(np.uint32)):
        raise AssertionError("V1: the last read differs from the final flat")
    if not m["read_native"]:
        raise AssertionError("V1: the native read tier is not armed")
    leaves = async_topk_leaves()
    for i, got in enumerate(m["worker_launches"]):
        _expect_launches(f"V1 worker {i}", got, {
            "exact_topk": topk_launches * len(leaves)
            * m["worker_pushes"][i]})
        _tally(tally, got)
    _expect_launches("V1 server", m["server_launches"], {})
    root = [r for r in rep["readers"] if r["name"] != "edge"]
    edge, = [r for r in rep["readers"] if r["name"] == "edge"]
    for r in root[:V1_DELTA_READERS]:
        if not r["lat"]["delta"]:
            raise AssertionError(f"V1 {r['name']}: no delta applied in "
                                 f"{len(r['held'])} versions held")
    if edge["hop_counts"] != [2]:
        raise AssertionError(f"V1/V3: the edge's hop counts "
                             f"{edge['hop_counts']}")
    lags = [f["replica_lag_versions"] for f in m["replica_finals"]]
    if max(lags) > 2:
        raise AssertionError(f"V3: replica lags {lags} after the root "
                             "stopped")
    full_bytes = m["final_flat"].nbytes
    deltas = [b for r in root for b in r["bytes"]["delta"]]
    reads = sum(len(r["lat"][k]) for r in root for k in r["lat"])
    secs = max(r["seconds"] for r in root)
    phase("serving", run="V1", card=repr(card), model="resnet50",
          code="ef_topk", ring=SERVING_RING, read_native=m["read_native"],
          pushes=int(m["grads_received"]), applied=int(m["applied"]),
          stale_drops=int(m["stale_drops"]), versions=final,
          readers=len(root), reads=reads, reads_per_s=f"{reads / secs:.1f}",
          **_kind_fields(root),
          delta_bytes_mean=int(statistics.mean(deltas)) if deltas else 0,
          full_bytes=full_bytes,
          delta_over_full=(f"{statistics.mean(deltas) / full_bytes:.5f}"
                           if deltas else "none"),
          coalesce_hits=int(m["coalesce_hits"]),
          reads_shed=int(m["reads_shed"]),
          shed_retries=sum(r["shed_retries"] for r in root),
          crc_versions_checked=sum(len(r["held"]) for r in rep["readers"]),
          delta_reads_by_delta_reader=json.dumps(
              [len(r["lat"]["delta"]) for r in root[:V1_DELTA_READERS]],
              separators=(",", ":")))
    phase("serving", run="V1", card=repr(card), what="publish",
          publishes=core.publishes, **_publish_fields(m),
          updates_per_sec=f"{m['updates_per_sec']:.3f}",
          steady_updates_per_sec=f"{m['steady_updates_per_sec']:.3f}",
          **_run_fields(m))
    # (publish, replica 1 arrival, replica 2 arrival, edge read) walls of
    # the versions after the edge's first (published before it connected)
    walls = [w for w in edge["hops"][1:] if len(w) == 4]
    hop_ms = {name: (f"{statistics.median((w[i + 1] - w[i]) * 1e3 for w in walls):.3f}"
                     if walls else "none")
              for i, name in enumerate(("root_to_replica1",
                                        "replica1_to_replica2",
                                        "replica2_to_edge_read"))}
    phase("serving", run="V3", card=repr(card), chain="root>replica1>"
          "replica2>reader", hop_count=2, edge_versions=len(edge["held"]),
          follow_poll_s=0.05,
          **{f"publish_to_visible_p50_ms_{k}": v for k, v in hop_ms.items()},
          follower_bytes_relayed=json.dumps(
              [int(f["follower_bytes_relayed"]) for f in m["replica_finals"]],
              separators=(",", ":")),
          replica_lag_versions=json.dumps([round(x, 4) for x in lags],
                                          separators=(",", ":")),
          republished=json.dumps([f["republished"]
                                  for f in m["replica_finals"]],
                                 separators=(",", ":")),
          seconds=f"{time.perf_counter() - t0:.1f}")
    return cfg, m


def serving_unarmed(card: str, tmp: str, m: dict, tally: dict) -> None:
    """V1's fleet (its checkpoints too) with nothing armed: the pair
    with V1's metrics ``m``."""
    t0 = time.perf_counter()
    du = os.path.join(tmp, "v1_unarmed")
    os.makedirs(du)
    kw = {"inner_name": "topk", "fraction": TOPK_FRACTION, "pallas": True}
    mu = serving_fleet("V1u", serving_cfg(
        du, "ef", kw, checkpoint_dir=os.path.join(du, "ckpt"),
        checkpoint_every=4), card)
    for got in mu["worker_launches"]:
        _tally(tally, got)
    phase("serving", what="armed_vs_unarmed", card=repr(card),
          compares="V1 read tier armed (8 readers, 2 replicas) vs the same "
          "fleet unarmed, one run each; V4's replica starts during the "
          "unarmed run's start-up",
          armed_steady_updates_per_sec=f"{m['steady_updates_per_sec']:.3f}",
          unarmed_steady_updates_per_sec=(
              f"{mu['steady_updates_per_sec']:.3f}"),
          armed_updates_per_sec=f"{m['updates_per_sec']:.3f}",
          unarmed_updates_per_sec=f"{mu['updates_per_sec']:.3f}",
          unarmed_publish_ms=f"{mu['server_times']['publish_s'] / max(mu['applied'], 1) * 1e3:.3f}",
          unarmed_applied=int(mu["applied"]),
          unarmed_stale_drops=int(mu["stale_drops"]),
          **{f"unarmed_{k}": v for k, v in _run_fields(mu).items()},
          seconds=f"{time.perf_counter() - t0:.1f}")


def serving_v4(card: str, cfg: dict, m: dict, meanwhile) -> None:
    """V4: ``serve_readonly --checkpoint-dir`` on V1's checkpoints; a
    reader here loads what it read into ResNet-50 on the card, and its
    held-out loss must equal the V1 server's final one bit for bit
    (cuDNN deterministic in both). ``meanwhile()`` runs while the
    replica's interpreter starts."""
    from pytorch_ps_mpi_tpu_torch.parallel import async_train as at
    from pytorch_ps_mpi_tpu_torch.parallel.dcn import flatten_params
    from pytorch_ps_mpi_tpu_torch.serving import ServingReader

    proc = _serve_readonly(["--checkpoint-dir", cfg["checkpoint_dir"],
                            "--model", "resnet50", "--read-port", "0",
                            "--duration", SERVING_LIMIT])
    try:
        meanwhile()
        t0 = time.perf_counter()
        hello = _json_line(proc, "V4 serve_readonly", SERVING_LIMIT)
        if hello["version"] != m["final_version"]:
            raise AssertionError(f"V4: serves version {hello['version']}, "
                                 f"V1 ended on {m['final_version']}")
        prob = at.make_problem(cfg, "cuda")
        r = ServingReader("127.0.0.1", hello["read_port"], prob.template)
        t1 = time.perf_counter()
        tree, ver = r.read_params()
        read_ms = (time.perf_counter() - t1) * 1e3
        r.close()
        flat = flatten_params(tree)
        prob.load_flat(torch.from_numpy(flat).to(prob.device))
        loss = prob.eval_loss()
    finally:
        final = _stop(proc)
    if loss != m["loss_final"] or not np.array_equal(
            flat.view(np.uint32), m["final_flat"].view(np.uint32)):
        raise AssertionError(f"V4: held-out loss {loss!r} vs the server's "
                             f"{m['loss_final']!r}")
    phase("serving", run="V4", card=repr(card), model="resnet50",
          checkpoint_step=hello["checkpoint_step"], version=ver,
          read_ms=f"{read_ms:.3f}", loss=f"{loss:.9g}",
          server_loss=f"{m['loss_final']:.9g}", bit_equal=True,
          reads_total=final["reads_total"],
          seconds=f"{time.perf_counter() - t0:.1f}")


def serving_v2(card: str, tmp: str, tally: dict) -> None:
    """V2: A1's fleet (sign) with int8-lossy deltas, two delta readers
    applying on the card."""
    d = os.path.join(tmp, "v2")
    os.makedirs(d)
    t0 = time.perf_counter()
    cfg = serving_cfg(d, "sign", {}, read_port=0,
                      serving_kw={"ring": SERVING_RING,
                                  "delta_codec": "int8"})
    save = os.path.join(d, "reader_final.npy")
    # each reads once a version's deltas are in: the native tier installs
    # a version before the serve thread pre-encodes its deltas (~0.9 s a
    # publish here), and a read in between is answered in full
    readers = [{"name": f"delta{i}", "root": True, "want_delta": True,
                "ready_file": os.path.join(d, "ready")}
               for i in range(V2_READERS)]
    readers[0]["save"] = save
    m = serving_fleet("V2", cfg, card, readers=readers)
    final, dc, core = m["final_version"], m["delta_codec"], m["core"]
    rep = m["reader"]
    sections = len(dc.segments)
    probed = sum(1 for e in range(1, dc.encodes + 1)
                 if e % dc.probe_every == 1 or dc.probe_every == 1)
    if core.lossy_fallbacks() or dc.lossy_fallbacks:
        raise AssertionError(f"V2: {dc.lossy_fallbacks} lossy fallbacks "
                             f"(last probe {dc.last_probe_rel_error})")
    if not m["read_native"]:
        raise AssertionError("V2: the native read tier is not armed")
    n50 = async_sizes("resnet50")
    k50 = sum(1 for n in n50 if n % 1024 == 0)
    want_server = {"quantize_int8": dc.encodes * sections,
                   "dequant_sum": probed * sections,
                   "unpack_signs_sum": k50 * int(m["decodes_done"])}
    if (dc.lossy_encodes, dc.probes) != (want_server["quantize_int8"],
                                         want_server["dequant_sum"]):
        raise AssertionError(f"V2: {dc.lossy_encodes} lossy encodes, "
                             f"{dc.probes} probe decodes; the plan gives "
                             f"{want_server}")
    _expect_launches("V2 server", m["server_launches"], want_server)
    _tally(tally, m["server_launches"])
    for i, got in enumerate(m["worker_launches"]):
        _expect_launches(f"V2 worker {i}", got,
                         {"encode_signs": k50 * m["worker_pushes"][i]})
        _tally(tally, got)
    delta_reads = sum(len(r["lat"]["delta"]) for r in rep["readers"])
    if not delta_reads:
        raise AssertionError("V2: no reader applied a delta")
    if m["reader_dequantize_launches"] != delta_reads * sections:
        raise AssertionError(f"V2 readers: {m['reader_dequantize_launches']} "
                             f"dequantize launches for {delta_reads} delta "
                             f"reads of {sections} sections")
    _tally(tally, {"dequant_sum": m["reader_dequantize_launches"]})
    for r in rep["readers"]:
        if r["final"] != final:
            raise AssertionError(f"V2 {r['name']}: ended on {r['final']}")
    held = np.load(save)
    err = float(np.linalg.norm(held - m["final_flat"]))
    bound = rep["readers"][0]["bound"]
    if not err <= bound:
        raise AssertionError(f"V2: the reader is {err} from the final flat, "
                             f"past the probe's bound {bound}")
    full_bytes = m["final_flat"].nbytes
    deltas = [b for r in rep["readers"] for b in r["bytes"]["delta"]]
    phase("serving", run="V2", card=repr(card), model="resnet50",
          code="sign", delta_codec="int8", read_native=m["read_native"],
          pushes=int(m["grads_received"]), applied=int(m["applied"]),
          versions=final, readers=V2_READERS, sections=sections,
          encodes=dc.encodes, lossy_encodes=dc.lossy_encodes,
          probe_decodes=dc.probes, lossy_fallbacks=dc.lossy_fallbacks,
          last_probe_rel_error=f"{dc.last_probe_rel_error:.6f}",
          reader_dequantize=m["reader_dequantize_launches"],
          reader_err_l2=f"{err:.6g}", bound_l2=f"{bound:.6g}",
          delta_over_full=(f"{statistics.mean(deltas) / full_bytes:.5f}"
                           if deltas else "none"),
          **_kind_fields(rep["readers"]), **_publish_fields(m),
          updates_per_sec=f"{m['updates_per_sec']:.3f}",
          steady_updates_per_sec=f"{m['steady_updates_per_sec']:.3f}",
          **_run_fields(m), seconds=f"{time.perf_counter() - t0:.1f}")


def run_serving(card: str, topk_launches: int) -> dict:
    """Phase ``serving``: the read tier beside A1's ResNet-50 fleet on
    the card, runs V1-V4 (V5 rides on S2 in ``scale_out``). Returns the
    runs' kernel launches, summed over every process."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_serving_")
    tally: dict = {}
    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        cfg, m1 = serving_v1(card, tmp, topk_launches, tally)
        serving_v4(card, cfg, m1,
                   lambda: serving_unarmed(card, tmp, m1, tally))
        serving_v2(card, tmp, tally)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark \
            = flags
        shutil.rmtree(tmp, ignore_errors=True)
    phase("serving", launches=json.dumps(tally, sort_keys=True,
                                         separators=(",", ":")),
          seconds=f"{time.perf_counter() - t0:.1f}")
    return tally


SO_LIMIT = 240.0  # seconds a scale-out run may take, spawn to join
S1_SHARDS = 2
R50_UNITS = 161  # ResNet-50's leaves, the units of its wire
R18_SIGN_UNITS = 20  # ResNet-18's kernel-layout leaves (n % 1024 == 0)
#: the kernel line's names of the port's launch counters
_COUNTER_NAMES = {"dequant_sum": "dequantize_int8",
                  "tern_unpack_sum": "tern_unpack"}


def s1_slices(n_total: int) -> list:
    """The element counts of S1's shard slices of ``n_total``
    parameters."""
    from pytorch_ps_mpi_tpu_torch.parallel.sharded import shard_plan

    return [b - a for a, b in shard_plan(n_total, S1_SHARDS)]


def _tally(into: dict, launches: dict) -> None:
    for k, v in launches.items():
        k = _COUNTER_NAMES.get(k, k)
        into[k] = into.get(k, 0) + int(v)


def _gb(nbytes) -> float:
    return round(float(nbytes) / 2**30, 2)


def _idle_fields(what: str, d: dict) -> dict:
    """An ``IdleMeter`` reading as printed fields; raises when the trace
    lost device rows, so that the share is never left unmeasured."""
    if "idle_share" not in d:
        raise AssertionError(f"{what}: the idle trace holds "
                             f"{int(d.get('device_rows', 0))} device rows "
                             f"of {int(d.get('launched', 0))} launched")
    return {"device_rows": int(d["device_rows"]),
            "launched": int(d["launched"]),
            "device_busy_ms": f"{d['device_busy_ms']:.3f}",
            "profiled_wall_ms": f"{d['profiled_wall_ms']:.3f}",
            "idle_share": f"{d['idle_share']:.3f}"}


def _median_ms(rows, key: str) -> str:
    vals = [t for r in rows for t in r.get(key, ())]
    return f"{statistics.median(vals) * 1e3:.3f}" if vals else "none"


def shard_fleet(cfg: dict, n_shards: int, n_workers: int, d: str,
                tag: str) -> tuple:
    """Spawn ``n_shards`` shard servers and ``n_workers`` sharded workers
    (fresh interpreters on the card), join them, and return the shards'
    .npz paths and the workers' stats."""
    from pytorch_ps_mpi_tpu_torch.parallel import async_train as at
    from pytorch_ps_mpi_tpu_torch.parallel import sharded

    servers, workers = [], []
    paths = [os.path.join(d, f"{tag}_shard{s}.npz") for s in range(n_shards)]
    wpaths = [os.path.join(d, f"{tag}_w{w}.json") for w in range(n_workers)]
    ports = [free_port() for _ in range(n_shards)]
    addrs = [f"127.0.0.1:{p}" for p in ports]
    try:
        # servers and workers start together: a worker's connect waits
        servers = [sharded.spawn_shard_server(s, n_shards, cfg, paths[s],
                                              port=ports[s])
                   for s in range(n_shards)]
        workers = [sharded.spawn_sharded_worker(addrs, w, cfg, wpaths[w])
                   for w in range(n_workers)]
        if [sharded.read_server_port(p, SO_LIMIT) for p in servers] != ports:
            raise AssertionError(f"{tag}: servers not on {ports}")
        codes = at.join_workers(workers, SO_LIMIT) + at.join_workers(
            servers, SO_LIMIT)
        if codes != [0] * (n_shards + n_workers):
            raise AssertionError(f"{tag}: exit codes {codes}")
    finally:
        at.join_workers(servers + workers, timeout=5.0)
    return paths, [json.load(open(p)) for p in wpaths]


def _flat_of(paths, template) -> np.ndarray:
    from pytorch_ps_mpi_tpu_torch.parallel.dcn import flatten_params
    from pytorch_ps_mpi_tpu_torch.parallel.sharded import assemble

    return flatten_params(assemble(paths, template))


class _FleetWatch:
    """Phase control's O3 beside a scale-out run: a thread that reads the
    fleet directory's cards, and ``/fleet`` from ``port``, every 0.25 s
    until stopped."""

    def __init__(self, fdir: str, port: int = None):
        import threading

        self.fdir, self.port = fdir, port
        self.cards, self.panes, self.errors = [], [], []
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self) -> None:
        from pytorch_ps_mpi_tpu_torch.telemetry.fleet import list_endpoints

        while not self._stop.is_set():
            self.cards.append([(e["name"], e["url"])
                               for e in list_endpoints(self.fdir)])
            if self.port is not None:
                try:
                    self.panes.append(_http_json(self.port, "/fleet"))
                except Exception as e:  # a member mid-start: kept, reported
                    self.errors.append(repr(e))
            self._stop.wait(0.25)

    def stop(self) -> None:
        self._stop.set()
        self._t.join(timeout=30.0)


def _o3_pane(card: str, watch: _FleetWatch, shards: int) -> None:
    """O3: one ``/fleet`` scrape that covered every shard server and the
    read tier, every member reachable, the shards' counters summed and
    the per-shard skew section present."""
    full = [p for p in watch.panes
            if p.get("n_members") == shards + 1
            and p.get("n_ok") == shards + 1
            and p["fleet"].get("grads_received", 0) > 0]
    if not full:
        raise AssertionError(f"O3: no /fleet scrape covered {shards} shards "
                             f"and the read tier: {watch.panes[-1:]}, "
                             f"errors {watch.errors[-3:]}")
    pane = full[-1]
    members = pane["members"].values()
    roles = sorted(m["role"] for m in members)
    summed = sum(m["metrics"].get("grads_received", 0.0) for m in members)
    if (roles != ["read"] + ["shard"] * shards
            or pane["fleet"]["grads_received"] != summed
            or "grads_received" not in pane["skew"]):
        raise AssertionError(f"O3: pane {pane}")
    phase("control", run="O3", card=repr(card), scrapes=len(watch.panes),
          members=len(pane["members"]), roles=json.dumps(roles),
          grads_received=pane["fleet"]["grads_received"],
          skew=json.dumps(pane["skew"]["grads_received"], sort_keys=True))


def scale_s1(card: str, tmp: str, tally: dict) -> None:
    """S1: 2 shard servers over TCP, 4 workers, int8, async, max_staleness
    4, shard 1 slowed 50 ms an update, 3 pushes a worker a shard,
    checkpoints a shard every 4 updates. O3 (phase ``control``) rides on
    it: the shards register their fleet cards, a read tier in this
    process registers its own, and its ``/fleet`` is scraped while the
    shards run."""
    from pytorch_ps_mpi_tpu_torch.parallel import async_train as at
    from pytorch_ps_mpi_tpu_torch.serving import ServingCore

    d = os.path.join(tmp, "s1")
    os.makedirs(d)
    fdir = os.path.join(d, "fleet")
    shards, workers, steps = S1_SHARDS, 4, 3
    cfg = async_cfg("resnet50", d, codec="int8", n_workers=workers,
                    steps=steps, max_staleness=4, transport="tcp",
                    server_slow_ms={"1": 50.0}, server_timeout=SO_LIMIT,
                    checkpoint_dir=os.path.join(d, "ckpt"),
                    checkpoint_every=4, idle_share=True, fleet_dir=fdir)
    tier = ServingCore(None, {"read_port": 0, "metrics_port": 0,
                              "fleet_dir": fdir, "device": "cuda",
                              "fleet_kw": {"min_poll_s": 0.0}},
                       template=at.make_problem(cfg, "cuda").template)
    watch = _FleetWatch(fdir, tier.metrics_http_port)
    t0 = time.perf_counter()
    try:
        paths, stats = shard_fleet(cfg, shards, workers, d, "s1")
    finally:
        watch.stop()
        tier.close()
    wall = time.perf_counter() - t0
    _o3_pane(card, watch, shards)
    zs = [np.load(p, allow_pickle=False) for p in paths]
    for i, st in enumerate(stats):
        # one quantize a slice a push
        _expect_launches(f"S1 worker {i}", st["launches"],
                         {"quantize_int8": shards * steps})
        _tally(tally, st["launches"])
    for i, z in enumerate(zs):
        launches = json.loads(str(z["launches"]))
        # one dequant_sum a decoded (not stale-dropped) push
        _expect_launches(f"S1 shard {i}", launches,
                         {"dequant_sum": int(z["applied"])})
        _tally(tally, launches)
        if int(z["grads_received"]) != workers * steps or int(
                z["applied"]) + int(z["stale_drops"]) != workers * steps:
            raise AssertionError(f"S1 shard {i}: {int(z['grads_received'])} "
                                 f"received, {int(z['applied'])} applied, "
                                 f"{int(z['stale_drops'])} dropped")
        if not os.listdir(os.path.join(d, "ckpt", f"shard{i}")):
            raise AssertionError(f"S1 shard {i}: no checkpoint")
    spread = max(st["max_version_spread"] for st in stats)
    if spread < 1:
        raise AssertionError("S1: the shards' versions never diverged")
    prob = at.make_problem(cfg, cfg["device"])
    slices = [int(z["stop"]) - int(z["start"]) for z in zs]
    if slices != s1_slices(prob.flat_params().numel()):
        # the sizes check_quant_kernels holds against the plain versions
        raise AssertionError(f"S1: slices {slices}")
    loss0 = prob.eval_loss()
    prob.load_flat(torch.from_numpy(_flat_of(paths, prob.template)).to(
        prob.device))
    loss1 = prob.eval_loss()
    if not loss1 < loss0:
        raise AssertionError(f"S1: the loss did not fall: {loss0} -> "
                             f"{loss1}")
    idle = [json.loads(str(z["idle"])) for z in zs]
    phase("scale_out", run="S1", card=repr(card), model="resnet50",
          code="int8", shards=shards, workers=workers, pushes=workers * steps,
          applied=json.dumps([int(z["applied"]) for z in zs]),
          stale_drops=json.dumps([int(z["stale_drops"]) for z in zs]),
          versions=json.dumps([int(z["version"]) for z in zs]),
          max_version_spread=spread, wall_s=f"{wall:.3f}",
          slice_elements=json.dumps(slices),
          loss_before=f"{loss0:.6f}", loss_after=f"{loss1:.6f}")
    srv_t = [json.loads(str(z["times"])) for z in zs]
    phase("scale_out", run="S1", card=repr(card), what="per_push_ms",
          worker_read=_median_ms(stats, "read_s"),
          worker_grad=_median_ms(stats, "grad_s"),
          worker_encode_d2h_2_slices=_median_ms(stats, "encode_s"),
          worker_push_2_slices=_median_ms(stats, "push_s"),
          shard_update=json.dumps([round(t["update_s"] / max(int(
              z["applied"]), 1) * 1e3, 3) for t, z in zip(srv_t, zs)]),
          shard_publish=json.dumps([round(t["publish_s"] / max(int(
              z["applied"]), 1) * 1e3, 3) for t, z in zip(srv_t, zs)]))
    phase("scale_out", run="S1", card=repr(card), what="peak_gb",
          shards=json.dumps([_gb(z["peak_bytes"]) for z in zs]),
          workers=json.dumps([_gb(st["peak_bytes"]) for st in stats]))
    for i, reading in enumerate(idle):
        phase("scale_out", run="S1", card=repr(card), what="shard_idle",
              shard=i, **_idle_fields(f"S1 shard {i}", reading))


S2_STEPS = 3


def s2_servers(tmp: str) -> dict:
    """S2's shard servers, 1 and 2 of them, fresh interpreters on the
    card: identity, one worker of ``S2_STEPS`` pushes. Spawned ahead of
    S1 so that their start-up overlaps its fleet's."""
    from pytorch_ps_mpi_tpu_torch.parallel import sharded

    d = os.path.join(tmp, "s2")
    os.makedirs(d)
    # the read tier armed on every shard (V5); the worker's last push is
    # a zero gradient, which SGD without momentum applies as no change,
    # so the shards hold the final state while their tenants are read
    cfg = async_cfg("resnet50", d, codec="identity", n_workers=1,
                    steps=S2_STEPS + 1, max_staleness=10**9,
                    transport="tcp", server_timeout=SO_LIMIT, read_port=0)
    s2 = {"cfg": cfg, "runs": {}}
    for n in (1, 2):
        paths = [os.path.join(d, f"n{n}_shard{i}.npz") for i in range(n)]
        ports = [free_port() for _ in range(n)]
        s2["runs"][n] = (paths, ports, [])
        for i in range(n):
            s2["runs"][n][2].append(sharded.spawn_shard_server(
                i, n, cfg, paths[i], port=ports[i]))
    return s2


def s2_procs(s2: dict) -> list:
    return [p for _, _, servers in s2["runs"].values() for p in servers]


def _lone_sync_worker(prob, ports: list, cfg: dict,
                      read_ports: list) -> tuple:
    """S2's one worker, driven from this process: each of ``S2_STEPS``
    steps reads every shard once its version has moved past the last one
    read (so the step sees its previous push applied on every shard),
    computes the gradient and pushes each slice to its shard. Then (V5)
    it reads each shard's tenant ``shard<i>`` from its read tier once the
    last update is in, and pushes a zero gradient that ends the run.
    Returns the steps' gradient ms and the tenants' reads assembled."""
    from pytorch_ps_mpi_tpu_torch.codecs import get_codec
    from pytorch_ps_mpi_tpu_torch.parallel.sharded import shard_plan
    from pytorch_ps_mpi_tpu_torch.parallel.tcp import TcpPSWorker
    from pytorch_ps_mpi_tpu_torch.serving import ServingReader

    flat_n = sum(p.numel() for p in prob.params)
    plan = shard_plan(flat_n, len(ports))
    conns = [TcpPSWorker("127.0.0.1", port, 0,
                         {"flat": np.zeros((b - a,), np.float32)},
                         code=get_codec(cfg["codec"]), timeout=SO_LIMIT,
                         frame=True, seed=cfg["seed"], device=prob.device)
             for (a, b), port in zip(plan, ports)]
    last, grad_ms = [0] * len(conns), []
    host = torch.empty(flat_n, dtype=torch.float32)
    read = np.empty(flat_n, np.float32)
    try:
        for step in range(S2_STEPS):
            versions = []
            for i, ((a, b), w) in enumerate(zip(plan, conns)):
                while True:
                    sl, ver = w.read_flat(timeout=SO_LIMIT)
                    if ver > last[i]:
                        break
                    time.sleep(0.0005)
                last[i] = ver
                host[a:b] = torch.from_numpy(sl)
                versions.append(ver)
            prob.load_flat(host.to(prob.device))
            t0 = time.perf_counter()
            _, grads = prob.grad_leaves(prob.batch_fn(step, 0))
            g = torch.cat([x.reshape(-1) for x in grads])
            torch.cuda.synchronize()
            grad_ms.append((time.perf_counter() - t0) * 1e3)
            for (a, b), ver, w in zip(plan, versions, conns):
                w.push_payload(w.encode([g[a:b]]), ver, timeout=SO_LIMIT,
                               lineage=(step, step))
        for i, ((a, b), port) in enumerate(zip(plan, read_ports)):
            r = ServingReader("127.0.0.1", port,
                              {"flat": np.zeros((b - a,), np.float32)},
                              tenant=f"shard{i}", timeout=SO_LIMIT)
            while True:
                tree, ver = r.read_params()
                if ver > last[i]:
                    break
                time.sleep(0.0005)
            r.close()
            read[a:b] = tree["flat"]
            last[i] = ver
        for (a, b), ver, w in zip(plan, last, conns):
            w.push_payload(w.encode([torch.zeros(b - a, device=prob.device)]),
                           ver, timeout=SO_LIMIT,
                           lineage=(S2_STEPS, S2_STEPS))
    finally:
        for w in conns:
            w.close()
    return grad_ms, read


def scale_s2(card: str, s2: dict) -> None:
    """S2: identity, 1 worker, 3 synchronous steps, cuDNN deterministic:
    1 shard and 2 shards (``s2_servers``) from the same seed. The one
    worker runs here, against the 1-shard servers and then the 2-shard
    ones. The final parameters must be equal bit for bit."""
    from pytorch_ps_mpi_tpu_torch.parallel import async_train as at
    from pytorch_ps_mpi_tpu_torch.parallel import sharded

    t0 = time.perf_counter()
    cfg, runs = s2["cfg"], s2["runs"]
    read_ports = {}
    for n, (_, ports, servers) in runs.items():
        hellos = [sharded.read_server_hello(p, SO_LIMIT) for p in servers]
        if [h["port"] for h in hellos] != ports:
            raise AssertionError(f"S2: servers not on {ports}")
        read_ports[n] = [h["read_port"] for h in hellos]
    prob = at.make_problem(cfg, "cuda")
    flat0 = prob.flat_params().cpu().numpy()
    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    # the same gradient for the same parameters in both runs
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.cuda.reset_peak_memory_stats()
    try:
        worked = {n: _lone_sync_worker(prob, ports, cfg, read_ports[n])
                  for n, (_, ports, _) in runs.items()}
        grad_ms = {n: g for n, (g, _) in worked.items()}
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark \
            = flags
    peak = torch.cuda.max_memory_allocated()
    codes = at.join_workers(s2_procs(s2), SO_LIMIT)
    if codes != [0] * len(codes):
        raise AssertionError(f"S2: exit codes {codes}")
    wall = time.perf_counter() - t0
    one, two = (_flat_of(runs[n][0], prob.template) for n in (1, 2))
    # the worker's model leaves the card before T1's root, which runs in
    # this process and reports its own peak memory
    del prob
    gc.collect()
    same = np.array_equal(one.view(np.uint32), two.view(np.uint32))
    moved = float(np.abs(one - flat0).max())
    if not same or moved == 0.0:
        raise AssertionError(f"S2: 1 shard vs 2 shards equal bit for bit: "
                             f"{same}; moved {moved}")
    for n, want in ((1, one), (2, two)):
        if not np.array_equal(worked[n][1].view(np.uint32),
                              want.view(np.uint32)):
            raise AssertionError(f"V5: the {n}-shard tenants' reads, "
                                 "assembled, differ from the result")
    zs2 = [np.load(p) for p in runs[2][0]]
    serving = [json.loads(str(z["serving"])) for z in zs2]
    phase("serving", run="V5", card=repr(card), model="resnet50",
          shards=2, tenants=json.dumps(sorted(t for s in serving
                                              for t in s["tenants"])),
          read_ports=json.dumps(read_ports[2]), bit_equal=True,
          read_native=json.dumps([s["read_native"] for s in serving]),
          shard_reads=json.dumps([s["reads_total"] for s in serving]))
    zs = [np.load(p) for n in (1, 2) for p in runs[n][0]]
    phase("scale_out", run="S2", card=repr(card), model="resnet50",
          code="identity", steps=S2_STEPS, bit_equal=same,
          max_abs_move=f"{moved:.6g}", wall_s=f"{wall:.3f}",
          worker="this_process",
          worker_grad_ms=json.dumps([f"{statistics.median(v):.3f}"
                                     for v in grad_ms.values()]),
          peak_gb_this_process=_gb(peak),
          peak_gb_shards=json.dumps([_gb(z["peak_bytes"]) for z in zs]))


def scale_tree(card: str, tmp: str, label: str, tally: dict,
               crash: bool) -> None:
    """T1: ``run_tree`` with 4 workers in 2 groups of 2; the leaf hop
    identity over TCP, the upstream hop int8 with hop EF, into a
    tree-mode root (sync barrier) on the card, 3 pushes a worker. T2: the
    same with group 1's leader crashing at its round 2, its workers paced
    (1.2 s) and pushing 8 times so they fall back to the root and rejoin
    the respawned leader."""
    from pytorch_ps_mpi_tpu_torch.parallel import tree

    d = os.path.join(tmp, label.lower())
    os.makedirs(d)
    steps = 3
    kw = {}
    if crash:
        steps = 8
        kw = dict(slow_ms={"2": 1200.0, "3": 1200.0},
                  degraded_round_after=1.0,
                  leader_kw={"crash_at_round": {"1": 2}, "rejoin_every": 2,
                             "degrade_after": 1.0, "flush_after": 2.0,
                             "idle_exit_s": 2.0})
    cfg = async_cfg("resnet50", d, codec="int8", n_workers=4, group_size=2,
                    steps=steps, max_staleness=10**9, transport="tcp",
                    idle_share=True, **kw)
    counters = kernel_counters()
    for k in counters.values():
        k.launches = 0
    t0 = time.perf_counter()
    _, m = tree.run_tree(cfg, total_pushes=None if crash else 4 * steps,
                         timeout=SO_LIMIT)
    wall = time.perf_counter() - t0
    t = m["tree"]
    if t["worker_codes"] != [0] * 4:
        raise AssertionError(f"{label}: worker exit codes "
                             f"{t['worker_codes']}")
    leaders = [json.load(open(os.path.join(d, f)))
               for f in sorted(os.listdir(d)) if f.startswith("leader-")]
    workers = [json.load(open(os.path.join(d, f"worker-{w}.json")))
               for w in range(4)]
    composed = [tuple(e) for e in t["composed_ids"]]
    lost = [tuple(e) for ld in leaders for e in ld["lost"]]
    expect = {(w, s, s) for w in range(4) for s in range(steps)}
    if len(set(composed)) != len(composed) or set(composed) & set(lost) \
            or set(composed) | set(lost) != expect:
        raise AssertionError(f"{label}: {len(composed)} composed and "
                             f"{len(lost)} lost of {len(expect)} pushes")
    for ld in leaders:
        if ld["decodes_done"]:
            raise AssertionError(f"{label}: leader {ld['group']} decoded "
                                 f"{ld['decodes_done']} pushes")
        # one upstream quantize a unit a hop push, and hop EF's decode
        _expect_launches(f"{label} leader {ld['group']}", ld["launches"],
                         {"quantize_int8": R50_UNITS * ld["upstream_pushes"],
                          "dequant_sum": R50_UNITS * ld["upstream_pushes"]})
        _tally(tally, ld["launches"])
    fallback = sum(w["fallback_pushes"] for w in workers)
    for i, w in enumerate(workers):
        # identity on the leaf hop; int8 for the root, a push encoded for
        # it (every fallback push, and one a probe that rejoins)
        if w["root_encodes"] < w["fallback_pushes"]:
            raise AssertionError(f"{label} worker {i}: {w}")
        _expect_launches(f"{label} worker {i}", w["launches"],
                         {"quantize_int8": R50_UNITS * w["root_encodes"]})
        _tally(tally, w["launches"])
    root = {k: v.launches for k, v in counters.items()}
    # the root folds int8 on the host: no decode kernel
    _expect_launches(f"{label} root", root, {})
    if not crash:
        if len(composed) != 12 or t["leader_respawns"] or fallback:
            raise AssertionError(f"T1: {len(composed)} composed, "
                                 f"{t['leader_respawns']} respawns, "
                                 f"{fallback} fallback pushes")
    else:
        rejoined = [ld for ld in leaders if ld["group"] == 1
                    and not ld["lost"] and ld["upstream_pushes"]]
        if t["leader_respawns"] < 1 or fallback < 1 or not rejoined:
            raise AssertionError(f"T2: {t['leader_respawns']} respawns, "
                                 f"{fallback} fallback pushes, rejoined "
                                 f"{len(rejoined)}")
    if (m["agg_mode"], m["decodes_per_publish"]) != (1.0, 1.0):
        raise AssertionError(f"{label}: agg_mode {m['agg_mode']}, "
                             f"decodes_per_publish "
                             f"{m['decodes_per_publish']}")
    if not m["loss_final"] < m["loss_initial"]:
        raise AssertionError(f"{label}: the loss did not fall: "
                             f"{m['loss_initial']} -> {m['loss_final']}")
    phase("scale_out", run=label, card=repr(card), model="resnet50",
          leaf_hop="identity_tcp", upstream="int8_hop_ef", groups=2,
          workers=4, pushes=len(expect), composed=len(composed),
          lost=len(lost), root_frames=int(m["grads_received"]),
          rounds=int(m["publish_version"]) - 1,
          degraded_rounds=int(m["degraded_rounds"]),
          leader_respawns=t["leader_respawns"], fallback_pushes=fallback,
          leader_codes=json.dumps(t["leader_codes"]),
          hop_rel_error=json.dumps([ld["hop"]["hop_rel_error"]
                                    for ld in leaders]),
          wall_s=f"{wall:.3f}", loss_before=f"{m['loss_initial']:.6f}",
          loss_after=f"{m['loss_final']:.6f}")
    lt = [ld["times"] for ld in leaders if ld["rounds"]]
    phase("scale_out", run=label, card=repr(card), what="per_push_ms",
          worker_grad=_median_ms(workers, "grad_s"),
          worker_encode_d2h=_median_ms(workers, "encode_s"),
          worker_push=_median_ms(workers, "push_s"),
          leader_fold=json.dumps([round(x["fold_s"] / ld["rounds"] * 1e3, 3)
                                  for x, ld in zip(lt, leaders)]),
          leader_h2d_encode=json.dumps([round(
              x["h2d_encode_s"] / ld["rounds"] * 1e3, 3)
              for x, ld in zip(lt, leaders)]),
          leader_push=json.dumps([round(x["push_s"] / ld["rounds"] * 1e3, 3)
                                  for x, ld in zip(lt, leaders)]),
          root_fold=f"{m['server_times'].get('fold_s', 0) / max(m['publish_version'] - 1, 1) * 1e3:.3f}",
          root_update=f"{m['server_times'].get('update_s', 0) / max(m['publish_version'] - 1, 1) * 1e3:.3f}")
    phase("scale_out", run=label, card=repr(card), what="peak_gb",
          root=_gb(m["server_peak_bytes"]),
          leaders=json.dumps([_gb(ld["peak_bytes"]) for ld in leaders]),
          workers=json.dumps([_gb(w["peak_bytes"]) for w in workers]))
    phase("scale_out", run=label, card=repr(card), what="root_idle",
          **_idle_fields(f"{label} root", m))


R1_PLAN = [{"at_step": 2, "worker": 0, "kind": "corrupt"},
           {"at_step": 3, "worker": 1, "kind": "crash_worker"},
           {"at_step": 4, "worker": 0, "kind": "drop"},
           {"at_step": 5, "worker": 1, "kind": "duplicate"},
           {"at_step": 6, "worker": "server", "kind": "crash_server"}]


def scale_r1(card: str, tmp: str, tally: dict) -> None:
    """R1: ResNet-18 (CIFAR stem), sign, shm, async, 2 workers of 8 steps
    under the Supervisor, checkpoints every 4, the fault plan
    ``R1_PLAN``."""
    from pytorch_ps_mpi_tpu_torch.resilience import (Supervisor,
                                                     load_fault_log)

    d = os.path.join(tmp, "r1")
    os.makedirs(d)
    fdir = os.path.join(d, "fleet")
    cfg = async_cfg("resnet18", d, codec="sign", steps=8, resilient=True,
                    push_timeout=3.0, slow_ms={"0": 100.0, "1": 100.0},
                    fault_plan=R1_PLAN, fault_seed=4,
                    fault_log_dir=os.path.join(d, "faults"),
                    idle_share=True, fleet_dir=fdir, metrics_port=0)
    counters = kernel_counters()
    for k in counters.values():
        k.launches = 0
    watch = _FleetWatch(fdir)
    t0 = time.perf_counter()
    try:
        _, m = Supervisor(cfg, 2, checkpoint_dir=os.path.join(d, "ckpt"),
                          checkpoint_every=4, timeout=SO_LIMIT).run()
    finally:
        watch.stop()
    wall = time.perf_counter() - t0
    # O3: the restarted server generation re-registered its card: one
    # card at a time, named "server", at a new endpoint
    urls = []
    for cards in watch.cards:
        if len(cards) > 1 or any(n != "server" for n, _ in cards):
            raise AssertionError(f"O3: fleet cards {cards}")
        if cards and (not urls or urls[-1] != cards[0][1]):
            urls.append(cards[0][1])
    if len(urls) != 2 or os.listdir(fdir):
        raise AssertionError(f"O3: the server's card at {urls}, left "
                             f"{os.listdir(fdir)}")
    phase("control", run="O3", card=repr(card), what="restart",
          server_cards=json.dumps(urls))
    server = {k: v.launches for k, v in counters.items()}
    fired = sorted((e["id"], e["kind"]) for role in ("0", "1", "server")
                   for e in load_fault_log(os.path.join(
                       d, "faults", f"faults-{role}.jsonl")))
    if fired != [(i, f["kind"]) for i, f in enumerate(R1_PLAN)]:
        raise AssertionError(f"R1: fired {fired}")
    if (m["worker_exit_codes"] != [0, 0] or m["worker_respawns"] < 1
            or m["server_restarts"] != 1 or m["workers_abandoned"]
            or not m["versions_monotonic"]):
        raise AssertionError(f"R1: exit codes {m['worker_exit_codes']}, "
                             f"respawns {m['worker_respawns']}, restarts "
                             f"{m['server_restarts']}")
    if m["reject_reasons_all_phases"] != {"corrupt": 1}:
        raise AssertionError(f"R1: rejected "
                             f"{m['reject_reasons_all_phases']}")
    _expect_launches("R1 server", server, {
        "unpack_signs_sum": R18_SIGN_UNITS
        * int(m["decodes_done_all_phases"])})
    _tally(tally, server)
    workers = [json.load(open(os.path.join(d, f"worker-{w}.json")))
               for w in range(2)]
    for i, w in enumerate(workers):
        # the last generation of each worker; a crashed one writes none
        _expect_launches(f"R1 worker {i}", w["launches"],
                         {"encode_signs": R18_SIGN_UNITS * w["encodes"]})
        _tally(tally, w["launches"])
    if not m["loss_final"] < m["run_loss_initial"]:
        raise AssertionError(f"R1: the loss did not fall: "
                             f"{m['run_loss_initial']} -> {m['loss_final']}")
    phase("scale_out", run="R1", card=repr(card), model="resnet18",
          code="sign", transport="shm", workers=2, steps=8,
          faults=json.dumps([k for _, k in fired]),
          worker_respawns=int(m["worker_respawns"]),
          server_restarts=int(m["server_restarts"]),
          worker_reconnects=int(m["worker_reconnects"]),
          rejected=json.dumps(m["reject_reasons_all_phases"]),
          received_all_phases=int(m["grads_received_all_phases"]),
          decodes_all_phases=int(m["decodes_done_all_phases"]),
          recovery_s=json.dumps(m["recovery_times"], separators=(",", ":")),
          wall_s=f"{wall:.3f}", loss_before=f"{m['run_loss_initial']:.6f}",
          loss_after=f"{m['loss_final']:.6f}")
    phase("scale_out", run="R1", card=repr(card), what="per_push_ms",
          worker_grad=_median_ms(workers, "grad_s"),
          worker_encode_d2h=_median_ms(workers, "encode_s"),
          worker_push=_median_ms(workers, "push_s"))
    phase("scale_out", run="R1", card=repr(card), what="peak_gb",
          server=_gb(m["server_peak_bytes"]),
          workers=json.dumps([_gb(w["peak_bytes"]) for w in workers]))
    phase("scale_out", run="R1", card=repr(card), what="server_idle",
          **_idle_fields("R1 server", m))


def run_scale_out(card: str) -> dict:
    """Phase 9 (``scale_out``): sharded servers, the aggregation tree and
    the supervised chaos run on the card, runs S1, S2, T1, T2 and R1
    (``PERF.md`` §4). Every process is a fresh interpreter on the same
    card but the root or server of T1, T2 and R1, which is this process.
    Returns the runs' kernel launches, summed over every process."""
    import shutil
    import tempfile

    from pytorch_ps_mpi_tpu_torch.parallel import async_train as at

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_scale_")
    tally: dict = {}
    s2 = None
    try:
        s2 = s2_servers(tmp)
        scale_s1(card, tmp, tally)
        scale_s2(card, s2)
        scale_tree(card, tmp, "T1", tally, crash=False)
        scale_tree(card, tmp, "T2", tally, crash=True)
        scale_r1(card, tmp, tally)
    finally:
        if s2 is not None:
            at.join_workers(s2_procs(s2), timeout=5.0)
        shutil.rmtree(tmp, ignore_errors=True)
    phase("scale_out", launches=json.dumps(tally, sort_keys=True,
                                           separators=(",", ":")),
          seconds=f"{time.perf_counter() - t0:.1f}")
    return tally


# -- phase telemetry: the per-process telemetry layer -------------------------

#: steps of each N1 optimizer; pushes a worker and probe cadence of N4
N1_STEPS = 3
N1_PAIRS = 10  # armed/unarmed step pairs timed in turns
N4_PUSHES = 4
N4_PROBE_EVERY = 2
N4_NAN = {"worker": 1, "at_step": 2}  # worker 1's third push
#: N4's max_staleness, its push count: no push is dropped as stale, so the
#: nan push always reaches the server's check
N4_MAX_STALENESS = ASYNC_WORKERS * N4_PUSHES
#: the kernel launches of one take of N2's profiled steps: ResNet-18 sign
#: per leaf; BERT-base 12 flash layers (dq and dkv each count a backward
#: launch) and TernGrad's per-leaf launches (:data:`TERN_LEAF`)
N2_LAUNCHES = {
    "sign": {"encode_signs": 20, "unpack_signs_sum": 20},
    "terngrad": {"flash_fwd": 12, "flash_bwd": 24, **TERN_LEAF},
}
#: the hand kernels a profiled step's ``top_ops`` must name
N2_KERNELS = {
    "sign": ("sign_encode_kernel", "sign_unpack_sum_kernel"),
    "terngrad": ("flash_fwd_tc", "flash_bwd_dq_tc", "flash_bwd_dkv_tc",
                 "tern_pack", "tern_unpack_sum"),
}


def _host_numerics(opt, old: dict, grads: dict) -> dict:
    """The numerics of a grads-only step in float64 on the host, from the
    same gradients and the parameters before (``old``) and after."""
    f64 = {k: g[0].double().cpu() for k, g in grads.items()}
    fin = {k: torch.where(torch.isfinite(g), g, torch.zeros_like(g))
           for k, g in f64.items()}
    gss = sum(float(torch.sum(g * g)) for g in fin.values())
    nonf = sum(int(torch.sum(~torch.isfinite(g))) for g in f64.values())
    upd = sum(float(torch.sum((p.detach().double().cpu() - old[k]) ** 2))
              for k, p in opt.params.items())
    psq = sum(float(torch.sum(o * o)) for o in old.values())
    out = {"grad_norm": math.sqrt(gss), "nonfinite_total": float(nonf),
           "update_ratio": math.sqrt(upd) / math.sqrt(psq)}
    plan = opt._bucket_plan
    if plan is not None:
        sums = [0.0] * plan.num_buckets
        for slot, name in zip(plan.leaf_slots, plan.names):
            sums[slot.bucket] += float(torch.sum(fin[name] ** 2))
        out["bucket_grad_norms"] = [math.sqrt(s) for s in sums]
    return out


def _launch_counts() -> dict:
    torch.cuda.synchronize()
    return {n: k.launches for n, k in kernel_counters().items()}


def _launched_since(before: dict) -> dict:
    """The kernel launches of this process since ``before``
    (:func:`_launch_counts`)."""
    now = _launch_counts()
    return {n: now[n] - before[n] for n in now if now[n] != before[n]}


def _window(fn) -> tuple:
    """``(fn(), launches)``: the kernel launches ``fn`` made, read as a
    difference and not by setting the counts to 0, so that the phase's
    own total (:func:`run_telemetry`) counts every launch of the phase."""
    before = _launch_counts()
    out = fn()
    return out, _launched_since(before)


def _dtoh_rows(rows) -> int:
    return sum(1 for e in rows if "memcpy dtoh" in e.name.lower())


def telemetry_n1() -> dict:
    """N1: ResNet-18 (CIFAR stem, b256) ``SGD(code=sign, numerics=True)``
    per leaf and at ``bucket_mb=16``: the statistics of a grads-only step
    against float64 on the host (rtol 1e-5), a NaN and an Inf planted in
    one leaf (the count exact, the norm the finite part's), the sign
    launches of ``N1_STEPS`` loss steps unchanged by numerics, one
    device-to-host copy more in a profiled step than without numerics,
    the step ms with and without (``N1_PAIRS`` steps each in turns) and
    the statistics' own ms."""
    from torch.func import functional_call

    from pytorch_ps_mpi_tpu_torch import SGD
    from pytorch_ps_mpi_tpu_torch.data import (cross_entropy_loss,
                                               synthetic_images)
    from pytorch_ps_mpi_tpu_torch.models import ResNet18
    from pytorch_ps_mpi_tpu_torch.utils import tracing

    stream = synthetic_images("cifar10", BATCH, seed=0, device="cuda")
    batches = [next(stream) for _ in range(N1_STEPS + 5)]
    out = {}
    for bucket_mb, per_step in ((0.0, {"encode_signs": 20,
                                       "unpack_signs_sum": 20}),
                                (BUCKET_MB, PLAN_LAUNCHES["sign"])):
        models = [ResNet18(num_classes=10, small_inputs=True, seed=0,
                           device="cuda") for _ in range(2)]

        def loss_of(model):
            def loss_fn(params, b):
                x, y = b
                return cross_entropy_loss(
                    functional_call(model, params, (x,)), y)
            return loss_fn

        armed, plain = (SGD(ordered_params(m), lr=0.01, momentum=0.9,
                            code=make_codec("sign"), device="cuda",
                            bucket_mb=bucket_mb, numerics=numerics)
                        for m, numerics in zip(models, (True, False)))
        losses = [loss_of(m) for m in models]
        # the sign launches of the armed loss steps: those of a step
        def steps():
            return [armed.step(loss_fn=losses[0], batch=b)[1]
                    for b in batches[:N1_STEPS]]
        datas, launches = _window(steps)
        _expect(f"N1 bucket_mb={bucket_mb}", launches, per_step, N1_STEPS)
        if not all(math.isfinite(d["grad_norm"]) and d["grad_norm"] > 0
                   for d in datas):
            raise AssertionError(f"N1: grad_norm {datas}")
        # one device-to-host copy more a profiled step than unarmed
        copies = []
        for opt, lf in ((armed, losses[0]), (plain, losses[1])):
            opt.step(loss_fn=lf, batch=batches[N1_STEPS])
            _, rows, _ = tracing.profiled_rows(
                lambda: opt.step(loss_fn=lf, batch=batches[N1_STEPS]))
            copies.append(_dtoh_rows(rows))
        if copies[0] != copies[1] + 1:
            raise AssertionError(f"N1: {copies[0]} D2H copies armed, "
                                 f"{copies[1]} unarmed")
        # armed and unarmed steps in turns, the first of a pair alternating
        pairs = ([], [])
        for i in range(N1_PAIRS):
            b = batches[i % len(batches)]
            order = (0, 1) if i % 2 == 0 else (1, 0)
            for j in order:
                opt = (armed, plain)[j]
                pairs[j].append(opt.step(loss_fn=losses[j], batch=b)[1]
                                ["step_time"] * 1e3)
        ms = [statistics.median(t) for t in pairs]
        added = statistics.median(a - u for a, u in zip(*pairs))
        # the statistics alone: the vector and its one copy, between syncs
        from pytorch_ps_mpi_tpu_torch.telemetry.numerics import flat_f32

        grads = {k: 1e-3 * p.detach() for k, p in armed.params.items()}
        old = flat_f32(armed.params.values())
        host = []
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            armed._numerics_vec(old, grads).cpu()
            host.append((time.perf_counter() - t0) * 1e3)
        stats_ms = statistics.median(host)
        # the statistics of a grads-only step against float64 on the host,
        # then with a NaN and an Inf planted in one leaf
        gen = torch.Generator(device="cuda").manual_seed(11)
        checks = {}
        for planted in (False, True):
            grads = {k: 1e-3 * torch.randn((WORLD,) + tuple(p.shape),
                                           generator=gen, device="cuda")
                     for k, p in armed.params.items()}
            if planted:
                leaf = grads["conv_init.weight"
                             if "conv_init.weight" in grads
                             else next(iter(grads))].view(-1)
                leaf[7], leaf[11], leaf[13] = (float("nan"), float("inf"),
                                               float("-inf"))
            old = {k: p.detach().double().cpu()
                   for k, p in armed.params.items()}
            _, data = armed.step(grads=grads)
            want = _host_numerics(armed, old, grads)
            if planted:
                if data["nonfinite_total"] != 3.0:
                    raise AssertionError(f"N1: nonfinite_total "
                                         f"{data['nonfinite_total']} != 3")
                keys = ("grad_norm",)
            else:
                keys = ("grad_norm", "update_ratio", "nonfinite_total")
            for k in keys:
                if not math.isclose(data[k], want[k], rel_tol=1e-5):
                    raise AssertionError(f"N1: {k} {data[k]} against "
                                         f"{want[k]} on the host")
            if bucket_mb and not planted:
                got, exp = data["bucket_grad_norms"], want["bucket_grad_norms"]
                if len(got) != len(exp) or not all(
                        math.isclose(a, b, rel_tol=1e-5)
                        for a, b in zip(got, exp)):
                    raise AssertionError(f"N1: bucket norms {got} against "
                                         f"{exp}")
            checks["planted" if planted else "clean"] = {
                k: data[k] for k in ("grad_norm", "update_ratio",
                                     "nonfinite_total")}
        phase("telemetry", run="N1", model="ResNet18-cifar-gn-f32",
              code="sign", batch=BATCH, bucket_mb=bucket_mb,
              launches=json.dumps(launches, separators=(",", ":")),
              dtoh_armed=copies[0], dtoh_unarmed=copies[1],
              step_ms_armed=f"{ms[0]:.3f}", step_ms_unarmed=f"{ms[1]:.3f}",
              pairs=N1_PAIRS, added_ms_median_pair=f"{added:.3f}",
              stats_alone_ms=f"{stats_ms:.3f}",
              grad_norm=f"{checks['clean']['grad_norm']:.6f}",
              update_ratio=f"{checks['clean']['update_ratio']:.6e}",
              planted_nonfinite=int(checks["planted"]["nonfinite_total"]),
              planted_grad_norm=f"{checks['planted']['grad_norm']:.6f}")
        out[f"bucket_mb={bucket_mb}"] = ms
        del armed, plain, models
        torch.cuda.empty_cache()
    return out


def _top_ops_names(split: dict, code: str) -> dict:
    names = [n for n, _ in split["top_ops"]]
    where = {}
    for want in N2_KERNELS[code]:
        hits = [i for i, n in enumerate(names) if want in n]
        if not hits:
            raise AssertionError(f"N2 {code}: top_ops names no {want}: "
                                 f"{names[:20]}")
        where[want] = hits[0]
    return where


def telemetry_n2(tmp: str) -> None:
    """N2: ``step(profile=True)`` on ResNet-18 sign and on BERT-base b4
    s512 bf16 ``Adam(terngrad(use_pallas=True))``: ``top_ops`` names the
    hand kernels, and each profiled step's launches are a step's times
    the profiler's takes (:data:`N2_LAUNCHES`: a retake runs the step
    again, from the state it began with); then a BERT step under ``utils.tracing.trace`` with the
    flight recorder on, merged by ``trace_export`` into one Chrome trace,
    read back and its host spans and device events counted."""
    from torch.func import functional_call

    from pytorch_ps_mpi_tpu_torch import SGD, Adam, telemetry
    from pytorch_ps_mpi_tpu_torch.data import (cross_entropy_loss,
                                               synthetic_images,
                                               synthetic_mlm)
    from pytorch_ps_mpi_tpu_torch.models import (BertConfig, BertMLM,
                                                 ResNet18, mlm_loss)
    from pytorch_ps_mpi_tpu_torch.utils import tracing

    r18 = ResNet18(num_classes=10, small_inputs=True, seed=0, device="cuda")
    opt = SGD(ordered_params(r18), lr=0.01, momentum=0.9,
              code=make_codec("sign"), device="cuda")
    x, y = next(synthetic_images("cifar10", BATCH, seed=0, device="cuda"))

    def r18_loss(params, b):
        return cross_entropy_loss(functional_call(r18, params, (b[0],)),
                                  b[1])

    opt.step(loss_fn=r18_loss, batch=(x, y))
    data, launches = _window(lambda: opt.step(
        loss_fn=r18_loss, batch=(x, y), profile=True)[1])
    rank = _top_ops_names(opt.profile_split, "sign")
    split = opt.profile_split
    _expect("N2 sign", launches, N2_LAUNCHES["sign"], split["takes"])
    phase("telemetry", run="N2", model="ResNet18-cifar-gn-f32", code="sign",
          device_busy_s=f"{split['device_busy_s']:.6f}",
          comm_s=f"{split['comm_s']:.6f}",
          compute_s=f"{split['compute_s']:.6f}",
          devices=split["devices"], device_rows=split["device_rows"],
          takes=split["takes"], step_ms=f"{data['step_time'] * 1e3:.3f}",
          top_ops_rank=json.dumps(rank, separators=(",", ":")),
          launches=json.dumps(launches, separators=(",", ":")))
    del opt, r18
    bert = BertMLM(BertConfig(dtype=torch.bfloat16, attention="flash"),
                   seed=0, device="cuda")
    opt = Adam(ordered_params(bert), lr=1e-4, code=make_codec("terngrad"),
               device="cuda")
    b = next(synthetic_mlm(BERT_BATCH, BERT_SEQ, bert.cfg.vocab_size, seed=0,
                           device="cuda"))

    def bert_loss(params, batch):
        logits = functional_call(bert, params, (batch["tokens"],))
        return mlm_loss(logits, batch["targets"], batch["mask"])

    opt.step(loss_fn=bert_loss, batch=b)
    data, launches = _window(
        lambda: opt.step(loss_fn=bert_loss, batch=b, profile=True)[1])
    rank = _top_ops_names(opt.profile_split, "terngrad")
    split = opt.profile_split
    _expect("N2 terngrad", launches, N2_LAUNCHES["terngrad"],
            split["takes"])
    phase("telemetry", run="N2", model="BERT-base-mlm-bf16-flash",
          code="terngrad", batch=f"{BERT_BATCH}x{BERT_SEQ}",
          device_busy_s=f"{split['device_busy_s']:.6f}",
          comm_s=f"{split['comm_s']:.6f}",
          compute_s=f"{split['compute_s']:.6f}",
          devices=split["devices"], device_rows=split["device_rows"],
          takes=split["takes"], step_ms=f"{data['step_time'] * 1e3:.3f}",
          top_ops_rank=json.dumps(rank, separators=(",", ":")),
          launches=json.dumps(launches, separators=(",", ":")))
    # the merged trace: recorder spans and the step's kernels in one file
    rec = telemetry.configure(worker="chip_smoke")
    try:
        d = os.path.join(tmp, "device-trace")
        t_wall = time.time()
        with tracing.trace(d):
            opt.step(loss_fn=bert_loss, batch=b)
        path, counts = telemetry.export_chrome_trace(
            os.path.join(tmp, "trace.json"), rec.events(),
            device_trace_dir=d, device_t0_wall=t_wall)
    finally:
        telemetry.disable()
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    host = sum(1 for e in events if e.get("cat") == "host"
               and e.get("ph") == "X")
    device = sum(1 for e in events if e.get("cat") == "device"
                 and e.get("ph") == "X")
    names = {e["name"] for e in events if e.get("cat") == "device"}
    if not host or not all(any(k in n for n in names)
                           for k in ("tern_pack", "flash_fwd_tc")):
        raise AssertionError(f"N2 trace: {host} host spans, {device} device "
                             f"events, counts {counts}")
    phase("telemetry", run="N2", what="merged_trace", host_spans=host,
          device_events=device, mb=f"{os.path.getsize(path) / 1e6:.1f}")
    del opt, bert
    torch.cuda.empty_cache()


@contextlib.contextmanager
def _plain_kernels():
    """The codecs' kernel wrappers swapped for their plain versions (on
    the card) inside; restored on exit."""
    from pytorch_ps_mpi_tpu_torch.ops import quant as Q
    from pytorch_ps_mpi_tpu_torch.ops import sign as S
    from pytorch_ps_mpi_tpu_torch.ops import topk as T

    saved = [(S, "encode_signs", S.encode_signs),
             (S, "unpack_signs_sum", S.unpack_signs_sum),
             (Q, "quantize_int8", Q.quantize_int8),
             (Q, "dequantize_int8", Q.dequantize_int8),
             (T, "exact_topk", T.exact_topk)]
    S.encode_signs = S.encode_signs_ref
    S.unpack_signs_sum = S.unpack_signs_sum_ref
    Q.quantize_int8 = Q.quantize_int8_ref
    Q.dequantize_int8 = lambda q, s: Q.dequant_sum_ref(q.reshape(1, -1),
                                                       s.reshape(1))
    T.exact_topk = T.exact_topk_ref
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def telemetry_n3(tmp: str) -> None:
    """N3: ``CodecWire.probe_fidelity`` on one ResNet-50 gradient (A1's
    ``small_inputs`` model) for sign, int8 and ef(topk(0.01, pallas)), on
    the card through the hand kernels, against the same probe with the
    kernels' plain versions on the card: ``rel_error`` and ``cosine`` to
    rtol 1e-5, bits/param and the unit exact, the top-k index set exact;
    each probe's kernel launches asserted."""
    from pytorch_ps_mpi_tpu_torch.ops import topk as T
    from pytorch_ps_mpi_tpu_torch.parallel import async_train as at
    from pytorch_ps_mpi_tpu_torch.parallel.dcn import CodecWire

    prob = at.make_problem(async_cfg("resnet50", tmp), "cuda")
    _, grads = prob.grad_leaves(prob.batch_fn(0, 0))
    want_launches = {"sign": {"encode_signs": 1, "unpack_signs_sum": 1},
                     "int8": {"quantize_int8": 1, "dequantize_int8": 1},
                     "ef_topk": {"exact_topk": T.LAUNCHES}}
    for name, want in want_launches.items():
        wire = CodecWire(make_codec(name), prob.template, device="cuda")
        got, launches = _window(lambda: wire.probe_fidelity(grads))
        _expect(f"N3 {name}", launches, want, 1)
        with _plain_kernels():
            ref = wire.probe_fidelity(grads)
        if (got["unit"], got["bits_per_param"]) != (ref["unit"],
                                                    ref["bits_per_param"]):
            raise AssertionError(f"N3 {name}: {got} against {ref}")
        for k in ("rel_error", "cosine", "grad_norm"):
            if not math.isclose(got[k], ref[k], rel_tol=1e-5):
                raise AssertionError(f"N3 {name}: {k} {got[k]} against the "
                                     f"plain versions' {ref[k]}")
        extra = {}
        if name == "ef_topk":
            unit = grads[got["unit"]].reshape(-1)
            inner = wire.code.inner
            idx = inner.encode(unit)[0]["indices"]
            with _plain_kernels():
                ref_idx = inner.encode(unit)[0]["indices"]
            if not torch.equal(torch.sort(idx.long())[0],
                               torch.sort(ref_idx.long())[0]):
                raise AssertionError("N3 ef_topk: the top-k index sets "
                                     "differ")
            extra = dict(k=int(idx.numel()),
                         ef_residual_norm=f"{got['ef_residual_norm']:.6f}")
        phase("telemetry", run="N3", model="resnet50-small", code=name,
              unit=got["unit"], unit_size=int(grads[got["unit"]].numel()),
              rel_error=f"{got['rel_error']:.6f}",
              cosine=f"{got['cosine']:.6f}",
              bits_per_param=f"{got['bits_per_param']:.4f}",
              launches=json.dumps(launches, separators=(",", ":")), **extra)
    del prob, grads
    torch.cuda.empty_cache()


def _scrape(port: int) -> tuple:
    import urllib.request

    base = f"http://127.0.0.1:{port}"
    text = urllib.request.urlopen(base + "/metrics", timeout=10).read()
    doc = json.loads(urllib.request.urlopen(base + "/health",
                                            timeout=10).read())
    return text.decode(), doc


def telemetry_n4(card: str, tmp: str, a1: dict, workers: dict) -> None:
    """N4: A1's fleet armed (ResNet-50 ``small_inputs``, b32, seed 5, SGD
    lr 1e-4, 4 workers over shm, async, sign, worker 3 a 200 ms straggler,
    ``N4_PUSHES`` pushes a worker; ``max_staleness`` above the push count,
    :data:`N4_MAX_STALENESS`, where A1 has 4) with
    ``telemetry_dir``, ``metrics_port=0``, ``health``, ``numerics``
    (policy skip, probes every ``N4_PROBE_EVERY``), ``lineage`` with the
    round anatomy and ``trace``; a ``nan`` fault on worker 1's third
    push. ``/metrics`` and ``/health`` are scraped while it runs. The
    workers' launches are added to ``workers``."""
    from pytorch_ps_mpi_tpu_torch.codecs import get_codec
    from pytorch_ps_mpi_tpu_torch.parallel import async_train as at
    from pytorch_ps_mpi_tpu_torch.parallel.dcn import ShmPSServer
    from pytorch_ps_mpi_tpu_torch.resilience.faults import normalize_plan
    from pytorch_ps_mpi_tpu_torch.telemetry import (load_jsonl,
                                                    load_lineage_rows)

    tdir = os.path.join(tmp, "n4")
    stats = os.path.join(tmp, "n4-stats")
    os.makedirs(stats)
    last = str(ASYNC_WORKERS - 1)
    cfg = async_cfg("resnet50", stats, slow_ms={last: 200.0},
                    steps=N4_PUSHES, codec="sign", telemetry_dir=tdir,
                    metrics_port=0, health=True, health_dir=tdir,
                    numerics=True, numerics_dir=tdir,
                    numerics_kw={"policy": "skip",
                                 "probe_every": N4_PROBE_EVERY},
                    lineage=True, anatomy="auto", trace=True,
                    fault_plan=normalize_plan([{**N4_NAN, "kind": "nan"}]))
    template = at.make_problem(cfg, "cuda").template
    name = f"/psq_chip_smoke_{os.getpid()}_N4"
    server = ShmPSServer(name, ASYNC_WORKERS, template,
                         max_staleness=N4_MAX_STALENESS,
                         code=get_codec("sign"), frame=True, device="cuda")
    scrapes = []

    def on_tick():
        http = getattr(server, "_metrics_http", None)
        if http is not None and (not scrapes
                                 or time.time() - scrapes[-1][0] > 1.0):
            scrapes.append((time.time(),) + _scrape(http.port))

    procs = []
    total = ASYNC_WORKERS * N4_PUSHES
    try:
        procs = [at.spawn_worker(name, i, cfg) for i in range(ASYNC_WORKERS)]
        _, m = at.serve(server, cfg, total_grads=0, total_received=total,
                        timeout=ASYNC_LIMIT, on_tick=on_tick)
        final = _scrape(m["metrics_port"])
        codes = at.join_workers(procs, timeout=ASYNC_LIMIT)
        if codes != [0] * ASYNC_WORKERS:
            raise AssertionError(f"N4: worker exit codes {codes}")
    finally:
        server.close()
        at.join_workers(procs, timeout=5.0)
    if len(scrapes) < 2:
        raise AssertionError(f"N4: {len(scrapes)} scrapes while running")
    if "ps_grad_norm" not in final[0] or "ps_worker_health" not in final[0]:
        raise AssertionError("N4: /metrics lacks the numerics or health "
                             "series")
    for _, text, doc in scrapes:
        if not (text.startswith("# HELP") and doc.get("workers")):
            raise AssertionError(f"N4: a scrape while running: {doc}")
    # no push is stale: the nan push is checked, quarantined once and
    # never applied, and worker 1's next push is dropped as quarantined
    # under the skip policy; every other push is applied
    rows = load_lineage_rows(os.path.join(tdir, "lineage-server.jsonl"))
    pubs = [r for r in rows if r.get("kind") == "publish"]
    applied_ids = {(p["worker"], p["step"]) for r in pubs
                   for p in r["pushes"]}
    fate = {(r["push"]["worker"], r["push"]["step"]): r["reason"]
            for r in rows if r.get("kind") == "drop"}
    nan_id = (N4_NAN["worker"], N4_NAN["at_step"])
    nan_fate = fate.get(nan_id)
    if nan_id in applied_ids or nan_fate != "numerics":
        raise AssertionError(f"N4: the nan push's lineage: {nan_fate}")
    num, reasons = m["numerics"], m["reject_reasons"]
    ok = ((num["nonfinite_total"], num["quarantined"]) == (1, [1])
          and reasons == {"nonfinite": 1, "quarantined": 1}
          and m["stale_drops"] == 0)
    if not ok or m["applied"] != total - 2:
        raise AssertionError(f"N4: the nan push {nan_fate}, numerics {num}, "
                             f"rejections {reasons}, applied "
                             f"{m['applied']}, dropped {m['stale_drops']}")
    with open(os.path.join(tdir, "anatomy-server.jsonl")) as f:
        rounds = [json.loads(x) for x in f if x.strip()]
    rounds = [r for r in rounds if r.get("kind") == "round"]
    if not (len(pubs) == len(rounds) == int(m["applied"])
            == int(m["anatomy_rounds"])):
        raise AssertionError(f"N4: {len(pubs)} lineage rows, {len(rounds)} "
                             f"anatomy rounds, {m['applied']} applied")
    probes = {}
    for w in range(ASYNC_WORKERS):
        with open(os.path.join(tdir, f"numerics-{w}.jsonl")) as f:
            probes[w] = [json.loads(x) for x in f if x.strip()]
    want_probes = len(range(0, N4_PUSHES, N4_PROBE_EVERY))
    if any(len(p) != want_probes for p in probes.values()):
        raise AssertionError(f"N4: probe rows {probes}")
    meta, events = load_jsonl(os.path.join(tdir, "server.jsonl"))
    names = {e["name"] for e in events}
    if not {"serve.update", "serve.consume",
            "numerics.nonfinite"} <= names:
        raise AssertionError(f"N4: recorder names {sorted(names)}")
    for w in range(ASYNC_WORKERS):
        load_jsonl(os.path.join(tdir, f"worker-{w}.jsonl"))
    if not m["loss_final"] < m["loss_initial"]:
        raise AssertionError(f"N4: the loss did not fall: "
                             f"{m['loss_initial']} -> {m['loss_final']}")
    # launches: an encode a kernel-layout unit a push and a probe's encode
    # and decode on the workers; a decode a kernel-layout unit a decoded
    # push on the server
    sizes = async_sizes("resnet50")
    k50 = sum(1 for n in sizes if n % 1024 == 0)
    wstats = [json.loads(open(os.path.join(stats, f"worker-{i}.json")).read())
              for i in range(ASYNC_WORKERS)]
    for i, s in enumerate(wstats):
        _expect_launches(f"N4 worker {i}", s["launches"],
                         {"encode_signs": k50 * s["encodes"] + want_probes,
                          "unpack_signs_sum": want_probes})
        _tally(workers, s["launches"])
    _expect_launches("N4 server", m["server_launches"],
                     {"unpack_signs_sum": k50 * int(m["decodes_done"])})
    health = {w["worker"]: w["verdict"] for w in m["health"]["workers"]}
    if {str(w): v for w, v in health.items()}.get(
            str(N4_NAN["worker"])) != "quarantined":
        raise AssertionError(f"N4: health verdicts {health}")
    crit = m["anatomy"]["critical_path"]
    top = crit[0]["stage"] if crit else None
    ratio = (m["steady_updates_per_sec"] / a1["steady_updates_per_sec"]
             if a1 else float("nan"))
    phase("telemetry", run="N4", card=repr(card), model="resnet50",
          code="sign", workers=ASYNC_WORKERS, pushes=total,
          applied=int(m["applied"]), stale_drops=int(m["stale_drops"]),
          nan_push=nan_fate, rejected=json.dumps(reasons, sort_keys=True),
          scrapes=len(scrapes) + 1, lineage_rows=len(pubs),
          anatomy_rounds=len(rounds), probe_rows=sum(map(len,
                                                         probes.values())),
          recorder_events=len(events), health=json.dumps(health),
          anatomy_top_stage=top,
          codec_rel_error=f"{m['codec_rel_error']:.6f}",
          grad_norm=f"{m['grad_norm']:.6f}",
          update_ratio=f"{m['update_ratio']:.6e}",
          steady_updates_per_sec=f"{m['steady_updates_per_sec']:.3f}",
          armed_over_a1=f"{ratio:.3f}",
          loss_before=f"{m['loss_initial']:.6f}",
          loss_after=f"{m['loss_final']:.6f}")


def run_telemetry(card: str, a1: dict = None) -> dict:
    """Phase ``telemetry``: the per-process telemetry layer on the card,
    runs N1-N4 (``PERF.md`` §4). Returns every kernel launch of the
    phase: this process's (N1-N4 and N4's server, the kernel side of N3's
    comparisons included; no count is set to 0 in the phase) and N4's
    workers'."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_telemetry_")
    before = _launch_counts()
    workers: dict = {}
    try:
        telemetry_n1()
        telemetry_n2(tmp)
        telemetry_n3(tmp)
        telemetry_n4(card, tmp, a1, workers)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    tally: dict = {}
    _tally(tally, _launched_since(before))
    _tally(tally, workers)
    phase("telemetry", launches=json.dumps(tally, sort_keys=True,
                                           separators=(",", ":")),
          seconds=f"{time.perf_counter() - t0:.1f}")
    return tally


# -- phase control: the fleet observability plane and the controller ---------

CONTROL_LIMIT = 300.0  # seconds a control fleet may take, spawn to join
#: the rules of O1 and O2: stale drops a second (target 0.1/s), and the
#: exact push e2e p95 against a target no healthy fleet reaches; windows
#: short enough for a run of seconds
CONTROL_SLO = {"rules": [
    {"name": "stale_drops", "key": "stale_drops", "mode": "rate",
     "target": 0.1},
    {"name": "push_e2e_p95", "key": "push_e2e_p95_ms", "mode": "value",
     "target": 60000.0}],
    "short_window_s": 2.0, "long_window_s": 4.0, "eval_every_s": 0.2}
#: O2: the straggler's sleep a step and the bound its pushes exceed
O2_SLOW_MS = 400.0
O2_MAX_STALENESS = 5
#: C: pushes of the healthy workers and of the straggler (worker 1), the
#: delay that makes a healthy step wire-bound, the straggler's sleep, the
#: nan worker and its steps, and the controller's knobs (after
#: ``tools/control_smoke.py``'s, its cooldowns a second)
C_STEPS, C_STRAGGLER_STEPS = 36, 9
C_DELAY_MS, C_SLOW_MS = 150.0, 1200.0
C_NAN = {"worker": 2, "steps": (2, 3)}
C_KNOBS = {"eval_every_s": 0.25, "warmup_s": 1.0, "cooldown_s": 1.0,
           "settle_s": 8.0, "window_s": 3.0, "probation_s": 1.5,
           # past the fleet's p50 by 3 versions, not the default 1: at
           # ResNet-50 on an H100 a healthy worker's staleness EWMA
           # reached p50 + 1.1 and p50 + 1.98, its wires built at boot
           # (PERF.md section 6); the straggler's reaches p50 + 10
           "lr_stale_margin": 3.0,
           "shed_hi_per_s": 0.5, "ring_grow_per_s": 0.5, "ring_max": 8,
           "read_p95_target_ms": 30000.0, "replica_max": 1,
           "replica_cooldown_s": 1.0, "replica_shed_per_s": 2.0,
           "ladder": [{"codec": "identity"}, {"codec": "int8"}]}
C_SERVING = {"admission_depth": 2, "ring": 2, "retry_after_s": 0.01}
#: C5: the workers' pace and leader 0's fold sleep a payload (ms), under
#: the pace for one payload, so the slow hop queues little; the pushes of
#: group 0's workers (0 and 1), enough for the split's new leader to
#: boot on the card and take most of worker 1's; and those of group 1's
#: (2 and 3), which go on until group 0's hop, idle once its workers are
#: done, is cold and merges back. The sync root paces every group at
#: ~4 s a push on an H100. The pace is slow on purpose: at 300 ms the
#: ResNet-50 hop's own fold keeps the advisor's saving at 0.29-0.58, at
#: 1 s at 0.02-0.08 with one group pushing (PERF.md section 6)
C5_PACE_MS, C5_SLOW_MS = 1000.0, 500.0
C5_HOT_STEPS, C5_STEPS = 12, 18
#: C5's saving thresholds: a split at 0.4, a merge under half of it. The
#: replan cooldown is the default 20 s: a merge waits 40 s after the
#: split, until group 0 is done (at 0.5 s one merged on a dip while it
#: pushed and split again at once)
C5_HOT_FRAC = 0.4
#: the storm: sockets, and requests pipelined on each before any reply
STORM_SOCKETS, STORM_DEPTH = 4, 6


def _http_json(port: int, path: str) -> dict:
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as r:
        return json.loads(r.read())


def control_fleet(label: str, cfg: dict, workers: int, *, code_name: str,
                  sync_barrier: bool = False, max_staleness: int = 10**9,
                  on_tick=None, beside=None) -> tuple:
    """One fleet of the phase: the server in this process, ``workers``
    fresh interpreters on the card with one intra-op thread each.
    ``beside(server, stop)`` runs on a thread while the fleet serves (the
    readers of C); ``on_tick(server, last)`` at the serve loop's tick and
    once more (``last``) after it, while the endpoint lives. Returns
    ``(metrics, worker stats, server)``; the server is closed, its
    counters kept."""
    import threading

    from pytorch_ps_mpi_tpu_torch.codecs import get_codec
    from pytorch_ps_mpi_tpu_torch.parallel import async_train as at

    cfg = {**cfg, "codec": code_name}
    template = at.make_problem(cfg, cfg["device"]).template
    kw = dict(max_staleness=max_staleness, code=get_codec(code_name),
              frame=True, device=cfg["device"])
    if cfg.get("transport") == "tcp":
        from pytorch_ps_mpi_tpu_torch.parallel.tcp import TcpPSServer

        server = TcpPSServer(0, workers, template, **kw)
        name = f"127.0.0.1:{server.port}"
    else:
        from pytorch_ps_mpi_tpu_torch.parallel.dcn import ShmPSServer

        name = f"/psq_chip_smoke_{os.getpid()}_{label}"
        server = ShmPSServer(name, workers, template, **kw)
    procs, stop, side, box = [], threading.Event(), None, {}
    total = sum(at.worker_cfg(cfg, i)[1] for i in range(workers))
    try:
        procs = [at.spawn_worker(name, i, cfg, env=FLEET_ENV)
                 for i in range(workers)]
        if beside is not None:
            def run_beside():
                try:
                    box["beside"] = beside(server, stop)
                except BaseException as e:  # raised below, not lost
                    box["error"] = e

            side = threading.Thread(target=run_beside, daemon=True)
            side.start()
        _, m = at.serve(server, cfg, total_grads=0, total_received=total,
                        sync_barrier=sync_barrier, timeout=CONTROL_LIMIT,
                        on_tick=None if on_tick is None
                        else (lambda: on_tick(server, False)))
        codes = at.join_workers(procs, timeout=CONTROL_LIMIT)
        if codes != [0] * workers:
            raise AssertionError(f"{label}: worker exit codes {codes}")
        if on_tick is not None:
            on_tick(server, True)  # a last look while the endpoint lives
    finally:
        stop.set()
        if side is not None:
            side.join(timeout=120.0)
        server.close()
        at.join_workers(procs, timeout=5.0)
    if "error" in box:
        raise AssertionError(f"{label}: beside the fleet: "
                             f"{box['error']!r}") from box["error"]
    m["beside"] = box.get("beside")
    stats = [json.loads(open(os.path.join(cfg["stats_dir"],
                                          f"worker-{i}.json")).read())
             for i in range(workers)]
    if m["grads_received"] != total:
        raise AssertionError(f"{label}: {m['grads_received']} received of "
                             f"{total}, rejected "
                             f"{m['reject_reasons']} in {m['wall_s']:.1f} s")
    return m, stats, server


def control_o1(card: str, tmp: str, a2: dict, tally: dict) -> None:
    """O1: A2's fleet (ResNet-50, 4 workers over shm, int8 under the sync
    barrier, agg auto: the host fold, worker 3 a 200 ms straggler, 3
    pushes a worker) with everything of the observability plane armed:
    the history, the SLO rules :data:`CONTROL_SLO`, the sampling profiler
    in the server and the workers, lineage (``trace``), beacons, the
    fleet card. ``/history`` is read while it runs."""
    from pytorch_ps_mpi_tpu_torch.telemetry import (load_lineage_rows,
                                                    load_profile)
    from pytorch_ps_mpi_tpu_torch.telemetry.profiler import native_counters

    d = os.path.join(tmp, "o1")
    os.makedirs(d)
    last = str(ASYNC_WORKERS - 1)
    cfg = async_cfg("resnet50", d, slow_ms={last: 200.0},
                    steps=ASYNC_STEPS // 2, telemetry_dir=d,
                    metrics_port=0, timeseries=True, slo=True,
                    slo_kw=CONTROL_SLO, profile=True, trace=True,
                    health=True, health_dir=d,
                    fleet_dir=os.path.join(d, "fleet"))
    reads, p95 = [], []

    def on_tick(server, last):
        http = getattr(server, "_metrics_http", None)
        if http is not None and (last or not reads
                                 or time.time() - reads[-1][0] > 0.5):
            reads.append((time.time(), _http_json(
                http.port, "/history?key=grads_received&window=600")))
            if last:
                p95.append(_http_json(
                    http.port, "/history?key=push_e2e_p95_ms&window=600"))

    folds0 = (native_counters().get("wirecodec") or {}).get("fold_calls", 0)
    t0 = time.perf_counter()
    m, stats, _ = control_fleet("O1", cfg, ASYNC_WORKERS, code_name="int8",
                                sync_barrier=True, max_staleness=4,
                                on_tick=on_tick)
    wall = time.perf_counter() - t0
    folds = (native_counters().get("wirecodec") or {}).get(
        "fold_calls", 0) - folds0
    for i, s in enumerate(stats):
        _expect_launches(f"O1 worker {i}", s["launches"],
                         {"quantize_int8": R50_UNITS * s["pushes"]})
        _tally(tally, s["launches"])
    _expect_launches("O1 server", m["server_launches"], {})
    if (m["agg_mode"], m["decodes_per_publish"]) != (1.0, 1.0):
        raise AssertionError(f"O1: agg_mode {m['agg_mode']}, "
                             f"decodes_per_publish {m['decodes_per_publish']}")
    rounds = int(m["publish_version"]) - 1
    if folds < R50_UNITS * ASYNC_WORKERS * rounds:
        raise AssertionError(f"O1: native_counters gives {folds} wc_fold "
                             f"calls for {rounds} rounds")
    # a read before the first sample answers "unknown key"
    docs = [doc for _, doc in reads if "points" in doc]
    if len(docs) < 2:
        raise AssertionError(f"O1: /history answered {len(docs)} of "
                             f"{len(reads)} reads")
    for doc in docs:
        ts = [p[0] for p in doc["points"]]
        if ts != sorted(ts) or len(set(ts)) != len(ts):
            raise AssertionError(f"O1: /history timestamps {ts}")
    final = docs[-1]["points"]
    if not final or final[-1][1] != m["grads_received"]:
        raise AssertionError(f"O1: /history ends at {final[-1:]}, "
                             f"received {m['grads_received']}")
    # the p95 in the history against lineage's exact distribution
    rows = load_lineage_rows(os.path.join(d, "lineage-server.jsonl"))
    e2e = sorted(p["e2e_s"] * 1e3 for r in rows if r.get("kind") == "publish"
                 for p in r["pushes"] if p.get("e2e_s") is not None)
    exact = e2e[min(len(e2e) - 1, int(round(0.95 * (len(e2e) - 1))))]
    # the last point is the closing sample, on the final counters (the
    # raw tier: no downsampling within a run of seconds)
    hist = p95[0]["points"][-1][1]
    if abs(hist - exact) > 0.01 * exact:
        raise AssertionError(f"O1: /history's push_e2e_p95_ms {hist} "
                             f"against lineage's exact {exact}")
    if m["slo"]["breaches_total"] != 0:
        raise AssertionError(f"O1: SLO verdicts {m['slo']['recent_verdicts']}")
    _, counts = load_profile(os.path.join(d, "profile-server.txt"))
    if not any("serve (async_train.py)" in s for s in counts):
        raise AssertionError("O1: no serve-loop frame in the server's "
                             "collapsed stacks")
    for i in range(ASYNC_WORKERS):
        if not os.path.exists(os.path.join(d, f"profile-worker-{i}.txt")):
            raise AssertionError(f"O1: no profile of worker {i}")
    # the plane's self-timed cost: the history's and the SLO's sampling on
    # the serve thread, the sampler thread's own time
    cost = (m["history"]["overhead_s"] + m["slo"]["overhead_s"]
            + m["profile"]["overhead_frac"] * m["wall_s"])
    # the fleet's wire share from the beacons (would the codec rule
    # downshift unforced? wire_hi is 0.65)
    comp = sorted(w["compute_ewma_s"] for w in m["health"]["workers"]
                  if w["compute_ewma_s"] is not None)
    wire = sorted(w["wire_ewma_s"] for w in m["health"]["workers"]
                  if w["wire_ewma_s"] is not None)
    med = (lambda xs: xs[len(xs) // 2] if xs else 0.0)
    frac = med(wire) / max(med(wire) + med(comp), 1e-9)
    phase("control", run="O1", card=repr(card), model="resnet50",
          code="int8", discipline="sync_barrier", workers=ASYNC_WORKERS,
          pushes=int(m["grads_received"]), rounds=rounds, wc_fold_calls=folds,
          history_reads=len(docs), history_samples=m["history"]["samples"],
          push_e2e_p95_ms_history=f"{hist:.3f}",
          push_e2e_p95_ms_lineage=f"{exact:.3f}",
          slo_breaches=m["slo"]["breaches_total"],
          profile_samples=m["profile"]["samples"],
          obs_cost_s=f"{cost:.4f}", obs_cost_share=f"{cost / m['wall_s']:.5f}",
          steady_updates_per_sec=f"{m['steady_updates_per_sec']:.3f}",
          armed_over_a2=f"{m['steady_updates_per_sec'] / a2['steady_updates_per_sec']:.3f}",
          wire_frac_beacons=f"{frac:.3f}", wall_s=f"{wall:.3f}")


def control_o2(card: str, tmp: str, tally: dict) -> None:
    """O2: A1's fleet (sign, async) with worker 3 an ``O2_SLOW_MS``
    straggler under ``max_staleness`` :data:`O2_MAX_STALENESS`: its
    pushes are dropped as stale and the ``stale_drops`` rule trips exactly
    one latched verdict; replaying the persisted ``timeseries-server.jsonl``
    re-derives it."""
    from pytorch_ps_mpi_tpu_torch.telemetry import (SLOWatchdog,
                                                    load_timeseries_rows)

    d = os.path.join(tmp, "o2")
    os.makedirs(d)
    last = str(ASYNC_WORKERS - 1)
    cfg = async_cfg("resnet50", d, slow_ms={last: O2_SLOW_MS}, steps=16,
                    worker_steps={last: 5}, telemetry_dir=d,
                    timeseries=True, slo=True, slo_kw=CONTROL_SLO)
    m, stats, _ = control_fleet("O2", cfg, ASYNC_WORKERS, code_name="sign",
                                max_staleness=O2_MAX_STALENESS)
    k50 = sum(1 for n in async_sizes("resnet50") if n % 1024 == 0)
    for i, s in enumerate(stats):
        _expect_launches(f"O2 worker {i}", s["launches"],
                         {"encode_signs": k50 * s["pushes"]})
        _tally(tally, s["launches"])
    _expect_launches("O2 server", m["server_launches"],
                     {"unpack_signs_sum": k50 * int(m["decodes_done"])})
    verdicts = [json.loads(x) for x in open(os.path.join(
        d, "slo-server.jsonl"))]
    breaches = [(v["rule"], v["kind"]) for v in verdicts
                if v["kind"] == "breach"]
    if m["stale_drops"] < 1 or breaches != [("stale_drops", "breach")]:
        raise AssertionError(f"O2: {m['stale_drops']} stale drops, "
                             f"verdicts {verdicts}")
    rows = load_timeseries_rows(os.path.join(d, "timeseries-server.jsonl"))
    kw = {k: v for k, v in CONTROL_SLO.items() if k != "rules"}
    replayed = SLOWatchdog.replay(rows, rules=CONTROL_SLO["rules"], **kw)
    if [(v["rule"], v["kind"]) for v in replayed] != [
            (v["rule"], v["kind"]) for v in verdicts]:
        raise AssertionError(f"O2: replayed {replayed}, live {verdicts}")
    phase("control", run="O2", card=repr(card), model="resnet50",
          code="sign", workers=ASYNC_WORKERS, straggler_ms=O2_SLOW_MS,
          max_staleness=O2_MAX_STALENESS, pushes=int(m["grads_received"]),
          stale_drops=int(m["stale_drops"]),
          verdicts=json.dumps([[v["rule"], v["kind"],
                                round(v["burn_long"], 3)] for v in verdicts]),
          replayed=len(replayed), history_rows=len(rows))


def _recv_reply(sock, buf) -> int:
    """Read one PSR1 reply off ``sock`` into ``buf``; returns its kind."""
    from pytorch_ps_mpi_tpu_torch.serving.net import _REP

    hdr = b""
    while len(hdr) < _REP.size:
        got = sock.recv(_REP.size - len(hdr))
        if not got:
            raise ConnectionError("read tier closed mid-reply")
        hdr += got
    _, kind, flen, _, _, _, _, plen = _REP.unpack(hdr)
    left, view = int(plen) + int(flen), memoryview(buf)
    while left:
        n = sock.recv_into(view[:min(left, len(view))])
        if not n:
            raise ConnectionError("read tier closed mid-payload")
        left -= n
    return int(kind)


def c_readers(server, stop) -> dict:
    """Beside C: (1) pipelined storms of not-modified reads,
    :data:`STORM_SOCKETS` sockets × :data:`STORM_DEPTH` requests written
    before any reply is read, every 0.6 s until one completes shed-free
    (the depth then holds the whole burst); (2) a reader whose base is
    version 1 (always aged out of a 2-deep ring, so each read is a ring
    ageout and a full reply), every 0.4 s while the storms run; (3) the
    fleet directory's cards, every 0.2 s."""
    import socket as so

    from pytorch_ps_mpi_tpu_torch.serving.net import pack_request
    from pytorch_ps_mpi_tpu_torch.telemetry.fleet import list_endpoints

    out = {"storms": [], "ageout_reads": 0, "cards": []}
    while (getattr(server, "serving_core", None) is None
           or server.serving_core.latest_version() < 2):
        if stop.is_set():
            return out
        time.sleep(0.05)
    core = server.serving_core
    port, fdir = core.read_port, core.cfg.get("fleet_dir")
    buf = bytearray(64 << 20)
    ageout = so.create_connection(("127.0.0.1", port), timeout=60.0)
    next_ageout = 0.0
    deadline = time.time() + 90.0
    try:
        while not stop.is_set() and time.time() < deadline:
            socks, kinds = [], []
            have = core.latest_version()
            try:
                for _ in range(STORM_SOCKETS):
                    s = so.create_connection(("127.0.0.1", port),
                                             timeout=60.0)
                    s.sendall(pack_request(have, True) * STORM_DEPTH)
                    socks.append(s)
                for s in socks:
                    kinds += [_recv_reply(s, buf) for _ in range(STORM_DEPTH)]
            finally:
                for s in socks:
                    s.close()
            out["storms"].append(sum(1 for k in kinds if k == 3))
            if len(out["storms"]) >= 2 and out["storms"][-1] == 0:
                break  # service restored under the same load
            t_end = time.time() + 0.6
            while time.time() < t_end and not stop.is_set():
                if time.time() >= next_ageout:
                    next_ageout = time.time() + 0.4
                    ageout.sendall(pack_request(1, True))
                    if _recv_reply(ageout, buf) != 3:
                        out["ageout_reads"] += 1
                if fdir:
                    out["cards"].append(sorted(
                        e["name"] for e in list_endpoints(fdir)))
                time.sleep(0.1)
        # the storms are over: watch the replica scale back in
        t_end = time.time() + 15.0
        while fdir and not stop.is_set() and time.time() < t_end:
            out["cards"].append(sorted(e["name"]
                                       for e in list_endpoints(fdir)))
            time.sleep(0.2)
    finally:
        ageout.close()
    return out


def c_cfg(d: str, controlled: bool) -> dict:
    """C's scenario (``tools/control_smoke.py``'s, at A1's ResNet-50 on
    the card): boot codec identity; workers 0 and 3 delayed
    :data:`C_DELAY_MS` a step (the beacons' wire bucket: a wire-bound
    fleet); worker 1 a :data:`C_SLOW_MS` straggler; worker 2 pushing NaN
    at its steps :data:`C_NAN`; the numerics skip policy, no probes.
    Controlled: the controller with the ladder identity -> int8, the
    structural actions (replicas), the Python read tier with admission
    depth 2 and a 2-deep ring, the fleet card."""
    plan = ([{"at_step": s, "worker": w, "kind": "delay",
              "delay_ms": C_DELAY_MS} for s in range(C_STEPS)
             for w in (0, 3)]
            + [{"at_step": s, "worker": C_NAN["worker"], "kind": "nan"}
               for s in C_NAN["steps"]])
    from pytorch_ps_mpi_tpu_torch.resilience.faults import normalize_plan

    cfg = async_cfg("resnet50", d, steps=C_STEPS,
                    worker_steps={"1": C_STRAGGLER_STEPS},
                    slow_ms={"1": C_SLOW_MS}, health=True, health_dir=d,
                    numerics=True, numerics_kw={"policy": "skip"},
                    telemetry_dir=d, fault_plan=normalize_plan(plan),
                    fault_seed=1)
    if controlled:
        cfg.update(control=True, control_dir=d, control_kw=dict(C_KNOBS),
                   topo_actions=True, read_port=0, read_native="off",
                   serving_kw=dict(C_SERVING), metrics_port=0,
                   fleet_dir=os.path.join(d, "fleet"))
    return cfg


def control_c(card: str, tmp: str, tally: dict) -> tuple:
    """C1-C4 and C5's replicas: the controlled run and the same scenario
    uncontrolled (:func:`c_cfg`). Returns the controlled run's actions
    and its seconds."""
    from pytorch_ps_mpi_tpu_torch.control import Controller
    from pytorch_ps_mpi_tpu_torch.telemetry import load_timeseries_rows

    d = os.path.join(tmp, "c")
    os.makedirs(d)
    cfg = c_cfg(d, controlled=True)
    t0 = time.perf_counter()
    m, stats, server = control_fleet("C", cfg, ASYNC_WORKERS,
                                     code_name="identity", beside=c_readers)
    wall = time.perf_counter() - t0
    ctl = m["control"]
    acts = [json.loads(x) for x in open(os.path.join(
        d, "control-server.jsonl"))]

    def by(rule, act=None):
        return [a for a in acts if a["rule"] == rule
                and (act is None or a["action"] == act)]

    # C1: the downshift, its epochs and its kernels
    if not (ctl["epoch"] >= 1 and ctl["ladder_idx"] == 1
            and by("codec", "renegotiate") and by("codec", "epoch_retire")
            and ctl["exec_errors"] == 0):
        raise AssertionError(f"C1: control {ctl}, codec rows "
                             f"{by('codec')}")
    rej = m["frames_rejected_by_worker"]
    if any(rej.get(w, 0) for w in range(ASYNC_WORKERS)
           if w != C_NAN["worker"]):
        raise AssertionError(f"C1: rejections {rej}")
    frames = server.epoch_frames
    if getattr(server, "epoch_regressions", 0):
        raise AssertionError(f"C1: {server.epoch_regressions} frames on "
                             "an epoch older than their worker's last")
    int8_frames = 0
    for i, s in enumerate(stats):
        sw = s["switches"]
        if len(sw) != 1 or sw[0]["codec"] != "int8":
            raise AssertionError(f"C1 worker {i}: switches {sw}")
        before, after = sw[0]["pushes_before"], s["pushes"] - sw[0][
            "pushes_before"]
        if {e: n for e, n in frames.get(i, {}).items() if n} != {
                e: n for e, n in {0: before, 1: after}.items() if n}:
            raise AssertionError(f"C1 worker {i}: frames by epoch "
                                 f"{frames.get(i)}, switched after "
                                 f"{before} of {s['pushes']} pushes")
        _expect_launches(f"C1 worker {i} before its switch",
                         sw[0]["launches_before"], {})
        _expect_launches(f"C1 worker {i}", s["launches"],
                         {"quantize_int8": R50_UNITS * after})
        _tally(tally, s["launches"])
        int8_frames += after
    _expect_launches("C1 server", m["server_launches"],
                     {"dequant_sum": R50_UNITS * int8_frames})
    # C2: the straggler de-weighted alone; the nan worker readmitted
    scales = by("lr_scale")
    if not scales or min(a["new"] for a in scales) >= 1.0 or any(
            a["worker"] != 1 for a in scales):
        raise AssertionError(f"C2: lr_scale rows {scales}")
    nw = C_NAN["worker"]
    applied_nan = stats[nw]["pushes"] - rej.get(nw, 0)
    if not (by("evict", "readmit_quarantine")
            and m["numerics"]["readmissions"] == 1
            and not m["numerics"]["quarantined"] and applied_nan >= 1):
        raise AssertionError(f"C2: readmissions "
                             f"{m['numerics']['readmissions']}, "
                             f"{applied_nan} of worker {nw}'s pushes applied")
    # C3: sheds, a depth raise, a storm shed-free; the ring grown
    side = m["beside"]
    ups = [a for a in by("read_tier", "depth") if a["new"] > a["old"]]
    rings = [a for a in by("read_tier", "ring") if a["new"] > a["old"]]
    if not (side["storms"] and side["storms"][0] > 0 and ups
            and side["storms"][-1] == 0 and m["reads_shed"] > 0
            and rings and side["ageout_reads"] > 0):
        raise AssertionError(f"C3: storms {side['storms']}, depth rows "
                             f"{ups}, ring rows {rings}, ageout reads "
                             f"{side['ageout_reads']}")
    # C5: a replica out (its card appears) and back in (its card goes)
    reps = by("topo", "replica")
    seen = [c for c in side["cards"] if any(n.startswith("replica-")
                                           for n in c)]
    if not (len(reps) >= 2 and reps[0]["new"] == 1 and reps[-1]["new"] == 0
            and seen and not any(n.startswith("replica-")
                                 for n in side["cards"][-1])):
        raise AssertionError(f"C5: replica rows {reps}, cards "
                             f"{side['cards'][-3:]}")
    # C4: replay, byte for byte; no flap
    rows = load_timeseries_rows(os.path.join(
        d, "timeseries-control-server.jsonl"))
    replayed = Controller.replay(rows, num_workers=ASYNC_WORKERS, cfg=cfg,
                                 depth=C_SERVING["admission_depth"],
                                 ring=C_SERVING["ring"])
    if json.dumps(replayed) != json.dumps(acts) or ctl["flaps"] != 0:
        raise AssertionError(f"C4: {len(replayed)} replayed of "
                             f"{len(acts)} actions, flaps {ctl['flaps']}")
    # each worker's staleness EWMA over the fleet's p50, at its highest:
    # what the lr rule holds against lr_stale_margin
    over = {w: max((r["m"].get(f"w{w}_stale", 0.0)
                    - r["m"].get("stale_p50", 0.0) for r in rows),
                   default=0.0)
            for w in range(ASYNC_WORKERS)}
    # the same scenario uncontrolled, for the loss
    du = os.path.join(tmp, "c_un")
    os.makedirs(du)
    mu, su, _ = control_fleet("U", c_cfg(du, controlled=False),
                              ASYNC_WORKERS, code_name="identity")
    for s in su:
        _expect_launches("U worker", s["launches"], {})
    reneg = by("codec", "renegotiate")[0]
    phase("control", run="C", card=repr(card), model="resnet50",
          workers=ASYNC_WORKERS, pushes=int(m["grads_received"]),
          actions=len(acts), flaps=ctl["flaps"], epoch=ctl["epoch"],
          reneg_verdict=json.dumps(reneg["verdict"], sort_keys=True),
          epoch_old_frames=ctl["epoch_old_frames"],
          frames_by_epoch=json.dumps({str(w): frames.get(w, {})
                                      for w in range(ASYNC_WORKERS)}),
          int8_pushes=int8_frames,
          lr_scale=json.dumps(sorted({(a["worker"], a["new"])
                                      for a in scales})),
          stale_over_p50_max=json.dumps({w: round(v, 3)
                                         for w, v in over.items()}),
          readmissions=m["numerics"]["readmissions"],
          storms=json.dumps(side["storms"]), reads_shed=int(m["reads_shed"]),
          depth=ctl["admission_depth"], ring=ctl["ring"],
          replica_rows=len(reps), replayed=len(replayed),
          compression=f"{m['compression_ratio']:.2f}",
          loss_controlled=f"{m['loss_final']:.6f}",
          loss_uncontrolled=f"{mu['loss_final']:.6f}",
          loss_ratio=f"{m['loss_final'] / max(mu['loss_final'], 1e-12):.4f}",
          wall_s=f"{wall:.3f}")
    return acts, wall


def control_c1_tcp(card: str, tmp: str, tally: dict) -> None:
    """C1 over TCP: A3's ResNet-18, 2 workers, identity -> int8 with both
    workers delayed :data:`C_DELAY_MS` a step. The native batched ingest
    stops while the transition lasts and grows again after the retire."""
    d = os.path.join(tmp, "c1tcp")
    os.makedirs(d)
    steps = 24
    from pytorch_ps_mpi_tpu_torch.resilience.faults import normalize_plan

    plan = [{"at_step": s, "worker": w, "kind": "delay",
             "delay_ms": C_DELAY_MS} for s in range(steps) for w in (0, 1)]
    knobs = {k: C_KNOBS[k] for k in ("eval_every_s", "warmup_s",
                                     "cooldown_s", "window_s", "ladder")}
    cfg = async_cfg("resnet18", d, transport="tcp", steps=steps,
                    health=True, health_dir=d, telemetry_dir=d,
                    control=True, control_dir=d,
                    control_kw={**knobs, "settle_min_s": 1.0,
                                "settle_s": 4.0,
                                "pin": ("lr_scale", "evict", "read_tier")},
                    fault_plan=normalize_plan(plan), fault_seed=2)
    ticks = []

    def on_tick(server, last):
        ticks.append((bool(getattr(server, "_epoch_transition", False)),
                      int(server.native_batches),
                      int(getattr(server, "_epoch", 0))))

    m, stats, server = control_fleet("C1tcp", cfg, 2, code_name="identity",
                                     on_tick=on_tick)
    during = [b for tr, b, _ in ticks if tr]
    after = [b for tr, b, ep in ticks if not tr and ep >= 1]
    r18 = len(async_sizes("resnet18"))
    for i, s in enumerate(stats):
        (sw,) = s["switches"]
        _expect_launches(f"C1tcp worker {i}", s["launches"],
                         {"quantize_int8": r18 * (s["pushes"]
                                                  - sw["pushes_before"])})
        _tally(tally, s["launches"])
    if not (during and after and max(during) == min(during)
            and after[-1] > during[-1] and m["frames_rejected"] == 0
            and m["control"]["epoch"] == 1):
        raise AssertionError(f"C1tcp: native batches during the transition "
                             f"{during[:1]}..{during[-1:]}, after "
                             f"{after[-1:]}, rejected {m['frames_rejected']}, "
                             f"epoch {m['control']['epoch']}")
    phase("control", run="C1tcp", card=repr(card), model="resnet18",
          transport="tcp", workers=2, pushes=int(m["grads_received"]),
          epoch_old_frames=m["control"]["epoch_old_frames"],
          native_batches_during=during[-1], native_batches_final=after[-1],
          frames_by_epoch=json.dumps(server.epoch_frames))


def control_c5_tree(card: str, tmp: str, tally: dict) -> None:
    """C5: T1's tree (ResNet-50, 4 workers in 2 groups, identity leaf hop
    over TCP, int8 upstream behind hop EF) with ``topo_actions``: leader
    0 sleeps :data:`C5_SLOW_MS` a folded payload (``slow_leader``, from
    its first round on) while the workers are paced at
    :data:`C5_PACE_MS`, so group 0 is the hot hop until it splits behind
    a freshly spawned leader; once group 0's workers are done
    (:data:`C5_HOT_STEPS` pushes) and its hop has gone cold (the advisor
    over the last 4 rounds), the group merges back while group 1 pushes
    on. Every push is composed at the root or positively lost, exactly
    once."""
    from pytorch_ps_mpi_tpu_torch.parallel import tree
    from pytorch_ps_mpi_tpu_torch.resilience.faults import normalize_plan

    d = os.path.join(tmp, "c5")
    os.makedirs(d)
    steps = {0: C5_HOT_STEPS, 1: C5_HOT_STEPS, 2: C5_STEPS, 3: C5_STEPS}
    cfg = async_cfg("resnet50", d, codec="int8", n_workers=4, group_size=2,
                    steps=C5_STEPS, max_staleness=10**9, transport="tcp",
                    worker_steps={str(w): n for w, n in steps.items()},
                    slow_ms={str(w): C5_PACE_MS for w in range(4)},
                    trace=True, lineage_dir=d, control_dir=d,
                    topo_actions=True,
                    anatomy_kw={"window": 4, "stage_window": 16},
                    control_kw={"pin": ("codec", "lr_scale", "evict",
                                        "read_tier"),
                                "eval_every_s": 0.2, "warmup_s": 0.5,
                                "leader_fold_hot_frac": C5_HOT_FRAC,
                                "leader_churn_replan": 10**9,
                                "replica_max": 0},
                    fault_plan=normalize_plan([{
                        "at_step": 0, "worker": "leader0",
                        "kind": "slow_leader", "slow_ms": C5_SLOW_MS}]),
                    fault_seed=1)
    _, m = tree.run_tree(cfg, total_pushes=sum(steps.values()),
                         timeout=SO_LIMIT,
                         worker_env=FLEET_ENV, leader_env=FLEET_ENV)
    t = m["tree"]
    events = t.get("topo_events", [])
    acts = [json.loads(x) for x in open(os.path.join(
        d, "control-server.jsonl"))]
    kinds = [a["action"] for a in acts if a["rule"] == "topo"]
    replanned = [e for e in events if e["act"] == "replanned"]
    merged = [e for e in events if e["act"] == "merged"]
    # the topo rule's inputs over the run, every fourth evaluation
    rows = [json.loads(x)["m"] for x in open(os.path.join(
        d, "timeseries-control-server.jsonl"))]
    t_0 = rows[0]["ts"] if rows else 0.0
    phase("control", run="C5", what="topo_inputs", inputs=json.dumps(
        [[round(r["ts"] - t_0, 1), r.get("lf_top"),
          round(r.get("lf_saving_frac", 0.0), 3), r.get("hot_group"),
          r.get("tree_groups")] for r in rows[::4]], separators=(",", ":")),
          events=json.dumps([[e["act"], round(e["t"] - t_0, 1)]
                             for e in events], separators=(",", ":")))
    leaders = [json.load(open(os.path.join(d, f)))
               for f in sorted(os.listdir(d)) if f.startswith("leader-")]
    workers = [json.load(open(os.path.join(d, f"worker-{w}.json")))
               for w in range(4)]
    composed = [tuple(e) for e in t["composed_ids"]]
    lost = [tuple(e) for ld in leaders for e in ld["lost"]]
    expect = {(w, s, s) for w, n in steps.items() for s in range(n)}
    if (len(set(composed)) != len(composed) or set(composed) & set(lost)
            or set(composed) | set(lost) != expect):
        raise AssertionError(f"C5: {len(composed)} composed and {len(lost)} "
                             f"lost of {len(expect)} pushes")
    # the pushes the split's own leader folded
    split_pushes = sum(ld["upstream_pushes"] for ld in leaders
                       if replanned and ld["group"]
                       == replanned[0]["new_group"])
    if not (replanned and merged and "group_replan" in kinds
            and "group_merge" in kinds and m["control"]["flaps"] == 0
            and replanned[0]["group"] == 0 and split_pushes >= 1
            and t["worker_codes"] == [0] * 4):
        raise AssertionError(f"C5: topo rows {kinds}, events "
                             f"{[e['act'] for e in events]}, worker codes "
                             f"{t['worker_codes']}, {split_pushes} pushes "
                             "through the split's leader")
    for ld in leaders:
        _expect_launches(f"C5 leader {ld['group']}", ld["launches"],
                         {"quantize_int8": R50_UNITS * ld["upstream_pushes"],
                          "dequant_sum": R50_UNITS * ld["upstream_pushes"]})
        _tally(tally, ld["launches"])
    for i, w in enumerate(workers):
        _expect_launches(f"C5 worker {i}", w["launches"],
                         {"quantize_int8": R50_UNITS * w["root_encodes"]})
        _tally(tally, w["launches"])
    phase("control", run="C5", card=repr(card), model="resnet50",
          pushes=len(expect), composed=len(composed), lost=len(lost),
          topo=json.dumps(kinds), groups_split_to=replanned[0]["new_group"],
          moved=json.dumps(replanned[0]["moved"]),
          split_leader_pushes=split_pushes,
          leader_codes=json.dumps(t["leader_codes"]),
          hot_verdict=json.dumps(replanned[0]["verdict"], sort_keys=True))


def run_control(card: str, a2: dict) -> dict:
    """Phase ``control``: the fleet observability plane and the
    controller on the card, legs O1, O2 and C1-C5 (``PERF.md`` §4; O3
    rides on ``scale_out``'s S1 and R1). Returns every kernel launch of
    the phase: this process's and its workers' and leaders'."""
    import shutil
    import tempfile

    from pytorch_ps_mpi_tpu_torch.utils import native

    if native.fast_path_disabled():
        raise AssertionError("PS_NO_NATIVE is set: phase control runs the "
                             "native folds and ingest")
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_control_")
    before = _launch_counts()
    tally: dict = {}
    seconds = {}
    try:
        for leg, fn in (("O1", lambda: control_o1(card, tmp, a2, tally)),
                        ("O2", lambda: control_o2(card, tmp, tally)),
                        ("C", lambda: control_c(card, tmp, tally)),
                        ("C1tcp", lambda: control_c1_tcp(card, tmp, tally)),
                        ("C5", lambda: control_c5_tree(card, tmp, tally))):
            t = time.perf_counter()
            fn()
            seconds[leg] = round(time.perf_counter() - t, 1)
            phase("control", leg=leg, seconds=seconds[leg])
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # the servers' and the root's launches are this process's, read as a
    # difference; the workers' and leaders' were tallied from their stats
    _tally(tally, _launched_since(before))
    phase("control", launches=json.dumps(tally, sort_keys=True,
                                         separators=(",", ":")),
          legs=json.dumps(seconds, separators=(",", ":")),
          seconds=f"{time.perf_counter() - t0:.1f}")
    return tally


SOURCES = {
    "encode_signs": ("sign.cu", "pytorch_ps_mpi_tpu/ops/sign_pallas.py:68"),
    "pack_signs": ("sign.cu", "pytorch_ps_mpi_tpu/ops/sign_pallas.py:104"),
    "unpack_signs": ("sign.cu", "pytorch_ps_mpi_tpu/ops/sign_pallas.py:131"),
    # with the codec's scale and rank-ordered fold (codecs/sign.py:89-96)
    "unpack_signs_sum": ("sign.cu",
                         "pytorch_ps_mpi_tpu/ops/sign_pallas.py:131"),
    "quantize_int8": ("quant.cu",
                      "pytorch_ps_mpi_tpu/ops/quant_pallas.py:64"),
    "dequantize_int8": ("quant.cu",
                        "pytorch_ps_mpi_tpu/ops/quant_pallas.py:118"),
    "exact_topk": ("topk.cu", "pytorch_ps_mpi_tpu/ops/topk_pallas.py:67"),
    # with the codec's jnp.maximum(jnp.max(jnp.abs(g)), 1e-12) (codecs/
    # terngrad.py:187), in one launch
    "tern_encode": ("tern.cu", "pytorch_ps_mpi_tpu/ops/tern_pallas.py:61"),
    # the chunked encode's absmax scan (XLA's, not a Pallas kernel)
    "tern_scale": ("tern.cu", "pytorch_ps_mpi_tpu/codecs/terngrad.py:149"),
    "tern_pack": ("tern.cu", "pytorch_ps_mpi_tpu/ops/tern_pallas.py:61"),
    "tern_unpack": ("tern.cu", "pytorch_ps_mpi_tpu/ops/tern_pallas.py:97"),
    # bf16, the main path's type (float32: attention.cu, the CUDA cores)
    "flash_fwd": ("attention_tc.cu",
                  "pytorch_ps_mpi_tpu/ops/attention_pallas.py:143"),
    "flash_bwd": ("attention_tc.cu",
                  "pytorch_ps_mpi_tpu/ops/attention_pallas.py:267"),
}


def main() -> int:
    t0 = time.perf_counter()
    card = check_device()
    # stated and set: f32 matmuls in full f32, f32 convolutions in TF32
    # (cuDNN's default), so the step runs as a PyTorch user's would
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    torch.cuda.set_device(0)

    from pytorch_ps_mpi_tpu_torch import mesh
    from pytorch_ps_mpi_tpu_torch.models import (BertConfig, BertMLM,
                                                 ResNet18, ResNet50)

    def resnet18():
        return ResNet18(num_classes=10, small_inputs=True, seed=0,
                        device="cuda")

    def resnet50():
        return ResNet50(num_classes=1000, seed=0, device="cuda")

    def bert_base():
        return BertMLM(BertConfig(dtype=torch.bfloat16, attention="flash"),
                       seed=0, device="cuda")

    build_kernels()
    model = resnet18()
    r50 = resnet50()
    # the async phase's ResNet-50 units, held to the plain versions here
    r50_async = async_sizes("resnet50")
    results = check_kernels(kernel_sizes(model), bucket_sizes(model),
                            r50_async)
    check_decode_sum(model)
    results.update(check_quant_kernels(model, r50_async,
                                       s1_slices(sum(r50_async)),
                                       delta_sections("resnet50")))
    leaves = topk_leaves(r50)
    topk_launches, topk_results = check_topk_kernels(leaves,
                                                     async_topk_leaves())
    results.update(topk_results)
    check_reference(model, "sign", "ResNet18-cifar-gn-f32")
    check_reference(model, "sign", "ResNet18-cifar-gn-f32",
                    bucket_mb=BUCKET_MB)
    check_reference(model, "int8", "ResNet18-cifar-gn-f32", exact=True)
    check_reference(model, "int8", "ResNet18-cifar-gn-f32", exact=True,
                    bucket_mb=BUCKET_MB)
    check_reference(model, "int8", "ResNet18-cifar-gn-f32", exact=True,
                    bucket_mb=BUCKET_MB, mode="leader")
    check_reference(r50, "ef_topk", "ResNet50-imagenet-gn-f32", exact=True)
    del r50
    bert = bert_base()
    results.update(check_tern_kernels(bert))
    results.update(check_flash_kernels())
    check_bert_reference(bert, TERN_LEAF)
    check_bert_reference(bert, PLAN_LAUNCHES["terngrad"],
                         bucket_mb=BUCKET_MB)
    check_bert_flash(bert)
    check_sparse_sync(bert)
    check_codec_reference(bert)
    check_powersgd_qr(bert)
    del bert
    torch.cuda.empty_cache()

    r18 = sum(1 for _ in model.parameters())
    bucketed = dict(bucket_mb=BUCKET_MB)
    leader = dict(bucket_mb=BUCKET_MB, mode="leader")
    # the collective calls of a grads-only step: one all-reduce a unit for
    # identity, one all-gather a payload tensor (two a unit) for the
    # gathered codecs, and in leader mode a reduce-scatter and an
    # all-gather a unit (psum_scatter) or the payload all-gathers and one
    # parameter all-gather a unit (payload_gather, int8 at world 1); a
    # unit is a leaf (ResNet-18 62, ResNet-50 161, BERT-base 150) or a
    # bucket (ResNet-18 4, BERT-base 28)
    runs = [
        ("identity", resnet18, "cifar10", BATCH, {}, {"all_reduce": 62}, {}),
        ("sign", lambda: model, "cifar10", BATCH,
         {"encode_signs": 20, "unpack_signs_sum": 20}, {"all_gather": 124},
         {}),
        ("int8", resnet18, "cifar10", BATCH,
         {"quantize_int8": r18, "dequantize_int8": r18}, {"all_gather": 124},
         {}),
        ("qsgd", resnet18, "cifar10", BATCH, {"dequantize_int8": r18},
         {"all_gather": 124}, {}),
        ("ef_topk", resnet50, "imagenet", BATCH_IMAGENET,
         {"exact_topk": topk_launches * len(leaves)}, {"all_gather": 322},
         {}),
        ("sign", resnet18, "cifar10", BATCH, from_plan("sign"),
         {"all_gather": 8}, bucketed),
        ("int8", resnet18, "cifar10", BATCH, from_plan("int8"),
         {"all_gather": 8}, bucketed),
        ("int8", resnet18, "cifar10", BATCH, from_plan("int8"),
         {"all_gather": 8 + 4}, leader),
    ]
    # BERT-base: 12 flash forward and 12 + 12 backward launches a loss
    # step, none in the grads-only step; TernGrad encodes 61 leaves whole
    # and the two 23,440,896-element leaves as a scale and 23 chunk packs
    # each, and unpack-sums its 63 sublane-layout leaves, in every step
    flash = {"flash_fwd": 12, "flash_bwd": 24}
    tern = TERN_LEAF
    bert_runs = [("identity", flash, {}, {"all_reduce": 150}, {}),
                 ("terngrad", {**flash, **tern}, tern, {"all_gather": 300},
                  {}),
                 ("terngrad", flash, from_plan("terngrad"),
                  {"all_gather": 56}, bucketed),
                 ("identity", flash, {},
                  {"reduce_scatter": 28, "all_gather": 28}, leader),
                 # no codec kernel: PowerSGD's two all-reduces on 51
                 # compressed leaves and one on each of the 99 others; an
                 # all-gather a payload tensor of the 150 leaves (random-k
                 # and block top-k values and indices, block top-k int8
                 # and threshold three), or of random-k's 28 buckets
                 ("powersgd-r4", flash, {}, {"all_reduce": 51 * 2 + 99}, {}),
                 ("blocktopk-1%", flash, {}, {"all_gather": 300}, {}),
                 ("blocktopk8-1%", flash, {}, {"all_gather": 450}, {}),
                 ("randomk-1%", flash, {}, {"all_gather": 300}, {}),
                 ("randomk-1%", flash, {}, {"all_gather": 56}, bucketed),
                 ("threshold", flash, {}, {"all_gather": 450}, {})]
    launches = {}
    mesh.initialize_distributed(f"tcp://localhost:{free_port()}",
                                world_size=WORLD, rank=0, backend="nccl")
    try:
        for code, make_model, dataset, batch, per_step, calls, opt_kw in runs:
            name = ("ResNet50-imagenet-gn-f32" if dataset == "imagenet"
                    else "ResNet18-cifar-gn-f32")
            got = run_main_path(make_model(), code, dataset, batch, per_step,
                                calls, name, **opt_kw)
            for kernel, n in got.items():
                if n:
                    launches.setdefault(kernel, n)
            torch.cuda.empty_cache()
        for code, per_loss, per_grads, calls, opt_kw in bert_runs:
            got = run_bert_path(bert_base(), code, per_loss, per_grads, calls,
                                **opt_kw)
            for kernel, n in got.items():
                if n:
                    launches.setdefault(kernel, n)
            torch.cuda.empty_cache()
        run_training()
    finally:
        torch.distributed.destroy_process_group()
    torch.cuda.empty_cache()
    longcontext = run_longcontext()
    torch.cuda.empty_cache()
    a1, a2 = run_async(card)
    torch.cuda.empty_cache()
    serving = run_serving(card, topk_launches)
    torch.cuda.empty_cache()
    scale_out = run_scale_out(card)
    torch.cuda.empty_cache()
    telemetry = run_telemetry(card, a1)
    torch.cuda.empty_cache()
    control = run_control(card, a2)
    launches.setdefault("pack_signs", 0)
    launches.setdefault("unpack_signs", 0)

    phase("done", seconds=f"{time.perf_counter() - t0:.1f}")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"pytorch_ps_mpi_tpu_torch/csrc/{SOURCES[name][0]}",
         "replaces": SOURCES[name][1], "launches": launches[name],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "device_ms": r["device_ms"], "plain_ms": r["plain_ms"],
         "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "library_ms": r["library_ms"],
         "launches_serving": serving.get(name, 0),
         "launches_scale_out": scale_out.get(name, 0),
         "launches_telemetry": telemetry.get(name, 0),
         "launches_control": control.get(name, 0),
         "launches_longcontext": longcontext.get(name, 0)}
        for name, r in results.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("NCCL_DEBUG", "WARN")
    sys.exit(main())
