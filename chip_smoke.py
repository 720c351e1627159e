"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py [--out report.json]

Needs one CUDA card and the CUDA toolkit; exits non-zero (printing no
result) without them or outside a checkout of the repository.  Phases, each
raising on failure:

1. build    every hand-written kernel from ``src/repro_torch/kernels/csrc``
            (one ``nvcc`` per source, all started together).
2. serve    full-width models through ``PlacementEngine(MABPolicy(
            bandit="ucb"))`` and ``TorchBackend`` on both arms, 128-512-token
            prompts from 3 shared-prefix families: stablelm-1.6b in bf16
            (24 requests), with int8 KV (9), with ``weight_quant="int8"``
            (9) and with ``weight_quant="int4"`` over int8 KV (6); then
            qwen2-moe-a2.7b (MoE FFN, hd 128) with ``weight_quant="int8"``
            (8 requests, 16-32 new tokens).  On the short serves the
            bandit's first two decisions are pinned to one arm each, so both
            arms' kernels run.  Before each serve the launch counters are
            zeroed; after it they must equal one paged launch per layer and
            four ``quant_matmul`` launches per layer (0 without
            ``weight_quant``) per prefill chunk and per decode step on each
            arm: the semantic arm's two branches share a launch.  Every
            prefill launch must take the tensor-core path (bf16 models),
            every decode launch ``decode_split``, and every ``quant_matmul``
            launch its tensor-core path by the step's rows.
3. model    after the bf16, int8-weight and MoE serves: the served models'
            bf16 logits are finite, and an f32 copy of each arm (its
            projections quantized as the served ones, to the same codes)
            gives the same logits through the kernels as through the plain
            versions on a small input (1e-3 of the largest logit).
            qwen2-moe's f32 copy at full depth (57 GB) would not fit beside
            the served model: it is built at full width from the first two
            superblocks' weights.
4. kernels  each paged-attention kernel against its plain PyTorch version on
            the same CUDA tensors at the full-width shapes of stablelm-1.6b
            (H = K = 32, hd = 64) and of qwen2-moe-a2.7b (H = K = 16,
            hd = 128): bs = 16, decode B = 8, prefill C = 128, ragged
            lengths up to 1024, blocks aliased across lanes, a length-0 pad
            row; f32, bf16 and int8 pools.  Each launch must take its path
            (bf16-q prefill: the tensor-core kernel; f32-q prefill: the
            CUDA-core one; decode: ``decode_split``, one CUDA kernel per
            call by the profiler's count).  Kernel vs plain within tol times
            each output row's max |plain| (``row_limit``); the same check
            must reject, in every query row with more than 256 keys, the
            plain output with the row's first 64-token K/V tile left out;
            both readings are reported.  Kernel, plain and library
            (``scaled_dot_product_attention`` on the pre-gathered dense
            cache, a yardstick the port never calls) device times from
            ``torch.profiler``, the kernel's CUDA-event time per call
            (host launch work included), and the bound.
5. quant    ``quant_matmul`` against ``quant_matmul_plain``: int8 and int4
            codes, f32 and bf16 x, the LAYER shape (G = 1, D = E = 2048) and
            the SEMANTIC one (G = 2, D = E = 1024), T = 1, 8, 200 and 1024,
            groups of 128 and of 32, within tol (1 + |plain|) (``QTOL``);
            each call on its path (bf16: ``mma_skinny`` for T <= 32,
            ``mma_tile`` above; f32: ``simt``), and the same check must
            reject, in every output row, the plain output with the last
            group of each split left out (``quant_fault``).  Timed as above
            at T = 8 (decode) and T = 1024 (prefill) beside ``torch.matmul``
            on the weight dequantized beforehand (a yardstick the port never
            calls); a tensor-core call is one CUDA kernel.
6. train    the training launcher ``repro_torch.launch.train.main`` at the
            full width of stablelm-1.6b in f32 (B 2, S 2048, remat): fsdp
            for 6 steps, then semantic (two branches) for 4.  The flash
            counter is zeroed before each run and must read 48 per step
            after it (24 layers: the forward, and remat's recompute in the
            backward; the backward itself is the plain chunked attention),
            every launch on the f32 CUDA-core path (``simt``).
            Every loss is finite and the first within 1 of ln(vocab) (the
            init gives unit-variance logits: ln V + 1/2 expected).  Step ms,
            tokens/s and peak memory are reported.  Then one fsdp
            ``value_and_grad`` at full width through the kernel and through
            ``flash_attention_plain`` patched into ``models.attention``:
            loss to rel 1e-5, each gradient leaf to 1e-4 of its largest.
7. flash    the flash-attention kernels against ``flash_attention_plain``
            at the main path's shapes (LAYER: B 2, H = K = 32; SEMANTIC: two
            branches x B 2, H = K = 16; hd 64, S 2048, causal), an hd-128
            GQA case with window 1024 and softcap 50 (H 32, K 16) and an
            Sq = 1024 < Sk = 2048 case, f32 (the CUDA-core path, ``simt``)
            and bf16 (the tensor-core path, ``mma``; each row's path is
            asserted, one CUDA kernel per call), within tol (f32 1e-4,
            bf16 1e-2: ``flash_attention.FLASH_TOL``) times each output
            row's max |plain| (``row_limit``); the same check must reject,
            by at least 3x in every query row at position >= 256, the plain
            output with the row's first 64 attended keys left out
            (``flash_fault``); both readings are reported.  Timed as above beside
            ``scaled_dot_product_attention`` where it computes the same
            function (no window, no softcap).
8. ops      the kernel-op layer ``repro_torch.kernels.ops`` at full widths:
            ``block_diag_matmul`` (stablelm-1.6b ``.semantic(2)`` branch MLP
            up and down at T 8, 200 and 2048; xlstm-125m's mLSTM
            projection, 4 heads of 384 at T 8, the row the kernels line
            reports), ``moe_gmm`` (qwen2-moe-a2.7b,
            60 experts x capacity 171), ``ssm_scan`` (jamba-1.5-large's
            mixer, [1, 2048, 16384, 16] f32) and ``decode_attention`` (B 8,
            L 4096, ragged lengths with a 0; stablelm-1.6b and a gemma2-27b
            layer), f32 and bf16; flash (bf16: the tensor-core path) and
            quant once each.  The launch counters are zeroed before each op
            call and must read 1 for its kernel and 0 for the others, and
            every grouped-GEMM call must take its path (bf16: the
            tensor-core tiles, ``mma_skinny`` at M <= 32 and ``wgmma``
            above; f32: the CUDA-core tiles, ``skinny`` and ``tiled``),
            and every call at M <= 32 must be one CUDA kernel (the
            profiler's count); with ``use_kernels(False)`` no
            launch and the oracle's result.  Kernel vs plain within tol (1 +
            |plain|) (``QTOL``), decode within tol times the largest |plain|
            of each output row; the decode check must also reject the plain
            output with each long row's first 256-slot piece dropped, and
            both readings are reported.  The four new kernels are timed as
            above beside ``torch.bmm`` or masked SDPA where one call
            computes the same function.

9. disagg   ``TorchBackend(fleet="disagg")`` at the full width of
            stablelm-1.6b (cache 1024, blocks of 16, prefill chunks of 128):
            each arm a prefill worker and a decode worker joined by a
            ``CacheStore``, ``MABPolicy(bandit="ucb")`` with every arm
            served first, 8 lanes, 9 requests of the smoke load in 3
            waves, once with bf16 pools and once with int8 pools.  Every
            request completes with its tokens; blocks ship and
            ``transfer_bytes`` is blocks x block bytes; decode calls
            overlap ship waves; both pools and the store unwind.  Launches
            are counted by worker: the paged prefill kernel (tensor-core
            path) only inside the prefill workers' chunk calls and paged
            decode (``decode_split``) only inside the decode workers' calls,
            one a layer a step.  Every wave's shipped blocks are compared,
            byte for byte on every leaf (int8 codes and scales too), with
            their source blocks.  Reports tokens/s, decode ms per step,
            ship waves, each wave's transfer time from CUDA events beside
            its bound (its bytes read and written at 3.35 TB/s) and
            ``ship_overlap_frac``.
10. disagg_parity  ``FixedPolicy`` on each arm at one lane, 4 requests
            with distinct random prompts, colocated and then disagg on the
            same seed's weights: every call has the same shapes in both
            runs, so every token stream must be equal.
11. chaos   the disagg fleet (bf16 pools, LAYER) under the six-fault plan
            of tests/test_faults.py (``CHAOS_PLAN``) against a clean twin:
            every request completes, nothing is shed or failed, the six
            faults fire (by kind as planned), retries, re-executions and
            recoveries happen, both pools unwind; the recovery latency and
            the share of streams equal to the twin's are reported (a
            re-executed prefill can run at other shapes than the clean one,
            so that share is not gated).  Then a colocated run with
            ``load_shed=True`` and half the SLAs expired on arrival: some
            requests are shed, none of them served, and completed + shed +
            failed = requests.
12. fleet   ``FleetBackend`` of 4 replicas of full-width stablelm-1.6b on
            the one card (LAYER, bf16 pools, cache 1024, blocks of 16,
            chunks of 128, 8 lanes, pools of 257 blocks: half of full
            capacity), replicas sharing one model and one built-call
            cache.  A shared-prefix trace (8 families: a 256-token head
            plus a 16-128-token tail, 16-32 new tokens; 24 requests in 4
            waves) runs a warm and a measured pass under
            ``PrefixAwareRouter(fleet.board)``, then again on a fresh fleet
            under ``RandomPlacement(3)``.  Every request completes; after
            every step the board equals the union of the replicas'
            ``PrefixIndex`` chains; the paged launches summed over the
            replicas equal one a layer per prefill chunk (tensor-core path)
            and per decode step (``decode_split``); each bucket is built
            once fleet-wide; the routed measured pass's prefix hit rate is
            above the random one's; every replica's pool unwinds.  Reports
            tokens/s and decode ms per step per pass, the hit rate,
            ``routed_per_replica``, sync deltas, tracked hashes, the
            router's expected overlap, place ms per request, response p50
            and p99 and peak memory.

13. legacy  the gang path (``TorchBackend(decode="legacy")``) at the full
            width and depth of stablelm-1.6b, bf16, both arms, cache 1024,
            8 lanes, ``MABPolicy(bandit="ucb")`` with every arm served
            first: 9 requests (random 64-256-token prompts, 32-64 new
            tokens) in 3 waves.  The launch counters are zeroed just
            before and read just after: ``decode_attention`` must read one
            launch per layer per decode step (the semantic arm's branches
            folded into one call).  Then ``gang_model_check`` at the
            phase's shape (8 lanes, cache 1024): the served bf16 logits are
            finite, and an f32 copy of each arm gives the same logits (a
            264-token prefill, so the kernel merges two 256-slot pieces,
            and 8 teacher-forced decode steps) through the kernel as
            through ``decode_attention_plain``, within 4 times the plain
            run's own response to a one-ulp weight nudge or 1e-5 of the
            largest |logit|, whichever is larger.
14. recurrent  xlstm-125m at full width and depth, ``decode="auto"`` (its
            mixers take the gang path, prompts prefilled token by token),
            ``bandit="thompson"``, 9 requests (16-48-token prompts, 16-32
            new) in 3 waves: three ``block_diag_matmul`` launches per mLSTM
            layer per decode step, every one on the bf16 decode-sized tile
            (``mma_skinny``); the same
            model check with ``block_diag_matmul_plain`` (a 24-token
            prompt; 8 lanes, so the mLSTM projections run at T 8).
15. window  gemma2-27b at full width cut to 2 superblocks (hd 128, GQA
            2:1, softcap 50, final softcap 30, the ``attn_local`` layers'
            ring caches), ``decode="auto"``, ``bandit="egreedy"``, 6
            requests in 3 waves; launches and model check as above.  Then
            ``decode_attention`` on a wrapped ring at the full window (L =
            W = 4096, every slot valid), f32 and bf16, against its plain
            version within tol times each row's max |plain|.
16. zoo     whisper-base (full, 1500 stub frames), internvl2-26b (full
            width, 2 superblocks, 256 stub patches), jamba-1.5-large's
            Mamba mixer (d 8192, d_inner 16384) and xlstm-125m's mLSTM and
            sLSTM mixers: in f32, 64 teacher-forced decode steps on the
            dense caches equal the full-sequence forward within 1e-3 of its
            largest |value|; in bf16 both are finite.  internvl's decode,
            like the reference's, takes no image prefix: it is held to the
            text-only forward, and the 256-patch forward to its shape and
            finiteness.  Then the Mamba mixer's full-sequence forward at S
            2048 (four 512-step chunks of the log-depth scan), B 1, f32
            and bf16, timed (CUDA events) beside the same forward with each
            chunk walked a step at a time, to which it is held in f32
            within 1e-4 of the largest |y|.
17. pipeline  the training launcher's explicit schedules at the train
            phase's shape (full-width stablelm-1.6b, f32, B 2 x S 2048,
            remat), ``--mode pipeline --n-microbatches 2``: ``--schedule
            gpipe`` for 3 steps, then ``1f1b`` for 3.  The flash counter is
            zeroed before each run and must read 3 x M x 24 = 144 per step
            after it (per microbatch: the F op's forward, the B op's
            re-forward and remat's recompute inside the B op's backward),
            every launch on ``simt``; the losses as in phase 6.  Step ms,
            tokens/s, peak memory and ``schedule_stats`` are reported.
            Then, from one set of weights and one batch, each schedule's
            ``value_and_grad`` against fsdp's, and the 1f1b one through the
            kernel against the same through ``flash_attention_plain``: loss
            to rel 1e-5, each gradient leaf to 1e-4 of its largest; each
            call's seconds beside fsdp's.
18. placement  Table I's two policies on ``SimBackend(seed=1)`` with
            ``PoissonSource(rate=0.6, seed=3, sla_range=(0.5, 3.0))`` for
            1000 intervals, A3C's networks on the card:
            ``CompressionPolicy(A3CPlacement())`` and
            ``MABPolicy("ucb", placement=A3CPlacement())``; then
            ``FixedPolicy(SEMANTIC, GOBIPlacement())``, its gradient steps
            on the card.  Every host's RAM stays within its capacity, the
            A3C weights are on the card and finite after the run, and one
            recorded episode's ``policy_logits``, ``value`` and
            ``a3c_update`` on the card equal the same functions on the CPU
            within 1e-5 of each tensor's max (floored at the lr, 1e-3, for
            ``b2``, whose gradient is zero in exact arithmetic).  Reports the four
            Table-I metrics (reward, SLA violations, accuracy, energy), ms
            per placement and per update (not gated: whether SplitPlace
            beats the baseline).

19. multi   training across ranks: two processes of this script
            (``--multi-rank``) in a gloo world whose ranks share the one
            card (``cuda:0``; NCCL refuses two ranks on one device), under
            a 480 s limit, each exit code checked.  Full-width f32 at the
            train phase's shape (B 2 x S 2048, remat), 2 steps a run, the
            runners of ``repro_torch.dist.api`` on ``launch.mesh.init_mesh``
            meshes: stablelm-1.6b fsdp on (2, 1), 1f1b and gpipe on (1, 2)
            (12 superblocks a rank, M 2), qwen2-moe-a2.7b cut to 4 of its
            24 superblocks, expert parallel on (1, 2) (30 of 60 experts a
            rank).  Each run's first step against a one-process run on the
            same weights (fsdp: the fsdp runner; the schedules: 1f1b on one
            device; expert parallel: the gspmd microbatched loss), slice by
            slice (the reference's gradients on the host): loss to rel
            1e-6, each gradient leaf to 1e-5 of its largest.  Each rank's
            parameter bytes must equal the specs' arithmetic, its flash
            launches (counters zeroed just before the run) the count the
            run implies (fsdp 2 x 24 a step, a stage 3 x M x 12, expert
            parallel 2 x 4), all on ``simt``; both ranks report the same
            losses.  The expert-parallel run takes one sequence (B 1 x S
            2048, one microbatch): each rank holds ~30 GB of its params,
            grads and moments, and B 2's step did not fit beside them.  Reports step ms per rank, peak and allocated GB,
            the collectives' bytes and ``dist.comm.COMM_STATS``' staged
            bytes and ms: host staging over gloo, not NVLink.  Last,
            qwen2-moe-a2.7b cut to 2 superblocks at capacity factor 1.0,
            fsdp on (2, 1) over B 2 (a row a rank): its experts overflow,
            so the ranks must size capacity and drop over the whole batch;
            held to one process as above, and the assignments the two
            ranks drop must sum to the one process's, above 0.
20. serve_multi  serving across ranks, on the same two ranks after their
            training runs, each part held to a one-process run of the same
            runner on a 1 x 1 mesh that this process makes first (seed-0
            weights, greedy; the ranks are fed its tokens): flash-decoding
            (``shard_cache_len=True``, fsdp on (2, 1); every part in f32,
            weights and caches, see ``serve_cfg``: bf16 across ranks is not
            gated, ``scripts/serve_bf16_witness.py`` reads it against f32)
            A, full-width
            stablelm-1.6b, B 1, a 65536-slot cache (25.8 GB of KV, 12.9 GB
            a rank), a 32760-token prompt (every rank its own causal
            attention on the flash path, only rank 0's slab written) and 16
            decode steps across the slab boundary at 32768 (rank 1's slab
            empty for the first 8: length 0, lse -inf); B, gemma2-27b at
            full width and 2 of its 23 superblocks, an 8192-slot cache
            whose first 6000 global slots and every slot of the 4096-slot
            rings hold seeded K/V (a 6000-step token-by-token prompt would
            take most of the phase's time), 16 decode steps from 6000:
            the ring has wrapped across both ranks, softcap 50.  Then the
            LAYER arm (pipeline: a stage of 12 superblocks a rank, the
            activation sent on, the logits broadcast) and the SEMANTIC arm
            (a branch a rank, the logits' branch shards all-gathered) on
            (1, 2), full-width stablelm-1.6b, B 8, prompts of 256-512
            tokens (right-padded, per-row lengths), 32 decode steps.  Each
            call's logits within ``SERVE_LOGIT_REL`` of the one-process
            run's largest |logit|, the same logits rounded to bf16 above
            it, both ranks' logits equal, every greedy token of the arms
            the one-process run's; ``decode_attention`` launches (zeroed
            before each part) one per held attention layer a step, one
            slab merge per launch under flash-decoding, 24 flash launches
            for A's prompt.  Then whisper-base (enc-dec, full width: 6 + 6
            layers, d 512, 1500 stub frames, vocab 51872) on the LAYER
            stages on (1, 2) (the stage layout: 3 encoder and 3 decoder
            superblocks a rank; the encoder a chain of stages of its own,
            its output broadcast to every stage), B 4: ``prefill_step`` on
            a 32-token prompt with the audio, the prompt teacher-forced
            through ``serve_step`` (each call re-encodes the audio), 16
            greedy steps; the same logit, token and equal-ranks gates, 3
            ``decode_attention`` launches a rank a ``serve_step`` and no
            flash launch, and each ``serve_step``'s bytes sent and
            broadcast exactly the design's (``whisper_wire``).  Reports
            prefill and decode ms per step (whisper's beside the one
            process's), the collectives' bytes and staged ms, cache bytes
            and peak GB.
            Then the engine across ranks: ``TorchBackend(mesh=<the
            process-group mesh>, decode="legacy")`` on (2, 1) and on
            (1, 2), full-width stablelm-1.6b in f32, each arm's 8
            requests (64-257-token prompts, 12-16 new tokens) under
            ``FixedPolicy``; rank 0 drives the engine and broadcasts each
            gang batch, rank 1 follows.  Rank 0's tokens must equal a
            one-process ``TorchBackend(decode="legacy")`` on the same seed
            (this process runs it first), the follower's batches, prefill
            calls, decode steps and token streams' CRC-32 rank 0's, and
            each rank's ``decode_attention`` launches one per attention
            layer it holds per decode step.  Reports decode ms per step on
            rank 0 beside the one process's, collectives and staged bytes
            per step and the headers sent.  Then the paged engine across
            ranks (``decode="paged"``, each rank holding its stages' or
            branches' slice of the pool, rank 0 relaying every device call)
            on (2, 1), (1, 2) and (1, 2) with int8 KV and weights, each
            arm's 8 requests in three waves of three prefix families:
            tokens and scheduler counters equal to one process's, the
            follower's counts and CRC to rank 0's, one ``prefill_simt``
            launch a held layer a chunk and one ``decode_split`` a held
            layer a step.  Then the disaggregated engine across ranks
            (``fleet="disagg"``: each rank holds its slice of both workers'
            pools, rank 0 relays every worker call and ship wave) on the
            same waves on (2, 1), (1, 2) and (1, 2) under a seeded plan of
            a dropped and a delayed ship wave (ship expiry 0 s, so a wave
            whose marks are lost expires at the step that shipped it on
            every run): rank 0's tokens, scheduler, ship and fault
            counters equal to one process's disaggregated backend on the
            same seed and plan; the follower's counts (ship waves and
            blocks included) and CRC equal to rank 0's; each rank's
            prefill worker launches one ``prefill_simt`` a held layer a
            chunk and its decode worker one ``decode_split`` a held layer
            a step, and nothing else launches; bytes into the decode
            calls' sends (LAYER) and all-gathers (SEMANTIC) the
            activation's and the (max, index) pairs' a step; each worker's
            pool bytes the rank's slice.  Reports decode ms per step on
            rank 0 beside one process's and ``ship_overlap_frac``.  Then
            the routed fleet across ranks: ``FleetBackend`` of two
            colocated paged replicas (LAYER) on (1, 2) and (2, 1) under
            ``PrefixAwareRouter`` (rank 0 routes and relays every
            replica's calls, the header naming the replica), two passes of
            prefix-family requests on a step clock: tokens, routes and
            sync counters equal to a one-process fleet's, the follower's
            counts and CRC rank 0's, one ``prefill_simt`` a held layer a
            chunk and one ``decode_split`` a held layer a step over both
            replicas, one runner for both.  Then ``fleet_devices=(1, 0)``
            on (1, 2): the LAYER arm's prefill worker pinned whole to rank
            1, its decode worker to rank 0, the KV ship crossing ranks:
            tokens and counters equal to the one-process disaggregated
            backend's, every wave's blocks received bit for bit (read
            back on the host), the bytes sent between the ranks
            ``transfer_bytes``, ``prefill_simt`` on rank 1 only and
            ``decode_split`` on rank 0 only for that arm.  Reports decode
            ms per step against one process, headers sent, ship ms a wave
            and its GB/s (gloo through the host) and
            ``ship_overlap_frac``.
21. disagg_xdev  the disagg fleet across devices: prefill worker on
            ``cuda:0``, decode worker on ``cuda:1`` with two cards, else on
            the CPU; stablelm-1.6b at full width cut to 2 superblocks, f32
            (its pools too), LAYER, 8 lanes, 8 requests with distinct
            prompts, then the same requests on the same-device fleet.
            Every wave's received blocks equal the sent ones bit for bit
            (read back on the host) with one cross-device copy a pool
            leaf; ``blocks_shipped``, ``transfer_bytes`` and the wave count
            equal the same-device run's; every request completes; the
            tokens equal the same-device run's on two cards (their share
            is reported with the decode worker on the CPU).
22. slab    ``decode_attention``'s log-sum-exp entry on one rank's slab of
            part A (H = K = 32, hd 64, bf16, 32768 valid slots) against its
            plain version, timed beside
            ``_scaled_dot_product_efficient_attention(compute_log_sumexp=
            True)`` with its byte bound; then in f32, serve_multi's dtype,
            on A's slab (32768 slots at lengths 32761, 32768, 0 and 8, and
            timed) and on gemma2's (hd 128, GQA 2:1, softcap 50: a global
            layer's 4096-slot slab at 4096 and 1905, the ring's 2048-slot
            slab wrapped), each launch against the plain version (runs with
            the timed kernel phases).

23. dryrun  the dry run (``repro_torch.launch.dryrun``, a rank traced on
            the meta device in a fake world) of the train phase's fsdp
            step on a 1 x 1 mesh, held to that run: its predicted flash
            launches a step equal the measured (48, all ``simt``), its
            argument bytes (parameters, AdamW state, batch) within 1% of
            what the run's setup allocated, its peak within 15% of the
            run's peak (less what was live before it); both numbers of
            each pair and their ratio reported.  Then production runs on
            the host (stablelm-1.6b ``train_4k`` on one pod as one
            microbatch, xlstm-125m ``decode_32k`` on one pod,
            jamba-1.5-large-398b ``long_500k`` on two): ``trace_s``, peak
            and argument bytes a rank.

Phases 9-16 and 21 run after the serves, before training; 23 and 17-20
after training.  The ``kernels`` line
counts ``flash_attention`` launches from the ``train``, ``pipeline`` and
``multi`` phases (the ``multi`` ranks' counts summed, ``serve_multi``'s
prompt included), ``decode_attention``
launches from the ops, ``legacy``, ``window`` and ``serve_multi`` phases
(both ranks summed, the engine part's too) and ``block_diag_matmul``
launches from the ops and ``recurrent`` phases.  Every backend is freed before the next one is
built.  The last lines are
one JSON object per kernel line, the card's name and power limit, and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12                    # H100 SXM device memory
PEAK_FLOPS = {torch.bfloat16: 989e12,        # dense tensor-core bf16
              torch.float32: 67e12}          # f32 outside the tensor cores
TOL = {"f32": 1e-4, "bf16": 2e-2, "int8-f32q": 1e-3, "int8-bf16q": 2e-2}
# quant GEMM and the op layer's kernels, as |kernel - plain| <= tol (1 +
# |plain|) (decode: tol times its row's max |plain|, see ``ops_limit``):
# f32 the JAX quant kernel test's 2e-4 (tests/test_quant.py), bf16 the 2e-2
# above
QTOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
PAGED_HEADS = ((32, 32, 64), (16, 16, 128))  # (H, K, hd): stablelm, qwen2-moe


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_and_limit() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def ptxas_spills(report: pathlib.Path):
    """(number of kernels, [(kernel, spill line)]) from an ``nvcc -Xptxas
    -v`` report: the kernels whose registers spilled to local memory."""
    kernels, spills, fn = 0, [], None
    for line in report.read_text().splitlines():
        if "Function properties for" in line:
            fn = line.split("Function properties for", 1)[1].strip()
            kernels += 1
        elif "spill stores" in line and fn is not None:
            if not line.strip().split(",")[1].strip().startswith("0 bytes"):
                spills.append((fn, line.strip()))
            fn = None
    return kernels, spills


def time_ms(fn, reps: int = 10, rounds: int = 5) -> float:
    """Median over ``rounds`` of the mean per-call time of ``reps`` calls,
    from CUDA events, after a warm-up call.  For a call shorter than its
    host-side launch work this reads the host's enqueue rate."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return statistics.median(out)


def device_profile(fn, reps: int = 20, tries: int = 5):
    """Device busy time per call, from ``torch.profiler`` over ``reps``
    calls after a warm-up call (gaps between launches excluded): for each
    CUDA kernel the calls launch, its mean time per record times its
    launches per call (its record count over ``reps``, rounded), summed.
    The tracer on the card sometimes loses device records (all, part, or
    one in every profile of a case); a kernel's mean stays right
    when a few of its records are lost, so a profile is taken again, up to
    ``tries`` times, only when a kernel's count is more than one record,
    or a tenth of ``reps``, off a positive multiple of ``reps``.  With
    every record there this is the kernels' total time over ``reps``.
    Returns (ms per call, CUDA kernels per call)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, tries + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.is_user_annotation and e.count > 0]
        per_call = [round(e.count / reps) for e in kernels]
        if kernels and all(
                k >= 1 and abs(e.count - k * reps) <= max(1, reps // 10)
                for e, k in zip(kernels, per_call)):
            us = sum(e.self_device_time_total / e.count * k
                     for e, k in zip(kernels, per_call))
            if us > 0:
                return us / 1e3, sum(per_call)
        log(f"[profiler] {[e.count for e in kernels]} device records per "
            f"kernel for {reps} calls (try {attempt} of {tries})")
    raise AssertionError("the profiler lost device records on every try")


def device_ms(fn, reps: int = 20, tries: int = 5) -> float:
    """Device busy time per call (:func:`device_profile`)."""
    return device_profile(fn, reps, tries)[0]


def timings(kern, plain, library) -> dict:
    """A kernel row's times: device time per call of the kernel, its plain
    version and the library yardstick, the kernel's CUDA-event time per
    call (``call_ms``, which includes the wrapper's host work when that is
    the longer), and the CUDA kernels one call of the kernel launches
    (``kernels_per_call``, from the profiler)."""
    ms, per_call = device_profile(kern)
    return dict(ms=ms, kernels_per_call=per_call, call_ms=time_ms(kern),
                plain_ms=device_ms(plain, reps=5),
                library_ms=device_ms(library))


def _bound(nbytes, flops, dt):
    """(bound_ms, bound_by) from the bytes moved once and the flops."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dt] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------------ kernels
def kernel_case(dev, *, kv: str, qdt, h: int, kh: int, hd: int,
                seed: int = 0):
    """Full-width paged inputs: 8 lanes over a 513-block pool, ragged
    lengths up to 1024 with a length-0 pad row (null table), lanes 1-3
    aliasing lane 1's first 8 blocks, and one prefill lane whose chunk
    runs past the table."""
    from repro_torch.decode.paged_cache import quantize_kv
    g = torch.Generator(device=dev).manual_seed(seed)
    b, bs, nb, c = 8, 16, 64, 128
    p_blocks = 1 + b * nb
    kf = torch.randn(p_blocks, bs, kh, hd, generator=g, device=dev)
    vf = torch.randn(p_blocks, bs, kh, hd, generator=g, device=dev)
    rng = np.random.default_rng(seed)
    tables = rng.permutation(np.arange(1, p_blocks)).reshape(b, nb)
    tables[2:4, :8] = tables[1, :8]
    tables[0] = 0
    lengths = np.asarray([0, 1024, 700, 513, 129, 1000, 64, 300], np.int32)
    starts = np.maximum(lengths - c, 0)
    starts[5] = 960                              # 960 + 127 > NB * bs
    positions = (starts[:, None] + np.arange(c)).astype(np.int32)
    case = dict(
        tables=torch.from_numpy(tables.astype(np.int32)).to(dev),
        lengths=torch.from_numpy(lengths).to(dev),
        positions=torch.from_numpy(positions).to(dev),
        q=torch.randn(b, h, hd, generator=g, device=dev).to(qdt),
        qc=torch.randn(b, c, h, hd, generator=g, device=dev).to(qdt))
    if kv == "int8":
        (k, ks), (v, vs) = quantize_kv(kf), quantize_kv(vf)
        case.update(k=k, v=v, k_scale=ks, v_scale=vs)
    else:
        case.update(k=kf.to(qdt), v=vf.to(qdt), k_scale=None, v_scale=None)
    return case


def _needed_slots(tables, last_pos, bs):
    """Unique physical (block, slot) pairs the lanes attend: keys
    0..last_pos[b] (clipped to the table) of each lane, aliases once."""
    slots = set()
    nb = tables.shape[1]
    for b, last in enumerate(last_pos):
        for pos in range(min(int(last) + 1, nb * bs)):
            slots.add((int(tables[b, pos // bs]), pos % bs))
    return len(slots)


def bound(case, *, chunk: bool):
    """(bound_ms, bound_by): the larger of the bytes this run's data needs
    over the memory rate and its flops over the peak for q's type."""
    q = case["qc"] if chunk else case["q"]
    tables = case["tables"].cpu().numpy()
    bs, kh, hd = case["k"].shape[1:]
    h = q.shape[-2]
    if chunk:
        qpos = case["positions"].cpu().numpy()
        last = qpos.max(axis=1)
        keys = np.minimum(qpos + 1, tables.shape[1] * bs).sum()
    else:
        lengths = case["lengths"].cpu().numpy()
        last = lengths - 1
        keys = lengths.sum()
    slots = _needed_slots(tables, last, bs)
    per_slot = 2 * kh * hd * case["k"].element_size()
    if case["k_scale"] is not None:
        per_slot += 2 * kh * 4
    nbytes = slots * per_slot + 2 * q.numel() * q.element_size() \
        + tables.nbytes + (case["positions"] if chunk
                           else case["lengths"]).numel() * 4
    flops = 4.0 * h * hd * float(keys)           # QK^T and PV
    return _bound(nbytes, flops, q.dtype)


def library_call(case, *, chunk: bool):
    """``scaled_dot_product_attention`` over the dense cache gathered
    beforehand (a yardstick; the port never calls it)."""
    import torch.nn.functional as F
    from repro_torch.kernels.ref import dequant_pool_ref
    tables = case["tables"].long()
    qdt = case["q"].dtype
    k = dequant_pool_ref(case["k"], case["k_scale"]).to(qdt)[tables]
    v = dequant_pool_ref(case["v"], case["v_scale"]).to(qdt)[tables]
    b, nb, bs, kh, hd = k.shape
    k = k.reshape(b, nb * bs, kh, hd).transpose(1, 2).contiguous()
    v = v.reshape(b, nb * bs, kh, hd).transpose(1, 2).contiguous()
    kpos = torch.arange(nb * bs, device=k.device)
    if chunk:
        q = case["qc"].transpose(1, 2).contiguous()          # [B, H, C, hd]
        mask = kpos[None, None, None, :] <= \
            case["positions"][:, None, :, None]
    else:
        q = case["q"][:, :, None, :]                          # [B, H, 1, hd]
        mask = kpos[None, None, None, :] < case["lengths"][:, None, None, None]
        mask = mask | (case["lengths"] == 0)[:, None, None, None]
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)


def row_limit(want, tol):
    """The largest |kernel - plain| each element of an attention kernel's
    output may show: tol times the largest |plain| of its output (head) row.
    The outputs are softmax averages over up to 2048 keys, |plain| ~
    0.03-0.13, so an absolute tol would pass a kernel that drops a K/V
    tile."""
    return tol * want.float().abs().amax(-1, keepdim=True)


PAGED_DROP = 64          # tokens of the fault's dropped K/V tile
PAGED_LONG = 256         # rows with more keys than this must reject it


def paged_fault(plain, args, kw, case, *, chunk: bool):
    """The plain output with each row's first ``PAGED_DROP`` keys left out
    (the table shifted by that many blocks, positions or lengths by as many
    tokens), and the query rows (lanes for decode, (lane, position) for
    prefill) with more than ``PAGED_LONG`` keys, where the check must reject
    it."""
    tables = case["tables"]
    bs, nb = case["k"].shape[1], tables.shape[1]
    drop = PAGED_DROP // bs
    q, _, _, _, qpos = args
    bad = plain(q, case["k"], case["v"], tables[:, drop:].contiguous(),
                qpos - PAGED_DROP, **kw)
    keys = (qpos + 1).clamp(max=nb * bs) if chunk else qpos
    return bad, keys > PAGED_LONG


def kernel_phase(dev):
    from repro_torch.kernels import _paged_launch as PL
    from repro_torch.kernels import paged_decode_attention as D
    from repro_torch.kernels import paged_prefill_attention as P
    results = {}
    cases = (("f32", "f32", torch.float32), ("bf16", "bf16", torch.bfloat16),
             ("int8-f32q", "int8", torch.float32),
             ("int8-bf16q", "int8", torch.bfloat16))
    specs = (
        ("paged_decode_attention", D.paged_decode_attention,
         D.paged_decode_attention_plain, "q", "lengths", False,
         "src/repro/kernels/paged_decode_attention.py:33"),
        ("paged_prefill_attention", P.paged_prefill_attention,
         P.paged_prefill_attention_plain, "qc", "positions", True,
         "src/repro/kernels/paged_prefill_attention.py:35"))
    for name, kern, plain, qkey, pkey, chunk, replaces in specs:
        per = {}
        for (h, kh, hd), (label, kv, qdt) in (
                (heads, case) for heads in PAGED_HEADS for case in cases):
            cs = kernel_case(dev, kv=kv, qdt=qdt, h=h, kh=kh, hd=hd)
            args = (cs[qkey], cs["k"], cs["v"], cs["tables"], cs[pkey])
            kw = dict(k_scale=cs["k_scale"], v_scale=cs["v_scale"])
            paths = dict(PL.PATH_LAUNCHES)
            got = kern(*args, **kw)
            torch.cuda.synchronize()
            path = [k for k in paths if PL.PATH_LAUNCHES[k] != paths[k]]
            want_path = PL.path_for(qdt, chunk)
            if path != [want_path]:
                raise AssertionError(f"{name} [{label}]: launched {path}, "
                                     f"not {want_path}")
            want = plain(*args, **kw)
            torch.cuda.synchronize()
            tag = f"{name} hd{hd} [{label}]"
            limit = row_limit(want, TOL[label])
            diff = (got.float() - want.float()).abs()
            err = float(diff.max())
            if not bool(got.isfinite().all()) or not bool(
                    (diff <= limit).all()):
                raise AssertionError(f"{tag}: max |kernel - plain| {err} "
                                     f"beyond {TOL[label]} max|plain| of "
                                     "its row")
            if not chunk and bool((got[0] != 0).any()):
                raise AssertionError(f"{tag}: pad row not 0")
            # the same check on the plain output with each long row's first
            # tile dropped must fail in every such row: the least, over
            # those rows, of the row's largest |fault - plain| / limit
            bad, long = paged_fault(plain, args, kw, cs, chunk=chunk)
            ratio = (bad.float() - want.float()).abs() / limit.clamp(
                min=1e-30)
            worst = float(ratio.amax((-2, -1))[long].min())
            del bad, ratio
            if worst <= 1:
                raise AssertionError(f"{tag}: the check passes a row with "
                                     f"its first tile dropped ({worst:.3g}"
                                     " of its limit)")
            bnd, by = bound(cs, chunk=chunk)
            row = dict(max_abs_err=err, tol=TOL[label], path=want_path,
                       err_over_limit=float((diff / limit.clamp(
                           min=1e-30)).max()),
                       fault_over_limit=worst, long_rows=int(long.sum()),
                       bound_ms=bnd, bound_by=by, **timings(
                           lambda: kern(*args, **kw),
                           lambda: plain(*args, **kw),
                           library_call(cs, chunk=chunk)))
            if not chunk:
                hg, rt, pieces, piece = PL.decode_plan(
                    h=h, kh=kh, hd=hd, kv_item=cs["k"].element_size(),
                    b=cs["q"].shape[0], g=1, nb=cs["tables"].shape[1],
                    bs=cs["k"].shape[1],
                    n_sm=torch.cuda.get_device_properties(
                        dev).multi_processor_count)
                row.update(pieces=pieces, piece=piece, kv_heads_per_cta=hg)
                if row["kernels_per_call"] != 1:
                    raise AssertionError(f"{tag}: {row['kernels_per_call']} "
                                         "CUDA kernels per call, not 1")
            per[f"hd{hd}/{label}"] = row
            log(f"[kernels] {name} hd{hd} {label} ({want_path}, "
                f"{row['kernels_per_call']} kernel(s) per call"
                + (f", {row['pieces']} pieces of {row['piece']}" if not chunk
                   else "") + "): "
                f"max_abs_err={err:.3g}, {row['err_over_limit']:.3g} of "
                f"{TOL[label]} max|plain| per row; a row with its first "
                f"{PAGED_DROP} keys dropped reads >= {worst:.3g} of it "
                f"({row['long_rows']} rows); kernel {row['ms']:.4f} ms (call"
                f" {row['call_ms']:.4f}), plain {row['plain_ms']:.4f} ms, "
                f"sdpa {row['library_ms']:.4f} ms, bound {bnd:.4f} ms ({by})")
            del cs, got, want, diff, limit
        results[name] = dict(replaces=replaces, per_dtype=per)
    return results


# -------------------------------------------------------------------- quant
QUANT_SHAPES = (("layer", 1, 2048, 2048), ("semantic", 2, 1024, 1024))


def quant_bound(x, q, scales):
    """(bound_ms, bound_by): codes, scales, x and the output each moved
    once over the memory rate, against 2 G T D E flops over the peak for
    x's type."""
    g, t, d = x.shape
    e = scales.shape[-1]
    nbytes = q.numel() + scales.numel() * 4 \
        + (x.numel() + g * t * e) * x.element_size()
    return _bound(nbytes, 2.0 * g * t * d * e, x.dtype)


def quant_fault(x, q, sc, dropped):
    """The plain output with the groups ``dropped`` left out of the
    contraction (their x columns zeroed), as a kernel that skips them
    would give."""
    from repro_torch.kernels import quant_matmul as Q
    group = x.shape[-1] // sc.shape[1]
    xd = x.clone()
    for gi in dropped:
        xd[..., gi * group:(gi + 1) * group] = 0
    return Q.quant_matmul_plain(xd, q, sc)


def quant_phase(dev):
    """``quant_matmul`` against its plain version over bit widths, x types,
    both arms' shapes, ragged and tiny T and two group sizes, each call on
    its path; the same check must reject the plain output with the last
    group of each split left out, in every output row; timed at the main
    path's decode and prefill T."""
    from repro_torch.kernels import _quant_launch as QL
    from repro_torch.kernels import quant_matmul as Q
    gen = torch.Generator(device=dev).manual_seed(7)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    checked, per, fault_min = 0, {}, math.inf
    for arm, g, d, e in QUANT_SHAPES:
        w = torch.randn(g, d, e, generator=gen, device=dev) / math.sqrt(d)
        for bits, group in ((8, 128), (4, 128), (8, 32), (4, 32)):
            q, sc = Q.quantize_blockwise(w, bits=bits, group=group)
            n_g = sc.shape[1]
            for xdt in (torch.float32, torch.bfloat16):
                for t in (1, 8, 200, 1024):
                    x = torch.randn(g, t, d, generator=gen,
                                    device=dev).to(xdt)
                    tag = f"quant_matmul {arm} int{bits} g{group} {xdt} T={t}"
                    paths0 = dict(QL.PATH_LAUNCHES)
                    got = Q.quant_matmul(x, q, sc)
                    want = Q.quant_matmul_plain(x, q, sc)
                    torch.cuda.synchronize()
                    path = [k for k in paths0
                            if QL.PATH_LAUNCHES[k] != paths0[k]]
                    want_path = QL.path_for(xdt, t, d, e, group, bits)
                    if path != [want_path]:
                        raise AssertionError(f"{tag}: took {path}, not "
                                             f"{want_path}")
                    limit = QTOL[xdt] * (1 + want.float().abs())
                    diff = (got.float() - want.float()).abs()
                    err = float(diff.max())
                    if got.shape != (g, t, e) or not bool(
                            (diff <= limit).all()) or not math.isfinite(err):
                        raise AssertionError(
                            f"{tag}: max |kernel - plain| {err} beyond "
                            f"{QTOL[xdt]} (1 + |plain|)")
                    # the last group of each split (of the whole walk when
                    # the call does not split) left out must fail the same
                    # check in every output row
                    if want_path == "simt":
                        splits = QL.split_count(g, t, e, n_g, n_sm)
                        per_split = -(-n_g // splits)
                    else:
                        _, splits, per_split = QL.mma_plan(g, t, e, n_g,
                                                           n_sm)
                    dropped = [min(n_g, (i + 1) * per_split) - 1
                               for i in range(splits)]
                    bad = quant_fault(x, q, sc, dropped)
                    ratio = float(((bad.float() - want.float()).abs()
                                   / limit).amax(-1).min())
                    del bad
                    if ratio <= 1:
                        raise AssertionError(f"{tag}: the check passes a row "
                                             f"with groups {dropped} dropped "
                                             f"({ratio:.3g} of its limit)")
                    fault_min = min(fault_min, ratio)
                    checked += 1
                    if group != 128 or t not in (8, 1024):
                        continue
                    wdq = Q.dequantize_blockwise(q, sc, bits=bits).to(xdt)
                    bnd, by = quant_bound(x, q, sc)
                    row = dict(max_abs_err=err, tol=QTOL[xdt], bound_ms=bnd,
                               bound_by=by, path=want_path, splits=splits,
                               fault_over_limit=ratio, **timings(
                                   lambda: Q.quant_matmul(x, q, sc),
                                   lambda: Q.quant_matmul_plain(x, q, sc),
                                   lambda: torch.matmul(x, wdq)))
                    if want_path != "simt" and row["kernels_per_call"] != 1:
                        raise AssertionError(f"{tag}: {row['kernels_per_call']}"
                                             " CUDA kernels per call, not 1")
                    label = f"{arm}/int{bits}/{str(xdt)[6:]}/T{t}"
                    per[label] = row
                    log(f"[quant] {label} ({want_path}, {splits} split(s), "
                        f"{row['kernels_per_call']} kernel(s) per call): "
                        f"max_abs_err={err:.3g}, dropped groups read "
                        f">= {ratio:.3g} of the limit; kernel "
                        f"{row['ms']:.4f} ms (call {row['call_ms']:.4f}), "
                        f"plain {row['plain_ms']:.4f} "
                        f"ms, matmul {row['library_ms']:.4f} ms, bound "
                        f"{bnd:.4f} ms ({by})")
                    del wdq
    log(f"[quant] {checked} shapes match the plain version and reject the "
        f"dropped groups (>= {fault_min:.3g} of the limit in every row)")
    return dict(replaces="src/repro/kernels/quant_matmul.py:106",
                checked=checked, fault_over_limit=fault_min, per_dtype=per)


# -------------------------------------------------------------------- serve
def make_requests(vocab: int, n: int, seed: int, max_new=(32, 65)):
    """``n`` requests over 3 apps: prompts of 128-512 tokens whose heads
    (100, 150 and 230 tokens: not block multiples, so hits end in a
    copy-on-write block) come from 3 families, ``max_new`` new tokens drawn
    from [lo, hi), SLAs from tight to loose."""
    from repro_torch.engine import Request
    rng = np.random.default_rng(seed)
    heads = [rng.integers(0, vocab, n_h).astype(np.int32)
             for n_h in (100, 150, 230)]
    reqs = []
    for rid in range(n):
        fam = rid % 3
        total = int(rng.integers(max(128, len(heads[fam]) + 8), 513))
        tail = rng.integers(0, vocab, total - len(heads[fam]))
        reqs.append(Request(
            rid=rid, app_id=int(rng.integers(0, 3)),
            tokens=np.concatenate([heads[fam], tail]).astype(np.int32),
            sla_s=float(rng.choice([0.5, 2.0, 8.0, 30.0])),
            max_new=int(rng.integers(*max_new))))
    return reqs


def _counters():
    from repro_torch.kernels.paged_decode_attention import \
        paged_decode_attention
    from repro_torch.kernels.paged_prefill_attention import \
        paged_prefill_attention
    from repro_torch.kernels.quant_matmul import quant_matmul
    return {"paged_decode_attention": paged_decode_attention,
            "paged_prefill_attention": paged_prefill_attention,
            "quant_matmul": quant_matmul}


def _every_arm_first(policy, arms):
    """Wrap a ``MABPolicy`` so that its first decisions visit each of
    ``arms`` once (the bandit still picks every context, observes every
    outcome and decides everything after): a short load then reaches every
    arm's kernels, which UCB's own explore-first rule only guarantees per
    context."""
    todo = list(arms)
    decide_batch = policy.decide_batch

    def pinned(requests):
        out = list(decide_batch(requests))
        for i in range(len(out)):
            if not todo:
                break
            out[i] = todo.pop(0)
        return out
    policy.decide_batch = pinned
    policy.decide = lambda r: pinned([r])[0]
    return policy


def serve_phase(dev, cfg, *, kv_dtype: str, n_requests: int, waves: int,
                weight_quant=None, max_new=(32, 65),
                every_arm_first: bool = False):
    from repro_torch.engine import (LAYER, SEMANTIC, MABPolicy,
                                    PlacementEngine, TorchBackend)
    from repro_torch.obs import Tracer, set_tracer
    tag = f"{cfg.name} kv={kv_dtype} weights={weight_quant or cfg.dtype}"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    backend = TorchBackend(cfg, cache_len=1024, max_batch=8, block_size=16,
                           prefill_chunk=128, kv_dtype=kv_dtype,
                           weight_quant=weight_quant, device=dev)
    policy = MABPolicy(bandit="ucb")
    if every_arm_first:
        policy = _every_arm_first(policy, (LAYER, SEMANTIC))
    eng = PlacementEngine(policy, backend)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    reqs = make_requests(cfg.vocab_size, n_requests, seed=1,
                         max_new=max_new)
    per_wave = -(-n_requests // waves)
    tracer = Tracer()
    old = set_tracer(tracer)
    from repro_torch.kernels import _paged_launch as PL
    from repro_torch.kernels import _quant_launch as QL
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    paths0 = dict(PL.PATH_LAUNCHES)
    qpaths0 = dict(QL.PATH_LAUNCHES)
    t0 = time.perf_counter()
    try:
        for w in range(waves):
            eng.submit(reqs[w * per_wave:(w + 1) * per_wave])
            eng.drain()
        torch.cuda.synchronize()
    finally:
        set_tracer(old)
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    paths = {k: PL.PATH_LAUNCHES[k] - paths0[k] for k in paths0}
    qpaths = {k: QL.PATH_LAUNCHES[k] - qpaths0[k] for k in qpaths0}
    summary = eng.summary()

    for r in reqs:
        if r.output is None or r.output.shape != (r.max_new,):
            raise AssertionError(f"request {r.rid}: output "
                                 f"{None if r.output is None else r.output.shape}"
                                 f", wanted {r.max_new} tokens")
    if summary["completed"] != n_requests:
        raise AssertionError(f"completed {summary['completed']}")
    if set(summary["per_mode"]) != {"layer", "semantic"}:
        raise AssertionError(f"arms served: {summary['per_mode']}")
    if not summary["prefix_hit_rate"] > 0:
        raise AssertionError("no prefix-cache hits")
    # steps by kind, and the projections' rows (T) per step: a prefill
    # bucket "prefill:WxC" runs T = W C rows, a decode bucket "decode:WxK"
    # K steps of T = W rows
    steps = {"prefill": 0, "decode": 0}
    qwant = dict.fromkeys(qpaths, 0)
    for s in backend._paged.values():
        for bucket, n in s.buckets.items():
            kind, shape = bucket.split(":")
            if kind not in ("prefill", "decode"):
                continue
            w, c = (int(v) for v in shape.split("x"))
            if kind == "prefill":
                steps["prefill"] += n
                t, calls = w * c, n
            else:
                steps["decode"] += n * c
                t, calls = w, n * c
            if weight_quant:      # bf16 x, widths that are multiples of 128
                qwant["mma_skinny" if t <= QL.DECODE_T else "mma_tile"] += \
                    4 * cfg.n_layers * calls
    layers = cfg.n_layers
    want = {"paged_prefill_attention": layers * steps["prefill"],
            "paged_decode_attention": layers * steps["decode"],
            "quant_matmul": 4 * layers * (steps["prefill"] + steps["decode"])
            if weight_quant else 0}
    for k in launches:
        if launches[k] != want[k] or (want[k] == 0) != (
                k == "quant_matmul" and not weight_quant):
            raise AssertionError(f"[{tag}] {k}: {launches[k]} launches, "
                                 f"dispatches imply {want[k]}")
    # the served models are bf16: every prefill chunk on the tensor cores,
    # every decode step split; every projection on the tensor cores
    want_paths = {"prefill_mma": want["paged_prefill_attention"],
                  "prefill_simt": 0,
                  "decode_split": want["paged_decode_attention"]}
    if cfg.dtype != "bfloat16" or paths != want_paths:
        raise AssertionError(f"[{tag}] paged launches by path {paths}, "
                             f"expected {want_paths}")
    if qpaths != qwant:
        raise AssertionError(f"[{tag}] quant_matmul launches by path "
                             f"{qpaths}, expected {qwant}")
    # a decode step's host time: the call's enqueue and the read of its
    # results (``finish_dispatch``)
    scans = tracer.events("decode_scan") + tracer.events("decode_read")
    decode_s = sum(e[4] for e in scans) / 1e6
    prefill_s = sum(e[4] for e in tracer.events("prefill_chunk")) / 1e6
    tokens = int(sum(r.max_new for r in reqs))
    m = backend.extra_metrics()
    out = dict(model=cfg.name, kv_dtype=kv_dtype, weight_quant=weight_quant,
               requests=n_requests, tokens=tokens, wall_s=wall,
               setup_s=setup_s, tokens_per_s=tokens / wall,
               decode_dispatches=summary["decode_dispatches"],
               prefill_chunks=summary["prefill_chunks"],
               decode_steps=steps["decode"],
               decode_ms_per_step=1e3 * decode_s / max(steps["decode"], 1),
               prefill_ms_per_chunk=1e3 * prefill_s / max(steps["prefill"],
                                                          1),
               prefill_share=prefill_s / wall,
               prefix_hit_rate=summary["prefix_hit_rate"],
               cow_copies=summary["cow_copies"],
               preemptions=summary["preemptions"],
               per_mode=summary["per_mode"], launches=launches,
               paged_paths=paths, quant_paths=qpaths,
               weight_quant_max_err=m.get("weight_quant_max_err"),
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               ttft_p50=summary.get("ttft_p50"),
               response_p50=summary.get("response_p50"))
    log(f"[serve {tag}] {json.dumps(out)}")
    return backend, out


# ------------------------------------------------------------------ disagg
SERVE_SHAPE = dict(cache_len=1024, block_size=16, prefill_chunk=128)
#: tests/test_faults.py's six-fault plan: (step, kind, fields)
CHAOS_PLAN = ((2.0, "ship_drop", {}),
              (3.0, "arm_blackout", dict(target=0, duration=3.0)),
              (6.0, "ship_delay", dict(magnitude=0.3)),
              (7.0, "ship_dup", {}),
              (8.0, "dispatch_error", dict(count=2)),
              (9.0, "ship_drop", {}))


def _free():
    """Release what the caller has just deleted: backends and their
    schedulers hold cycles."""
    gc.collect()
    torch.cuda.empty_cache()


def _check_unwound(backend, tag):
    for arm, sched in backend._paged.items():
        if sched.alloc.used_blocks or sched.backlog:
            raise AssertionError(
                f"[{tag}] arm {arm}: pool not unwound "
                f"({sched.alloc.used_blocks} blocks used, backlog "
                f"{sched.backlog})")
    for arm, (pf, dc, store) in backend._disagg.items():
        if pf.alloc.used_blocks or dc.alloc.used_blocks or store.backlog:
            raise AssertionError(
                f"[{tag}] arm {arm}: pools not unwound (prefill "
                f"{pf.alloc.used_blocks}, decode {dc.alloc.used_blocks} "
                f"blocks used, store backlog {store.backlog})")


def _bucket_steps(sched, kind):
    """Model steps a scheduler ran of ``kind``: prefill chunks, or decode
    calls times their loop length."""
    n = 0
    for bucket, calls in sched.buckets.items():
        k, shape = bucket.split(":")
        if k == kind:
            n += calls * (int(shape.split("x")[1]) if k == "decode" else 1)
    return n


def _instrument_store(store, waves):
    """Wrap ``store._transfer``: CUDA events around each wave's transfer
    and, enqueued after it, a device-side comparison of every shipped
    block with its source block (each leaf, codes and scales), read once
    the run is over so the ship stays asynchronous."""
    from repro_torch.decode.cache_store import _index
    from repro_torch.decode.paged_cache import _leaves, gather_blocks
    transfer = store._transfer

    def timed(src_ids, dst_ids):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        transfer(src_ids, dst_ids)
        end.record()
        dev = store.dst.device
        a = gather_blocks(store.src.pool,
                          _index(np.asarray(src_ids, np.int64), dev))
        b = gather_blocks(store.dst.pool,
                          _index(np.asarray(dst_ids, np.int64), dev))
        # bitwise: each leaf's bytes compared as bytes
        same = torch.stack([(x.view(torch.uint8) == y.view(torch.uint8))
                            .all() for (_, x), (_, y) in zip(_leaves(a),
                                                             _leaves(b))])
        waves.append(dict(blocks=len(src_ids), start=start, end=end,
                          same=same.all(), leaves=len(same)))
    store._transfer = timed


def _by_role(backend, role_launches):
    """Count the paged launches made inside each arm's prefill worker's
    device calls and inside its decode worker's."""
    for pf, dc, _ in backend._disagg.values():
        _count_by_role(pf, dc, role_launches)


def _new_roles():
    zero = dict.fromkeys(_counters(), 0)
    return {"prefill": dict(zero), "decode": dict(zero)}


def _with_colocated(role, launches):
    """``role`` plus the launches made outside any fleet worker."""
    return dict(role, colocated={
        k: n - role["prefill"][k] - role["decode"][k]
        for k, n in launches.items()})


def _count_by_role(pf, dc, role_launches):
    """Count paged launches made inside the prefill worker's device calls
    and inside the decode worker's (``call``: rank 0's and a follower's
    replayed calls alike)."""
    counters = _counters()

    def wrap(sched, role):
        call = sched.call

        def counted(*a, **kw):
            before = {k: fn.launches for k, fn in counters.items()}
            try:
                return call(*a, **kw)
            finally:
                for k, fn in counters.items():
                    role_launches[role][k] += fn.launches - before[k]
        sched.call = counted
    wrap(pf, "prefill")
    wrap(dc, "decode")


def disagg_phase(dev, cfg, *, kv_dtype: str, n_requests: int = 9,
                 waves: int = 3):
    """``TorchBackend(fleet="disagg")``: each arm a prefill worker and a
    decode worker joined by a ``CacheStore``, MAB-routed, every arm served
    first, under the smoke load."""
    from repro_torch.engine import (LAYER, SEMANTIC, MABPolicy,
                                    PlacementEngine, TorchBackend)
    from repro_torch.kernels import _paged_launch as PL
    from repro_torch.obs import Tracer, set_tracer
    tag = f"disagg {cfg.name} kv={kv_dtype}"
    backend = TorchBackend(cfg, max_batch=8, kv_dtype=kv_dtype,
                           fleet="disagg", device=dev, **SERVE_SHAPE)
    eng = PlacementEngine(_every_arm_first(MABPolicy(bandit="ucb"),
                                           (LAYER, SEMANTIC)), backend)
    reqs = make_requests(cfg.vocab_size, n_requests, seed=1)
    per_wave = -(-n_requests // waves)
    ship = {arm: [] for arm in backend._disagg}
    zero = dict.fromkeys(_counters(), 0)
    role = _new_roles()
    _by_role(backend, role)
    for arm, (_, _, store) in backend._disagg.items():
        _instrument_store(store, ship[arm])
    tracer = Tracer()
    old = set_tracer(tracer)
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    paths0 = dict(PL.PATH_LAUNCHES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        for w in range(waves):
            eng.submit(reqs[w * per_wave:(w + 1) * per_wave])
            eng.drain()
        torch.cuda.synchronize()
    finally:
        set_tracer(old)
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    paths = {k: PL.PATH_LAUNCHES[k] - paths0[k] for k in paths0}
    m = eng.summary()

    for r in reqs:
        if r.output is None or r.output.shape != (r.max_new,):
            raise AssertionError(f"[{tag}] request {r.rid}: output "
                                 f"{None if r.output is None else r.output.shape}"
                                 f", wanted {r.max_new} tokens")
    if m["completed"] != n_requests or set(m["per_mode"]) != {
            "layer", "semantic"}:
        raise AssertionError(f"[{tag}] completed {m['completed']}, arms "
                             f"{m['per_mode']}")
    if not m["blocks_shipped"] > 0:
        raise AssertionError(f"[{tag}] no block shipped")
    if m["transfer_bytes"] != m["blocks_shipped"] * m["kv_block_bytes"]:
        raise AssertionError(f"[{tag}] transfer_bytes {m['transfer_bytes']}"
                             f" != {m['blocks_shipped']} x "
                             f"{m['kv_block_bytes']}")
    if not m["overlap_steps"] > 0:
        raise AssertionError(f"[{tag}] no decode call overlapped a ship")
    _check_unwound(backend, tag)
    # the prefill kernel ran on the prefill workers only, the decode kernel
    # on the decode workers only, one launch a layer a step
    layers = cfg.n_layers
    pf_steps = sum(_bucket_steps(pf, "prefill")
                   for pf, _, _ in backend._disagg.values())
    dc_steps = sum(_bucket_steps(dc, "decode")
                   for _, dc, _ in backend._disagg.values())
    if any(_bucket_steps(pf, "decode") or _bucket_steps(dc, "prefill")
           for pf, dc, _ in backend._disagg.values()):
        raise AssertionError(f"[{tag}] a worker ran the other role's calls")
    want_role = {
        "prefill": dict(zero, paged_prefill_attention=layers * pf_steps),
        "decode": dict(zero, paged_decode_attention=layers * dc_steps)}
    if role != want_role or not pf_steps or not dc_steps:
        raise AssertionError(f"[{tag}] launches by role {role}, expected "
                             f"{want_role}")
    want_paths = {"prefill_mma": layers * pf_steps, "prefill_simt": 0,
                  "decode_split": layers * dc_steps}
    if paths != want_paths or launches != {
            k: role["prefill"][k] + role["decode"][k] for k in zero}:
        raise AssertionError(f"[{tag}] paged launches {launches} by path "
                             f"{paths}, expected {want_paths}")
    # every wave's shipped blocks equal their source blocks, bit for bit
    all_waves = [w for ws in ship.values() for w in ws]
    if not all_waves or not all(bool(w["same"]) for w in all_waves):
        raise AssertionError(f"[{tag}] shipped blocks differ from their "
                             "source blocks")
    if sum(w["blocks"] for w in all_waves) != m["blocks_shipped"]:
        raise AssertionError(f"[{tag}] waves moved "
                             f"{sum(w['blocks'] for w in all_waves)} blocks"
                             f", store counted {m['blocks_shipped']}")
    wave_ms = [w["start"].elapsed_time(w["end"]) for w in all_waves]
    wave_bytes = [w["blocks"] * m["kv_block_bytes"] for w in all_waves]
    # the least time: each shipped byte read once and written once
    bound_ms = [2 * b / HBM_BYTES_PER_S * 1e3 for b in wave_bytes]
    dec = tracer.events("decode_scan") + tracer.events("decode_read")
    decode_s = sum(e[4] for e in dec) / 1e6
    tokens = int(sum(r.max_new for r in reqs))
    out = dict(model=cfg.name, kv_dtype=kv_dtype, requests=n_requests,
               tokens=tokens, wall_s=wall, tokens_per_s=tokens / wall,
               decode_steps=dc_steps, prefill_chunks=pf_steps,
               decode_ms_per_step=1e3 * decode_s / max(dc_steps, 1),
               ship_waves=len(all_waves),
               waves_checked=len(all_waves),
               leaves_per_wave=all_waves[0]["leaves"],
               blocks_shipped=m["blocks_shipped"],
               transfer_bytes=m["transfer_bytes"],
               ship_skipped_blocks=m["ship_skipped_blocks"],
               ship_ms_per_wave=statistics.mean(wave_ms),
               ship_ms_max=max(wave_ms),
               ship_bytes_per_wave=statistics.mean(wave_bytes),
               ship_bound_ms_per_wave=statistics.mean(bound_ms),
               ship_gb_per_s=2 * sum(wave_bytes) / sum(wave_ms) / 1e6,
               ship_overlap_frac=m.get("ship_overlap_frac"),
               overlap_steps=m["overlap_steps"],
               ship_latency_p50=m.get("ship_latency_p50"),
               prefix_hit_rate=m["prefix_hit_rate"],
               decode_spills=m["decode_spills"],
               per_mode=m["per_mode"], launches=launches, paths=paths,
               launches_by_role=role, ttft_p50=m.get("ttft_p50"))
    log(f"[{tag}] {json.dumps(out)}")
    del backend, eng
    _free()
    return out


def _parity_requests(vocab, n=4, seed=4):
    """``n`` requests with distinct random prompts (no shared prefix), one
    SLA (deadlines in submit order), 8-16 new tokens."""
    from repro_torch.engine import Request
    rng = np.random.default_rng(seed)
    return [Request(rid=i, app_id=i % 3, sla_s=60.0,
                    tokens=rng.integers(0, vocab, int(rng.integers(128, 513)))
                    .astype(np.int32), max_new=int(rng.integers(8, 17)))
            for i in range(n)]


def disagg_parity_phase(dev, cfg):
    """``FixedPolicy`` on each arm at one lane, colocated then disagg on
    the same seed's weights: every call has the same shapes in both runs,
    so every token stream must be equal."""
    from repro_torch.engine import (LAYER, SEMANTIC, FixedPolicy,
                                    PlacementEngine, TorchBackend)
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    role = _new_roles()
    out = {}
    for arm, name in ((LAYER, "layer"), (SEMANTIC, "semantic")):
        streams = {}
        for fleet in (None, "disagg"):
            backend = TorchBackend(cfg, max_batch=1, arms=(arm,),
                                   fleet=fleet, device=dev, **SERVE_SHAPE)
            _by_role(backend, role)
            eng = PlacementEngine(FixedPolicy(arm, placement=None), backend)
            reqs = _parity_requests(cfg.vocab_size)
            eng.submit(reqs)
            eng.drain()
            if eng.summary()["completed"] != len(reqs):
                raise AssertionError(f"[disagg_parity {name} {fleet}] "
                                     "requests lost")
            streams[fleet] = [r.output for r in reqs]
            shipped = eng.summary().get("blocks_shipped")
            if fleet:
                _check_unwound(backend, f"disagg_parity {name}")
            del backend, eng
            _free()
        equal = [bool(np.array_equal(a, b))
                 for a, b in zip(streams[None], streams["disagg"])]
        if not all(equal):
            raise AssertionError(f"[disagg_parity {name}] colocated and "
                                 f"disagg streams differ: {equal}")
        out[name] = dict(requests=len(equal), streams_equal=sum(equal),
                         blocks_shipped=shipped)
    out["launches"] = {k: fn.launches for k, fn in counters.items()}
    by = out["launches_by_role"] = _with_colocated(role, out["launches"])
    pre, dec = "paged_prefill_attention", "paged_decode_attention"
    if not (by["prefill"][pre] and by["decode"][dec] and by["colocated"][pre]
            and by["colocated"][dec]) or by["prefill"][dec] \
            or by["decode"][pre]:
        raise AssertionError(f"[disagg_parity] launches by role {by}")
    log(f"[disagg_parity {cfg.name}] {json.dumps(out)}")
    return out


def chaos_phase(dev, cfg, n_requests: int = 6):
    """The disagg fleet (bf16 pools, LAYER) under the six-fault plan
    against a clean twin, then a colocated run with load shedding."""
    from repro_torch.engine import (LAYER, FixedPolicy, PlacementEngine,
                                    Request, TorchBackend)
    from repro_torch.faults import Fault, FaultPlan
    plan = FaultPlan([Fault(at=at, kind=kind, **kw)
                      for at, kind, kw in CHAOS_PLAN], seed=7)
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    role = _new_roles()
    runs = {}
    for name, faults in (("clean", None), ("chaos", plan)):
        backend = TorchBackend(cfg, max_batch=4, arms=(LAYER,),
                               fleet="disagg", ship_timeout_s=0.05,
                               max_ship_retries=8, faults=faults, device=dev,
                               **SERVE_SHAPE)
        _by_role(backend, role)
        eng = PlacementEngine(FixedPolicy(LAYER, placement=None), backend)
        reqs = make_requests(cfg.vocab_size, n_requests, seed=2,
                             max_new=(16, 33))
        t0 = time.perf_counter()
        eng.submit(reqs)
        eng.drain()
        torch.cuda.synchronize()
        m = eng.summary()
        m["wall_s"] = time.perf_counter() - t0
        if m["completed"] != n_requests or m.get("shed", 0) or \
                m.get("failed", 0):
            raise AssertionError(f"[chaos {name}] completed "
                                 f"{m['completed']}, shed {m.get('shed')}, "
                                 f"failed {m.get('failed')}")
        _check_unwound(backend, f"chaos {name}")
        runs[name] = (m, [r.output for r in reqs])
        del backend, eng
        _free()
    m, chaos_out = runs["chaos"]
    kinds = {f"fault_{k}": n for k, n in plan.counts().items()}
    got = {k: m.get(k) for k in kinds}
    if m.get("faults_injected") != len(plan) or got != kinds:
        raise AssertionError(f"[chaos] injected {m.get('faults_injected')} "
                             f"{got}, planned {kinds}")
    if not (m["retries"] > 0 and m["re_executions"] >= 1
            and m["recovered"] >= 1):
        raise AssertionError(f"[chaos] retries {m['retries']}, re_executions"
                             f" {m['re_executions']}, recovered "
                             f"{m['recovered']}")
    equal = [bool(np.array_equal(a, b))
             for a, b in zip(runs["clean"][1], chaos_out)]

    # colocated, load shedding on: half the SLAs expire on arrival
    backend = TorchBackend(cfg, max_batch=4, arms=(LAYER,), load_shed=True,
                           device=dev, **SERVE_SHAPE)
    eng = PlacementEngine(FixedPolicy(LAYER, placement=None), backend)
    reqs = make_requests(cfg.vocab_size, n_requests, seed=3,
                         max_new=(8, 17))
    for r in reqs:
        r.arrival_s, r.sla_s = 0.0, 1e-6 if r.rid % 2 else 60.0
    eng.submit(reqs)
    eng.drain()
    sm = eng.summary()
    shed = sm.get("shed", 0)
    if not shed > 0 or sm["completed"] + shed + sm.get("failed", 0) != \
            n_requests or any(r.output is not None for r in reqs
                              if r.rid % 2):
        raise AssertionError(f"[load_shed] completed {sm['completed']}, "
                             f"shed {shed}, failed {sm.get('failed')}")
    del backend, eng
    _free()
    launches = {k: fn.launches for k, fn in counters.items()}
    out = dict(requests=n_requests,
               faults_injected=m["faults_injected"], by_kind=got,
               retries=m["retries"], re_executions=m["re_executions"],
               recovered=m["recovered"],
               ship_requeues=m.get("ship_requeues"),
               ship_stale_marks=m.get("ship_stale_marks"),
               recovery_latency_p50=m.get("recovery_latency_p50"),
               recovery_latency_p99=m.get("recovery_latency_p99"),
               streams_equal_clean=sum(equal),
               streams_equal_share=sum(equal) / len(equal),
               wall_s_clean=runs["clean"][0]["wall_s"],
               wall_s_chaos=m["wall_s"],
               load_shed=dict(requests=n_requests,
                              completed=sm["completed"], shed=shed,
                              failed=sm.get("failed", 0)),
               launches=launches,
               launches_by_role=_with_colocated(role, launches))
    log(f"[chaos {cfg.name}] {json.dumps(out)}")
    return out


# -------------------------------------------------------------------- fleet
FLEET_REPLICAS = 4
FLEET_FAMILIES = 8
FLEET_HEAD = 256                   # tokens: 16 blocks of 16
#: half of full capacity (1 + 8 lanes x 64 blocks), as the benchmarks size
#: a replica's pool: one replica caches only a few families' heads beside
#: its working set
FLEET_BLOCKS = 1 + 4 * 64


def fleet_requests(vocab: int, *, n: int, seed: int, rid0: int):
    """``n`` requests over ``FLEET_FAMILIES`` families: one family's
    ``FLEET_HEAD``-token head (the same heads on every call) plus a fresh
    16-128-token tail, 16-32 new tokens."""
    from repro_torch.engine import Request
    heads = np.random.default_rng(100).integers(
        0, vocab, (FLEET_FAMILIES, FLEET_HEAD)).astype(np.int32)
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        fam = int(rng.integers(FLEET_FAMILIES))
        tail = rng.integers(0, vocab, int(rng.integers(16, 129)))
        reqs.append(Request(
            rid=rid0 + i, app_id=int(rng.integers(0, 3)), sla_s=30.0,
            tokens=np.concatenate([heads[fam], tail]).astype(np.int32),
            max_new=int(rng.integers(16, 33))))
    return reqs


def _board_mirrors_indexes(fleet) -> bool:
    """The sync invariant: the board holds exactly the union of every
    replica's index chains (with multiplicity)."""
    for i, rep in enumerate(fleet.replicas):
        want = sorted(s.index._chain_hash((parent, chunk))
                      for s in rep._all_scheds()
                      for parent, kids in s.index._children.items()
                      for chunk in kids)
        got = sorted(h for h, owners in fleet.board._owners.items()
                     for _ in range(owners.get(i, 0)))
        if got != want:
            return False
    return True


def _fleet_counts(fleet):
    """Cumulative fleet counters a pass is measured by."""
    m = fleet.extra_metrics()
    scheds = [s for rep in fleet.replicas for s in rep._all_scheds()]
    return dict(
        hit=m.get("prefix_hit_tokens", 0), query=m.get("prefix_query_tokens",
                                                        0),
        routed=fleet.routed_per_replica.copy(), place_s=fleet.place_time_s,
        prefill=sum(_bucket_steps(s, "prefill") for s in scheds),
        decode=sum(_bucket_steps(s, "decode") for s in scheds))


def _fleet_pass(fleet, policy, reqs, waves: int):
    """One pass of ``reqs`` in ``waves``: each wave submitted, then one
    fleet step; then steps until the fleet is empty.  The board is held to
    the replicas' indexes after every step (that check's time is left out
    of the pass's wall time)."""
    from repro_torch.engine import PlacementEngine
    from repro_torch.obs import Tracer, set_tracer
    eng = PlacementEngine(policy, fleet)
    per_wave = -(-len(reqs) // waves)
    before = _fleet_counts(fleet)
    steps, check_s = 0, 0.0
    tracer = Tracer()
    old = set_tracer(tracer)
    t0 = time.perf_counter()
    try:
        for w in range(waves + 2000):
            if w < waves:
                eng.submit(reqs[w * per_wave:(w + 1) * per_wave])
            elif not fleet.pending():
                break
            eng.step()
            steps += 1
            c0 = time.perf_counter()
            if not _board_mirrors_indexes(fleet):
                raise AssertionError(f"[fleet] step {steps}: the board "
                                     "does not mirror the replicas' indexes")
            check_s += time.perf_counter() - c0
        torch.cuda.synchronize()
    finally:
        set_tracer(old)
    wall = time.perf_counter() - t0 - check_s
    after = _fleet_counts(fleet)
    if fleet.pending():
        raise AssertionError(f"[fleet] {fleet.pending()} requests still in "
                             "flight")
    m = eng.summary()
    for r in reqs:
        if r.output is None or r.output.shape != (r.max_new,):
            raise AssertionError(f"[fleet] request {r.rid}: output "
                                 f"{None if r.output is None else r.output.shape}"
                                 f", wanted {r.max_new} tokens")
    if m["completed"] != len(reqs):
        raise AssertionError(f"[fleet] completed {m['completed']} of "
                             f"{len(reqs)}")
    dec = tracer.events("decode_scan") + tracer.events("decode_read")
    decode_steps = after["decode"] - before["decode"]
    query = after["query"] - before["query"]
    tokens = int(sum(r.max_new for r in reqs))
    routed = after["routed"] - before["routed"]
    return dict(
        requests=len(reqs), tokens=tokens, wall_s=wall,
        tokens_per_s=tokens / wall, fleet_steps=steps,
        board_check_s=check_s,
        prefill_chunks=after["prefill"] - before["prefill"],
        decode_steps=decode_steps,
        decode_ms_per_step=1e3 * sum(e[4] for e in dec) / 1e6
        / max(decode_steps, 1),
        prefix_hit_rate=(after["hit"] - before["hit"]) / max(query, 1),
        routed_per_replica=[int(n) for n in routed],
        place_ms_per_request=1e3 * (after["place_s"] - before["place_s"])
        / max(int(routed.sum()), 1),
        response_p50=m.get("response_p50"),
        response_p99=m.get("response_p99"))


def _fleet_run(dev, cfg, name: str, n_requests: int, waves: int, steps):
    """One fleet under one placement: build, warm pass, measured pass,
    then the unwind and shared-cache checks.  Adds the replicas' prefill
    and decode steps to ``steps``; the fleet is freed on return."""
    from repro_torch.engine import (LAYER, FixedPolicy, FleetBackend,
                                    PrefixAwareRouter)
    from repro_torch.sched.baselines import RandomPlacement
    tag = f"fleet {name}"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fleet = FleetBackend(cfg, n_replicas=FLEET_REPLICAS, arms=(LAYER,),
                         max_batch=8, num_blocks=FLEET_BLOCKS,
                         prefix_sharing=True, device=dev, **SERVE_SHAPE)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    placement = PrefixAwareRouter(fleet.board) if name == "routed" \
        else RandomPlacement(3)
    policy = FixedPolicy(LAYER, placement=placement)
    passes = {}
    for i, label in enumerate(("warm", "measured")):
        reqs = fleet_requests(cfg.vocab_size, n=n_requests, seed=20 + i,
                              rid0=i * n_requests)
        passes[label] = _fleet_pass(fleet, policy, reqs, waves)
    for rep in fleet.replicas:
        _check_unwound(rep, tag)
    # the shared built-call cache: each bucket built (a miss) on one
    # replica only, and served from the cache everywhere else
    scheds = [s for rep in fleet.replicas for s in rep._all_scheds()]
    shared = fleet.jit_cache[LAYER]
    if any(rep.models[LAYER] is not shared["model"]
           for rep in fleet.replicas):
        raise AssertionError(f"[{tag}] replicas hold their own models")
    builds = {}
    for kind in ("prefill", "decode", "cow"):
        built = sum(1 for k in shared
                    if isinstance(k, tuple) and k[0] == kind)
        missed = sum(s.compile_stats.get(f"{kind}_misses", 0)
                     for s in scheds)
        if missed != built:
            raise AssertionError(f"[{tag}] {kind}: {missed} misses over "
                                 f"the replicas, {built} buckets")
        builds[kind] = dict(buckets=built, hits=sum(
            s.compile_stats.get(f"{kind}_hits", 0) for s in scheds))
    for s in scheds:
        steps["prefill"] += _bucket_steps(s, "prefill")
        steps["decode"] += _bucket_steps(s, "decode")
    m = fleet.extra_metrics()
    out = dict(passes, setup_s=setup_s, builds=builds,
               replicas_serving=int((fleet.routed_per_replica > 0).sum()),
               sync_deltas=m["sync_deltas"],
               tracked_hashes=m["tracked_hashes"],
               route_expected_overlap=m.get("route_expected_overlap"),
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"[{tag} {cfg.name}] {json.dumps(out)}")
    return out


def fleet_phase(dev, cfg, *, n_requests: int = 24, waves: int = 4):
    """``FleetBackend`` of ``FLEET_REPLICAS`` full-width replicas on the
    one card, LAYER arm, half-capacity pools: a warm and a measured pass of
    the shared-prefix trace under ``PrefixAwareRouter(fleet.board)``, then
    the same on a fresh fleet under ``RandomPlacement``.  Gates: every
    request completes; the board mirrors the indexes after every step; one
    paged launch a layer per prefill chunk and per decode step summed over
    the replicas, each on its path; every bucket built once fleet-wide;
    the routed measured pass's hit rate above the random one's; every
    pool unwinds."""
    from repro_torch.kernels import _paged_launch as PL
    t0 = time.perf_counter()
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    paths0 = dict(PL.PATH_LAUNCHES)
    steps = {"prefill": 0, "decode": 0}
    out = {}
    for name in ("routed", "random"):
        out[name] = _fleet_run(dev, cfg, name, n_requests, waves, steps)
        _free()
    launches = {k: fn.launches for k, fn in counters.items()}
    paths = {k: PL.PATH_LAUNCHES[k] - paths0[k] for k in paths0}
    layers = cfg.n_layers
    want = {"paged_prefill_attention": layers * steps["prefill"],
            "paged_decode_attention": layers * steps["decode"],
            "quant_matmul": 0}
    want_paths = {"prefill_mma": want["paged_prefill_attention"],
                  "prefill_simt": 0,
                  "decode_split": want["paged_decode_attention"]}
    if launches != want or paths != want_paths or not (
            steps["prefill"] and steps["decode"]):
        raise AssertionError(f"[fleet] paged launches {launches} by path "
                             f"{paths}, the replicas' steps imply {want}")
    routed = out["routed"]["measured"]["prefix_hit_rate"]
    blind = out["random"]["measured"]["prefix_hit_rate"]
    if not routed > blind:
        raise AssertionError(f"[fleet] routed hit rate {routed} is not "
                             f"above random's {blind}")
    if out["routed"]["replicas_serving"] < 2:
        raise AssertionError("[fleet] the router used one replica")
    out.update(launches=launches, paths=paths, replicas=FLEET_REPLICAS,
               num_blocks=FLEET_BLOCKS, phase_s=time.perf_counter() - t0)
    log(f"[fleet {cfg.name}] launches {json.dumps(launches)}, phase "
        f"{out['phase_s']:.1f} s")
    return out


# -------------------------------------------------------------------- model
def _f32_copy(dev, model, superblocks):
    """An f32 copy of ``model`` (its first ``superblocks`` superblocks, or
    all of them)."""
    from repro_torch.models.model import build_model
    cfg = model.cfg.replace(dtype="float32")
    if superblocks:
        cfg = cfg.replace(n_layers=len(cfg.pattern) * superblocks)
    f32 = build_model(cfg, device=dev)
    src = dict(model.named_parameters())
    sb_dim = len(model._lead)              # [(Bb,) N_sb, ...]
    with torch.no_grad():
        for name, p32 in f32.named_parameters():
            p = src[name]
            if name.startswith("blocks."):
                p = p.narrow(sb_dim, 0, p32.shape[sb_dim])
            p32.copy_(p.float())
    return f32


def model_phase(dev, backend, *, superblocks=None):
    """bf16 logits of the served models are finite; f32 copies give the
    same logits through the kernels and through the plain versions.  A
    quantized arm's f32 copy is quantized the same way: its codes equal the
    served model's, since bf16 values are exact in f32."""
    from repro_torch.decode import paged_model as PM
    from repro_torch.kernels.paged_decode_attention import \
        paged_decode_attention_plain
    from repro_torch.kernels.paged_prefill_attention import \
        paged_prefill_attention_plain
    from repro_torch.kernels.quant_matmul import quant_matmul_plain
    rng = np.random.default_rng(3)
    bits = int(backend.weight_quant[3:]) if backend.weight_quant else None
    out = {}
    for arm, model in sorted(backend.models.items()):
        vocab = backend.cfg.vocab_size
        toks = torch.from_numpy(rng.integers(0, vocab, (2, 128))
                                .astype(np.int32)).to(dev)
        tables = torch.arange(1, 17, dtype=torch.int32,
                              device=dev).reshape(2, 8)
        starts = torch.zeros(2, dtype=torch.int32, device=dev)
        n_tok = torch.tensor([100, 60], dtype=torch.int32, device=dev)

        def run(m, params):
            pool = m.init_pool(17, 16)
            lc, _ = PM.paged_chunk_logits(m, pool, toks, starts, n_tok,
                                          tables, params)
            tok = lc.argmax(-1).int()[:, None]
            ld, _ = PM.paged_decode_logits(m, pool, tok, tables, n_tok,
                                           torch.ones(2, dtype=torch.bool,
                                                      device=dev), params)
            return torch.cat([lc, ld])

        served_params = backend._paged[arm].params
        served = run(model, served_params)
        if served.shape != (4, vocab) or not bool(served.isfinite().all()):
            raise AssertionError(f"arm {arm}: bf16 logits not finite")
        f32 = _f32_copy(dev, model, superblocks)
        params = f32.grouped_views()
        if bits:
            params, _ = PM.quantize_attn_params(params, bits)
            for name in PM.ATTN_PROJ:
                a = params[2][0]["pos0"]["mix"][name]["q"]
                b = served_params[2][0]["pos0"]["mix"][name]["q"]
                if not torch.equal(a, b):
                    raise AssertionError(f"arm {arm}: f32 copy's {name} "
                                         "codes differ from the served ones")
        kern = run(f32, params)
        saved = (PM.paged_decode_attention, PM.paged_prefill_attention,
                 PM.quant_matmul)
        PM.paged_decode_attention = paged_decode_attention_plain
        PM.paged_prefill_attention = paged_prefill_attention_plain
        PM.quant_matmul = quant_matmul_plain
        try:
            ref = run(f32, params)
        finally:
            (PM.paged_decode_attention, PM.paged_prefill_attention,
             PM.quant_matmul) = saved
        rel = float((kern - ref).abs().max() / ref.abs().max())
        if not rel <= 1e-3:
            raise AssertionError(f"arm {arm}: f32 kernel vs plain logits "
                                 f"differ by {rel} of the largest")
        out[arm] = dict(rel_err_f32=rel, superblocks=f32.cfg.n_superblocks,
                        argmax_equal=bool(
                            (kern.argmax(-1) == ref.argmax(-1)).all()))
        log(f"[model] {backend.cfg.name} arm {arm} weights="
            f"{backend.weight_quant or 'bf16'}: bf16 logits finite; f32 "
            f"({f32.cfg.n_superblocks} superblocks) kernel vs plain max diff "
            f"{rel:.3g} of max |logit|")
        del f32, params
        torch.cuda.empty_cache()
    return out


def serve_and_check(dev, cfg, *, model_check: bool = False,
                    superblocks=None, **kw):
    """A serve phase, then (``model_check``) the model phase on its
    backend; the backend is freed before returning, so the next one has
    the card's memory."""
    backend, serve = serve_phase(dev, cfg, **kw)
    model = model_phase(dev, backend, superblocks=superblocks) \
        if model_check else None
    del backend
    _free()
    return serve, model


# ------------------------------------------------------------ gang path
GANG_SHAPE = dict(cache_len=1024, max_batch=8)
#: mLSTM layers run three ``block_diag_matmul`` launches a step (q, k, v)
BDM_PER_MLSTM = 3


def gang_requests(vocab: int, n: int, seed: int, plen=(16, 49),
                  max_new=(16, 33)):
    """``n`` requests over 3 apps with random prompts of ``plen`` tokens
    and ``max_new`` new tokens, SLAs from tight to loose."""
    from repro_torch.engine import Request
    rng = np.random.default_rng(seed)
    return [Request(rid=rid, app_id=int(rng.integers(0, 3)),
                    tokens=rng.integers(0, vocab, int(rng.integers(*plen)))
                    .astype(np.int32),
                    sla_s=float(rng.choice([0.5, 2.0, 8.0, 30.0])),
                    max_new=int(rng.integers(*max_new)))
            for rid in range(n)]


def _gang_counters():
    from repro_torch.kernels.block_diag_matmul import block_diag_matmul
    from repro_torch.kernels.decode_attention import decode_attention
    return {"decode_attention": decode_attention,
            "block_diag_matmul": block_diag_matmul}


def gang_phase(dev, cfg, *, tag: str, decode: str, bandit: str, reqs,
               waves: int):
    """Serve ``reqs`` in ``waves`` through ``MABPolicy(bandit)`` (every arm
    served first) and ``TorchBackend(decode=...)`` on both arms, all on the
    gang path.  The launch counters are zeroed just before and read just
    after: ``decode_attention`` must read one launch per attention layer
    per decode step (the semantic arm's branches share it) and
    ``block_diag_matmul`` three per mLSTM layer per step, every one on the
    decode-sized tile of the model's dtype (bf16: ``mma_skinny``).  Returns
    (backend, report)."""
    from repro_torch.engine import (LAYER, SEMANTIC, MABPolicy,
                                    PlacementEngine, TorchBackend)
    from repro_torch.kernels import _gemm_launch as GL
    from repro_torch.obs import Tracer, set_tracer
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    backend = TorchBackend(cfg, decode=decode, device=dev, **GANG_SHAPE)
    eng = PlacementEngine(_every_arm_first(MABPolicy(bandit=bandit),
                                           (LAYER, SEMANTIC)), backend)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    if backend._paged or backend._disagg:
        raise AssertionError(f"[{tag}] an arm took the paged path")
    counters = _gang_counters()
    for fn in counters.values():
        fn.launches = 0
    paths0 = dict(GL.PATH_LAUNCHES)
    tracer = Tracer()
    old = set_tracer(tracer)
    per_wave = -(-len(reqs) // waves)
    t0 = time.perf_counter()
    try:
        for w in range(waves):
            eng.submit(reqs[w * per_wave:(w + 1) * per_wave])
            eng.drain()
        torch.cuda.synchronize()
    finally:
        set_tracer(old)
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    paths = {k: GL.PATH_LAUNCHES[k] - paths0[k] for k in paths0}
    summary = eng.summary()
    for r in reqs:
        if r.output is None or r.output.shape != (r.max_new,):
            raise AssertionError(f"[{tag}] request {r.rid}: output "
                                 f"{None if r.output is None else r.output.shape}")
    if summary["completed"] != len(reqs):
        raise AssertionError(f"[{tag}] completed {summary['completed']}")
    if set(summary["per_mode"]) != {"layer", "semantic"}:
        raise AssertionError(f"[{tag}] arms served: {summary['per_mode']}")
    steps = backend.decode_steps
    mixers = [m for m, _ in cfg.pattern] * cfg.n_superblocks
    n_attn = sum(m in ("attn", "attn_local") for m in mixers)
    n_mlstm = sum(m == "mlstm" for m in mixers)
    want = {"decode_attention": n_attn * steps,
            "block_diag_matmul": BDM_PER_MLSTM * n_mlstm * steps}
    if launches != want or steps == 0:
        raise AssertionError(f"[{tag}] launches {launches}, {steps} decode "
                             f"steps imply {want}")
    want_paths = dict.fromkeys(paths, 0)
    want_paths["mma_skinny" if cfg.dtype == "bfloat16" else "skinny"] = \
        want["block_diag_matmul"]
    if paths != want_paths:
        raise AssertionError(f"[{tag}] block_diag_matmul launches by path "
                             f"{paths}, expected {want_paths}")
    dec = tracer.events("legacy_decode")
    dec_steps = sum(e[5]["steps"] for e in dec)
    decode_s = sum(e[4] for e in dec) / 1e6
    prefill_s = sum(e[4] for e in tracer.events("legacy_prefill")) / 1e6
    tokens = int(sum(r.max_new for r in reqs))
    m = backend.extra_metrics()
    out = dict(model=cfg.name, decode=decode, bandit=bandit,
               requests=len(reqs), tokens=tokens, wall_s=wall,
               setup_s=setup_s, tokens_per_s=tokens / wall,
               batches=m["batches"], decode_steps=steps,
               prefill_calls=m["prefill_calls"],
               decode_ms_per_step=1e3 * decode_s / max(dec_steps, 1),
               prefill_s=prefill_s, prefill_share=prefill_s / wall,
               batch_occupancy=m.get("batch_occupancy"),
               bucket_misses=m.get("prefill_bucket_misses"),
               per_mode=summary["per_mode"], launches=launches,
               bdm_paths=paths,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               response_p50=summary.get("response_p50"))
    log(f"[{tag}] {json.dumps(out)}")
    return backend, out


def _plain_gang_kernels():
    """Context: the gang path's kernels swapped for their plain versions."""
    import contextlib
    from unittest import mock
    from repro_torch.kernels.block_diag_matmul import block_diag_matmul_plain
    from repro_torch.kernels.decode_attention import decode_attention_plain
    from repro_torch.models import layers as ML
    from repro_torch.models import xlstm as MX
    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(ML, "decode_attention",
                                          decode_attention_plain))
    stack.enter_context(mock.patch.object(MX, "block_diag_matmul",
                                          block_diag_matmul_plain))
    return stack


#: one f32 ulp: the model check's nudge scales every weight by 1 + ULP
ULP = 2.0 ** -23
#: the model check's gate on f32 kernel-vs-plain logits, as a share of the
#: largest |logit|: GANG_NOISE times the plain run's own response to the
#: one-ulp nudge, or GANG_REL where that is larger
GANG_REL, GANG_NOISE = 1e-5, 4.0


def gang_model_check(dev, backend, *, steps: int = 8):
    """bf16 logits of the served models are finite; an f32 copy of each
    arm gives the same logits through the gang path's kernels as through
    their plain versions, within ``GANG_NOISE`` times ``nudge_rel`` or
    ``GANG_REL`` of the largest |logit|, whichever is larger, at the
    phase's own shape: ``backend.max_batch`` lanes (the semantic arm's branches fold
    into the kernels' batch) on a fresh ``backend.cache_len`` dense cache,
    a prompt of ``DECODE_PIECE + 8`` tokens on models with attention
    layers (so ``decode_attention`` merges two pieces) and 24 on the
    others (token by token where the model has no single-step prefill),
    then ``steps`` decode steps, every run fed the same random tokens
    (teacher-forced: a greedy feed would let one near-tied argmax send
    the two runs down different streams).  ``nudge_rel``: how far the
    plain run itself moves when every f32 weight is scaled by 1 + one
    ulp."""
    rng = np.random.default_rng(3)
    cfg = backend.cfg
    b, cache_len = backend.max_batch, backend.cache_len
    has_attn = any(m in ("attn", "attn_local") for m, _ in cfg.pattern)
    plen = DECODE_PIECE + 8 if has_attn else 24
    if plen + steps > cache_len:
        raise AssertionError(f"cache {cache_len} < {plen + steps}")
    out = {}
    for arm, model in sorted(backend.models.items()):
        toks = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (b, plen + steps)).astype(np.int32)).to(dev)

        def run(m):
            cache = m.init_cache(b, cache_len)
            logits = []
            if m.supports_single_step_prefill:
                lg, cache = m.prefill_cache(None, cache, toks[:, :plen])
            else:
                for i in range(plen):
                    lg, cache = m.decode_step(None, cache, toks[:, i:i + 1],
                                              i)
                    lg = lg[:, -1]
            logits.append(lg)
            for i in range(plen, plen + steps):
                lg, cache = m.decode_step(None, cache, toks[:, i:i + 1], i)
                logits.append(lg[:, -1])
            return torch.stack(logits, 1)

        served = run(model)
        if not bool(served.isfinite().all()):
            raise AssertionError(f"arm {arm}: bf16 logits not finite")
        f32 = _f32_copy(dev, model, None)
        kern = run(f32)
        with _plain_gang_kernels():
            ref = run(f32)
            with torch.no_grad():
                for p in f32.parameters():
                    p.mul_(1 + ULP)
            nudged = run(f32)
        top = ref.abs().max()
        by_step = ((kern - ref).abs().amax(dim=(0, 2)) / top).tolist()
        rel = max(by_step)
        nudge_rel = float((nudged - ref).abs().max() / top)
        gate = max(GANG_REL, GANG_NOISE * nudge_rel)
        out[arm] = dict(rel_err_f32=rel, rel_by_step=by_step,
                        nudge_rel=nudge_rel, gate=gate, lanes=b, prompt=plen,
                        cache_len=cache_len,
                        superblocks=f32.cfg.n_superblocks,
                        argmax_equal=bool((kern.argmax(-1)
                                           == ref.argmax(-1)).all()))
        log(f"[gang model] {cfg.name} arm {arm}: bf16 logits finite; f32 "
            f"({f32.cfg.n_superblocks} superblocks, {b} lanes, prompt "
            f"{plen}, cache {cache_len}) kernel vs plain max diff {rel:.3g}"
            f" of max |logit|; plain vs plain on weights one ulp up "
            f"{nudge_rel:.3g}; gate {gate:.3g}")
        if not rel <= gate:
            raise AssertionError(f"arm {arm}: f32 kernel vs plain logits "
                                 f"differ by {rel} of the largest, over "
                                 f"the gate {gate}")
        del f32
        torch.cuda.empty_cache()
    return out


def gang_and_check(dev, cfg, **kw):
    """A gang phase, then its model check; the backend is freed after.
    ``phase_s``: the wall time of both, setup included."""
    t0 = time.perf_counter()
    backend, serve = gang_phase(dev, cfg, **kw)
    model = gang_model_check(dev, backend)
    del backend
    _free()
    serve["phase_s"] = time.perf_counter() - t0
    return serve, model


def window_kernel_check(dev, cfg):
    """``decode_attention`` on a wrapped ring at the config's full local
    window (L = W, every slot valid: ``length = W``), bf16 and f32, the
    GQA ratio, hd and softcap of the config, held to its plain version
    within tol times each output row's max |plain|."""
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_plain)
    gen = torch.Generator(device=dev).manual_seed(29)
    w = cfg.sliding_window
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        q = torch.randn(8, cfg.n_heads, cfg.hd, generator=gen,
                        device=dev).to(dt)
        k = torch.randn(8, w, cfg.n_kv_heads, cfg.hd, generator=gen,
                        device=dev).to(dt)
        v = torch.randn(8, w, cfg.n_kv_heads, cfg.hd, generator=gen,
                        device=dev).to(dt)
        length = torch.full((8,), w, dtype=torch.int32, device=dev)
        got = decode_attention(q, k, v, length, softcap=cfg.attn_softcap)
        want = decode_attention_plain(q, k, v, length,
                                      softcap=cfg.attn_softcap)
        diff = (got.float() - want.float()).abs()
        limit = ops_limit(want, dt, rows=True)
        err = float(diff.max())
        if not bool((diff <= limit).all()):
            raise AssertionError(f"[window] decode_attention at L = W = {w}"
                                 f" ({dt}): max |kernel - plain| {err} "
                                 "beyond tol x the row's max |plain|")
        out[str(dt)[6:]] = dict(max_abs_err=err, tol=QTOL[dt],
                                err_over_limit=float(
                                    (diff / limit.clamp(min=1e-30)).max()))
        log(f"[window] decode_attention ring L = W = {w}, softcap "
            f"{cfg.attn_softcap}, {str(dt)[6:]}: max_abs_err={err:.3g}")
    return out


ZOO_STEPS = 64
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _decode_vs_forward(model, batch, *, enc: bool):
    """Teacher-forced decode of ``batch["tokens"]`` [B, ZOO_STEPS] on a
    dense cache against the model's full-sequence forward: the largest
    |difference| over the largest |forward logit|."""
    toks = batch["tokens"]
    full, _ = model.forward(model.param_tree(), batch)
    cache = model.init_cache(toks.shape[0], toks.shape[1])
    outs = []
    for i in range(toks.shape[1]):
        lg, cache = model.decode_step(None, cache, toks[:, i:i + 1], i,
                                      batch=batch if enc else None)
        outs.append(lg[:, 0])
    dec = torch.stack(outs, 1)
    return full, dec, float((dec.float() - full.float()).abs().max()
                            / full.float().abs().max())


def _zoo_model(dev, name, *, superblocks, dtype):
    from repro_torch.configs.base import get_config
    from repro_torch.models.model import build_model
    cfg = get_config(name).replace(dtype=dtype)
    if superblocks:
        cfg = cfg.replace(n_layers=len(cfg.pattern) * superblocks)
    with torch.no_grad():
        m = build_model(cfg, device=dev).reset_parameters(
            torch.Generator(device=dev).manual_seed(5))
    return cfg, m


def zoo_phase(dev):
    """whisper-base (full, 1500 stub frames), internvl2-26b (full width, 2
    superblocks, 256 stub patches), jamba-1.5-large's Mamba mixer (d 8192)
    and xlstm-125m's mLSTM and sLSTM mixers: in f32, ZOO_STEPS
    teacher-forced decode steps equal the full-sequence forward within
    1e-3 of its largest |value|; in bf16 the same outputs are finite.
    internvl's decode takes no image prefix (the reference's does not
    either), so its decode is held to the text-only forward and its
    256-patch forward is checked for shape and finiteness."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import ssm as MS
    from repro_torch.models import xlstm as MX
    from repro_torch.models.model import ParamTree, init_leaf
    out = {}
    gen = torch.Generator(device=dev).manual_seed(31)
    for name, sbs in (("whisper-base", None), ("internvl2-26b", 2)):
        for dtype in ("float32", "bfloat16"):
            t0 = time.perf_counter()
            cfg, m = _zoo_model(dev, name, superblocks=sbs, dtype=dtype)
            fe = cfg.frontend
            toks = torch.randint(0, cfg.vocab_size, (2, ZOO_STEPS),
                                 generator=gen, device=dev)
            emb = torch.randn(2, fe.n_tokens, fe.d_frontend, generator=gen,
                              device=dev).to(_DTYPES[dtype])
            with torch.no_grad():
                if cfg.is_encdec:
                    batch = {"tokens": toks, "audio_embeds": emb}
                else:
                    vis, _ = m.forward(m.param_tree(), {
                        "tokens": toks, "image_embeds": emb})
                    if vis.shape != (2, ZOO_STEPS, cfg.vocab_size) or not \
                            bool(vis.isfinite().all()):
                        raise AssertionError(f"[zoo] {name} {dtype}: the "
                                             "256-patch forward")
                    batch = {"tokens": toks,
                             "image_embeds": emb[:, :0]}
                full, dec, rel = _decode_vs_forward(m, batch,
                                                    enc=cfg.is_encdec)
            finite = bool(full.isfinite().all() and dec.isfinite().all())
            if not finite or (dtype == "float32" and not rel <= 1e-3):
                raise AssertionError(f"[zoo] {name} {dtype}: decode vs "
                                     f"forward {rel}, finite {finite}")
            out[f"{name}/{dtype}"] = dict(decode_vs_forward=rel,
                                          finite=finite,
                                          s=time.perf_counter() - t0)
            log(f"[zoo] {name} {dtype}: decode vs forward {rel:.3g} of max "
                f"|logit| over {ZOO_STEPS} steps, finite")
            del m, full, dec
            _free()
    mixers = (("mamba", "jamba-1.5-large-398b", MS.mamba_shapes,
               MS.mamba_apply, MS.mamba_init_state),
              ("mlstm", "xlstm-125m", MX.mlstm_shapes, MX.mlstm_apply,
               MX.mlstm_init_state),
              ("slstm", "xlstm-125m", MX.slstm_shapes, MX.slstm_apply,
               MX.slstm_init_state))
    for kind, name, shapes, apply, init_state in mixers:
        for dtype in ("float32", "bfloat16"):
            t0 = time.perf_counter()
            cfg = get_config(name).replace(dtype=dtype)
            dt = _DTYPES[dtype]
            params = ParamTree(shapes(cfg), (1,), dt, dev)
            for leaf, p in params.named_parameters():
                init_leaf(leaf, p, gen)
            x = torch.randn(1, 2, ZOO_STEPS, cfg.d_model, generator=gen,
                            device=dev).to(dt)
            with torch.no_grad():
                full, _ = apply(params, x, cfg)
                state = init_state(cfg, 2, dt, (1,), dev) if kind == "mamba" \
                    else init_state(cfg, 2, (1,), dev)
                outs = []
                for i in range(ZOO_STEPS):
                    y, state = apply(params, x[:, :, i:i + 1], cfg,
                                     state=state)
                    outs.append(y)
                dec = torch.cat(outs, 2)
            rel = float((dec.float() - full.float()).abs().max()
                        / full.float().abs().max())
            finite = bool(full.isfinite().all() and dec.isfinite().all())
            if not finite or (dtype == "float32" and not rel <= 1e-3):
                raise AssertionError(f"[zoo] {kind} mixer of {name} {dtype}:"
                                     f" decode vs forward {rel}, finite "
                                     f"{finite}")
            out[f"{kind}/{dtype}"] = dict(decode_vs_forward=rel,
                                          finite=finite,
                                          s=time.perf_counter() - t0)
            log(f"[zoo] {kind} mixer of {name} (d {cfg.d_model}) {dtype}: "
                f"decode vs forward {rel:.3g} of max |y| over {ZOO_STEPS} "
                "steps, finite")
            del params, x, full, dec, state
            _free()
    out["mamba_scan"] = mamba_scan_timing(dev, gen)
    return out


#: the Mamba mixer's timed full-sequence forward: four 512-step chunks
MAMBA_SCAN_SEQ = 2048


def mamba_scan_timing(dev, gen):
    """jamba-1.5-large's Mamba mixer (d 8192, d_inner 16384), its
    full-sequence forward at S ``MAMBA_SCAN_SEQ`` (B 1, f32 and bf16):
    CUDA-event ms a call (``time_ms``) with the log-depth scan, beside the
    same forward with each chunk walked a step at a time; in f32 the two
    agree within 1e-4 of the largest |y|, in bf16 both are finite."""
    from unittest import mock

    from repro_torch.configs.base import get_config
    from repro_torch.models import ssm as MS
    from repro_torch.models.model import ParamTree, init_leaf
    out = {}
    for dtype in ("float32", "bfloat16"):
        cfg = get_config("jamba-1.5-large-398b").replace(dtype=dtype)
        dt = _DTYPES[dtype]
        params = ParamTree(MS.mamba_shapes(cfg), (1,), dt, dev)
        for leaf, p in params.named_parameters():
            init_leaf(leaf, p, gen)
        x = torch.randn(1, 1, MAMBA_SCAN_SEQ, cfg.d_model, generator=gen,
                        device=dev).to(dt)
        fwd = lambda: MS.mamba_apply(params, x, cfg)[0]
        timed = dev.type == "cuda"        # not when rehearsed on the CPU
        with torch.no_grad():
            y = fwd()
            ms = time_ms(fwd, reps=3, rounds=3) if timed else None
            with mock.patch.object(MS, "_scan_chunk", MS._scan_chunk_steps):
                y_loop = fwd()
                loop_ms = time_ms(fwd, reps=1, rounds=3) if timed else None
        rel = float((y.float() - y_loop.float()).abs().max()
                    / y_loop.float().abs().max())
        finite = bool(y.isfinite().all() and y_loop.isfinite().all())
        if not finite or (dtype == "float32" and not rel <= 1e-4):
            raise AssertionError(f"[zoo] mamba scan {dtype}: against the "
                                 f"step loop {rel}, finite {finite}")
        out[dtype] = dict(seq=MAMBA_SCAN_SEQ,
                          chunks=MAMBA_SCAN_SEQ // MS.DEFAULT_SCAN_CHUNK,
                          ms=ms, loop_ms=loop_ms, rel_to_loop=rel)
        log(f"[zoo] mamba scan {dtype}: {json.dumps(out[dtype])}")
        del params, x, y, y_loop
        _free()
    return out


# -------------------------------------------------------------------- flash
# (label, N, Sq, Sk, H, K, hd, causal, window, softcap)
FLASH_CASES = (
    ("layer", 2, 2048, 2048, 32, 32, 64, True, 0, 0.0),
    ("semantic", 4, 2048, 2048, 16, 16, 64, True, 0, 0.0),
    ("gqa-hd128-window-softcap", 2, 2048, 2048, 32, 16, 128, True, 1024,
     50.0),
    ("sq1024-sk2048", 2, 1024, 2048, 32, 32, 64, True, 0, 0.0),
)


def flash_bound(q, k, *, causal, window):
    """(bound_ms, bound_by): q, k, v and out each moved once over the memory
    rate, against 4 hd flops (QK^T and PV) per unmasked (query, key) pair
    of this call over the peak for q's type (``kernels.cost.flash_cost``,
    which the dry run counts)."""
    from repro_torch.kernels.cost import flash_cost
    n, sq, h, hd = q.shape
    flops, nbytes = flash_cost(n, sq, k.shape[1], h, k.shape[2], hd,
                               q.element_size(), causal=causal,
                               window=window)
    return _bound(nbytes, flops, q.dtype)


# flash within ``flash_attention.FLASH_TOL`` times each output row's max
# |plain| (bf16 1e-2, not the paged checks' 2e-2, which rejects the fault
# below by as little as 1.9x at S 2048)
FLASH_DROP = 64          # keys of the fault's dropped tile
FLASH_LONG = 256         # rows at this position or later must reject it
FLASH_MIN_RATIO = 3.0    # ... by at least this multiple of their limit


def flash_fault(plain, q, k, v, *, causal, window, softcap):
    """The plain output with each row's first ``FLASH_DROP`` attended keys
    left out (keys 0.. of a row whose window does not bind, else the first
    keys of its window), and the query rows at position >= ``FLASH_LONG``,
    where the check must reject it."""
    sq, sk = q.shape[1], k.shape[1]
    qpos = torch.arange(sq, device=q.device) + sk - sq
    opts = dict(causal=causal, softcap=softcap)
    bad = plain(q, k[:, FLASH_DROP:], v[:, FLASH_DROP:], window=window,
                **opts)
    if window:
        slid = plain(q, k, v, window=window - FLASH_DROP, **opts)
        binds = (qpos - window + 1 > 0)[None, :, None, None]
        bad = torch.where(binds, slid, bad)
    return bad, qpos >= FLASH_LONG


def flash_phase(dev):
    import torch.nn.functional as F
    from repro_torch.kernels import _flash_launch as FL
    from repro_torch.kernels import flash_attention as FA
    gen = torch.Generator(device=dev).manual_seed(17)
    per = {}
    for label, n, sq, sk, h, kh, hd, causal, window, cap in FLASH_CASES:
        for dt, tol in FA.FLASH_TOL.items():
            q = torch.randn(n, sq, h, hd, generator=gen, device=dev).to(dt)
            k, v = (torch.randn(n, sk, kh, hd, generator=gen,
                                device=dev).to(dt) for _ in range(2))
            opts = dict(causal=causal, window=window, softcap=cap)
            paths = dict(FL.PATH_LAUNCHES)
            got = FA.flash_attention(q, k, v, **opts)
            want = FA.flash_attention_plain(q, k, v, **opts)
            torch.cuda.synchronize()
            name = f"flash_attention [{label}/{str(dt)[6:]}]"
            path = [p for p in paths if FL.PATH_LAUNCHES[p] != paths[p]]
            if path != [FL.path_for(dt)]:
                raise AssertionError(f"{name}: launched {path}, not "
                                     f"{FL.path_for(dt)}")
            limit = row_limit(want, tol)
            diff = (got.float() - want.float()).abs()
            err = float(diff.max())
            if got.shape != q.shape or not bool(got.isfinite().all()) or \
                    not bool((diff <= limit).all()):
                raise AssertionError(f"{name}: max |kernel - plain| {err} "
                                     f"beyond {tol} max|plain| of its row")
            # the same check on the plain output with each long row's first
            # tile dropped must fail in every such row, by FLASH_MIN_RATIO:
            # the least, over those rows, of the row's largest
            # |fault - plain| / limit
            bad, long = flash_fault(FA.flash_attention_plain, q, k, v,
                                    **opts)
            ratio = (bad.float() - want.float()).abs() / limit.clamp(
                min=1e-30)
            worst = float(ratio.amax(-1)[:, long].min())
            del bad, ratio
            if worst < FLASH_MIN_RATIO:
                raise AssertionError(f"{name}: the check rejects a row with "
                                     f"its first tile dropped by only "
                                     f"{worst:.3g}x its limit")
            library = None
            if not window and not cap and h == kh:
                qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
                kpos = torch.arange(sk, device=dev)
                mask = kpos[None, :] <= (torch.arange(sq, device=dev)
                                         + sk - sq)[:, None]
                library = (lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True)) if sq == sk else (
                    lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, attn_mask=mask))
            bnd, by = flash_bound(q, k, causal=causal, window=window)
            ms, per_call = device_profile(
                lambda: FA.flash_attention(q, k, v, **opts))
            if per_call != 1:
                raise AssertionError(f"{name}: {per_call} CUDA kernels per "
                                     "call, not 1")
            row = dict(max_abs_err=err, tol=tol, path=path[0],
                       err_over_limit=float((diff / limit.clamp(
                           min=1e-30)).max()),
                       fault_over_limit=worst, long_rows=int(long.sum()),
                       bound_ms=bnd, bound_by=by, ms=ms,
                       kernels_per_call=per_call,
                       call_ms=time_ms(lambda: FA.flash_attention(q, k, v,
                                                                  **opts)),
                       plain_ms=device_ms(lambda: FA.flash_attention_plain(
                           q, k, v, **opts), reps=3),
                       library_ms=device_ms(library) if library else None)
            per[f"{label}/{str(dt)[6:]}"] = row
            lib = "n/a" if library is None else f"{row['library_ms']:.4f} ms"
            log(f"[flash] {name} ({path[0]}): max_abs_err={err:.3g}, "
                f"{row['err_over_limit']:.3g} of {tol} max|plain| per row; "
                f"a row with its first {FLASH_DROP} keys dropped reads >= "
                f"{worst:.3g} of it ({row['long_rows']} rows); kernel "
                f"{row['ms']:.4f} ms (call {row['call_ms']:.4f}), plain "
                f"{row['plain_ms']:.4f} ms, sdpa {lib}, bound {bnd:.4f} ms "
                f"({by})")
            del q, k, v, got, want, diff, limit
    return dict(replaces="src/repro/kernels/flash_attention.py:25",
                per_dtype=per)


# ---------------------------------------------------------------------- ops
OPS_KERNELS = ("block_diag_matmul", "moe_gmm", "ssm_scan",
               "decode_attention")
OPS_REPLACES = {
    "block_diag_matmul": "src/repro/kernels/block_diag_matmul.py:21",
    "moe_gmm": "src/repro/kernels/moe_gmm.py:19",
    "ssm_scan": "src/repro/kernels/ssm_scan.py:22",
    "decode_attention": "src/repro/kernels/decode_attention.py:23"}
DECODE_B, DECODE_L = 8, 4096
DECODE_LENGTHS = (4096, 1, 0, 2049, 3000, 517, 4095, 1234)
DECODE_PIECE = 256                  # slots per CTA (csrc/decode_attention.cu)


def ops_limit(want, dt, rows: bool = False):
    """The largest |kernel - plain| each element may show: tol (1 +
    |plain|), or with ``rows`` tol times the largest |plain| of the
    element's last-dim row.  Decode needs the second: its outputs are
    softmax averages over up to L slots, |plain| ~ (e / L)^0.5 ~ 0.03 at
    L 4096, so tol (1 + |plain|) would pass a kernel that drops a piece."""
    mag = want.float().abs()
    if rows:
        return QTOL[dt] * mag.amax(-1, keepdim=True)
    return QTOL[dt] * (1 + mag)


def _op_wrappers():
    """Every wrapper the op layer reaches, by name."""
    from repro_torch.kernels.block_diag_matmul import block_diag_matmul
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.moe_gmm import moe_gmm
    from repro_torch.kernels.quant_matmul import quant_matmul
    from repro_torch.kernels.ssm_scan import ssm_scan
    return {"block_diag_matmul": block_diag_matmul, "moe_gmm": moe_gmm,
            "ssm_scan": ssm_scan, "decode_attention": decode_attention,
            "flash_attention": flash_attention, "quant_matmul": quant_matmul}


def ops_cases(dev):
    """The op layer's cases at full widths of the repo's configs, one at a
    time (inputs freed between them): dicts with the kernel's name, a
    label, the op's arguments, the plain version and oracle, the bound and
    the library yardstick (or None)."""
    import torch.nn.functional as F
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import block_diag_matmul as BDM
    from repro_torch.kernels import decode_attention as DEC
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import moe_gmm as GMM
    from repro_torch.kernels import quant_matmul as Q
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssm_scan as SCAN
    from repro_torch.kernels.cost import decode_cost, gemm_cost
    gen = torch.Generator(device=dev).manual_seed(23)
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev)

    def gemm(name, mod, label, g, m, k, n, dt):
        x = rnd(g, m, k).to(dt)
        w = (rnd(g, k, n) / math.sqrt(k)).to(dt)
        flops, nbytes = gemm_cost(g, m, k, n, x.element_size())
        return dict(kernel=name, label=f"{label}/{str(dt)[6:]}", dt=dt,
                    args=(x, w), kw={}, plain=getattr(mod, f"{name}_plain"),
                    oracle=getattr(ref, f"{name}_ref"),
                    bound=_bound(nbytes, flops, dt),
                    library=lambda: torch.bmm(x, w))

    sem = get_config("stablelm-1.6b").semantic(2)
    for t in (8, 2048, 200):
        for proj, k, n in (("up", sem.d_model, sem.d_ff),
                           ("down", sem.d_ff, sem.d_model)):
            for dt in (torch.float32, torch.bfloat16):
                yield gemm("block_diag_matmul", BDM, f"{proj}/T{t}", 2, t, k,
                           n, dt)
    # the gang path's caller: xlstm-125m's mLSTM q/k/v projection, one
    # block per head, T = the decode step's 8 lanes
    xl = get_config("xlstm-125m")
    hd = xl.ssm_expand * xl.d_model // xl.n_heads
    for dt in (torch.float32, torch.bfloat16):
        yield gemm("block_diag_matmul", BDM, "mlstm/T8", xl.n_heads, 8, hd,
                   hd, dt)
    moe_cfg = get_config("qwen2-moe-a2.7b")
    m = moe_cfg.moe
    seq = 2048
    cap = int(max(m.top_k, math.ceil(seq * m.top_k * m.capacity_factor
                                     / m.n_experts)))
    for proj, k, n in (("gate_up", moe_cfg.d_model, m.d_ff),
                       ("down", m.d_ff, moe_cfg.d_model)):
        for dt in (torch.float32, torch.bfloat16):
            yield gemm("moe_gmm", GMM, f"{proj}/C{cap}", m.n_experts, cap, k,
                       n, dt)

    jamba = get_config("jamba-1.5-large-398b")
    shape = (1, 2048, jamba.ssm_expand * jamba.d_model, jamba.ssm_d_state)
    a = 0.7 + 0.299 * torch.rand(shape, generator=gen, device=dev)
    b = rnd(*shape)
    yield dict(kernel="ssm_scan", label="jamba/float32", dt=torch.float32,
               args=(a, b), kw={}, plain=SCAN.ssm_scan_plain,
               oracle=ref.ssm_scan_ref, plain_reps=2,
               bound=_bound(3 * a.numel() * 4, 2.0 * a.numel(),
                            torch.float32), library=None)
    del a, b

    length = torch.tensor(DECODE_LENGTHS, dtype=torch.int32, device=dev)
    for cfg_name in ("stablelm-1.6b", "gemma2-27b"):
        cfg = get_config(cfg_name)
        h, kh = cfg.n_heads, cfg.n_kv_heads
        hd = cfg.head_dim or cfg.d_model // h
        cap_s = cfg.attn_softcap
        for dt in (torch.float32, torch.bfloat16):
            q = rnd(DECODE_B, h, hd).to(dt)
            k = rnd(DECODE_B, DECODE_L, kh, hd).to(dt)
            v = rnd(DECODE_B, DECODE_L, kh, hd).to(dt)
            keys = sum(DECODE_LENGTHS)
            library = None
            if not cap_s and h == kh:
                kt, vt = (t.transpose(1, 2).contiguous() for t in (k, v))
                kpos = torch.arange(DECODE_L, device=dev)
                mask = (kpos[None, :] < length[:, None]) \
                    | (length == 0)[:, None]
                library = (lambda q=q, kt=kt, vt=vt, mask=mask:
                           F.scaled_dot_product_attention(
                               q[:, :, None], kt, vt,
                               attn_mask=mask[:, None, None, :]))
            long = (length > DECODE_PIECE)[:, None, None]
            cut = (length - DECODE_PIECE).clamp(min=0)
            # a kernel that drops each long row's first piece
            fault = (lambda q=q, k=k, v=v, cut=cut, long=long, cap_s=cap_s:
                     (DEC.decode_attention_plain(
                         q, k[:, DECODE_PIECE:], v[:, DECODE_PIECE:], cut,
                         softcap=cap_s), long))
            yield dict(kernel="decode_attention",
                       label=f"{cfg_name}/{str(dt)[6:]}", dt=dt,
                       args=(q, k, v, length), kw=dict(softcap=cap_s),
                       plain=DEC.decode_attention_plain,
                       oracle=ref.decode_attention_ref, zero_rows=length == 0,
                       row_limit=True, fault=fault,
                       bound=_bound(*reversed(decode_cost(
                           DECODE_B, h, kh, hd, keys, q.element_size())), dt),
                       library=library)
            del q, k, v, library, fault

    # the two ops whose kernels earlier phases time: wiring only
    qf = rnd(2, 2048, 32, 64).to(torch.bfloat16)
    yield dict(kernel="flash_attention", label="layer/bfloat16",
               dt=torch.bfloat16, args=(qf, qf, qf), kw={},
               plain=FA.flash_attention_plain, oracle=ref.flash_attention_ref)
    del qf
    codes, scales = Q.quantize_blockwise(rnd(2048, 2048) / math.sqrt(2048))
    yield dict(kernel="quant_matmul", label="layer/int8/bfloat16/T8",
               dt=torch.bfloat16,
               args=(rnd(8, 2048).to(torch.bfloat16), codes, scales), kw={},
               plain=Q.quant_matmul_plain, oracle=ref.quant_matmul_ref)


def ops_phase(dev):
    """Each case through ``repro_torch.kernels.ops``: one counted launch,
    the plain version's result, no launch and the oracle's result with the
    switch off; the four new kernels timed."""
    from repro_torch.kernels import _flash_launch as FL
    from repro_torch.kernels import _gemm_launch as GL
    from repro_torch.kernels import ops
    wrappers = _op_wrappers()
    results = {name: dict(replaces=OPS_REPLACES.get(name), launches=0,
                          per_dtype={}) for name in wrappers}
    for case in ops_cases(dev):
        name, label, dt = case["kernel"], case["label"], case["dt"]
        op = getattr(ops, name)
        args, kw = case["args"], case["kw"]
        tag = f"{name} [{label}]"
        for fn in wrappers.values():
            fn.launches = 0
        paths0 = dict(GL.PATH_LAUNCHES)
        flash0 = dict(FL.PATH_LAUNCHES)
        got = op(*args, **kw)                    # the op layer's main path
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in wrappers.items()}
        if launches != {k: int(k == name) for k in wrappers}:
            raise AssertionError(f"{tag}: launches {launches}")
        path = [k for k in paths0 if GL.PATH_LAUNCHES[k] != paths0[k]]
        if name == "flash_attention":
            path = [k for k in flash0 if FL.PATH_LAUNCHES[k] != flash0[k]]
            if path != [FL.path_for(dt)]:
                raise AssertionError(f"{tag}: took {path}, not "
                                     f"{FL.path_for(dt)}")
        gemm = name in ("block_diag_matmul", "moe_gmm")
        decode_sized = gemm and args[0].shape[1] <= GL.SKINNY_M
        if gemm:
            want_path = ("mma_skinny" if decode_sized else "wgmma") \
                if dt == torch.bfloat16 else (
                    "skinny" if decode_sized else "tiled")
            if path != [want_path]:
                raise AssertionError(f"{tag}: took {path}, not "
                                     f"{want_path}")
        results[name]["launches"] += launches[name]
        want = case["plain"](*args, **kw)
        torch.cuda.synchronize()
        rows = case.get("row_limit", False)
        rule = f"{QTOL[dt]} " + ("max|plain| of its row" if rows
                                 else "(1 + |plain|)")
        limit = ops_limit(want, dt, rows)
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        if got.shape != want.shape or got.dtype != want.dtype \
                or not bool(got.isfinite().all()) or not bool(
                    (diff <= limit).all()):
            raise AssertionError(f"{tag}: max |kernel - plain| {err} beyond "
                                 f"{rule}")
        if "zero_rows" in case and bool((got[case["zero_rows"]] != 0).any()):
            raise AssertionError(f"{tag}: a length-0 row is not 0")
        row = dict(max_abs_err=err, tol=QTOL[dt], rule=rule)
        if path:
            row["path"] = path[0]
        if "fault" in case:
            # the same check on a faulty output must fail in every lane the
            # fault touches: the least, over those lanes, of the lane's
            # largest |fault - plain| / limit
            bad, where = case["fault"]()
            off = (bad.float() - want.float()).abs()
            lanes = where.flatten()
            worst = float((off / limit.clamp(min=1e-30)).amax((1, 2))[
                lanes].min())
            # the same reading under tol (1 + |plain|), for the record
            loose = float((off / ops_limit(want, dt)).amax((1, 2))[
                lanes].min())
            row.update(err_over_limit=float((diff / limit.clamp(
                min=1e-30)).max()), fault_over_limit=worst,
                fault_over_loose_limit=loose)
            if worst <= 1:
                raise AssertionError(f"{tag}: the check passes a lane that "
                                     f"drops a piece ({worst:.3g} of its "
                                     "limit)")
            log(f"[ops] {tag}: kernel at {row['err_over_limit']:.3g} of its "
                f"limit; a lane with its first piece dropped reads at least "
                f"{worst:.3g} of it ({loose:.3g} of tol (1 + |plain|))")
            del bad, where, off
        del diff, want, limit
        ops.use_kernels(False)
        try:
            off = op(*args, **kw)
        finally:
            ops.use_kernels(True)
        if wrappers[name].launches != 1:
            raise AssertionError(f"{tag}: a launch with use_kernels(False)")
        if not torch.equal(off, case["oracle"](*args, **kw)):
            raise AssertionError(f"{tag}: use_kernels(False) is not the "
                                 "oracle's result")
        del off
        if name in OPS_KERNELS:
            bnd, by = case["bound"]
            lib = case["library"]
            ms, per_call = device_profile(lambda: op(*args, **kw))
            if decode_sized and per_call != 1:
                raise AssertionError(f"{tag}: {per_call} CUDA kernels per "
                                     "call, not 1")
            row.update(
                bound_ms=bnd, bound_by=by, ms=ms, kernels_per_call=per_call,
                call_ms=time_ms(lambda: op(*args, **kw)),
                plain_ms=device_ms(lambda: case["plain"](*args, **kw),
                                   reps=case.get("plain_reps", 5)),
                library_ms=None if lib is None else device_ms(lib))
            libs = "—" if lib is None else f"{row['library_ms']:.4f} ms"
            log(f"[ops] {tag}: max_abs_err={err:.3g} kernel "
                f"{row['ms']:.4f} ms ({per_call} kernel(s) per call; call "
                f"{row['call_ms']:.4f}), plain "
                f"{row['plain_ms']:.4f} ms, library {libs}, bound {bnd:.4f} "
                f"ms ({by})")
        else:
            log(f"[ops] {tag}: one launch, max_abs_err={err:.3g}")
        results[name]["per_dtype"][label] = row
        del got, args, case
        gc.collect()
        torch.cuda.empty_cache()
    return results


# -------------------------------------------------------------------- train
TRAIN_RUNS = (("fsdp", 6), ("semantic", 4))
TRAIN_SHAPE = dict(seq_len=2048, batch=2)


def train_phase(dev, cfg):
    """The training launcher at full width on both modes, each run's flash
    launches counted; then the kernel-vs-plain ``value_and_grad`` check."""
    from repro_torch.kernels import _flash_launch as FL
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch import train as TR
    runs = {}
    ln_vocab = math.log(cfg.vocab_size)
    for mode, steps in TRAIN_RUNS:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        step_s = []
        flash_attention.launches = 0
        paths = dict(FL.PATH_LAUNCHES)
        # the bytes live before the run, and those its setup (parameters
        # and AdamW state) adds: the dry run's argument bytes, measured
        base = torch.cuda.memory_allocated()
        setup = {}
        losses = TR.main(
            ["--arch", cfg.name, "--mode", mode, "--steps", str(steps),
             "--seq-len", str(TRAIN_SHAPE["seq_len"]), "--batch",
             str(TRAIN_SHAPE["batch"]), "--log-every", "1"],
            on_step=lambda i, loss, s: step_s.append(s),
            on_setup=lambda *a: setup.update(
                bytes=torch.cuda.memory_allocated() - base))
        torch.cuda.synchronize()
        launches = flash_attention.launches
        want = 2 * cfg.n_layers * steps
        if launches != want:
            raise AssertionError(f"[train {mode}] {launches} flash launches,"
                                 f" {steps} steps of {cfg.n_layers} layers "
                                 f"with remat imply {want}")
        by_path = {p: FL.PATH_LAUNCHES[p] - paths[p] for p in paths}
        if by_path != {"mma": 0, "simt": launches}:
            raise AssertionError(f"[train {mode}] flash launches by path "
                                 f"{by_path}: f32 takes the CUDA-core path")
        if not all(math.isfinite(x) for x in losses) or \
                abs(losses[0] - ln_vocab) > 1.0:
            raise AssertionError(f"[train {mode}] losses {losses}: not "
                                 f"finite or first not within 1 of ln V = "
                                 f"{ln_vocab:.3f}")
        steady = statistics.median(step_s[1:])
        tokens = TRAIN_SHAPE["seq_len"] * TRAIN_SHAPE["batch"]
        runs[mode] = dict(steps=steps, losses=losses, step_s=step_s,
                          step_ms=1e3 * steady, tokens_per_s=tokens / steady,
                          peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                          base_bytes=base, setup_bytes=setup["bytes"],
                          flash_launches=launches,
                          flash_launches_by_path=by_path,
                          launches_per_step=launches / steps)
        log(f"[train {mode}] {json.dumps(runs[mode])}")
    runs["kernel_vs_plain"] = grad_check(dev, cfg)
    return runs


def value_and_grad_limits(tag, want, got):
    """(loss rel, worst leaf error over that leaf's max) of ``got`` against
    ``want``, each a (loss, [grads]) pair: loss to rel 1e-5, each gradient
    leaf to 1e-4 of its largest, or raise."""
    rel_loss = abs(float(got[0]) - float(want[0])) / abs(float(want[0]))
    worst = 0.0
    for gw, gg in zip(want[1], got[1]):
        worst = max(worst, float((gg - gw).abs().max()
                                 / gw.abs().max().clamp_min(1e-30)))
    if not rel_loss <= 1e-5 or not worst <= 1e-4:
        raise AssertionError(f"[{tag}] loss rel {rel_loss}, worst grad leaf "
                             f"{worst} of its max")
    return dict(loss=float(got[0]), loss_want=float(want[0]),
                rel_loss=rel_loss, worst_grad_rel=worst)


def grad_check(dev, cfg):
    """One full-width fsdp ``value_and_grad`` through the kernel and one
    through ``flash_attention_plain`` patched into ``models.attention``,
    from the same weights and batch."""
    from repro_torch.data.pipeline import batches_for
    from repro_torch.dist import api as A
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.models import attention as MA
    gc.collect()
    torch.cuda.empty_cache()
    cfg = cfg.replace(dtype="float32")
    runner = A.build_runner(cfg, "fsdp", device=dev)
    tree = runner.init(seed=0)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in next(batches_for(
        cfg, seq_len=TRAIN_SHAPE["seq_len"],
        global_batch=TRAIN_SHAPE["batch"])).items()}
    loss_k, grads_k = runner.value_and_grad(tree, batch, remat=True)
    grads_k = A.tree_leaves(grads_k)
    saved = MA.flash_attention
    MA.flash_attention = flash_attention_plain
    try:
        loss_p, grads_p = runner.value_and_grad(tree, batch, remat=True)
    finally:
        MA.flash_attention = saved
    out = value_and_grad_limits("train kernel vs plain",
                                (loss_p, A.tree_leaves(grads_p)),
                                (loss_k, grads_k))
    del grads_k, grads_p, tree, runner
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[train] kernel vs plain value_and_grad: {json.dumps(out)}")
    return out


#: the dry run's production runs on the card's host: (arch, shape, two
#: pods, microbatches).  train_4k runs as one microbatch (``--n-micro 1``):
#: its default 16 traced 104 s on the card's host, past the phase's
#: budget
DRYRUN_RUNS = (("stablelm-1.6b", "train_4k", False, 1),
               ("xlstm-125m", "decode_32k", False, None),
               ("jamba-1.5-large-398b", "long_500k", True, None))
#: the dry run against the train phase's fsdp run: argument bytes within
#: 1% of the setup's bytes, the peak within 15% of the run's own peak
DRYRUN_ARG_REL, DRYRUN_PEAK_REL = 0.01, 0.15


def dryrun_phase(cfg, train):
    """The dry run (``repro_torch.launch.dryrun``) of the step the train
    phase measured, on a 1 x 1 fake mesh on the meta device (fsdp, f32,
    remat, the train phase's batch), held to that run: its predicted flash
    launches a step to the measured (all ``simt``), its argument bytes to
    the bytes the run's setup allocated, its peak to the run's peak less
    what was live before it.  Then the production runs of
    ``DRYRUN_RUNS`` on the host, each a rank of the production mesh."""
    import torch.distributed as dist
    from repro_torch.dist import api as A
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.mesh import fake_mesh
    from repro_torch.models.model import InputShape
    if dist.is_initialized():
        raise AssertionError("[dryrun] a process group is running")
    t_phase = time.perf_counter()
    run = train["fsdp"]
    shape = InputShape("train_phase", TRAIN_SHAPE["seq_len"],
                       TRAIN_SHAPE["batch"], "train")
    with fake_mesh((1, 1)) as mesh:
        runner = A.build_runner(cfg.replace(dtype="float32"), "fsdp", mesh,
                                device="meta")
        rec = DR.dryrun_rank(runner, shape, remat=True)
    flash = rec["kernels"]["flash_attention"]
    want = run["launches_per_step"]
    if flash["launches"] != want or flash["paths"] != {"simt": want}:
        raise AssertionError(f"[dryrun] predicted flash launches {flash}, "
                             f"the train phase measured {want} a step, all "
                             "simt")
    peak = run["peak_mem_gb"] * 1e9 - run["base_bytes"]
    ratios = dict(argument=rec["argument_bytes"] / run["setup_bytes"],
                  peak=rec["peak_bytes"] / peak)
    out = dict(trace_s=rec["trace_s"], flash_launches=flash,
               flash_launches_measured=want,
               argument_bytes=rec["argument_bytes"],
               argument_bytes_measured=run["setup_bytes"],
               peak_bytes=rec["peak_bytes"], peak_bytes_measured=peak,
               base_bytes=run["base_bytes"], ratios=ratios,
               flops=rec["flops"], production={})
    log(f"[dryrun] train phase's fsdp step: {json.dumps(out)}")
    if not abs(ratios["argument"] - 1) <= DRYRUN_ARG_REL \
            or not abs(ratios["peak"] - 1) <= DRYRUN_PEAK_REL:
        raise AssertionError(f"[dryrun] predicted / measured {ratios}: "
                             f"limits {DRYRUN_ARG_REL} (arguments), "
                             f"{DRYRUN_PEAK_REL} (peak)")
    for arch, shape_name, pod2, n_micro in DRYRUN_RUNS:
        r = DR.run_dryrun(arch, shape_name, multi_pod=pod2, save=False,
                          verbose=False, n_micro=n_micro)
        tag = f"{arch}/{shape_name}/{'pod2' if pod2 else 'pod1'}" + (
            f"/n_micro{n_micro}" if n_micro else "")
        out["production"][tag] = dict(
            trace_s=r["trace_s"], peak_gb=r["peak_bytes"] / 1e9,
            argument_bytes=r["argument_bytes"], flops=r["flops"],
            collectives=r["collectives"], kernels=r["kernels"],
            ranks=r["ranks"])
        log(f"[dryrun] {tag}: {json.dumps(out['production'][tag])}")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[dryrun] phase seconds {out['phase_s']:.1f}")
    return out


PIPELINE_RUNS = (("gpipe", 3), ("1f1b", 3))
PIPELINE_MICRO = 2


def pipeline_phase(dev, cfg):
    """The training launcher's explicit schedules (gpipe, 1f1b) at the train
    phase's shape, each run's flash launches counted; then both schedules'
    ``value_and_grad`` against fsdp's and one through the kernel against
    the same through ``flash_attention_plain``."""
    from repro_torch.dist import api as A
    from repro_torch.kernels import _flash_launch as FL
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch import train as TR
    runs = {}
    ln_vocab = math.log(cfg.vocab_size)
    tokens = TRAIN_SHAPE["seq_len"] * TRAIN_SHAPE["batch"]
    for schedule, steps in PIPELINE_RUNS:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        step_s = []
        flash_attention.launches = 0
        paths = dict(FL.PATH_LAUNCHES)
        losses = TR.main(
            ["--arch", cfg.name, "--mode", "pipeline", "--schedule",
             schedule, "--n-microbatches", str(PIPELINE_MICRO), "--steps",
             str(steps), "--seq-len", str(TRAIN_SHAPE["seq_len"]),
             "--batch", str(TRAIN_SHAPE["batch"]), "--log-every", "1"],
            on_step=lambda i, loss, s: step_s.append(s))
        torch.cuda.synchronize()
        launches = flash_attention.launches
        # per microbatch: the F op's forward, the B op's re-forward and
        # remat's recompute inside the B op's backward
        want = 3 * PIPELINE_MICRO * cfg.n_layers * steps
        if launches != want:
            raise AssertionError(
                f"[pipeline {schedule}] {launches} flash launches, {steps} "
                f"steps of {PIPELINE_MICRO} microbatches x {cfg.n_layers} "
                f"layers x 3 imply {want}")
        by_path = {p: FL.PATH_LAUNCHES[p] - paths[p] for p in paths}
        if by_path != {"mma": 0, "simt": launches}:
            raise AssertionError(f"[pipeline {schedule}] flash launches by "
                                 f"path {by_path}: f32 takes simt")
        if not all(math.isfinite(x) for x in losses) or \
                abs(losses[0] - ln_vocab) > 1.0:
            raise AssertionError(f"[pipeline {schedule}] losses {losses}: "
                                 f"not finite or first not within 1 of ln V")
        steady = statistics.median(step_s[1:])
        stats = A.build_runner(
            cfg.replace(dtype="float32"), "pipeline",
            n_microbatches=PIPELINE_MICRO, schedule=schedule,
            device=dev).schedule_stats(TRAIN_SHAPE["batch"],
                                       TRAIN_SHAPE["seq_len"])
        runs[schedule] = dict(
            steps=steps, losses=losses, step_s=step_s, step_ms=1e3 * steady,
            tokens_per_s=tokens / steady,
            peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
            flash_launches=launches, flash_launches_by_path=by_path,
            launches_per_step=launches / steps, schedule_stats=stats)
        log(f"[pipeline {schedule}] {json.dumps(runs[schedule])}")
    runs["checks"] = pipeline_check(dev, cfg)
    return runs


def pipeline_check(dev, cfg):
    """From one set of full-width weights and one batch: fsdp's
    ``value_and_grad``, each schedule's held to it, and the 1f1b one held
    to the same call through ``flash_attention_plain`` patched into
    ``models.attention``; each timed once (device work included)."""
    from repro_torch.data.pipeline import batches_for
    from repro_torch.dist import api as A
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.models import attention as MA
    gc.collect()
    torch.cuda.empty_cache()
    cfg = cfg.replace(dtype="float32")
    fsdp = A.build_runner(cfg, "fsdp", device=dev)
    tree = fsdp.init(seed=0)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in next(batches_for(
        cfg, seq_len=TRAIN_SHAPE["seq_len"],
        global_batch=TRAIN_SHAPE["batch"])).items()}

    def vag(runner):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads = runner.value_and_grad(tree, batch, remat=True)
        torch.cuda.synchronize()
        return (loss, A.tree_leaves(grads)), time.perf_counter() - t0

    ref, ref_s = vag(fsdp)
    out = {"fsdp_s": ref_s}
    for schedule, _ in PIPELINE_RUNS:
        runner = A.build_runner(cfg, "pipeline", n_microbatches=PIPELINE_MICRO,
                                schedule=schedule, device=dev)
        runner.model = fsdp.model
        kernel = None               # one schedule's grads alive at a time
        kernel, secs = vag(runner)
        out[schedule] = dict(value_and_grad_limits(
            f"pipeline {schedule} vs fsdp", ref, kernel), seconds=secs,
            vs_fsdp_time=secs / ref_s)
    saved = MA.flash_attention
    MA.flash_attention = flash_attention_plain
    try:
        plain, _ = vag(runner)
    finally:
        MA.flash_attention = saved
    out["kernel_vs_plain"] = value_and_grad_limits(
        f"pipeline {runner.schedule} kernel vs plain", plain, kernel)
    del ref, plain, kernel, tree, fsdp, runner
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[pipeline] checks: {json.dumps(out)}")
    return out


# -------------------------------------------------------------------- multi
MULTI_WORLD = 2
MULTI_STEPS = 2
MULTI_MICRO = 2
MULTI_EP_SUPERBLOCKS = 4
MULTI_TIMEOUT_S = 600
MULTI_LOSS_REL = 1e-6        # loss against the one-process run, relative
# each gradient leaf against the one-process run, over that leaf's max.
# Sound runs read at most 9.9e-6 (fsdp, whose data split sums the batch's
# gradient in halves, as the pipeline phase's microbatch split does there,
# 9.7e-6); the same run's gradient rounded to bf16 (``ctrl_bf16``, checked
# above the limit every run) reads 3.2e-3 to 3.5e-3 on the card.  The
# pipeline phase's limit, with 10x room below and 30x above.
MULTI_GRAD_REL = 1e-4
_PIPE = dict(mode="pipeline", n_microbatches=MULTI_MICRO)
# expert parallel on one sequence (B 1 x S 2048, one microbatch): at B 2,
# M 2 a rank peaks at 41.1 GB (30 GB of params, grads and moments, and one
# microbatch's activations beside a whole gradient tree), which fits the
# card beside this process only when no phase ran before
_EP = dict(mode="pipeline", n_microbatches=1, expert_parallel=True)
# the one-process runs each sharded run is held to, and their global batch
MULTI_REFS = {"fsdp": ("stablelm-1.6b", dict(mode="fsdp")),
              "stage": ("stablelm-1.6b", dict(_PIPE, schedule="1f1b")),
              "moe": ("qwen2-moe-a2.7b", _EP),
              "moe_rows": ("qwen2-moe-a2.7b", dict(mode="fsdp"))}
MULTI_BATCH = {"fsdp": TRAIN_SHAPE["batch"], "stage": TRAIN_SHAPE["batch"],
               "moe": 1, "moe_rows": 2}
# the MoE on a row split: fsdp on (2, 1) splits B 2 into a row a rank, 2
# superblocks at a capacity factor whose experts overflow, so capacity and
# drops must be the whole batch's for the ranks to match one process
MULTI_MOE_ROWS = dict(superblocks=2, capacity_factor=1.0)
# (tag, mesh, runner kwargs, reference)
MULTI_RUNS = (("fsdp", (2, 1), dict(mode="fsdp"), "fsdp"),
              ("1f1b", (1, 2), dict(_PIPE, schedule="1f1b"), "stage"),
              ("gpipe", (1, 2), dict(_PIPE, schedule="gpipe"), "stage"),
              ("ep", (1, 2), dict(_EP, schedule="1f1b"), "moe"),
              ("moe_rows", (2, 1), dict(mode="fsdp"), "moe_rows"))


def multi_cfg(key: str, reduced: bool):
    """The multi phase's config of a reference key: f32; qwen2-moe cut to
    its first ``MULTI_EP_SUPERBLOCKS`` superblocks (full width), or as
    ``MULTI_MOE_ROWS`` says."""
    import dataclasses

    from repro_torch.configs.base import get_config
    cfg = get_config(MULTI_REFS[key][0])
    if reduced:
        cfg = cfg.reduced()
    if cfg.moe is not None:
        rows = MULTI_MOE_ROWS if key == "moe_rows" else {}
        cfg = cfg.replace(n_layers=min(
            rows.get("superblocks", MULTI_EP_SUPERBLOCKS),
            cfg.n_superblocks) * len(cfg.pattern))
        if rows:
            cfg = cfg.replace(moe=dataclasses.replace(
                cfg.moe, capacity_factor=rows["capacity_factor"]))
    return cfg.replace(dtype="float32")


class _MoeDrops:
    """While active, the assignments this process's MoE dispatch drops past
    capacity, summed over its calls (``dropped``), of ``assigned``: an
    assignment is kept exactly when its routing weight lands in a slot
    (the top-k softmax weights are never 0)."""

    def __enter__(self):
        from repro_torch.models import moe as MOE
        self.dropped = self.assigned = 0
        self.orig = MOE._dispatch_buffers

        def counted(weights, idx, g, t, m, rows=None):
            buf_tok, buf_w = self.orig(weights, idx, g, t, m, rows)
            self.assigned += g * t * m.top_k
            self.dropped += g * t * m.top_k - int((buf_w != 0).sum())
            return buf_tok, buf_w
        MOE._dispatch_buffers = counted
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe as MOE
        MOE._dispatch_buffers = self.orig


def multi_flash_per_step(cfg, mesh, kw) -> int:
    """Flash launches one rank makes a step: fsdp runs every layer on its
    rows (forward and remat's recompute); a stage runs its span three times
    a microbatch (F, B's re-forward, remat's recompute); expert parallel
    runs every layer twice a microbatch."""
    if kw["mode"] == "fsdp":
        return 2 * cfg.n_layers
    if kw.get("expert_parallel"):
        return 2 * kw["n_microbatches"] * cfg.n_layers
    return 3 * kw["n_microbatches"] * cfg.n_layers // mesh[1]


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _multi_reference(dev, key, reduced, batch):
    """A one-process ``value_and_grad`` on the seed-0 weights: (loss, {leaf
    path: gradient on the host}, MoE assignments dropped)."""
    from repro_torch.dist import api as A
    _, kw = MULTI_REFS[key]
    runner = A.build_runner(multi_cfg(key, reduced), device=dev, **kw)
    tree = runner.init(seed=0)
    with _MoeDrops() as drops:
        loss, grads = runner.value_and_grad(tree, batch, remat=True)
    host = {k: v.detach().cpu() for k, v in _paths(grads).items()}
    out = float(loss)
    del runner, tree, grads
    _free()
    return out, host, drops.dropped


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def multi_worker(rank: int, workdir: pathlib.Path, device: str,
                 reduced: bool) -> int:
    """One rank of the multi phase's gloo world: each run of
    ``MULTI_RUNS`` on its mesh, its first step's loss and gradient slices
    held to the one-process run, then a second step; results to
    ``workdir/rank<r>.json``."""
    import torch.distributed as dist

    from repro_torch.data.pipeline import batches_for
    from repro_torch.dist import api as A
    from repro_torch.dist import comm
    from repro_torch.dist import sharding as SH
    from repro_torch.kernels import _flash_launch as FL
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch.mesh import init_mesh
    from repro_torch.models import attention as MA
    from repro_torch.optim.adamw import adamw_init, adamw_update
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:                 # the plain version's calls count as launches
        import os
        torch.set_num_threads(max(1, (os.cpu_count() or 2) // MULTI_WORLD))
        plain = FA.flash_attention_plain

        def counted(q, k, v, **kw):
            FA.flash_attention.launches += 1
            FL.PATH_LAUNCHES["simt"] += 1
            return plain(q, k, v, **kw)
        MA.flash_attention = counted
        from repro_torch.kernels import decode_attention as DEC
        from repro_torch.models import layers as ML
        plain_dec = DEC.decode_attention_plain

        def dec_counted(*a, **kw):
            DEC.decode_attention.launches += 1
            return plain_dec(*a, **kw)
        ML.decode_attention = dec_counted
        _count_paged_plain()
    world = dict(backend="gloo", device=dev, rank=rank,
                 world_size=MULTI_WORLD, timeout_s=120,
                 store=dist.FileStore(str(workdir / "store"), MULTI_WORLD))
    init_mesh(MULTI_RUNS[0][1], **world)
    refs, batches, runs = {}, {}, {}
    for tag, dims, kw, ref_key in MULTI_RUNS:
        cfg = multi_cfg(ref_key, reduced)
        if ref_key not in batches:
            batches[ref_key] = {k: torch.from_numpy(v).to(dev) for k, v in
                                next(batches_for(
                                    cfg, seq_len=TRAIN_SHAPE["seq_len"],
                                    global_batch=MULTI_BATCH[ref_key]))
                                .items()}
        batch = batches[ref_key]
        if ref_key not in refs:     # one rank at a time: each is a whole
            refs.clear()            # one-process step on the card
            _free()
            for r in range(MULTI_WORLD):
                if r == rank:
                    refs[ref_key] = _multi_reference(dev, ref_key, reduced,
                                                     batch)
                dist.barrier()
        want_loss, want, want_dropped = refs[ref_key]
        mesh = init_mesh(dims, **world)
        _free()
        mem = {}

        def note(at):
            if dev.type == "cuda":
                mem[at] = round(torch.cuda.memory_allocated() / 1e9, 3)
        note("start")
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        runner = A.build_runner(cfg, device=dev, mesh=mesh, **kw)
        params = runner.init(seed=0)
        spec_bytes = SH.bytes_per_rank(runner.model.param_tree(),
                                       runner.specs, mesh)
        held = sum(t.numel() * t.element_size()
                   for t in A.tree_leaves(params))
        note("params")
        step = A.make_train_step(runner, lr=3e-4, remat=True)
        comm.reset_stats()
        FA.flash_attention.launches = 0
        paths = dict(FL.PATH_LAUNCHES)
        dist.barrier()
        _sync(dev)
        t0 = time.perf_counter()
        with _MoeDrops() as drops:
            loss, grads = runner.value_and_grad(params, batch, remat=True)
        _sync(dev)
        vag_s = time.perf_counter() - t0
        note("grads")
        worst, worst_leaf, ctrl = 0.0, "", 0.0
        sizes = dict(mesh.shape)
        specs = _paths(runner.specs)
        for path, g in _paths(grads).items():
            w = SH.shard_leaf(want[path], specs[path], sizes,
                              mesh.coords).to(dev)
            top = w.abs().max().clamp_min(1e-30)
            err = float((g - w).abs().max() / top)
            if err > worst:
                worst, worst_leaf = err, path
            # the control: this gradient with a bf16 rounding planted
            ctrl = max(ctrl, float((g.bfloat16().float() - w).abs().max()
                                   / top))
            del w
        rel_loss = abs(float(loss) - want_loss) / abs(want_loss)
        _free()
        opt = adamw_init(params)
        note("moments")
        _sync(dev)
        t1 = time.perf_counter()
        params, opt = adamw_update(grads, opt, params, lr=3e-4,
                                   specs=runner.specs, mesh=mesh)
        _sync(dev)
        step_s = [vag_s + time.perf_counter() - t1]
        losses = [float(loss)]
        del grads
        for _ in range(MULTI_STEPS - 1):
            _free()      # the other rank's allocator may need it
            dist.barrier()
            _sync(dev)
            t1 = time.perf_counter()
            params, opt, loss = step(params, opt, batch)
            losses.append(float(loss))
            step_s.append(time.perf_counter() - t1)
        _sync(dev)
        launches = FA.flash_attention.launches
        by_path = {p: FL.PATH_LAUNCHES[p] - paths[p] for p in paths}
        runs[tag] = dict(
            mesh=list(dims), coords=mesh.coords, ref=ref_key, losses=losses,
            step_ms=[1e3 * s for s in step_s], rel_loss=rel_loss,
            worst_grad_rel=worst, worst_leaf=worst_leaf, ctrl_bf16=ctrl,
            param_bytes=held, param_bytes_specs=spec_bytes,
            flash_launches=launches, flash_by_path=by_path,
            flash_want=MULTI_STEPS * multi_flash_per_step(cfg, dims, kw),
            comm=dict(comm.COMM_STATS), mem_gb=mem,
            moe_dropped=drops.dropped, moe_assigned=drops.assigned,
            moe_dropped_one_process=want_dropped,
            peak_mem_gb=(torch.cuda.max_memory_allocated() / 1e9
                         if dev.type == "cuda" else 0.0))
        log(f"[multi {tag} rank {rank}] step ms {runs[tag]['step_ms']}, "
            f"loss rel {rel_loss:.3g}, worst grad {worst:.3g} "
            f"({worst_leaf}; bf16 control {ctrl:.3g}), peak GB "
            f"{runs[tag]['peak_mem_gb']:.2f}, allocated GB {mem}")
        del runner, params, opt, step
        comm.release_buffers()
    refs.clear()
    runs["serve"] = serve_multi_worker(rank, workdir, dev, reduced, world)
    runs["engine"] = engine_worker(rank, dev, reduced, world)
    runs["engine_paged"] = engine_paged_worker(rank, dev, reduced, world)
    runs["engine_disagg"] = engine_disagg_worker(rank, dev, reduced, world)
    runs["engine_fleet"] = engine_fleet_worker(rank, dev, reduced, world)
    runs["engine_pinned"] = engine_pinned_worker(rank, dev, reduced, world)
    dist.barrier()
    dist.destroy_process_group()
    (workdir / f"rank{rank}.json").write_text(json.dumps(runs))
    return 0


def multi_phase(dev, *, reduced: bool = False):
    """Two ranks of this script (``--multi-rank``) in a gloo world on the
    one card; each run's gates checked here on both ranks' results."""
    import os
    import tempfile
    _free()
    if dev.type == "cuda":
        log(f"[multi] this process holds "
            f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card")
    card = gpu_name_and_limit() if dev.type == "cuda" else "cpu"
    workdir = pathlib.Path(tempfile.mkdtemp(prefix="multi_"))
    serve_refs = serve_multi_refs(dev, workdir, reduced)
    engine_ref = engine_refs(dev, reduced)
    engine_paged_ref = engine_paged_refs(dev, reduced)
    engine_disagg_ref = engine_disagg_refs(dev, reduced)
    engine_fleet_ref = engine_fleet_refs(dev, reduced)
    # two processes' caching allocators share the card: expandable
    # segments keep their freed blocks from fragmenting it
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    # both ranks on the card's index 0 (or the CPU, when rehearsing)
    child = "cuda:0" if dev.type == "cuda" else "cpu"
    args = ["--multi-dir", str(workdir), "--multi-device", child] + \
        (["--multi-reduced"] if reduced else [])
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                               "--multi-rank", str(r)] + args, env=env)
             for r in range(MULTI_WORLD)]
    try:
        rcs = [p.wait(timeout=max(1.0, MULTI_TIMEOUT_S
                                  - (time.perf_counter() - t0)))
               for p in procs]
    except subprocess.TimeoutExpired:
        rcs = None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall_s = time.perf_counter() - t0
    if rcs is None:
        raise AssertionError(f"[multi] the world ran past {MULTI_TIMEOUT_S} s")
    if any(rcs):
        raise AssertionError(f"[multi] ranks exited with {rcs}")
    ranks = [json.loads((workdir / f"rank{r}.json").read_text())
             for r in range(MULTI_WORLD)]
    out = {"wall_s": wall_s, "card": card, "runs": {}}
    for tag, dims, kw, _ in MULTI_RUNS:
        per = [rk[tag] for rk in ranks]
        for r, run in enumerate(per):
            where = f"[multi {tag} rank {r}]"
            if not run["rel_loss"] <= MULTI_LOSS_REL or \
                    not run["worst_grad_rel"] <= MULTI_GRAD_REL:
                raise AssertionError(
                    f"{where} loss rel {run['rel_loss']}, worst grad leaf "
                    f"{run['worst_grad_rel']} ({run['worst_leaf']}) of its "
                    "max against the one-process run")
            if not run["ctrl_bf16"] > MULTI_GRAD_REL:
                raise AssertionError(
                    f"{where} the gate passes a bf16-rounded gradient "
                    f"({run['ctrl_bf16']} of its max)")
            if run["param_bytes"] != run["param_bytes_specs"]:
                raise AssertionError(f"{where} holds {run['param_bytes']} "
                                     f"parameter bytes, specs say "
                                     f"{run['param_bytes_specs']}")
            if run["flash_launches"] != run["flash_want"] or \
                    run["flash_by_path"].get("simt") != run["flash_launches"]:
                raise AssertionError(
                    f"{where} {run['flash_launches']} flash launches "
                    f"({run['flash_by_path']}), want {run['flash_want']} "
                    "on simt")
            if not all(math.isfinite(x) for x in run["losses"]):
                raise AssertionError(f"{where} losses {run['losses']}")
        dropped = sum(r["moe_dropped"] for r in per)
        if tag == "moe_rows" and not (
                dropped == per[0]["moe_dropped_one_process"] > 0):
            raise AssertionError(
                f"[multi {tag}] the ranks dropped {dropped} MoE "
                f"assignments, one process "
                f"{per[0]['moe_dropped_one_process']} (must be equal and "
                "above 0)")
        if per[0]["losses"] != per[1]["losses"]:
            raise AssertionError(f"[multi {tag}] ranks report different "
                                 f"losses {per[0]['losses']} "
                                 f"{per[1]['losses']}")
        out["runs"][tag] = per
        log(f"[multi {tag}] {card} | " + json.dumps(dict(
            mesh=dims, ranks=[dict(
                step_ms=r["step_ms"], losses=r["losses"],
                rel_loss=r["rel_loss"], worst_grad_rel=r["worst_grad_rel"],
                worst_leaf=r["worst_leaf"], ctrl_bf16=r["ctrl_bf16"],
                param_bytes=r["param_bytes"],
                param_bytes_specs=r["param_bytes_specs"],
                flash_launches=r["flash_launches"], comm=r["comm"],
                moe_dropped=r["moe_dropped"],
                moe_assigned=r["moe_assigned"],
                moe_dropped_one_process=r["moe_dropped_one_process"],
                peak_mem_gb=r["peak_mem_gb"]) for r in per])))
    out["serve"] = serve_multi_gates(ranks, reduced, card, serve_refs)
    out["serve_one_process"] = serve_refs
    out["engine"] = engine_gates(ranks, engine_ref, card)
    out["engine_one_process"] = engine_ref
    out["engine_paged"] = engine_paged_gates(ranks, engine_paged_ref, card)
    out["engine_paged_one_process"] = engine_paged_ref
    out["engine_disagg"] = engine_disagg_gates(ranks, engine_disagg_ref,
                                               card)
    out["engine_disagg_one_process"] = engine_disagg_ref
    out["engine_fleet"] = engine_fleet_gates(ranks, engine_fleet_ref, card)
    out["engine_fleet_one_process"] = engine_fleet_ref
    out["engine_pinned"] = engine_pinned_gates(
        ranks, engine_disagg_ref["clean"], card)
    log(f"[multi] {card} | world of {MULTI_WORLD} gloo ranks on one "
        f"device, {wall_s:.1f} s")
    return out


# ------------------------------------------------------------ serve_multi
#: flash-decoding on (2, 1) under ``shard_cache_len``: (config, superblocks
#: or None for all, cache slots, prompt tokens, decode steps).  A fills
#: slots 0 .. P-1 with a prompt through ``prefill_into_cache`` and decodes
#: across the slab boundary at cache / 2; B (``attn_local`` ring layers,
#: which prefill one token at a time) starts from a cache whose first P
#: global slots and every ring slot hold seeded K/V (``_seeded_cache``),
#: so its 4096-slot ring has wrapped across both ranks' slabs.
SERVE_FD = {"A": ("stablelm-1.6b", None, 65536, 32760, 16),
            "B": ("gemma2-27b", 2, 8192, 6000, 16)}
SERVE_FD_REDUCED = {"A": ("stablelm-1.6b", None, 512, 250, 16),
                    "B": ("gemma2-27b", None, 64, 48, 16)}
#: the LAYER and SEMANTIC arms on (1, 2): (batch, prompt lengths [lo, hi),
#: decode steps)
SERVE_ARMS = {"layer": "pipeline", "semantic": "semantic"}
#: the LAYER arm in the stage graph's layout (``stage_param_specs``): a
#: stage holds its superblocks and whole embed and norms, so no leaf is
#: gathered a call (the gspmd layout splits the 411 MB embed and head over
#: 'model' and gathers both every call)
SERVE_ARM_KW = {"layer": dict(schedule="1f1b")}
SERVE_ARM_SHAPE = (8, (256, 513), 32)
SERVE_ARM_SHAPE_REDUCED = (8, (16, 33), 8)
#: whisper-base (enc-dec) on the LAYER stages on (1, 2), the stage layout:
#: 3 encoder and 3 decoder superblocks a rank; (batch, prompt tokens,
#: greedy steps).  Calls: ``prefill_step`` on the prompt with the audio
#: (1500 stub frames), the prompt teacher-forced through ``serve_step``
#: (each call re-encodes the audio, as the reference's decode step does),
#: then the greedy steps
SERVE_WHISPER = (4, 32, 16)
SERVE_WHISPER_REDUCED = (4, 8, 4)
SERVE_SEED = 29
#: each part's logits against the one-process run, max |diff| over the
#: run's max |logit|, set from readings (see PERF.md); the same logits
#: rounded to bf16 (``ctrl_bf16``) must read above it every run
SERVE_LOGIT_REL = {"A": 1e-4, "B": 1e-4, "layer": 1e-4, "semantic": 1e-4,
                   "whisper": 1e-4}


def serve_cfg(name: str, superblocks, reduced: bool,
              dtype: str = "float32"):
    """A serve_multi config, in f32 (weights and caches) unless ``dtype``
    says otherwise.  In bf16 the logits are bf16 values, so two sound runs
    differ by whole bf16 ulps after 24 layers (NVIDIA H100 80GB HBM3,
    700.00 W: 1.1e-2 of the largest logit in part A, 1.3e-2 and one flipped
    greedy token in the SEMANTIC arm; see PERF.md) and a bf16-rounded
    control reads 0; in f32 the gate can sit far below a bf16 rounding.
    So bf16 across ranks is not gated here: ``scripts/serve_bf16_
    witness.py`` reads bf16 ranks and a bf16 process against the f32
    process."""
    from repro_torch.configs.base import get_config
    cfg = get_config(name)
    if reduced:
        cfg = cfg.reduced()
    if superblocks:
        cfg = cfg.replace(n_layers=superblocks * len(cfg.pattern))
    return cfg.replace(dtype=dtype)


def serve_inputs(reduced: bool) -> dict:
    """Every token the serve_multi runs feed, from one seed: A's prompt,
    B's first token, the arms' right-padded prompts and their lengths."""
    fd = SERVE_FD_REDUCED if reduced else SERVE_FD
    b, (lo, hi), _ = SERVE_ARM_SHAPE_REDUCED if reduced else SERVE_ARM_SHAPE
    rng = np.random.default_rng(SERVE_SEED)
    vocab = {k: serve_cfg(n, s, reduced).vocab_size
             for k, (n, s, _, _, _) in fd.items()}
    lengths = rng.integers(lo, hi, b).astype(np.int32)
    arm_vocab = serve_cfg("stablelm-1.6b", None, reduced).vocab_size
    inp = {"A_prompt": rng.integers(0, vocab["A"], (1, fd["A"][3]))
           .astype(np.int32),
           "B_first": rng.integers(0, vocab["B"], (1, 1)).astype(np.int32),
           "arm_prompt": rng.integers(0, arm_vocab, (b, int(lengths.max())))
           .astype(np.int32),
           "arm_lengths": lengths}
    wb, wp, ws = SERVE_WHISPER_REDUCED if reduced else SERVE_WHISPER
    wcfg = serve_cfg("whisper-base", None, reduced)
    fe = wcfg.frontend
    inp["whisper_prompt"] = rng.integers(0, wcfg.vocab_size, (wb, wp)) \
        .astype(np.int32)
    inp["whisper_audio"] = rng.standard_normal(
        (wb, fe.n_tokens, fe.d_frontend)).astype(np.float32)
    inp["whisper_steps"] = np.asarray(ws)
    return inp


def _seeded_cache(cfg, batch: int, cache_len: int, n_pos: int, dev):
    """The whole decode cache of part B's start: every leaf drawn from
    N(0, 1) with one seed, in tree order; the global layers' slots from
    ``n_pos`` on zeroed (not yet written), the ring layers' (shorter)
    caches full."""
    from repro_torch.models import transformer as T
    from repro_torch.models.model import build_model
    gen = torch.Generator(device=dev).manual_seed(SERVE_SEED)

    def fill(t):
        x = torch.randn(t.shape, generator=gen, device=dev).to(t.dtype)
        if t.shape[-3] == cache_len:
            x[..., n_pos:, :, :] = 0
        return x
    return T.tree_map(fill, build_model(cfg, device="meta").init_cache(
        batch, cache_len))


def _serve_calls(runner, params, cache, inp, part, *, fd, arm_steps,
                 feed=None, on_logits=None):
    """One part's calls: A a prompt then its decode steps, B decode steps
    from the seeded cache, an arm a right-padded prompt (per-row lengths)
    then its decode steps, whisper its audio and prompt
    (``_whisper_calls``).  ``feed`` gives the tokens of each decode step
    (the one-process run's, teacher-forced); without it the greedy token
    of the last logits.  ``on_logits(i, logits)`` sees each call's [B,
    vocab] logits.  Returns (the tokens fed, per-call ms, cache)."""
    dev = runner.device
    ms, fed = [], []

    def timed(fn):
        _sync(dev)
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        ms.append(1e3 * (time.perf_counter() - t0))
        return out
    t = lambda a: torch.from_numpy(np.asarray(a)).to(dev)
    if part == "whisper":
        return _whisper_calls(runner, params, cache, inp, t, timed, feed=feed,
                              on_logits=on_logits), ms, cache
    if part == "B":
        start, steps = fd["B"][3], fd["B"][4]
        tok = t(inp["B_first"])
    else:
        if part == "A":
            prompt, lengths, steps = t(inp["A_prompt"]), None, fd["A"][4]
        else:
            prompt, lengths = t(inp["arm_prompt"]), t(inp["arm_lengths"])
            steps = arm_steps
        start = prompt.shape[1]
        logits, cache = timed(lambda: runner.prefill_into_cache(
            params, cache, prompt, lengths=lengths))
        if on_logits:
            on_logits(0, logits)
        tok = logits.argmax(-1)[:, None].int()
    first = 0 if part == "B" else 1
    for i in range(steps):
        if feed is not None:
            tok = t(feed[i])
        fed.append(tok.cpu().numpy())
        logits, cache = timed(lambda: runner.serve_step(
            params, cache, {"tokens": tok}, start + i))
        if on_logits:
            on_logits(first + i, logits)
        tok = logits.argmax(-1)[:, None].int()
    return np.stack(fed), ms, cache


def _whisper_calls(runner, params, cache, inp, t, timed, *, feed,
                   on_logits):
    """The whisper part's calls (see ``SERVE_WHISPER``), each through
    ``timed``: the prefill_step's last position's logits are call 0, each
    serve_step's the next; ``feed`` and ``on_logits`` as in
    ``_serve_calls``.  Writes ``cache`` in place; returns the tokens
    fed."""
    audio, prompt = t(inp["whisper_audio"]), inp["whisper_prompt"]
    n_prompt, steps = prompt.shape[1], int(inp["whisper_steps"])
    logits = timed(lambda: runner.prefill_step(
        params, {"tokens": t(prompt), "audio_embeds": audio}))
    if on_logits:
        on_logits(0, logits[:, -1])
    fed = []
    for i in range(n_prompt + steps):
        if i < n_prompt:
            tok = t(prompt[:, i:i + 1])
        elif feed is not None:
            tok = t(feed[i])
        else:
            tok = logits.argmax(-1)[:, None].int()
        fed.append(tok.cpu().numpy())
        logits, _ = timed(lambda: runner.serve_step(
            params, cache, {"tokens": tok, "audio_embeds": audio}, i))
        if on_logits:
            on_logits(1 + i, logits)
    return np.stack(fed)


def _serve_parts(reduced: bool, dtype: str = "float32"):
    """The serve_multi runs as (part, config, mode, mesh dims, runner
    kwargs, batch, cache slots), with the flash-decoding table, the arms'
    decode steps and the inputs."""
    fd = SERVE_FD_REDUCED if reduced else SERVE_FD
    b, _, steps = SERVE_ARM_SHAPE_REDUCED if reduced else SERVE_ARM_SHAPE
    inp = serve_inputs(reduced)
    parts = []
    for part, (name, sb, cache_len, _, _) in fd.items():
        parts.append((part, serve_cfg(name, sb, reduced, dtype), "fsdp",
                      (2, 1),
                      dict(shard_cache_len=True, zero_data=False), 1,
                      cache_len))
    arm_cache = inp["arm_prompt"].shape[1] + steps
    for part, mode in SERVE_ARMS.items():
        parts.append((part, serve_cfg("stablelm-1.6b", None, reduced,
                                      dtype), mode,
                      (1, 2), SERVE_ARM_KW.get(part, {}), b, arm_cache))
    wb, wp, ws = SERVE_WHISPER_REDUCED if reduced else SERVE_WHISPER
    parts.append(("whisper", serve_cfg("whisper-base", None, reduced, dtype),
                  "pipeline", (1, 2), dict(schedule="1f1b"), wb, wp + ws))
    return parts, fd, steps, inp


def serve_multi_refs(dev, workdir: pathlib.Path, reduced: bool) -> dict:
    """The one-process runs the serve_multi ranks are held to, in this
    process before the world starts: each part's runner on a 1 x 1 mesh,
    the seed-0 weights, greedy decoding; the tokens it fed and every call's
    logits (host, f32) to ``workdir/serve_<part>.pt``, the inputs to
    ``workdir/serve_inputs.npz``."""
    from repro_torch.dist import api as A
    parts, fd, steps, inp = _serve_parts(reduced)
    np.savez(workdir / "serve_inputs.npz", **inp)
    out = {}
    for part, cfg, mode, _, _, b, cache_len in parts:
        _free()
        runner = A.build_runner(cfg, mode, device=dev)
        params = runner.init(seed=0)
        cache = _seeded_cache(cfg, b, cache_len, fd["B"][3], dev) \
            if part == "B" else runner.init_cache(b, cache_len)
        logits = []
        fed, ms, cache = _serve_calls(
            runner, params, cache, inp, part, fd=fd, arm_steps=steps,
            on_logits=lambda i, lg: logits.append(lg.float().cpu()))
        torch.save({"fed": torch.from_numpy(fed),
                    "logits": torch.stack(logits)},
                   workdir / f"serve_{part}.pt")
        out[part] = dict(call_ms=ms, calls=len(logits))
        log(f"[serve_multi {part} one process] {cfg.name} {mode}: "
            f"{len(logits)} calls, first ms {[round(x, 2) for x in ms[:3]]}")
        del runner, params, cache, logits
    _free()
    return out


def serve_multi_worker(rank: int, workdir: pathlib.Path, dev, reduced: bool,
                       world: dict, dtype: str = "float32") -> dict:
    """One rank's serve_multi runs on the multi world: each part's runner on
    its mesh, fed the one-process run's tokens; per call, the logits'
    largest difference from the one-process run's over their largest
    |value|, the same with this rank's logits rounded to bf16 (the
    control), and whether this rank's greedy tokens are the one-process
    run's; the launches, merges and collectives of the run (counters zeroed
    just before it).  ``dtype`` is the ranks' (the one-process run's is
    what ``workdir`` holds)."""
    import torch.distributed as dist

    from repro_torch.dist import api as A
    from repro_torch.dist import comm
    from repro_torch.dist import sharding as SH
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.launch.mesh import init_mesh
    from repro_torch.models import layers as L
    parts, fd, steps, _ = _serve_parts(reduced, dtype)
    inp = dict(np.load(workdir / "serve_inputs.npz"))
    out = {}
    for part, cfg, mode, dims, kw, b, cache_len in parts:
        _free()
        mesh = init_mesh(dims, **world)
        ref = torch.load(workdir / f"serve_{part}.pt")
        want = ref["logits"].to(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        runner = A.build_runner(cfg, mode, mesh, device=dev, **kw)
        params = runner.init(seed=0)
        cache = runner.init_cache(b, cache_len)
        if part == "B":
            whole = _seeded_cache(cfg, b, cache_len, fd["B"][3], dev)
            sizes = dict(mesh.shape)
            SH.tree_map(lambda loc, w, s: loc.copy_(SH.shard_leaf(
                w, s, sizes, mesh.coords)), cache, whole,
                runner.cache_specs(whole))
            del whole
        stats = dict(rel=[], ctrl=[], same_token=[], checksum=0.0)

        def check(i, logits):
            if i == 0:          # the collectives of the first call alone
                stats["comm_first"] = dict(comm.COMM_STATS)
            w = want[i]
            top = w.abs().max().clamp_min(1e-30)
            got = logits.float()
            stats["rel"].append(float((got - w).abs().max() / top))
            stats["ctrl"].append(float((got.bfloat16().float() - w)
                                       .abs().max() / top))
            stats["same_token"].append(bool(
                (got.argmax(-1) == w.argmax(-1)).all()))
            stats["checksum"] += float(got.double().sum())
        comm.reset_stats()
        L.FLASH_STATS["lse_merges"] = 0
        decode_attention.launches = 0
        FA.flash_attention.launches = 0
        dist.barrier()
        _, ms, cache = _serve_calls(
            runner, params, cache, inp, part, fd=fd, arm_steps=steps,
            feed=ref["fed"].numpy(), on_logits=check)
        n_prefill = 0 if part == "B" else 1
        out[part] = dict(
            mesh=list(dims), mode=mode, model=cfg.name, calls=len(ms),
            prefill_ms=ms[:n_prefill], decode_ms=ms[n_prefill:],
            worst_rel=max(stats["rel"]), ctrl_bf16=min(stats["ctrl"]),
            tokens_same=sum(stats["same_token"]),
            checksum=stats["checksum"],
            decode_launches=decode_attention.launches,
            flash_launches=FA.flash_attention.launches,
            lse_merges=L.FLASH_STATS["lse_merges"],
            comm=dict(comm.COMM_STATS), comm_first=stats["comm_first"],
            cache_bytes=sum(t.numel() * t.element_size()
                            for t in _leaves_of(cache)),
            peak_mem_gb=(torch.cuda.max_memory_allocated() / 1e9
                         if dev.type == "cuda" else 0.0))
        log(f"[serve_multi {part} rank {rank}] decode ms "
            f"{statistics.median(out[part]['decode_ms']):.2f} (median), "
            f"worst rel {out[part]['worst_rel']:.3g} (bf16 control "
            f"{out[part]['ctrl_bf16']:.3g}), tokens same "
            f"{out[part]['tokens_same']}/{len(ms)}")
        del runner, params, cache, want, ref
        comm.release_buffers()
    return out


def _leaves_of(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves_of(v)]
    if isinstance(tree, tuple):
        return [x for v in tree for x in _leaves_of(v)]
    return [tree]


def serve_multi_want(part: str, cfg, dims, fd, steps,
                     reduced: bool = False) -> dict:
    """The launches one rank makes in a part: a decode step runs the decode
    kernel once per attention layer the rank holds (a stage its half; the
    semantic rank its branch, folded into one call), and flash-decoding
    merges the slabs once per such call; a prompt of 2048 tokens or more
    at ``cache_index`` 0 runs the flash forward once per layer (its own
    causal attention: no merge).  Whisper's stages launch the decode
    kernel for their decoder layers' self-attention only (cross-attention
    and the encoder's 1500 frames, under the flash threshold, take dense
    attention), at every serve_step, the prompt's included."""
    n_steps = fd[part][4] if part in fd else steps
    if part == "whisper":
        _, n_prompt, n_greedy = SERVE_WHISPER_REDUCED if reduced \
            else SERVE_WHISPER
        n_steps = n_prompt + n_greedy
    layers = cfg.n_layers // (dims[1] if SERVE_ARMS.get(part) == "pipeline"
                              or part == "whisper" else 1)
    prompt = fd["A"][3] if part == "A" else 0
    return dict(decode_launches=n_steps * layers,
                lse_merges=n_steps * layers if part in fd else 0,
                flash_launches=layers if prompt >= 2048 else 0)


def whisper_wire(cfg, b: int, seq: int) -> dict:
    """The bytes one call of whisper's stages on (1, 2) puts into each
    collective, by the design: stage 0 sends the encoder's [b, F, d]
    activation and then the decoder's [b, seq, d]; each rank broadcasts
    (as root or receiver) the encoder's output [b, F, d] and the f32
    logits [b, seq, vocab]."""
    act = b * cfg.d_model * _DTYPES[cfg.dtype].itemsize
    enc = act * cfg.frontend.n_tokens
    return dict(send=enc + act * seq,
                broadcast=enc + b * seq * cfg.vocab_size * 4)


def _whisper_wire_gates(part, cfg, b, per) -> dict:
    """Whisper's collectives a serve_step (the run's less its first call's,
    the prefill_step) against ``whisper_wire``, exactly: rank 0 sends,
    rank 1 only receives; staged ms a step."""
    want = whisper_wire(cfg, b, 1)
    got = []
    for r, run in enumerate(per):
        n = run["calls"] - 1
        step = {k: (run["comm"].get(f"{k}_bytes", 0)
                    - run["comm_first"].get(f"{k}_bytes", 0)) / n
                for k in ("send", "broadcast")}
        step["staged_ms"] = (run["comm"].get("staged_ms", 0.0)
                             - run["comm_first"].get("staged_ms", 0.0)) / n
        expect = dict(want, send=want["send"] if r == 0 else 0)
        if {k: step[k] for k in expect} != expect:
            raise AssertionError(f"[serve_multi {part} rank {r}] bytes a "
                                 f"serve_step {step}, want {expect}")
        got.append(step)
    return dict(want=want, ranks=got)


def serve_multi_gates(ranks, reduced: bool, card: str, refs=None) -> dict:
    """Each part's gates on both ranks' results (see ``serve_multi_worker``):
    logits within ``SERVE_LOGIT_REL`` of the one-process run's, the bf16
    control above it, the ranks' logits equal, the launches and merges the
    run implies; on the arms and whisper every greedy token the
    one-process run's; whisper's bytes a step (``_whisper_wire_gates``).
    ``refs`` (``serve_multi_refs``' record) puts the one-process run's
    median decode ms beside the ranks' in the log."""
    parts, fd, steps, _ = _serve_parts(reduced)
    out = {}
    for part, cfg, mode, dims, _, b, _ in parts:
        per = [rk["serve"][part] for rk in ranks]
        want = serve_multi_want(part, cfg, dims, fd, steps, reduced)
        lim = SERVE_LOGIT_REL[part]
        for r, run in enumerate(per):
            where = f"[serve_multi {part} rank {r}]"
            if not run["worst_rel"] <= lim:
                raise AssertionError(f"{where} logits {run['worst_rel']} of "
                                     f"their max from the one-process run's,"
                                     f" limit {lim}")
            if not run["ctrl_bf16"] > lim:
                raise AssertionError(f"{where} the gate passes bf16-rounded "
                                     f"logits ({run['ctrl_bf16']})")
            got = {k: run[k] for k in want}
            if got != want:
                raise AssertionError(f"{where} launches {got}, want {want}")
            if (part in SERVE_ARMS or part == "whisper") \
                    and run["tokens_same"] != run["calls"]:
                raise AssertionError(
                    f"{where} greedy tokens equal the one-process run's in "
                    f"{run['tokens_same']} of {run['calls']} calls")
        if per[0]["checksum"] != per[1]["checksum"]:
            raise AssertionError(f"[serve_multi {part}] the ranks' logits "
                                 f"differ ({per[0]['checksum']}, "
                                 f"{per[1]['checksum']})")
        wire = _whisper_wire_gates(part, cfg, b, per) \
            if part == "whisper" else None
        out[part] = per
        # the one-process run's decode calls: all but A's and the arms'
        # prompt and whisper's prefill_step
        one = refs[part]["call_ms"][part != "B":] if refs else None
        log(f"[serve_multi {part}] {card} | " + json.dumps(dict(
            model=cfg.name, mode=mode, mesh=dims, limit=lim,
            one_process_decode_ms_median=statistics.median(one)
            if one else None, wire=wire, ranks=[dict(
                prefill_ms=r["prefill_ms"],
                decode_ms_median=statistics.median(r["decode_ms"]),
                worst_rel=r["worst_rel"], ctrl_bf16=r["ctrl_bf16"],
                tokens_same=r["tokens_same"], calls=r["calls"],
                decode_launches=r["decode_launches"],
                flash_launches=r["flash_launches"],
                lse_merges=r["lse_merges"], comm=r["comm"],
                cache_bytes=r["cache_bytes"], peak_mem_gb=r["peak_mem_gb"])
                for r in per])))
    return out


# ----------------------------------------------------- the engine, ranks
#: ``TorchBackend`` on a process-group mesh (the gang path through the
#: runners; rank 0 drives the engine, rank 1 follows its headers) on each
#: of these meshes, against a one-process backend on the same seed
ENGINE_MESHES = ((2, 1), (1, 2))
ENGINE_SHAPE = dict(cache_len=320, max_batch=8, decode="legacy")
ENGINE_SHAPE_REDUCED = dict(cache_len=48, max_batch=8, decode="legacy")
#: requests an arm (one gang batch of 8 rows), prompt lengths [lo, hi) and
#: new tokens [lo, hi)
ENGINE_REQUESTS = (8, (64, 258), (12, 17))
ENGINE_REQUESTS_REDUCED = (8, (8, 25), (4, 9))


def engine_setup(reduced: bool):
    """The engine part's config (stablelm-1.6b, f32), backend shape and
    each arm's requests (made anew per run: they carry their outputs)."""
    from repro_torch.engine import LAYER, SEMANTIC
    cfg = serve_cfg("stablelm-1.6b", None, reduced)
    n, plen, max_new = ENGINE_REQUESTS_REDUCED if reduced \
        else ENGINE_REQUESTS
    reqs = lambda arm: gang_requests(cfg.vocab_size, n, seed=40 + arm,
                                     plen=plen, max_new=max_new)
    shape = ENGINE_SHAPE_REDUCED if reduced else ENGINE_SHAPE
    return cfg, shape, {arm: reqs for arm in (LAYER, SEMANTIC)}


def _engine_serve(backend, reqs):
    """Each arm's requests under ``FixedPolicy`` on ``backend`` (rank 0's
    or one process's), traced: ({arm: {rid: tokens}}, {arm: decode
    steps}, decode ms a step over the ``legacy_decode`` spans)."""
    from repro_torch.engine import FixedPolicy, PlacementEngine
    from repro_torch.obs import Tracer, set_tracer
    tokens, steps = {}, {}
    tracer = Tracer()
    old = set_tracer(tracer)
    try:
        for arm, make in reqs.items():
            batch = make(arm)
            before = backend.decode_steps
            eng = PlacementEngine(FixedPolicy(arm, placement=None), backend)
            eng.submit(batch)
            eng.drain()
            if any(r.output is None or r.output.shape != (r.max_new,)
                   for r in batch):
                raise AssertionError(f"[engine] arm {arm}: a request did "
                                     "not complete")
            tokens[arm] = {str(r.rid): r.output.tolist() for r in batch}
            steps[arm] = backend.decode_steps - before
    finally:
        set_tracer(old)
    dec = tracer.events("legacy_decode")
    n = sum(e[5]["steps"] for e in dec)
    return tokens, steps, 1e3 * sum(e[4] for e in dec) / 1e6 / max(n, 1)


def engine_refs(dev, reduced: bool) -> dict:
    """The one-process backend the engine part is held to, in this
    process before the world starts: each arm's tokens, decode steps and
    decode ms a step."""
    from repro_torch.engine import TorchBackend
    cfg, shape, reqs = engine_setup(reduced)
    _free()
    backend = TorchBackend(cfg, device=dev, **shape)
    tokens, steps, ms = _engine_serve(backend, reqs)
    del backend
    _free()
    log(f"[engine one process] {cfg.name}: decode ms a step {ms:.2f}, "
        f"steps {steps}")
    return dict(tokens={str(a): t for a, t in tokens.items()}, steps=steps,
                decode_ms=ms)


def engine_worker(rank: int, dev, reduced: bool, world: dict) -> dict:
    """One rank of the engine part on each of ``ENGINE_MESHES``: the
    backend built on the mesh; rank 0 serves each arm's requests under
    ``FixedPolicy`` and closes it, rank 1 follows.  The counters
    (``decode_attention`` launches, ``COMM_STATS``) are zeroed just
    before."""
    import torch.distributed as dist

    from repro_torch.dist import comm
    from repro_torch.engine import TorchBackend
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.launch.mesh import init_mesh
    cfg, shape, reqs = engine_setup(reduced)
    out = {}
    for dims in ENGINE_MESHES:
        _free()
        mesh = init_mesh(dims, **world)
        backend = TorchBackend(cfg, mesh=mesh, device=dev, **shape)
        comm.reset_stats()
        decode_attention.launches = 0
        dist.barrier()
        t0 = time.perf_counter()
        if rank == 0:
            try:
                tokens, steps, ms = _engine_serve(backend, reqs)
            finally:
                backend.close()
            res = dict(tokens={str(a): t for a, t in tokens.items()},
                       steps=steps, decode_ms=ms,
                       metrics={k: v for k, v in
                                backend.extra_metrics().items()
                                if not isinstance(v, dict)})
        else:
            res = dict(follow=backend.follow())
        _sync(dev)
        res.update(wall_s=time.perf_counter() - t0,
                   decode_launches=decode_attention.launches,
                   comm=dict(comm.COMM_STATS),
                   held_layers={str(a): _held_attention_layers(r)
                                for a, r in backend.runners.items()})
        out[",".join(map(str, dims))] = res
        log(f"[engine {dims} rank {rank}] {res['wall_s']:.1f} s, "
            f"{res['decode_launches']} decode_attention launches")
        del backend
        comm.release_buffers()
    return out


def _held_attention_layers(runner) -> int:
    """Attention layers whose decode step a rank runs: a stage its span,
    every other layout every layer (the semantic branches in one call)."""
    cfg = runner.cfg
    n = sum(m in ("attn", "attn_local") for m, _ in cfg.pattern) \
        * cfg.n_superblocks
    return n // runner.n_stages if getattr(runner, "_staged", None) and \
        runner._staged() else n


def engine_gates(ranks, ref: dict, card: str) -> dict:
    """The engine part's gates: rank 0's tokens are the one-process
    backend's on every arm, the follower ran rank 0's batches, prefill
    calls and decode steps and took its tokens (the streams' CRC-32), and
    each rank launched ``decode_attention`` once per attention layer it
    holds per decode step."""
    out = {}
    for dims in ENGINE_MESHES:
        key = ",".join(map(str, dims))
        lead, follower = (rk["engine"][key] for rk in ranks)
        where = f"[engine {dims}]"
        if lead["tokens"] != ref["tokens"]:
            same = sum(lead["tokens"][a][r] == ref["tokens"][a][r]
                       for a in ref["tokens"] for r in ref["tokens"][a])
            raise AssertionError(f"{where} rank 0's tokens equal the "
                                 f"one-process backend's in {same} requests "
                                 f"of {sum(map(len, ref['tokens'].values()))}")
        m = lead["metrics"]
        followed = ("batches", "prefill_calls", "decode_steps",
                    "stream_digest")
        if any(follower["follow"][k] != m[k] for k in followed):
            raise AssertionError(f"{where} the follower ran "
                                 f"{follower['follow']}, rank 0 {m}")
        for r, rk in enumerate((lead, follower)):
            want = sum(rk["held_layers"][str(a)] * n
                       for a, n in lead["steps"].items())
            if rk["decode_launches"] != want:
                raise AssertionError(f"{where} rank {r} launched "
                                     f"decode_attention "
                                     f"{rk['decode_launches']} times, want "
                                     f"{want}")
        steps = m["decode_steps"]
        row = dict(mesh=dims, decode_ms=lead["decode_ms"],
                   decode_ms_one_process=ref["decode_ms"],
                   decode_steps=steps, batches=m["batches"],
                   headers_sent=m["headers_sent"] + 1,       # and the stop
                   wall_s=[lead["wall_s"], follower["wall_s"]],
                   decode_launches=[lead["decode_launches"],
                                    follower["decode_launches"]],
                   collectives_per_step=[sum(
                       v for k, v in rk["comm"].items()
                       if k.endswith("_calls")) / steps
                       for rk in (lead, follower)],
                   staged_bytes_per_step=[rk["comm"].get("staged_bytes", 0)
                                          / steps
                                          for rk in (lead, follower)],
                   comm=[lead["comm"], follower["comm"]])
        out[key] = row
        log(f"[engine {dims}] {card} | " + json.dumps(
            {k: v for k, v in row.items() if k != "comm"}))
    return out


# ----------------------------------------------- the paged engine, ranks
#: ``TorchBackend(decode="paged")`` on a process-group mesh (each rank
#: holding its stages' or branches' slice of the paged pool; rank 0
#: deciding and relaying every device call) on each mesh, with each set of
#: backend options; each held to a one-process backend of the same options
ENGINE_PAGED = (((2, 1), {}), ((1, 2), {}),
                ((1, 2), dict(kv_dtype="int8", weight_quant="int8")))
ENGINE_PAGED_SHAPE = dict(cache_len=320, max_batch=8, decode="paged",
                          block_size=16, prefill_chunk=128)
ENGINE_PAGED_SHAPE_REDUCED = dict(cache_len=48, max_batch=8, decode="paged",
                                  block_size=4, prefill_chunk=8)
#: rank 0's scheduler counters held to the one process's
PAGED_COUNTERS = ("prefix_hit_rate", "cow_copies", "preemptions",
                  "prefill_chunks", "decode_dispatches", "decoded_tokens")
#: the three prefix families' heads (not whole blocks: a probe's match ends
#: inside a block, which copy-on-write resolves)
ENGINE_PAGED_HEADS = (100, 150, 200)
ENGINE_PAGED_HEADS_REDUCED = (10, 13, 18)


def _paged_key(dims, kw) -> str:
    return ",".join(map(str, dims)) + ("/int8" if kw else "")


def paged_engine_waves(vocab: int, arm: int, reduced: bool):
    """An arm's 8 requests in three waves (all at ``arrival_s`` 0, so
    deadlines order them alike on every run): a donor of each prefix
    family; probes that share a family's head, 12-16 new tokens; two urgent
    ones (one a family's, one fresh) whose earlier deadline comes first.
    Full size: prompts of 64 to 257 tokens."""
    from repro_torch.engine import Request
    rng = np.random.default_rng(60 + arm)
    r = lambda n: rng.integers(0, vocab, n).astype(np.int32)
    heads = [r(n) for n in (ENGINE_PAGED_HEADS_REDUCED if reduced
                            else ENGINE_PAGED_HEADS)]
    tails = (2, 5, 3, 6, 4, 7) if reduced else (2, 57, 40, 30, 20, 64)
    spec = [[(np.r_[h, r(tails[0])], 30.0, 12) for h in heads],
            [(np.r_[h, r(t)], 20.0, 16) for h, t in zip(heads, tails[1:4])],
            [(np.r_[heads[1], r(tails[4])], 1.0, 12), (r(tails[5]), 1.0, 14)]]
    waves, rid = [], 0
    for wave in spec:
        waves.append([])
        for toks, sla, max_new in wave:
            waves[-1].append(Request(rid=rid, app_id=rid % 3, tokens=toks,
                                     sla_s=sla, max_new=max_new,
                                     arrival_s=0.0))
            rid += 1
    return waves


def _paged_engine_serve(backend, cfg, reduced: bool) -> dict:
    """Each arm's waves under ``FixedPolicy`` on ``backend`` (rank 0's or
    one process's; colocated or disaggregated), traced: the donors
    drained, two steps into the probes, the urgent wave, drained; the
    pools checked unwound.  Returns {arm: {rid: tokens}}, the counters
    (``PAGED_COUNTERS``; ``DISAGG_COUNTERS`` and the fault counters on a
    disaggregated backend), {arm: (prefill chunks, decode steps)}, decode ms a step over
    the ``decode_scan`` and ``decode_read`` spans and
    ``ship_overlap_frac``."""
    from repro_torch.engine import FixedPolicy, PlacementEngine
    from repro_torch.obs import Tracer, set_tracer
    tokens = {}
    tracer = Tracer()
    old = set_tracer(tracer)
    try:
        for arm in list(backend._paged) + list(backend._disagg):
            waves = paged_engine_waves(cfg.vocab_size, arm, reduced)
            eng = PlacementEngine(FixedPolicy(arm, placement=None), backend)
            eng.submit(waves[0])
            eng.drain()
            eng.submit(waves[1])
            eng.step()
            eng.step()
            eng.submit(waves[2])
            eng.drain()
            reqs = [q for w in waves for q in w]
            if any(q.output is None or q.output.shape != (q.max_new,)
                   for q in reqs):
                raise AssertionError(f"[engine paged] arm {arm}: a request "
                                     "did not complete")
            tokens[str(arm)] = {str(q.rid): q.output.tolist() for q in reqs}
    finally:
        set_tracer(old)
    _check_unwound(backend, "engine paged")
    m = backend.extra_metrics()
    keys = DISAGG_COUNTERS + tuple(k for k in m if k.startswith("fault")) \
        if backend._disagg else PAGED_COUNTERS
    workers = {a: (s, s) for a, s in backend._paged.items()}
    workers.update({a: (pf, dc) for a, (pf, dc, _) in backend._disagg.items()})
    calls = {str(a): (_bucket_steps(pf, "prefill"), _bucket_steps(dc, "decode"))
             for a, (pf, dc) in workers.items()}
    steps = sum(d for _, d in calls.values())
    dec = tracer.events("decode_scan") + tracer.events("decode_read")
    return dict(tokens=tokens, counters={k: m[k] for k in keys}, calls=calls,
                decode_ms=1e3 * sum(e[4] for e in dec) / 1e6 / max(steps, 1),
                ship_overlap_frac=m.get("ship_overlap_frac"))


def engine_paged_refs(dev, reduced: bool) -> dict:
    """The one-process paged backends the ranks are held to, in this
    process before the world starts: per option set, each arm's tokens,
    the counters and decode ms a step."""
    from repro_torch.engine import TorchBackend
    cfg, _, _ = engine_setup(reduced)
    shape = ENGINE_PAGED_SHAPE_REDUCED if reduced else ENGINE_PAGED_SHAPE
    out = {}
    for _, kw in ENGINE_PAGED:
        tag = "int8" if kw else "f32"
        if tag in out:
            continue
        _free()
        backend = TorchBackend(cfg, device=dev, **shape, **kw)
        got = _paged_engine_serve(backend, cfg, reduced)
        m = backend.extra_metrics()
        out[tag] = dict(got, quant=m.get("weight_quant_max_err"),
                        quant_mean=m.get("weight_quant_mean_err"))
        del backend
        log(f"[engine paged one process {tag}] {cfg.name}: decode ms a "
            f"step {got['decode_ms']:.2f}, {got['counters']}")
    _free()
    return out


def _count_paged_plain():
    """On the CPU (a rehearsal), each plain call of the paged kernels and
    of ``quant_matmul`` from the paged forward counts as the launch its
    CUDA wrapper would make, on the path it would take."""
    from repro_torch.decode import paged_model as PM
    from repro_torch.kernels import _paged_launch as PL
    from repro_torch.kernels import _quant_launch as QL
    from repro_torch.kernels import paged_decode_attention as PD
    from repro_torch.kernels import paged_prefill_attention as PP
    from repro_torch.kernels import quant_matmul as QM

    def prefill(q, *a, **kw):
        PP.paged_prefill_attention.launches += 1
        PL.PATH_LAUNCHES[PL.path_for(q.dtype, True)] += 1
        return PP.paged_prefill_attention_plain(q, *a, **kw)

    def decode(q, *a, **kw):
        PD.paged_decode_attention.launches += 1
        PL.PATH_LAUNCHES["decode_split"] += 1
        return PD.paged_decode_attention_plain(q, *a, **kw)

    def quant(x, q, sc):
        QM.quant_matmul.launches += 1
        d, e = x.shape[-1], q.shape[-1]
        QL.PATH_LAUNCHES[QL.path_for(
            x.dtype, x.shape[-2], d, e, d // sc.shape[-2],
            QM.infer_bits(d, q))] += 1
        return QM.quant_matmul_plain(x, q, sc)
    PM.paged_prefill_attention = prefill
    PM.paged_decode_attention = decode
    PM.quant_matmul = quant


def _decode_comm(scheds) -> dict:
    """Wrap the ``call`` of each arm's decoding scheduler (``{arm:
    sched}``): ``COMM_STATS`` summed over its decode calls, by arm (on
    rank 0 the relay of each call's header and host arrays included; a
    follower receives those before its call), and the lane-steps (pow2
    width x loop length) the calls ran."""
    from collections import defaultdict

    from repro_torch.dist import comm
    acc = {}
    for arm, sched in scheds.items():
        def call(kind, key, host, orig=sched.call,
                 mine=acc.setdefault(str(arm), defaultdict(float))):
            if kind != "decode":
                return orig(kind, key, host)
            before = dict(comm.COMM_STATS)
            out = orig(kind, key, host)
            for k, v in comm.COMM_STATS.items():
                mine[k] += v - before.get(k, 0.0)
            mine["lane_steps"] += key[0] * key[1]
            return out
        sched.call = call
    return acc


def engine_paged_worker(rank: int, dev, reduced: bool, world: dict) -> dict:
    """One rank of each ``ENGINE_PAGED`` run: the paged backend built on
    the mesh; rank 0 serves each arm's waves and closes it, rank 1
    follows.  The paged and quant launches by path and ``COMM_STATS`` are
    zeroed just before; each arm's held attention layers and this rank's
    pool bytes recorded."""
    import torch.distributed as dist

    from repro_torch.dist import comm
    from repro_torch.engine import TorchBackend
    from repro_torch.kernels import _paged_launch as PL
    from repro_torch.kernels import _quant_launch as QL
    from repro_torch.launch.mesh import init_mesh
    cfg, _, _ = engine_setup(reduced)
    shape = ENGINE_PAGED_SHAPE_REDUCED if reduced else ENGINE_PAGED_SHAPE
    out = {}
    for dims, kw in ENGINE_PAGED:
        _free()
        mesh = init_mesh(dims, **world)
        backend = TorchBackend(cfg, mesh=mesh, device=dev, **shape, **kw)
        decode_comm = _decode_comm(backend._paged)
        comm.reset_stats()
        paths0, qpaths0 = dict(PL.PATH_LAUNCHES), dict(QL.PATH_LAUNCHES)
        dist.barrier()
        t0 = time.perf_counter()
        if rank == 0:
            try:
                res = _paged_engine_serve(backend, cfg, reduced)
            finally:
                backend.close()
            res["metrics"] = {k: v for k, v in backend.extra_metrics().items()
                              if not isinstance(v, dict)}
        else:
            res = dict(follow=backend.follow())
        _sync(dev)
        res.update(
            wall_s=time.perf_counter() - t0, comm=dict(comm.COMM_STATS),
            decode_comm={a: dict(c) for a, c in decode_comm.items()},
            paths={k: PL.PATH_LAUNCHES[k] - paths0[k] for k in paths0},
            quant_paths={k: QL.PATH_LAUNCHES[k] - qpaths0[k]
                         for k in qpaths0},
            held_layers={str(a): _held_attention_layers(r)
                         for a, r in backend.runners.items()},
            pool_bytes={str(a): _tree_bytes(s.pool)
                        for a, s in backend._paged.items()})
        key = _paged_key(dims, kw)
        out[key] = res
        log(f"[engine paged {key} rank {rank}] {res['wall_s']:.1f} s, "
            f"launches {res['paths']} quant {res['quant_paths']}")
        del backend
        comm.release_buffers()
    return out


def _tree_bytes(pool) -> int:
    """Bytes of a paged pool's leaves."""
    return sum(t.numel() * t.element_size() for e in pool.values()
               for t in e.values())


def _paged_engine_launches(row: dict, name: str) -> int:
    """A paged engine run's launches of kernel ``name`` on both ranks."""
    keys = {"paged_prefill_attention": ("prefill_simt", "prefill_mma"),
            "paged_decode_attention": ("decode_split",),
            "quant_matmul": ("quant_simt", "quant_mma_skinny",
                             "quant_mma_tile")}[name]
    return sum(r.get(k, 0) for r in row["launches"] for k in keys)


def engine_paged_gates(ranks, ref: dict, card: str) -> dict:
    """The paged engine runs' gates: rank 0's tokens and counters (prefix
    hit rate, COW copies, preemptions, chunks, dispatches) are the
    one-process backend's, and so is its weight-quant telemetry (the max
    error exactly, the mean within 1e-6: each rank sums its slices' errors
    and the ranks' sums are added); the follower made rank 0's calls (its
    chunks, dispatches and COW copies and the CRC-32 of its decode tokens
    equal rank 0's); each rank launched one prefill (``prefill_simt``: f32 q) per
    held attention layer a chunk and one ``decode_split`` per held layer a
    decode step, and with ``weight_quant`` four ``quant_matmul`` (``simt``)
    per held layer a chunk or step, and nothing else."""
    out = {}
    followed = ("prefill_chunks", "decode_dispatches", "cow_copies",
                "stream_digest")
    for dims, kw in ENGINE_PAGED:
        key = _paged_key(dims, kw)
        want = ref["int8" if kw else "f32"]
        lead, follower = (rk["engine_paged"][key] for rk in ranks)
        where = f"[engine paged {key}]"
        if lead["tokens"] != want["tokens"]:
            same = sum(lead["tokens"][a][r] == want["tokens"][a][r]
                       for a in want["tokens"] for r in want["tokens"][a])
            raise AssertionError(f"{where} rank 0's tokens equal the "
                                 f"one-process backend's in {same} requests")
        if lead["counters"] != want["counters"]:
            raise AssertionError(f"{where} counters {lead['counters']}, "
                                 f"one process {want['counters']}")
        if not (want["counters"]["cow_copies"] > 0
                and want["counters"]["prefix_hit_rate"] > 0):
            raise AssertionError(f"{where} no prefix hit or COW copy "
                                 f"({want['counters']})")
        m = lead["metrics"]
        if m.get("weight_quant_max_err") != want["quant"] or (
                kw and abs(m["weight_quant_mean_err"] - want["quant_mean"])
                > 1e-6):
            raise AssertionError(
                f"{where} weight-quant error max {m.get('weight_quant_max_err')}"
                f" mean {m.get('weight_quant_mean_err')}, one process "
                f"{want['quant']} and {want['quant_mean']}")
        if any(follower["follow"][k] != m[k] for k in followed):
            raise AssertionError(f"{where} the follower ran "
                                 f"{follower['follow']}, rank 0 {m}")
        for r, rk in enumerate((lead, follower)):
            held = rk["held_layers"]
            chunks = sum(held[a] * c for a, (c, _) in lead["calls"].items())
            steps = sum(held[a] * d for a, (_, d) in lead["calls"].items())
            got = {p: n for p, n in rk["paths"].items() if n}
            exp = {"prefill_simt": chunks, "decode_split": steps}
            qgot = {p: n for p, n in rk["quant_paths"].items() if n}
            qexp = {"simt": 4 * (chunks + steps)} if kw else {}
            if got != exp or qgot != qexp:
                raise AssertionError(f"{where} rank {r} launched {got} and "
                                     f"quant {qgot}, want {exp} and {qexp}")
        steps = sum(d for _, d in lead["calls"].values())
        row = dict(
            mesh=dims, options=kw, decode_ms=lead["decode_ms"],
            decode_ms_one_process=want["decode_ms"], decode_steps=steps,
            counters=lead["counters"], headers_sent=m["headers_sent"] + 1,
            wall_s=[lead["wall_s"], follower["wall_s"]],
            # by arm and rank: a decode step's collectives, the bytes put
            # into them and the bytes staged through the host
            decode_comm_per_step={a: [{k: v / max(d, 1) for k, v in
                                       rk["decode_comm"][a].items()
                                       if not k.endswith("_ms")}
                                      for rk in (lead, follower)]
                                  for a, (_, d) in lead["calls"].items()},
            launches=[dict(rk["paths"], **{"quant_" + k: v for k, v in
                                           rk["quant_paths"].items()})
                      for rk in (lead, follower)],
            pool_bytes=[lead["pool_bytes"], follower["pool_bytes"]])
        out[key] = row
        log(f"[engine paged {key}] {card} | " + json.dumps(row))
    return out


# -------------------------------------------- the disaggregated engine, ranks
#: ``TorchBackend(fleet="disagg")`` on a process-group mesh (each rank
#: holding its slice of both workers' pools; rank 0 deciding and relaying
#: every worker call and ship wave), on each mesh, clean and under the
#: ship-fault plan; each held to a one-process disaggregated backend of the
#: same options and plan
ENGINE_DISAGG = (((2, 1), None), ((1, 2), None), ((1, 2), "faults"))
#: the fault run's plan (the step counter its clock): the first ship wave
#: from step 2 loses its marks, the first from step 4 gets them a second
#: late; with ship expiry at 0 s both shipments expire at the step that
#: shipped them, on every run alike, and their requests re-prefill
ENGINE_DISAGG_PLAN = ((2.0, "ship_drop", 0.0), (4.0, "ship_delay", 1.0))
ENGINE_DISAGG_SEED = 11
#: rank 0's counters held to the one process's
DISAGG_COUNTERS = PAGED_COUNTERS + (
    "blocks_shipped", "ship_waves", "ship_skipped_blocks", "transfer_bytes",
    "ship_deferred", "decode_spills", "ship_requeues", "ship_dropped_waves",
    "ship_retries", "kv_block_bytes")
#: the follower's counts held to rank 0's
DISAGG_FOLLOWED = ("prefill_chunks", "decode_dispatches", "cow_copies",
                   "ship_waves", "blocks_shipped", "stream_digest")


def _disagg_key(dims, faults) -> str:
    return ",".join(map(str, dims)) + (f"/{faults}" if faults else "")


def _disagg_kw(faults) -> dict:
    """The backend options of a disaggregated engine run: its plan built
    anew (an injector consumes it)."""
    from repro_torch import faults as F
    kw = dict(fleet="disagg")
    if faults:
        kw.update(ship_timeout_s=0.0, faults=F.FaultPlan(
            [F.Fault(at=at, kind=kind, magnitude=mag)
             for at, kind, mag in ENGINE_DISAGG_PLAN],
            seed=ENGINE_DISAGG_SEED))
    return kw


def engine_disagg_refs(dev, reduced: bool) -> dict:
    """The one-process disaggregated backends the ranks are held to, in
    this process before the world starts: clean and under the plan, each
    arm's tokens, the counters, decode ms a step and
    ``ship_overlap_frac``."""
    from repro_torch.engine import TorchBackend
    cfg, _, _ = engine_setup(reduced)
    shape = ENGINE_PAGED_SHAPE_REDUCED if reduced else ENGINE_PAGED_SHAPE
    out = {}
    for faults in sorted({f or "" for _, f in ENGINE_DISAGG}):
        _free()
        backend = TorchBackend(cfg, device=dev, **shape,
                               **_disagg_kw(faults))
        got = out[faults or "clean"] = _paged_engine_serve(backend, cfg,
                                                           reduced)
        del backend
        log(f"[engine disagg one process {faults or 'clean'}] {cfg.name}: "
            f"decode ms a step {got['decode_ms']:.2f}, overlap "
            f"{got['ship_overlap_frac']}, {got['counters']}")
    _free()
    return out


def engine_disagg_worker(rank: int, dev, reduced: bool, world: dict) -> dict:
    """One rank of each ``ENGINE_DISAGG`` run: the disaggregated backend
    built on the mesh; rank 0 serves each arm's waves and closes it, rank 1
    follows.  The paged launches by path and ``COMM_STATS`` are zeroed just
    before; the launches by worker, each arm's held attention layers, this
    rank's calls and each worker's pool bytes recorded."""
    import torch.distributed as dist

    from repro_torch.dist import comm
    from repro_torch.engine import TorchBackend
    from repro_torch.kernels import _paged_launch as PL
    from repro_torch.launch.mesh import init_mesh
    cfg, _, _ = engine_setup(reduced)
    shape = ENGINE_PAGED_SHAPE_REDUCED if reduced else ENGINE_PAGED_SHAPE
    out = {}
    for dims, faults in ENGINE_DISAGG:
        _free()
        mesh = init_mesh(dims, **world)
        backend = TorchBackend(cfg, mesh=mesh, device=dev, **shape,
                               **_disagg_kw(faults))
        roles = _new_roles()
        _by_role(backend, roles)
        decode_comm = _decode_comm({a: dc for a, (_, dc, _) in
                                    backend._disagg.items()})
        comm.reset_stats()
        paths0 = dict(PL.PATH_LAUNCHES)
        dist.barrier()
        t0 = time.perf_counter()
        if rank == 0:
            try:
                res = _paged_engine_serve(backend, cfg, reduced)
            finally:
                backend.close()
            res["metrics"] = {k: v for k, v in backend.extra_metrics().items()
                              if not isinstance(v, dict)}
        else:
            res = dict(follow=backend.follow())
        _sync(dev)
        res.update(
            wall_s=time.perf_counter() - t0, comm=dict(comm.COMM_STATS),
            decode_comm={a: dict(c) for a, c in decode_comm.items()},
            paths={k: PL.PATH_LAUNCHES[k] - paths0[k] for k in paths0},
            roles=roles,
            calls={str(a): (_bucket_steps(pf, "prefill"),
                            _bucket_steps(dc, "decode"))
                   for a, (pf, dc, _) in backend._disagg.items()},
            held_layers={str(a): _held_attention_layers(r)
                         for a, r in backend.runners.items()},
            pool_bytes={str(a): [_tree_bytes(w.pool) for w in (pf, dc)]
                        for a, (pf, dc, _) in backend._disagg.items()},
            # one process's pool of the arm, from its shapes on meta
            whole_pool={str(a): _tree_bytes(backend.runners[a].whole_pool(
                pf.alloc.num_blocks, pf.block_size))
                for a, (pf, _, _) in backend._disagg.items()},
            d_model=cfg.d_model)
        key = _disagg_key(dims, faults)
        out[key] = res
        log(f"[engine disagg {key} rank {rank}] {res['wall_s']:.1f} s, "
            f"launches by worker {roles}")
        del backend
        comm.release_buffers()
    return out


def engine_disagg_gates(ranks, ref: dict, card: str) -> dict:
    """The disaggregated engine runs' gates: rank 0's tokens and counters
    (scheduler, ship and fault) are the one-process backend's of the same
    plan; the follower made rank 0's calls and ship waves (its chunks,
    dispatches, COW copies, ship waves, blocks and the CRC-32 of its decode
    tokens equal rank 0's); on each rank the prefill workers launched one
    ``prefill_simt`` per held attention layer a chunk and the decode
    workers one ``decode_split`` per held layer a step, and nothing else
    launched; on (1, 2) the decode calls put the activation ([W, 1, d] f32
    a step) into LAYER's one send and a (max, index) pair a lane into
    SEMANTIC's all-gather; each worker's pool is the rank's slice of one
    process's."""
    from repro_torch.engine import LAYER, SEMANTIC
    out = {}
    for dims, faults in ENGINE_DISAGG:
        key = _disagg_key(dims, faults)
        want = ref[faults or "clean"]
        lead, follower = (rk["engine_disagg"][key] for rk in ranks)
        where = f"[engine disagg {key}]"
        if lead["tokens"] != want["tokens"]:
            same = sum(lead["tokens"][a][r] == want["tokens"][a][r]
                       for a in want["tokens"] for r in want["tokens"][a])
            raise AssertionError(f"{where} rank 0's tokens equal the "
                                 f"one-process backend's in {same} requests")
        if lead["counters"] != want["counters"]:
            raise AssertionError(f"{where} counters {lead['counters']}, "
                                 f"one process {want['counters']}")
        c = want["counters"]
        if not (c["blocks_shipped"] > 0 and c["prefix_hit_rate"] > 0
                and c["cow_copies"] > 0) or (faults and not (
                    c["ship_dropped_waves"] > 0 and c["ship_requeues"] > 0)):
            raise AssertionError(f"{where} the run missed a ship, a prefix "
                                 f"hit, a COW copy or a fault ({c})")
        m = lead["metrics"]
        if any(follower["follow"][k] != m[k] for k in DISAGG_FOLLOWED):
            raise AssertionError(f"{where} the follower ran "
                                 f"{follower['follow']}, rank 0 {m}")
        for r, rk in enumerate((lead, follower)):
            held = rk["held_layers"]
            if rk["calls"] != lead["calls"]:
                raise AssertionError(f"{where} rank {r} ran calls "
                                     f"{rk['calls']}, rank 0 {lead['calls']}")
            chunks = sum(held[a] * n for a, (n, _) in rk["calls"].items())
            steps = sum(held[a] * n for a, (_, n) in rk["calls"].items())
            zero = dict.fromkeys(rk["roles"]["prefill"], 0)
            exp = {"prefill": dict(zero, paged_prefill_attention=chunks),
                   "decode": dict(zero, paged_decode_attention=steps)}
            got = {p: n for p, n in rk["paths"].items() if n}
            if rk["roles"] != exp or got != {"prefill_simt": chunks,
                                             "decode_split": steps}:
                raise AssertionError(f"{where} rank {r} launched "
                                     f"{rk['roles']} by worker ({got}), "
                                     f"want {exp}")
            for arm, pair in rk["pool_bytes"].items():
                split = dims[1] if int(arm) in (LAYER, SEMANTIC) else 1
                whole = rk["whole_pool"][arm]
                if pair != [whole // split] * 2:
                    raise AssertionError(f"{where} rank {r} arm {arm} pools "
                                         f"{pair} bytes, want {whole} / "
                                         f"{split} each")
            dcomm = rk["decode_comm"]
            layer, sem = dcomm[str(LAYER)], dcomm[str(SEMANTIC)]
            if dims[1] == 1 and any(
                    arm_comm.get(k, 0) for arm_comm in dcomm.values()
                    for k in ("send_bytes", "all_gather_bytes")):
                raise AssertionError(f"{where} rank {r}: a decode call "
                                     f"sent or gathered ({dcomm})")
            if dims[1] > 1:
                act = layer["lane_steps"] * rk["d_model"] * 4
                if layer.get("send_bytes", 0) != (act if r == 0 else 0):
                    raise AssertionError(
                        f"{where} rank {r} LAYER decode sends "
                        f"{layer.get('send_bytes', 0)} B, want {act}")
                if sem.get("all_gather_bytes", 0) != sem["lane_steps"] * 8:
                    raise AssertionError(
                        f"{where} rank {r} SEMANTIC decode all-gathers "
                        f"{sem.get('all_gather_bytes', 0)} B, want "
                        f"{sem['lane_steps'] * 8}")
        steps = sum(d for _, d in want["calls"].values())
        row = dict(
            mesh=dims, faults=faults, decode_ms=lead["decode_ms"],
            decode_ms_one_process=want["decode_ms"], decode_steps=steps,
            ship_overlap_frac=lead["ship_overlap_frac"],
            ship_overlap_frac_one_process=want["ship_overlap_frac"],
            counters=lead["counters"], headers_sent=m["headers_sent"] + 1,
            wall_s=[lead["wall_s"], follower["wall_s"]],
            decode_comm_per_step={a: [{k: v / max(d, 1) for k, v in
                                       rk["decode_comm"][a].items()
                                       if not k.endswith("_ms")}
                                      for rk in (lead, follower)]
                                  for a, (_, d) in want["calls"].items()},
            launches=[rk["paths"] for rk in (lead, follower)],
            launches_by_worker=[rk["roles"] for rk in (lead, follower)],
            pool_bytes=[lead["pool_bytes"], follower["pool_bytes"]])
        out[key] = row
        log(f"[engine disagg {key}] {card} | " + json.dumps(row))
    return out


# ------------------------------------------- the engine fleet, pinned
#: ``FleetBackend`` of ``ENGINE_FLEET_REPLICAS`` colocated paged replicas
#: (the LAYER arm) on a process-group mesh under ``PrefixAwareRouter``:
#: rank 0 routes, runs every replica's engine and relays each replica's
#: calls, the header naming the replica; on each of these meshes
ENGINE_FLEET = ((1, 2), (2, 1))
ENGINE_FLEET_REPLICAS = 2
#: a pass's requests and waves, the passes (warm, measured), the prefix
#: families and their head tokens, tail tokens [lo, hi), new tokens [lo,
#: hi): full size, then reduced
ENGINE_FLEET_LOAD = dict(n=12, waves=4, passes=2, families=4, head=128,
                         tail=(8, 41), new=(8, 17))
ENGINE_FLEET_LOAD_REDUCED = dict(n=12, waves=4, passes=2, families=4,
                                 head=16, tail=(2, 9), new=(4, 9))
#: the step clock both fleets run on (the router weighs SLA slack, so the
#: wall clock would route the two runs apart)
ENGINE_FLEET_TICK = 0.01
#: rank 0's routing, sync and scheduler counters held to one process's
FLEET_COUNTERS = ("completed", "prefix_hit_rate", "sync_deltas",
                  "tracked_hashes", "prefill_chunks", "decode_dispatches",
                  "decoded_tokens", "cow_copies", "routed_per_replica")
#: the follower's counts held to rank 0's
FLEET_FOLLOWED = ("prefill_chunks", "decode_dispatches", "cow_copies",
                  "prefill_calls", "stream_digest")
#: ``fleet_devices=(1, 0)`` on this mesh: the LAYER arm's prefill worker
#: pinned whole to rank 1, its decode worker to rank 0 (SEMANTIC, the
#: pool spent, on the runner's view); held to the one-process
#: disaggregated backend (``engine_disagg_refs``' clean run)
ENGINE_PINNED = ((1, 2), (1, 0))


@contextlib.contextmanager
def _step_clock():
    """``FleetBackend.now`` and ``TorchBackend.now`` read a counter that
    every fleet step advances by ``ENGINE_FLEET_TICK``."""
    from repro_torch.engine import FleetBackend, TorchBackend
    clock = {"t": 0.0}
    step = FleetBackend.step

    def ticking(self, policy=None):
        clock["t"] += ENGINE_FLEET_TICK
        return step(self, policy)

    saved = [(c, k, c.__dict__[k]) for c, k in
             ((FleetBackend, "now"), (TorchBackend, "now"),
              (FleetBackend, "step"))]
    now = property(lambda self: clock["t"])
    FleetBackend.now = TorchBackend.now = now
    FleetBackend.step = ticking
    try:
        yield
    finally:
        for c, k, v in saved:
            setattr(c, k, v)


def engine_fleet_requests(vocab: int, reduced: bool, seed: int, rid0: int):
    """A pass's requests: one of the families' heads (the same on every
    call) and a fresh tail, SLA 30 s (step clock)."""
    from repro_torch.engine import Request
    load = ENGINE_FLEET_LOAD_REDUCED if reduced else ENGINE_FLEET_LOAD
    heads = np.random.default_rng(200).integers(
        0, vocab, (load["families"], load["head"])).astype(np.int32)
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(load["n"]):
        fam = int(rng.integers(load["families"]))
        tail = rng.integers(0, vocab, int(rng.integers(*load["tail"])))
        reqs.append(Request(
            rid=rid0 + i, app_id=int(rng.integers(0, 3)), sla_s=30.0,
            tokens=np.concatenate([heads[fam], tail]).astype(np.int32),
            max_new=int(rng.integers(*load["new"]))))
    return reqs


def _fleet_engine_serve(fleet, cfg, reduced: bool) -> dict:
    """The passes under ``PrefixAwareRouter`` on ``fleet`` (rank 0's or one
    process's), on the step clock and traced: each wave submitted, then a
    step; then steps until the fleet is empty; every pool checked unwound.
    Returns {rid: tokens}, the counters (``FLEET_COUNTERS``), the prefill
    chunks and decode steps over the replicas, decode ms a step over the
    ``decode_scan`` and ``decode_read`` spans, and place ms a request."""
    from repro_torch.engine import (LAYER, FixedPolicy, PlacementEngine,
                                    PrefixAwareRouter)
    from repro_torch.obs import Tracer, set_tracer
    load = ENGINE_FLEET_LOAD_REDUCED if reduced else ENGINE_FLEET_LOAD
    eng = PlacementEngine(
        FixedPolicy(LAYER, placement=PrefixAwareRouter(fleet.board)), fleet)
    tokens = {}
    tracer = Tracer()
    old = set_tracer(tracer)
    try:
        with _step_clock():
            for p in range(load["passes"]):
                reqs = engine_fleet_requests(cfg.vocab_size, reduced,
                                             seed=70 + p, rid0=p * load["n"])
                per = -(-len(reqs) // load["waves"])
                for w in range(load["waves"]):
                    eng.submit(reqs[w * per:(w + 1) * per])
                    eng.step()
                for _ in range(2000):
                    if not fleet.pending():
                        break
                    eng.step()
                if any(q.output is None or q.output.shape != (q.max_new,)
                       for q in reqs):
                    raise AssertionError("[engine fleet] a request did not "
                                         "complete")
                tokens.update({str(q.rid): q.output.tolist() for q in reqs})
    finally:
        set_tracer(old)
    for rep in fleet.replicas:
        _check_unwound(rep, "engine fleet")
    m = dict(fleet.extra_metrics(), **eng.summary())
    scheds = [s for rep in fleet.replicas for s in rep._all_scheds()]
    calls = (sum(_bucket_steps(s, "prefill") for s in scheds),
             sum(_bucket_steps(s, "decode") for s in scheds))
    dec = tracer.events("decode_scan") + tracer.events("decode_read")
    return dict(tokens=tokens, counters={k: m[k] for k in FLEET_COUNTERS},
                calls=calls,
                decode_ms=1e3 * sum(e[4] for e in dec) / 1e6
                / max(calls[1], 1),
                place_ms=1e3 * fleet.place_time_s / max(len(tokens), 1))


def engine_fleet_refs(dev, reduced: bool) -> dict:
    """The one-process fleet the ranks' fleets are held to, in this
    process before the world starts."""
    from repro_torch.engine import LAYER, FleetBackend
    cfg, _, _ = engine_setup(reduced)
    shape = ENGINE_PAGED_SHAPE_REDUCED if reduced else ENGINE_PAGED_SHAPE
    _free()
    fleet = FleetBackend(cfg, n_replicas=ENGINE_FLEET_REPLICAS,
                         arms=(LAYER,), device=dev, **shape)
    out = _fleet_engine_serve(fleet, cfg, reduced)
    del fleet
    _free()
    log(f"[engine fleet one process] {cfg.name}: decode ms a step "
        f"{out['decode_ms']:.2f}, {out['counters']}")
    return out


def engine_fleet_worker(rank: int, dev, reduced: bool, world: dict) -> dict:
    """One rank of each ``ENGINE_FLEET`` run: the fleet built on the mesh;
    rank 0 serves the passes and closes it, rank 1 follows.  The paged
    launches by path and ``COMM_STATS`` are zeroed just before; the held
    layers, the steps this rank ran and what the replicas share
    recorded."""
    import torch.distributed as dist

    from repro_torch.dist import comm
    from repro_torch.engine import LAYER, FleetBackend
    from repro_torch.kernels import _paged_launch as PL
    from repro_torch.launch.mesh import init_mesh
    cfg, _, _ = engine_setup(reduced)
    shape = ENGINE_PAGED_SHAPE_REDUCED if reduced else ENGINE_PAGED_SHAPE
    out = {}
    for dims in ENGINE_FLEET:
        _free()
        mesh = init_mesh(dims, **world)
        fleet = FleetBackend(cfg, mesh=mesh,
                             n_replicas=ENGINE_FLEET_REPLICAS,
                             arms=(LAYER,), device=dev, **shape)
        comm.reset_stats()
        paths0 = dict(PL.PATH_LAUNCHES)
        dist.barrier()
        t0 = time.perf_counter()
        if rank == 0:
            try:
                res = _fleet_engine_serve(fleet, cfg, reduced)
            finally:
                fleet.close()
            res["metrics"] = {k: v for k, v in fleet.extra_metrics().items()
                              if not isinstance(v, (dict, list))}
        else:
            res = dict(follow={k: v for k, v in fleet.follow().items()
                               if k != "replicas"})
        _sync(dev)
        scheds = [s for rep in fleet.replicas for s in rep._all_scheds()]
        res.update(
            wall_s=time.perf_counter() - t0, comm=dict(comm.COMM_STATS),
            paths={k: PL.PATH_LAUNCHES[k] - paths0[k] for k in paths0},
            held=_held_attention_layers(fleet.replicas[0].runners[LAYER]),
            steps=[sum(_bucket_steps(s, k) for s in scheds)
                   for k in ("prefill", "decode")],
            runners=len({id(r.runners[LAYER]) for r in fleet.replicas}),
            pools=len({id(s.pool["pos0"]["k"]) for s in scheds}))
        key = ",".join(map(str, dims))
        out[key] = res
        log(f"[engine fleet {key} rank {rank}] {res['wall_s']:.1f} s, "
            f"launches {res['paths']}")
        del fleet, scheds
        comm.release_buffers()
    return out


def engine_fleet_gates(ranks, ref: dict, card: str) -> dict:
    """The fleet runs' gates: rank 0's tokens, routes and counters are the
    one-process fleet's (one step clock); the follower replayed every
    replica's calls (its counts and stream CRC rank 0's); on each rank one
    ``prefill_simt`` a held layer a chunk and one ``decode_split`` a held
    layer a step over both replicas, and nothing else; the replicas share
    one runner and hold a pool each."""
    out = {}
    for dims in ENGINE_FLEET:
        key = ",".join(map(str, dims))
        lead, follower = (rk["engine_fleet"][key] for rk in ranks)
        where = f"[engine fleet {key}]"
        if lead["tokens"] != ref["tokens"]:
            same = sum(lead["tokens"][r] == t for r, t in
                       ref["tokens"].items())
            raise AssertionError(f"{where} rank 0's tokens equal the "
                                 f"one-process fleet's in {same} requests")
        if lead["counters"] != ref["counters"]:
            raise AssertionError(f"{where} counters {lead['counters']}, "
                                 f"one process {ref['counters']}")
        c = ref["counters"]
        if not (c["prefix_hit_rate"] > 0 and min(c["routed_per_replica"])
                > 0):
            raise AssertionError(f"{where} the run missed a prefix hit or "
                                 f"a replica ({c})")
        m = lead["metrics"]
        if any(follower["follow"][k] != m[k] for k in FLEET_FOLLOWED):
            raise AssertionError(f"{where} the follower ran "
                                 f"{follower['follow']}, rank 0 {m}")
        for r, rk in enumerate((lead, follower)):
            want = {"prefill_simt": rk["held"] * rk["steps"][0],
                    "decode_split": rk["held"] * rk["steps"][1]}
            got = {p: n for p, n in rk["paths"].items() if n}
            if rk["steps"] != list(lead["calls"]) or got != want:
                raise AssertionError(f"{where} rank {r} launched {got} in "
                                     f"{rk['steps']} steps, want {want}")
            if (rk["runners"], rk["pools"]) != (1, ENGINE_FLEET_REPLICAS):
                raise AssertionError(
                    f"{where} rank {r}: {rk['runners']} runners, "
                    f"{rk['pools']} pools for {ENGINE_FLEET_REPLICAS} "
                    "replicas")
        row = dict(
            mesh=dims, decode_ms=lead["decode_ms"],
            decode_ms_one_process=ref["decode_ms"],
            decode_steps=lead["calls"][1], prefill_chunks=lead["calls"][0],
            place_ms=lead["place_ms"], counters=lead["counters"],
            headers_sent=m["headers_sent"] + 1,
            wall_s=[lead["wall_s"], follower["wall_s"]],
            launches=[rk["paths"] for rk in (lead, follower)],
            staged_bytes=[rk["comm"].get("staged_bytes", 0)
                          for rk in (lead, follower)])
        out[key] = row
        log(f"[engine fleet {key}] {card} | " + json.dumps(row))
    return out


def _watch_pinned_ship(store, rec: dict) -> None:
    """Wrap a pinned store's ``_ship``: per wave the non-null blocks, this
    rank's host ms of the ship and the bytes it sent; on the prefill rank
    a device copy of the wave's source blocks, on the decode rank of the
    blocks it wrote (gathers enqueued after the ship, read once the run is
    over)."""
    from repro_torch.decode.paged_cache import NULL_BLOCK, gather_blocks
    from repro_torch.dist import comm
    orig = store._ship

    def ship(wire):
        n = int(np.count_nonzero(wire[:, 0] != NULL_BLOCK))
        sent = comm.COMM_STATS.get("send_bytes", 0.0)
        t0 = time.perf_counter()
        orig(wire)
        ms = 1e3 * (time.perf_counter() - t0)
        rec["waves"].append(dict(
            blocks=n, ms=ms,
            sent=comm.COMM_STATS.get("send_bytes", 0.0) - sent))
        src, dst = store.pinned
        for side, rank, sched, col in (("src", src, store.src, 0),
                                       ("dst", dst, store.dst, 1)):
            if store.mesh.rank == rank:
                ids = torch.from_numpy(wire[:n, col].astype(np.int64)).to(
                    sched.device)
                rec[side].append(gather_blocks(sched.pool, ids))
    store._ship = ship


def _tree_crc(tree) -> list:
    """CRC-32 of each leaf's bytes, in leaf order (read to the host)."""
    import zlib

    from repro_torch.decode.paged_cache import _leaves
    return [zlib.crc32(t.contiguous().view(torch.uint8).cpu().numpy()
                       .tobytes()) for _, t in _leaves(tree)]


def engine_pinned_worker(rank: int, dev, reduced: bool, world: dict) -> dict:
    """One rank of the pinned run: the disaggregated backend on the mesh
    with ``fleet_devices`` as ranks (``ENGINE_PINNED``); rank 0 serves each
    arm's waves and closes it, rank 1 follows.  The paged launches by path
    and ``COMM_STATS`` are zeroed just before; the launches inside the
    pinned workers' calls, each wave's ship and the pools recorded."""
    import torch.distributed as dist

    from repro_torch.dist import comm
    from repro_torch.engine import LAYER, SEMANTIC, TorchBackend
    from repro_torch.kernels import _paged_launch as PL
    from repro_torch.launch.mesh import init_mesh
    cfg, _, _ = engine_setup(reduced)
    shape = ENGINE_PAGED_SHAPE_REDUCED if reduced else ENGINE_PAGED_SHAPE
    dims, pins = ENGINE_PINNED
    _free()
    mesh = init_mesh(dims, **world)
    backend = TorchBackend(cfg, mesh=mesh, device=dev, **shape,
                           fleet="disagg", fleet_devices=pins)
    pf, dc, store = backend._disagg[LAYER]
    roles = _new_roles()
    _count_by_role(pf, dc, roles)
    ship = dict(waves=[], src=[], dst=[])
    _watch_pinned_ship(store, ship)
    comm.reset_stats()
    paths0 = dict(PL.PATH_LAUNCHES)
    dist.barrier()
    t0 = time.perf_counter()
    if rank == 0:
        try:
            res = _paged_engine_serve(backend, cfg, reduced)
        finally:
            backend.close()
        res["metrics"] = {k: v for k, v in backend.extra_metrics().items()
                          if not isinstance(v, dict)}
        res["digest_for_1"] = backend.stream_digest_for(1)
        res["layer_transfer_bytes"] = store.transfer_bytes
    else:
        res = dict(follow=backend.follow())
    _sync(dev)
    res.update(
        wall_s=time.perf_counter() - t0, comm=dict(comm.COMM_STATS),
        paths={k: PL.PATH_LAUNCHES[k] - paths0[k] for k in paths0},
        roles=roles, pins=list(backend._pins[LAYER]),
        layer_steps=[_bucket_steps(pf, "prefill"),
                     _bucket_steps(dc, "decode")],
        semantic_steps=[_bucket_steps(w, k) for w, k in zip(
            backend._disagg[SEMANTIC][:2], ("prefill", "decode"))],
        layer_held=_held_attention_layers(pf.model),
        semantic_held=_held_attention_layers(backend.runners[SEMANTIC]),
        pools=[[_tree_bytes(w.pool), all(
            t.is_meta for e in w.pool.values() for t in e.values())]
            for w in (pf, dc)],
        whole_pool=pf.kv_block_bytes * pf.alloc.num_blocks,
        ship_waves=ship["waves"],
        ship_src=[_tree_crc(p) for p in ship["src"]],
        ship_dst=[_tree_crc(p) for p in ship["dst"]])
    log(f"[engine pinned rank {rank}] {res['wall_s']:.1f} s, launches "
        f"{res['paths']}, by worker {roles}")
    del backend, pf, dc, store, ship
    comm.release_buffers()
    return res


def engine_pinned_gates(ranks, ref: dict, card: str) -> dict:
    """The pinned run's gates: rank 0's tokens and counters are the
    one-process disaggregated backend's; the follower's counts rank 0's
    and its stream CRC rank 0's over the workers it holds; every wave's
    blocks landed on rank 0 bit for bit, and the bytes rank 1 sent are the
    LAYER store's ``transfer_bytes``; the LAYER prefill worker launched
    ``prefill_simt`` on rank 1 only and its decode worker ``decode_split``
    on rank 0 only, one a layer a chunk or step, and each rank launched
    nothing else but its SEMANTIC slices' (one a held layer); each pinned
    pool is whole on its rank and absent from the other."""
    dims, pins = ENGINE_PINNED
    lead, follower = (rk["engine_pinned"] for rk in ranks)
    where = "[engine pinned]"
    if lead["tokens"] != ref["tokens"]:
        raise AssertionError(f"{where} rank 0's tokens differ from the "
                             "one-process disaggregated backend's")
    if lead["counters"] != ref["counters"]:
        raise AssertionError(f"{where} counters {lead['counters']}, one "
                             f"process {ref['counters']}")
    m = lead["metrics"]
    want = dict(m, stream_digest=lead["digest_for_1"])
    if any(follower["follow"][k] != want[k] for k in DISAGG_FOLLOWED):
        raise AssertionError(f"{where} the follower ran {follower['follow']}"
                             f", rank 0 {want}")
    src, dst = ranks[pins[0]]["engine_pinned"], ranks[pins[1]]["engine_pinned"]
    if not src["ship_src"] or src["ship_src"] != dst["ship_dst"]:
        raise AssertionError(f"{where} {len(src['ship_src'])} waves sent, "
                             f"{len(dst['ship_dst'])} received; equal "
                             f"{src['ship_src'] == dst['ship_dst']}")
    sent = sum(w["sent"] for w in src["ship_waves"])
    if sent != lead["layer_transfer_bytes"] or any(
            w["sent"] for w in dst["ship_waves"]):
        raise AssertionError(f"{where} rank {pins[0]} sent {sent} B, "
                             f"transfer_bytes {lead['layer_transfer_bytes']}")
    chunks, steps = lead["layer_steps"]
    for r, rk in enumerate((lead, follower)):
        held = rk["layer_held"]
        exp = {"prefill": dict.fromkeys(rk["roles"]["prefill"], 0),
               "decode": dict.fromkeys(rk["roles"]["decode"], 0)}
        if r == pins[0]:
            exp["prefill"]["paged_prefill_attention"] = held * chunks
        if r == pins[1]:
            exp["decode"]["paged_decode_attention"] = held * steps
        sem = rk["semantic_held"]
        want_paths = {
            "prefill_simt": exp["prefill"]["paged_prefill_attention"]
            + sem * lead["semantic_steps"][0],
            "decode_split": exp["decode"]["paged_decode_attention"]
            + sem * lead["semantic_steps"][1]}
        got = {p: n for p, n in rk["paths"].items() if n}
        if rk["roles"] != exp or got != want_paths:
            raise AssertionError(f"{where} rank {r} launched {rk['roles']} "
                                 f"by worker, {got} in all; want {exp}, "
                                 f"{want_paths}")
        for i, (nbytes, meta) in enumerate(rk["pools"]):
            if (pins[i] == r) == meta or (pins[i] == r and nbytes !=
                                          lead["whole_pool"]):
                raise AssertionError(f"{where} rank {r} worker {i}: pool "
                                     f"{nbytes} B, meta {meta}")
    waves = src["ship_waves"]
    recv = dst["ship_waves"]
    gbs = [w["sent"] / (v["ms"] * 1e6) for w, v in zip(waves, recv)]
    row = dict(
        mesh=dims, pins=pins, decode_ms=lead["decode_ms"],
        decode_ms_one_process=ref["decode_ms"],
        ship_overlap_frac=lead["ship_overlap_frac"],
        ship_overlap_frac_one_process=ref["ship_overlap_frac"],
        ship_waves=len(waves), blocks=[w["blocks"] for w in waves],
        ship_ms_rank0=[round(v["ms"], 3) for v in recv],
        ship_ms_median=statistics.median(v["ms"] for v in recv),
        ship_gbps_median=statistics.median(gbs), ship_bytes=sent,
        counters=lead["counters"], headers_sent=m["headers_sent"] + 1,
        wall_s=[lead["wall_s"], follower["wall_s"]],
        launches=[rk["paths"] for rk in (lead, follower)],
        launches_by_worker=[rk["roles"] for rk in (lead, follower)])
    log(f"{where} {card} | " + json.dumps(row))
    return row


# ------------------------------------------------------------ disagg_xdev
XDEV_REQUESTS = 8


def _xdev_check(store, waves):
    """Wrap ``store._transfer``: after each wave, the blocks it wrote on
    the receiver and the blocks it read on the sender, both read back on
    the host and compared byte for byte, leaf by leaf."""
    from repro_torch.decode.cache_store import _index
    from repro_torch.decode.paged_cache import _leaves, gather_blocks
    transfer = store._transfer

    def checked(src_ids, dst_ids):
        copies = store.xdev_copies
        t0 = time.perf_counter()
        transfer(src_ids, dst_ids)
        _sync(store.src.device)
        _sync(store.dst.device)
        ms = 1e3 * (time.perf_counter() - t0)
        a = gather_blocks(store.src.pool, _index(
            np.asarray(src_ids, np.int64), store.src.device))
        b = gather_blocks(store.dst.pool, _index(
            np.asarray(dst_ids, np.int64), store.dst.device))
        same = all(torch.equal(x.cpu().view(torch.uint8),
                               y.cpu().view(torch.uint8))
                   for (_, x), (_, y) in zip(_leaves(a), _leaves(b)))
        waves.append(dict(blocks=len(src_ids), same=same, ms=ms,
                          copies=store.xdev_copies - copies,
                          leaves=len(list(_leaves(a)))))
    store._transfer = checked


def disagg_xdev_phase(dev, cfg):
    """``TorchBackend(fleet="disagg", fleet_devices=...)`` with the prefill
    worker on ``cuda:0`` and the decode worker on ``cuda:1`` (two cards) or
    the CPU (one): stablelm-1.6b at full width cut to 2 superblocks, f32
    (its pools too), LAYER under ``FixedPolicy``, 8 lanes, 8 requests with
    distinct prompts; then the same requests on the same-device fleet.
    Every wave's received blocks must equal the sent ones bit for bit (read
    back on the host), with one cross-device copy a pool leaf; the ship
    counters must equal the same-device run's; every request completes.
    Tokens are gated equal to the same-device run's on two cards; with the
    decode worker on the CPU (the plain versions, another summation order)
    their share is reported."""
    from repro_torch.engine import (LAYER, FixedPolicy, PlacementEngine,
                                    TorchBackend)
    cfg = cfg.replace(n_layers=2 * len(cfg.pattern), dtype="float32")
    two = torch.cuda.device_count() >= 2 if dev.type == "cuda" else False
    dst = torch.device("cuda:1") if two else torch.device("cpu")
    src = torch.device("cuda:0") if dev.type == "cuda" else dev
    counters = _counters()
    runs = {}
    for name, devices in (("same", None), ("xdev", [src, dst])):
        backend = TorchBackend(cfg, max_batch=XDEV_REQUESTS, arms=(LAYER,),
                               fleet="disagg", fleet_devices=devices,
                               device=src, **SERVE_SHAPE)
        pf, dc, store = backend._disagg[LAYER]
        waves = []
        _xdev_check(store, waves)
        role = _new_roles()
        _count_by_role(pf, dc, role)
        reqs = _parity_requests(cfg.vocab_size, n=XDEV_REQUESTS, seed=7)
        eng = PlacementEngine(FixedPolicy(LAYER, placement=None), backend)
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        eng.submit(reqs)
        eng.drain()
        wall = time.perf_counter() - t0
        m = eng.summary()
        runs[name] = dict(
            devices=[str(pf.device), str(dc.device)], fleet=store.fleet,
            completed=m["completed"], wall_s=wall,
            blocks_shipped=m["blocks_shipped"],
            transfer_bytes=m["transfer_bytes"], ship_waves=m["ship_waves"],
            ship_xdev_copies=m["ship_xdev_copies"],
            waves_same=sum(w["same"] for w in waves), waves=len(waves),
            leaves=waves[0]["leaves"] if waves else 0,
            copies_per_wave=[w["copies"] for w in waves],
            wave_ms=[w["ms"] for w in waves], launches_by_role=role,
            tokens=[r.output for r in reqs])
        if m["completed"] != XDEV_REQUESTS or any(
                r.output is None or r.output.shape != (r.max_new,)
                for r in reqs):
            raise AssertionError(f"[disagg_xdev {name}] completed "
                                 f"{m['completed']} of {XDEV_REQUESTS}")
        _check_unwound(backend, f"disagg_xdev {name}")
        del backend, eng, pf, dc, store
        _free()
    same, xdev = runs["same"], runs["xdev"]
    if not xdev["fleet"] or same["fleet"]:
        raise AssertionError(f"[disagg_xdev] fleet flags {same['fleet']} "
                             f"{xdev['fleet']}")
    if not xdev["waves"] or xdev["waves_same"] != xdev["waves"]:
        raise AssertionError(f"[disagg_xdev] {xdev['waves_same']} of "
                             f"{xdev['waves']} waves received their blocks "
                             "bit for bit")
    if any(c != xdev["leaves"] for c in xdev["copies_per_wave"]) or \
            same["ship_xdev_copies"] != 0:
        raise AssertionError(f"[disagg_xdev] copies per wave "
                             f"{xdev['copies_per_wave']}, {xdev['leaves']} "
                             "leaves; the same-device run made "
                             f"{same['ship_xdev_copies']}")
    for k in ("blocks_shipped", "transfer_bytes", "ship_waves"):
        if same[k] != xdev[k] or not xdev[k]:
            raise AssertionError(f"[disagg_xdev] {k} {xdev[k]}, same-device"
                                 f" run {same[k]}")
    equal = [bool(np.array_equal(a, b))
             for a, b in zip(same.pop("tokens"), xdev.pop("tokens"))]
    if two and not all(equal):
        raise AssertionError(f"[disagg_xdev] streams differ from the "
                             f"same-device run's: {equal}")
    pre, dec = "paged_prefill_attention", "paged_decode_attention"
    if not xdev["launches_by_role"]["prefill"][pre] or (
            bool(xdev["launches_by_role"]["decode"][dec]) != two):
        raise AssertionError(f"[disagg_xdev] launches by role "
                             f"{xdev['launches_by_role']}")
    out = dict(model=cfg.name, decode_device=str(dst), same=same, xdev=xdev,
               streams_equal=sum(equal), streams=len(equal),
               launches={k: n + xdev["launches_by_role"]["decode"][k]
                         for k, n in
                         xdev["launches_by_role"]["prefill"].items()})
    log(f"[disagg_xdev {cfg.name}] {json.dumps(out, default=str)}")
    return out


# -------------------------------------------------- decode_attention slab
SLAB = dict(h=32, kh=32, hd=64, L=32768)     # one rank's slab of part A
#: the f32 slabs serve_multi's flash-decoding gives the log-sum-exp entry:
#: (label, H, K, hd, slots a rank, softcap, the valid lengths, a B 1 call
#: each).  A: rank 0 before and once its slab is full (32761, 32768), rank
#: 1 before and past the boundary (0, 8); B: gemma2's global layers (8192
#: slots over two ranks at step 0: rank 0 full, rank 1 1905) and its
#: 4096-slot ring wrapped across both ranks (2048 valid each)
SLAB_F32 = (("A", 32, 32, 64, 32768, 0.0, (32761, 32768, 0, 8)),
            ("B global", 32, 16, 128, 4096, 50.0, (4096, 1905)),
            ("B ring", 32, 16, 128, 2048, 50.0, (2048,)))
#: |lse - plain lse| a slab may show, by dtype
SLAB_LSE_TOL = {torch.bfloat16: 1e-3, torch.float32: 1e-4}


def _slab(dev, h, kh, hd, L, dt, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(1, h, hd, generator=gen, device=dev).to(dt)
    k = torch.randn(1, L, kh, hd, generator=gen, device=dev).to(dt)
    v = torch.randn(1, L, kh, hd, generator=gen, device=dev).to(dt)
    return q, k, v


def _slab_check(label, q, k, v, n, softcap=0.0):
    """One launch of the log-sum-exp entry over ``n`` valid slots against
    the plain version: the output within the row tolerance of its dtype,
    the lse within ``SLAB_LSE_TOL`` (both -inf at n = 0, the output 0).
    Returns (out, lse, max |out err|, max |lse err|)."""
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_plain)
    length = torch.full((1,), n, dtype=torch.int32, device=q.device)
    before = decode_attention.launches
    got, lse = decode_attention(q, k, v, length, softcap=softcap,
                                return_lse=True)
    want, want_lse = decode_attention_plain(q, k, v, length,
                                            softcap=softcap, return_lse=True)
    _sync(q.device)
    if decode_attention.launches != before + 1:
        raise AssertionError(f"[slab {label}] the kernel did not launch once")
    err = float((got - want).abs().max())
    if n == 0:
        ok = bool((got == 0).all()) and bool(torch.isneginf(lse).all())
        lse_err = 0.0 if ok else math.inf
    else:
        ok = bool(((got - want).abs() <= row_limit(want, QTOL[q.dtype]))
                  .all())
        lse_err = float((lse - want_lse).abs().max())
    if not ok or not lse_err <= SLAB_LSE_TOL[q.dtype]:
        raise AssertionError(f"[slab {label} n={n}] out error {err}, lse "
                             f"error {lse_err}")
    return got, lse, err, lse_err


def _slab_times(q, k, v, got, lse):
    """Row 5c's times on a full slab, with its bound (the slab's K and V
    read once), beside SDPA's ``_scaled_dot_product_efficient_attention(
    compute_log_sumexp=True)`` on the same slab (a yardstick the port
    never calls) and its errors against the plain version."""
    from repro_torch.kernels.cost import decode_cost
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_plain)
    L, kh, hd, h = k.shape[1], k.shape[2], k.shape[3], q.shape[1]
    length = torch.full((1,), L, dtype=torch.int32, device=q.device)
    want, want_lse = decode_attention_plain(q, k, v, length,
                                            return_lse=True)
    qt = q[:, :, None]
    kt, vt = (x.transpose(1, 2).contiguous() for x in (k, v))
    sdpa = torch.ops.aten._scaled_dot_product_efficient_attention
    lib_out, lib_lse = sdpa(qt, kt, vt, None, True)[:2]
    times = timings(
        lambda: decode_attention(q, k, v, length, return_lse=True),
        lambda: decode_attention_plain(q, k, v, length, return_lse=True),
        lambda: sdpa(qt, kt, vt, None, True))
    flops, nbytes = decode_cost(q.shape[0], h, kh, hd, q.shape[0] * L,
                                q.element_size(), return_lse=True)
    bound_ms, bound_by = _bound(nbytes, flops, q.dtype)
    return dict(library_lse_max_abs_err=float(
                    (lib_lse[..., 0].float() - want_lse).abs().max()),
                library_out_max_abs_err=float(
                    (lib_out[:, :, 0].float() - want).abs().max()),
                bound_ms=bound_ms, bound_by=bound_by, **times)


def slab_phase(dev):
    """``decode_attention``'s log-sum-exp entry on the slabs serve_multi
    gives it, each launch against its plain version: part A's slab in
    bf16 (stablelm-1.6b's H = K = 32, hd 64, B 1, all 32768 slots valid),
    timed with its bound (row 5c); then every f32 slab of ``SLAB_F32``,
    serve_multi's own dtype and shapes (A at hd 64; B's gemma2 layers at
    hd 128, GQA 2:1, softcap 50, its ring wrapped), with lengths 0 and
    the slab boundary's, and A's full f32 slab timed too."""
    h, kh, hd, L = SLAB["h"], SLAB["kh"], SLAB["hd"], SLAB["L"]
    q, k, v = _slab(dev, h, kh, hd, L, torch.bfloat16, 31)
    got, lse, err, lse_err = _slab_check("A bf16", q, k, v, L)
    out = dict(shape=dict(SLAB, B=1, dtype="bfloat16"), max_abs_err=err,
               lse_max_abs_err=lse_err, **_slab_times(q, k, v, got, lse))
    del q, k, v
    f32 = {}
    for i, (label, h, kh, hd, L, cap, lengths) in enumerate(SLAB_F32):
        q, k, v = _slab(dev, h, kh, hd, L, torch.float32, 41 + i)
        errs = [_slab_check(label, q, k, v, n, cap)[2:] for n in lengths]
        f32[label] = dict(H=h, K=kh, hd=hd, L=L, softcap=cap,
                          lengths=list(lengths),
                          max_abs_err=max(e for e, _ in errs),
                          lse_max_abs_err=max(e for _, e in errs))
        if label == "A":
            got, lse = _slab_check(label, q, k, v, L)[:2]
            f32[label]["times"] = _slab_times(q, k, v, got, lse)
        del q, k, v
    out["f32"] = f32
    log(f"[slab decode_attention lse] {json.dumps(out)}")
    return out


PLACEMENT_INTERVALS = 1000


def _timed_placement(place):
    """Wrap ``place`` and ``on_complete`` with host-clock timers (the update
    synchronized, so its device work is inside), and keep the first
    episode (the first of two or more placements, if one completes) with
    the weights it started from."""
    times = {"place": [], "update": []}
    rec = {}
    inner_place = place.place

    def timed_place(container, hosts):
        t0 = time.perf_counter()
        out = inner_place(container, hosts)
        times["place"].append(time.perf_counter() - t0)
        return out

    place.place = timed_place
    if not hasattr(place, "on_complete"):         # GOBI learns nothing
        return times, rec
    inner_done = place.on_complete

    def timed_done(w):
        ep = place._episodes.get(w.wid)
        if ep and (not rec or len(rec["episode"]) < 2 <= len(ep)):
            rec.update(params=tuple(p.clone() for p in place.params),
                       episode=list(ep), w=w)
        t0 = time.perf_counter()
        inner_done(w)
        torch.cuda.synchronize()
        times["update"].append(time.perf_counter() - t0)

    place.on_complete = timed_done
    return times, rec


def _episode_check(rec, dev):
    """One recorded episode's networks and update on ``dev`` (the card)
    against the same port functions on the CPU, within 1e-5 of each
    tensor's max, the max floored at the update's lr (1e-3, one SGD step
    of a unit gradient): ``b2`` shifts every logit alike, so its gradient
    is zero in exact arithmetic and, from its zero init, it holds only
    rounding noise (~1e-10) on either device."""
    from repro_torch.core.reward import workload_reward
    from repro_torch.sched import a3c as A3
    w = rec["w"]
    r = float(workload_reward(w.response_time, w.sla, w.accuracy))
    ep = rec["episode"]
    host = dict(feats=torch.from_numpy(np.stack([e[0] for e in ep])),
                actions=torch.tensor([e[1] for e in ep]),
                masks=torch.from_numpy(np.stack([e[2] for e in ep])))
    out = {}
    for where in (dev, torch.device("cpu")):
        params = A3.A3CParams(*(p.to(where) for p in rec["params"]))
        x = {k: v.to(where) for k, v in host.items()}
        out[where.type] = dict(
            logits=A3.policy_logits(params, x["feats"]),
            value=A3.value(params, x["feats"]),
            **A3.a3c_update(params, x["feats"], x["actions"], x["masks"],
                            r)._asdict())
    worst = 0.0
    for k, want in out["cpu"].items():
        got = out[dev.type][k]
        if got.device.type != dev.type:
            raise AssertionError(f"[placement] {k} not on {dev}")
        err = float((got.cpu() - want).abs().max()
                    / want.abs().max().clamp_min(1e-3))
        if not err <= 1e-5:
            raise AssertionError(f"[placement] {k}: card vs CPU {err} of "
                                 f"its max")
        worst = max(worst, err)
    return dict(steps=len(ep), worst_rel=worst)


def placement_phase(dev):
    """Table I's two policies with A3C on the card, and semantic-only GOBI,
    on ``SimBackend`` for ``PLACEMENT_INTERVALS`` intervals."""
    from repro_torch.engine import (SEMANTIC, CompressionPolicy, FixedPolicy,
                                    MABPolicy, PlacementEngine,
                                    PoissonSource)
    from repro_torch.engine.sim_backend import SimBackend
    from repro_torch.sched.a3c import A3CPlacement
    from repro_torch.sched.gobi import GOBIPlacement
    policies = (
        ("baseline", A3CPlacement(device=dev), CompressionPolicy),
        ("splitplace", A3CPlacement(device=dev),
         lambda p: MABPolicy(bandit="ucb", placement=p)),
        ("gobi_semantic", GOBIPlacement(device=dev),
         lambda p: FixedPolicy(SEMANTIC, p)))
    runs = {}
    for name, place, make in policies:
        times, rec = _timed_placement(place)
        eng = PlacementEngine(make(place), SimBackend(seed=1))
        t0 = time.perf_counter()
        m = eng.run(PoissonSource(rate=0.6, seed=3, sla_range=(0.5, 3.0)),
                    PLACEMENT_INTERVALS)
        wall = time.perf_counter() - t0
        b = eng.backend
        if not (b.host_ram_used <= b.host_ram_mb + 1e-6).all():
            raise AssertionError(f"[placement {name}] a host's RAM is over "
                                 f"its capacity")
        if m["completed"] < 100 or not times["place"]:
            raise AssertionError(f"[placement {name}] {m['completed']} "
                                 f"completed, {len(times['place'])} places")
        row = {k: m[k] for k in ("completed", "reward", "sla_violation",
                                 "accuracy", "energy_wh", "mean_response_s",
                                 "decisions_semantic_frac")}
        row.update(wall_s=wall, places=len(times["place"]),
                   place_ms=1e3 * statistics.median(times["place"]),
                   updates=len(times["update"]))
        if isinstance(place, A3CPlacement):
            if not all(p.device.type == dev.type
                       and bool(torch.isfinite(p).all())
                       for p in place.params):
                raise AssertionError(f"[placement {name}] A3C weights not "
                                     f"on the card or not finite")
            if not rec:
                raise AssertionError(f"[placement {name}] no episode "
                                     f"completed")
            row["update_ms"] = 1e3 * statistics.median(times["update"])
            row["episode_check"] = _episode_check(rec, dev)
        runs[name] = row
        log(f"[placement {name}] {json.dumps(row)}")
    sp, base = runs["splitplace"], runs["baseline"]
    runs["splitplace_beats_baseline"] = dict(
        reward=sp["reward"] > base["reward"],
        sla_violation=sp["sla_violation"] < base["sla_violation"],
        accuracy=sp["accuracy"] > base["accuracy"])
    log(f"[placement] SplitPlace beats the baseline (not gated): "
        f"{json.dumps(runs['splitplace_beats_baseline'])}")
    return runs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write the full report as JSON here")
    ap.add_argument("--multi-rank", type=int, default=None,
                    help=argparse.SUPPRESS)      # a rank of the multi phase
    ap.add_argument("--multi-dir", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--multi-device", default="cuda:0",
                    help=argparse.SUPPRESS)
    ap.add_argument("--multi-reduced", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.multi_rank is not None:
        return multi_worker(args.multi_rank, pathlib.Path(args.multi_dir),
                            args.multi_device, args.multi_reduced)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import _build

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_name_and_limit()
    log(f"[device] {torch.cuda.get_device_name(0)} | {card} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    libs = _build.build_all()
    build_s = time.perf_counter() - t0
    for name, path in libs.items():
        kernels, spills = ptxas_spills(path.with_suffix(".ptxas.txt"))
        log(f"[build] {name}: {path.name} in {build_s:.1f} s, {kernels} "
            f"kernels, spills in {len(spills)}")
        for fn, line in spills:
            log(f"[build]   {fn}: {line}")

    stablelm = get_config("stablelm-1.6b")
    serves, models = {}, {}
    serves["bf16"], models["bf16"] = serve_and_check(
        dev, stablelm, kv_dtype="f32", n_requests=24, waves=4,
        model_check=True)
    short = dict(every_arm_first=True)
    serves["int8_kv"], _ = serve_and_check(
        dev, stablelm, kv_dtype="int8", n_requests=9, waves=3, **short)
    serves["int8_weights"], models["int8_weights"] = serve_and_check(
        dev, stablelm, kv_dtype="f32", weight_quant="int8", n_requests=9,
        waves=3, model_check=True, **short)
    serves["int4_weights_int8_kv"], _ = serve_and_check(
        dev, stablelm, kv_dtype="int8", weight_quant="int4", n_requests=6,
        waves=3, **short)
    serves["moe_int8_weights"], models["moe_int8_weights"] = \
        serve_and_check(dev, get_config("qwen2-moe-a2.7b"), kv_dtype="f32",
                        weight_quant="int8", n_requests=8, waves=4,
                        max_new=(16, 33), model_check=True, superblocks=2,
                        **short)
    fleet = {f"disagg_{kv}": disagg_phase(dev, stablelm, kv_dtype=kv)
             for kv in ("f32", "int8")}
    fleet["disagg_parity"] = disagg_parity_phase(dev, stablelm)
    fleet["chaos"] = chaos_phase(dev, stablelm)
    fleet["fleet"] = fleet_phase(dev, stablelm)
    fleet["disagg_xdev"] = disagg_xdev_phase(dev, stablelm)
    gang, gang_models = {}, {}
    gang["legacy"], gang_models["legacy"] = gang_and_check(
        dev, stablelm, tag="legacy", decode="legacy", bandit="ucb", waves=3,
        reqs=gang_requests(stablelm.vocab_size, 9, seed=2, plen=(64, 257),
                           max_new=(32, 65)))
    xlstm = get_config("xlstm-125m")
    gang["recurrent"], gang_models["recurrent"] = gang_and_check(
        dev, xlstm, tag="recurrent", decode="auto", bandit="thompson",
        waves=3, reqs=gang_requests(xlstm.vocab_size, 9, seed=3))
    gemma2 = get_config("gemma2-27b")
    gemma2 = gemma2.replace(n_layers=2 * len(gemma2.pattern))
    gang["window"], gang_models["window"] = gang_and_check(
        dev, gemma2, tag="window", decode="auto", bandit="egreedy", waves=3,
        reqs=gang_requests(gemma2.vocab_size, 6, seed=4, plen=(16, 33),
                           max_new=(8, 17)))
    gang["window"]["ring_kernel"] = window_kernel_check(dev, gemma2)
    t0 = time.perf_counter()
    zoo = zoo_phase(dev)
    zoo["phase_s"] = time.perf_counter() - t0
    log(f"[gang] phase seconds: " + json.dumps(
        {**{k: g["phase_s"] for k, g in gang.items()},
         "zoo": zoo["phase_s"]}))
    train = train_phase(dev, stablelm)
    dryrun = dryrun_phase(stablelm, train)
    pipeline = pipeline_phase(dev, stablelm)
    multi = multi_phase(dev)
    placement = placement_phase(dev)
    # the timed kernel phases run last: the profiler they use may leave
    # launch overhead behind, which the serves would otherwise absorb
    kernels = kernel_phase(dev)
    kernels["quant_matmul"] = quant_phase(dev)
    kernels["flash_attention"] = flash_phase(dev)
    kernels["decode_attention_slab"] = slab_phase(dev)
    op_layer = ops_phase(dev)
    for name in OPS_KERNELS:
        kernels[name] = op_layer[name]

    line = []
    main_paths = {"paged_decode_attention": "decode_split",
                  "paged_prefill_attention": "prefill_mma",
                  "quant_matmul": "mma_skinny",
                  "flash_attention": "simt",
                  "block_diag_matmul": "mma_skinny", "moe_gmm": "wgmma"}
    for label, row in kernels["flash_attention"]["per_dtype"].items():
        want_path = "mma" if label.endswith("bfloat16") else "simt"
        if row["path"] != want_path:
            raise AssertionError(f"flash_attention [{label}] took "
                                 f"{row['path']}, not {want_path}")
    main_rows = {"paged_decode_attention": "hd64/bf16",
                 "paged_prefill_attention": "hd64/bf16",
                 "quant_matmul": "layer/int8/bfloat16/T8",
                 "flash_attention": "layer/float32",
                 "block_diag_matmul": "mlstm/T8/bfloat16",
                 "moe_gmm": "gate_up/C171/bfloat16",
                 "ssm_scan": "jamba/float32",
                 "decode_attention": "stablelm-1.6b/bfloat16"}
    sources = {"quant_matmul": "quant_matmul.cu",
               "flash_attention": "flash_attention.cu",
               "block_diag_matmul": "grouped_matmul.cu",
               "moe_gmm": "grouped_matmul.cu",
               "ssm_scan": "ssm_scan.cu",
               "decode_attention": "decode_attention.cu"}
    for name, label in main_rows.items():
        row = kernels[name]["per_dtype"][label]
        if row.get("path") != main_paths.get(name, row.get("path")):
            raise AssertionError(f"{name} [{label}] took {row.get('path')}")
        src = sources.get(name, "paged_attention.cu")
        if name in OPS_KERNELS:
            launches = kernels[name]["launches"] + sum(
                g["launches"].get(name, 0) for g in gang.values())
            if name == "decode_attention":
                launches += sum(r["decode_launches"]
                                for per in multi["serve"].values()
                                for r in per) \
                    + sum(sum(e["decode_launches"])
                          for e in multi["engine"].values())
        elif name == "flash_attention":
            launches = sum(train[m]["flash_launches"] for m, _ in TRAIN_RUNS) \
                + sum(pipeline[s]["flash_launches"] for s, _ in PIPELINE_RUNS) \
                + sum(r["flash_launches"] for per in multi["runs"].values()
                      for r in per) \
                + sum(r["flash_launches"] for per in multi["serve"].values()
                      for r in per)
        else:
            launches = sum(s["launches"][name] for s in serves.values()) \
                + sum(f["launches"][name] for f in fleet.values()) \
                + sum(_paged_engine_launches(row, name)
                      for part in ("engine_paged", "engine_disagg",
                                   "engine_fleet")
                      for row in multi[part].values()) \
                + _paged_engine_launches(multi["engine_pinned"], name)
        line.append(dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{src}",
            replaces=kernels[name]["replaces"],
            launches=launches,
            max_abs_err=row["max_abs_err"], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"]))
    total_s = time.perf_counter() - t_start
    log(f"[done] {total_s:.1f} s")
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(dict(
            card=card, build_s=build_s, total_s=total_s, kernels=kernels,
            op_layer=op_layer, serves=serves, models=models, fleet=fleet,
            gang=gang, gang_models=gang_models, zoo=zoo, train=train,
            dryrun=dryrun, pipeline=pipeline, multi=multi, placement=placement),
            indent=1))
    print(json.dumps({"kernels": line}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
