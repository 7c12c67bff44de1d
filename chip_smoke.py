#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA Hopper card.

    python3 chip_smoke.py [--seed N]

Phases (any failure raises and exits non-zero; nothing is caught; they
run in the order 1, 2, 3, 7, 4, 5, 6, 9, 15, 10, 13, 11, 16, 12, 19, 8, 17,
18, 14, 20, 21, 22).
Each phase's start goes to stderr with the script's clock; a run still
going after WATCHDOG_S prints every thread's stack there, kills the
processes it started and exits 3.
The train task's single-card step is a CUDA graph (train/step.py
``StepGraph``): its B1 and B1' runs are the eager warm-up launches plus
the replays times the launches each capture recorded (``kernel_runs``):

1. card     - the card's name and power limit, from nvidia-smi;
2. build    - every kernel under deepfm_tpu_torch/csrc, built from source
              with nvcc, and the native record reader and Criteo hash
              encoder with g++;
3. kernel   - each kernel's wrapper against its plain PyTorch version on the
              card, at the shapes its main paths give it: the forward at
              the flagship table (117,584 x 32) for every serving bucket,
              the funnel's rank rows (256, 2,048) and the train batches;
              the backward at the train batches with the 13 hot numeric
              rows of every Criteo record, on uniform ids and with every
              lookup on one row; with the kernel's time, the plain
              version's time and the least time the card could take (CUDA
              events, median over repetitions), the forward's layout and
              share of that bound, and the time of a one-element add (the
              launch floor);
4. serve    - the full-width DeepFM (117,581 x 39 x 32, MLP 256/128/64,
              bf16, random weights from --seed) exported and served on the
              card over HTTP with hot reload from a publish root: every
              bucket's forward a CUDA graph in each of two weight slots (8
              graphs), sent :predict requests of 1, 8 and 100 instances,
              which must be finite, repeatable and agree with the plain
              forward of the same weights; the graphs must have replayed
              the forward kernel (its runs on this path are the replays
              times the launches captured into a graph; the warm-ups before
              capture and the captures are printed apart) and the requests
              launched it eagerly no time.
              Then (a) each bucket's graphed dispatch against the eager
              kernel forward (1e-6) and the plain one (1e-4), with its host
              ms beside the eager predict's and the forward's device and
              call ms; (g) /metrics parsed as Prometheus text and a traced
              request's queue and dispatch spans; (c) :predict and
              :predict_binary p50 at 1, 8 and 100 instances on the graphed
              server and on an eager micro-batcher over load_model; (d) 16
              closed-loop clients in another process for 3 s against each
              (requests/s, p50, p99); (e) versions 1 and 2 published through
              the port's ModelPublisher and swapped in under concurrent
              :predict traffic, every response within 1e-4 of the plain
              answer of the version it reports or the one before, all on
              version 2 after, the graph count 8 after each swap, with the
              swap, stage and canary ms; (f) a NaN version rolled back and
              a version with a corrupted params.npz refused on its hash;
5. parity   - one loss.backward() of the full-width float32 model on a batch
              of 1,024 synthetic records through the kernels and through
              the plain versions, from the same weights: the loss and every
              gradient must agree;
6. train    - `python -m deepfm_tpu_torch --task_type train` in-process at
              full width (bf16, dropout 0.5, Adam, batch 1,024) on synthetic
              TFRecords written from --seed: losses finite and falling, both
              kernels launched at least once per step, eval AUC in [0, 1],
              and the exported servable's probabilities equal to the trained
              model's; then examples/s, the input-wait share, one step's
              device time and its split by kernel, and peak memory;
7. b2       - kernel B2 (int8 retrieval score + top-k) against its plain
              version at the served corpus (117,581 rows) and the benchmark
              corpus (2,000,000), D 32, kos 128, B 8 and 64, on a mix
              with equal rows and pad ids, and on inputs that fill or
              starve its select (all scores equal, 100 live rows, kos 1
              and 1,024, D 16 and 128): scores within the stated
              tolerance, rows equal but for near-ties (counted); with its
              device and call time, its split by kernel, the plain time,
              the least time and the torch.topk composition's time;
8. funnel   - the full-width recommendation funnel (the flagship ranker,
              a two-tower query encoder, an int8 index of 117,581 items,
              top 32 -> 8) built on the card, exported through the recall
              gate, served over HTTP (each bucket's retrieve and rank stages
              two CUDA graphs a weight slot, funnel/graphs.py) and sent
              /v1/recommend with 1, 8 and 64 users; the answers must agree
              with the same payload run through the plain B2 and plain B1
              (near-ties counted), and both kernels must have run through
              the graphs' replays (their runs are the eager warm-ups before
              capture plus the replays times the launches captured); then the stage
              times, latency and the device recall@32 against exact f32;
              then the serve task (train/loop.py run_serve, with the
              flags --funnel_top_k 16 --funnel_return_n 4) over the same
              servable: every answer 4 items, held to the plain pipeline
              at top 16 -> 4 the same way, B2 and B1 launched;
9. lazy     - the train task of phase 6 with lazy Adam on the tables
              (optimizer.lazy_embedding_updates): losses finite and
              falling, both kernels launched at least once per step; one
              lazy step of the float32 model through the kernels and
              through the plain versions from the same state (loss, the
              touched rows' step, m and v agree; every untouched row of
              the tables, m and v bit for bit as before); B1 and B1' on
              the compact tables against their plain versions (B1' against
              the plain version in float64), with B1''s
              time, bound and zero fill; the lazy step's device time and
              split beside the dense step's;
10. ddp     - data-parallel training at world size 1 over NCCL in this
              process: steps through parallel/spmd.py and through the
              single-card step from the same weights agree; the fused
              all-reduce's time on the full-width gradient buffer;
11. lifecycle - the train task at full width on 24 batches of distinct
              ids (so B1''s atomics add one term a row and a run is
              bit-reproducible), a checkpoint every 8 steps, dense Adam and
              lazy Adam: stopped by a real SIGTERM from inside the loop
              after step 12 (PreemptedError, checkpoints at 8 and 12, the
              preempted event), resumed by the same command (resume at
              12, the end at 24) and held against an uninterrupted run bit
              for bit (parameters, BN statistics, moments, step); then the
              eval task (AUC and loss within 1e-6 of the train task's
              final eval), the infer task (pred.txt, one line a val
              record, within TOL_PROB of the servable) and the export task
              (params.npz bit-equal to the train task's); then one timed
              save of the full-width state (blocking and write time), one
              1,024-record batch read by the C++ reader and by the Python
              route, and the train phase's command run with each reader
              (train_done's examples/s and input-wait share);
12. online  - online training at full width (dropout 0.5, Adam 5e-4,
              batch 1,024) through the CLI in its own processes, on an
              event log of 32 segments of 1,024 records of distinct ids
              written by the port's SegmentWriter (the second half by a
              thread while the trainer follows): `--task_type online-train`
              commits and publishes every 8 steps; a graphed serve process
              (`--task_type serve`, hot reload from the publish root) starts
              on its first version; a SIGTERM after the second publish must
              end it with exit 0 and online_done, and the same command again
              must log online_resume at the committed cursor, under 4
              closed-loop clients of 1, 3, 8 and 20 rows.  Every response
              must be of a published version and within 1e-4 of the plain
              answer of that version or the one before, the server must end
              on the last version with 8 graphs throughout, B1 and B1' must
              launch once a step in each trainer, the final commit must equal
              one pass over the records cut at the committed cursor bit for
              bit (parameters, moments, step, cursor), and the last
              manifest's param_hash must be that state's.  Then the
              flywheel: 4,096 impressions and their clicks (25% in the
              window, 5% late, 64 orphans, sampled at 0.5) through
              `python -m deepfm_tpu_torch.flywheel.join --drain` (positives,
              negatives, flips and orphans as generated) and
              `--task_type feedback-train` on its output (every joined
              record trained, a version published).  Its `online` line
              holds the card, the trainers' examples/s, input-wait share,
              commit and publish ms, the freshness (a manifest's marker to
              the first response of its version), the swap, stage and
              canary ms, the join's records/s and the phase's seconds.

13. sharded - ROADMAP A9's [data x model] grid: 4 ranks spawned on the one
              card in a gloo group of their own (NCCL refuses two ranks of
              one communicator on one card), at full width (bf16 MLP,
              fused_kernel "auto", 1,024 records a data index, Adam 5e-4,
              L2 1e-4, dropout off, every id of a step distinct), 4 steps
              through parallel/spmd.py's step in each of: [2, 2] dense over
              the psum exchange, [2, 2] dense over the all-to-all exchange
              with ZeRO, [2, 2] lazy over the all-to-all exchange, [1, 4]
              dense over the all-to-all exchange with two batches skewed
              past its capacity (the psum fallback), [4, 1] lazy with whole
              tables, a float32 MLP and every id twice in a data index, so
              that each step takes the unique pack (update_dedup) over the
              data group.
              Every rank's exchange (at [4, 1] the lazy step's local
              assembly) must give rows bit-equal to the dense gather of the
              whole tables, the lazy updates must take the pack or every
              slot as their configuration says, B1 and B1' must launch every step on every rank and
              agree with their plain versions on the exchange's compact
              table, the fallback must run on the skewed steps only, and the whole
              tables and MLP must agree with the single-card step on the
              same global batches (the data-parallel mean of each data
              index's gradient, the tables' times the model shards, as the
              exchange's transpose gives it in JAX) within TOL_GRAD_REL; a
              `sharded` line a configuration with the step and exchange
              times and bytes, over gloo on one card.  In the [1, 4] and
              the [2, 2] lazy configurations every rank then saves through
              Checkpointer (each model index its own row file) and
              restores into a fresh state: bit-equal, each row file exactly
              its rank's rows, and each rank's rise of
              torch.cuda.max_memory_allocated in the save and in the
              restore within its shard state plus 1 MiB (a `sharded
              checkpoint` line: the rises, the files' bytes);
14. prep    - the reference's data preparation: raw Criteo TSV from --seed
              (98,304 train and 8,192 val lines, missing fields, Zipf
              tokens, a few negative counts, some CRLF lines) converted by
              `python -m deepfm_tpu_torch.data.criteo --encoder hash
              --feature_size 117581 --records_per_shard 32768` on the C++
              route and with DEEPFM_NO_NATIVE=1, whose shards must be
              byte-equal; 4,096 records through both directions of `python
              -m deepfm_tpu_torch.data.libsvm`; the train task at full
              width on the converted shards, one epoch: losses finite and
              falling, B1 and B1' every step, eval AUC in [0, 1]; a `prep`
              line with the encoders' records/s on each route (host clock,
              beside the card's name and power limit) and the phase's
              seconds.

15. graphed - the train phase's model (flagship widths, bf16 MLP, dropout
              0.5, Adam, batch 1,024), dense and lazy, on 8 batches of
              distinct ids from one initial state and one dropout
              generator state: the graphed step (3 eager warm-up steps on a
              side stream, the capture, 5 replays) against the eager step,
              every step's metrics and every carried tensor bit for bit; a
              step's device time (CUDA events) and idle share, graphed and
              eager, beside the train task's examples/s; then the port's
              analyser, python -m deepfm_tpu_torch.analysis
              deepfm_tpu_torch/ --concurrency --trace-audit, must exit 0:
              engines 1 and 3 over the package at an empty baseline, and
              analysis/trace_audit.py run_trace_audit("cuda") (in place,
              dtype, graphed = eager, the captures under
              set_sync_debug_mode("error"), the bucket graphs and a hot
              swap that captures nothing, the paged step, the observability
              of the captured bodies, and the grid step's two collective
              contracts on a spawned [2, 2] world of gloo ranks on the card:
              dense psum, dense alltoall, lazy alltoall and ZeRO steps
              recorded, the ZeRO update under the sync guard) finding
              nothing and waiving neither collective contract; the
              collective world's seconds on a line of their own;
16. tiered  - ROADMAP A11's tiered store at the flagship width
              (fused_kernel "off", lazy Adam, batch 1,024, a hot cache of
              65,536 slots, a host tier of 65,536 rows, pages of 1,024
              rows, a local cold directory): the paged step against the
              resident lazy step on the train phase's 48 batches (step by
              step from one state, within TOL_LOSS_REL and TOL_GRAD_REL:
              repeated ids meet B1''s atomics; a cache of 49,152 slots,
              fewer than the 55,480 rows those batches touch) and on the
              lifecycle's first 12 batches of distinct ids (one trajectory,
              bit for bit), both evicting and writing back, with the hit rate,
              the staged and written-back bytes and the step's time; B1 on
              the hot cache [65,537, 32]
              with slot ids (the tiered scorer's lookup) and B1 and B1' on
              the compact rows gathered from it (the paged step's), each
              against its plain version, with times and bounds; the
              distinct run published by publish_tiered and served by a
              TieredScorer behind the port's server (1, 8 and 100
              instances within 1e-6 of the resident model's predict, each
              request one B1 launch, the paging gauges in /metrics); then the tiered train task through
              cli.run on the lifecycle's first file (12 batches) stopped by
              a SIGTERM after step 6, resumed, and held bit for bit
              (tables, moments, the rest of the model) against an
              uninterrupted run.

17. funnel_swap - the funnel's versioned hot swap (ROADMAP A13) at phase
              8's width (117,581 items, top 32 -> 8, oversample 4, buckets 8
              and 64): (1) the graphs of both slots, exact and int8, against
              the same stages run eagerly (ids equal, probabilities and
              retrieval scores within 1e-6) and against the plain B2 and B1
              on the same payload, with each bucket's graphed and eager
              dispatch ms and each stage's stream us (CUDA events around
              its replay: its device time plus the gap before the launch);
              (2) versions 1 and 2 (the ranker moved by 0.01, the query
              tower scaled by 1 + 0.05·N(0, 1), the index rebuilt)
              published by FunnelPublisher and swapped in under 8 HTTP
              clients of one user each: 0 failed responses, 0 outside
              {1, 2}, 0 mixed (model, index) pairs, 0 answers that are
              neither version's, and each version's answers held to its
              weights and index staged afresh, through the plain B2 and
              B1; then a NaN ranker and a corrupted index.npz, both rolled
              back while version 2 serves the same answers; the stage,
              canary and swap ms and the graph count (8, unchanged); (3)
              the index row-sharded over 2 and 4 shards on the card, exact
              and int8, against one shard and brute force (exact ids equal
              but for near-ties, scores within 1e-5, no pad row), and the
              same inside FunnelGraphs' graphs against the eager call; the
              funnel_swap lines.  The kernels line's B2 and B1
              runs include this phase's main path (the server's boot,
              traffic and swaps).
18. pool    - the serving pools (ROADMAP A14) at the flagship width, each
              process under its own HOME and TMPDIR, the four servers
              below started together so that their boots overlap, each
              check then run alone on its own server: (a) the serve task
              with run.serve_workers=2 (two graphed servers on one port,
              each its own interpreter): every bucket 8-512 by JSON and
              binary bit-equal to the single-process graphed answer, 16
              closed-loop clients from four client processes by JSON and
              by binary beside one worker's under the same load and phase
              4's figures, a worker killed and respawned;
              (b) the serve task with run.serve_groups=2 (a router and two
              [1, 1] member processes, the swapper adopting version 1,
              flywheel.enabled): every bucket bit-equal, version 2 swapped
              in under 8 clients (0 failed, 0 skew-mixed, 0 outside
              {1, 2}, each answer within 1e-4 of its version's weights
              through the plain B1), a member killed (ejected, respawned,
              repaired to version 2, readmitted), a NaN version refused by
              every member, the impression log joined; (c) in-process
              members at [1, 2] and [2, 2], psum and all-to-all, their
              graphs bit-equal to the single-process graphed predict at
              every bucket and on a batch that overflows the all-to-all;
              (d) a funnel group (`python -m deepfm_tpu_torch.serve.pool`)
              with an SLO that degrades at any queued row: degraded
              dispatches held to the plain B2 and B1 at the degraded
              oversample.  Its B1 and B2 runs, in the kernels line too,
              are the workers' and members' own, from their exit lines
              (`pool kernel runs by process`; the references and
              comparisons in this process are printed apart).

19. elastic - ROADMAP A15's elastic online training at the flagship width
              (bf16 MLP, fused_kernel "auto", dropout off, Adam 5e-4, L2
              1e-4, a global batch of 1,024, weights from --seed) over an
              event log of 12 segments of distinct ids, one rank process a
              device on the one card (gloo, which the ranks pick as they
              outnumber the cards), each the online-train task's command
              line with elastic.enabled and the launcher's environment,
              the coordinator and the rendezvous store in this process;
              the log comes in three parts, the board changes while the
              ranks tail an idle log: (a) [2, 2] -> [1, 2] after
              step 4 (devices 2 and 3 taken off the board, their ranks
              drain, commit and exit 0) -> [2, 2] after step 8 (two new
              rank processes join), dense with inline publishes, then lazy:
              the reshards' shapes, 0 table bytes moved on the shrink and
              more on the grow, no step replayed, 12 strictly increasing
              cursors, every manifest at the true vocabulary, B1 and B1' on
              each epoch's first compact rows against their plain versions,
              and the final tables and MLP within TOL_GRAD_REL of the
              single-card step over the same batches in each epoch's grid
              arithmetic; (b) the lazy run with elastic.publisher_split and
              a `--task_type publish` process, which exits 0 having
              published each version with its commit's param_hash, and a
              commit and a publish with a stale token both refused; (c)
              the lifecycle's dense train task with --model_dir on the
              port's dev object store (a URL), SIGTERMed after step 12 and
              resumed, bit for bit equal to an uninterrupted run, every
              remote step with its marker, then a remote save and restore
              timed; (d) the dense run's [1, 2] drain commit restored at
              [1, 4] and [1, 1], every rank's tables and moments equal to
              the commit's rows at its window and its device memory rise
              within its shard state + 1 MiB; (e) the dense config at
              [2, 2] under a 6 s lease, ranks 2 and 3 SIGKILLed 2 steps
              past the step-4 commit with the board unchanged: their
              leases expire, the survivors' agreement fails, the
              coordinator opens [1, 2] without their devices and the
              survivors replay the 2 steps once (lineage, reshard and the
              single-card reference on that lineage).  Its `elastic` line
              holds the card, the reshard seconds, drain-commit and group
              re-form ms, the host ms a step at [2, 2] and [1, 2], the
              publisher's lag, (e)'s seconds from the kill to the new
              epoch, the remote save and restore ms and the phase's
              seconds; the ranks' B1 and B1' runs (main path only) are in
              the kernels line.
20. stream  - ROADMAP A6 and A21 at the flagship width (bf16 MLP 256/128/64,
              dropout 0.5, Adam, batch 1,024, weights from --seed) on the
              train phase's first 3 training files (36,864 records, 36
              batches a route) and its validation file: (a) the port's dev
              object store started as `python -m
              deepfm_tpu_torch.utils.dev_object_store` on localhost, the
              files uploaded as tr-*/va-* under a prefix; one epoch of the
              URL route's batches (FifoBridge into the C++ readers, the
              record shuffle over 8,192 records) byte-equal to the same
              files read from disk with the same seed, though the store cuts
              that read's first GET of tr-1 at half (the bridge resumes
              it); the train task with that prefix as --training_data_dir
              and --val_data_dir, a URL --model_dir and
              data.shuffle_buffer=8192, and the same task twice from
              disk: 36 steps each, B1 and B1' every step, the final train
              and eval losses and eval AUC of disk against disk and of S3
              against disk within TOL_ROUTE (B1''s atomics make two runs
              differ in their last bits, so the limits come from readings
              of both routes), the
              eval task over the S3 run's checkpoint from the store and the
              validation file from disk equal to that run's final eval
              (which read it through a bridge), the bridges' bytes and
              resumes; the infer task writing pred.txt
              into the store, within 1e-4 of the plain forward of the
              exported weights; (b) Pipe mode: the train task with
              data.stream_mode from a `training` FIFO and its final eval
              from an `evaluation` FIFO, each filled by a writer thread:
              36 steps, every validation record evaluated, the AUC within
              1e-6 of the eval task over the same checkpoint and records
              as files; the eval task with eval_max_batches=2 over a
              channel whose writer never closes it returns after 2 batches
              and lets go of the FIFO; (c) the serve task with
              run.serve_reload_url on a URL publish root: version 1 (the S3
              run's weights) adopted before its socket opens, version 2
              (the Pipe run's) swapped in, every answer within 1e-4 of the
              plain forward of the version it reports, the swap, stage and
              canary ms; B1 and B1' against their plain versions on the
              first batch through a bridge and the first through a FIFO.
              Every FIFO open, write and join and the store's start wait
              at most STREAM_DEADLINE_S.  Its `stream` line holds the card,
              examples/s and input-wait share by route (S3, Pipe, disk,
              and the lifecycle's local files), the bridges' bytes and
              resumes, the eval's examples and AUC, the reload's ms, the
              B1 and B1' runs and the phase's seconds; those runs are in
              the kernels line.
21. families - ROADMAP A12 at benchmarks/model_zoo.py's widths (117,581 x
              39 x 32, MLP 128/64/32, dropout 0.5, bf16, Adam 5e-4, batch
              1,024; xDeepFM's CIN 128/128, DCN-v2's 3 cross layers):
              for xDeepFM and DCN-v2 the train task through the CLI
              (`--model_name xdeepfm|dcnv2`, the graphed dense step) on the
              train phase's first 2 files (24 steps), the same with lazy
              Adam (DCN-v2: fm_v alone), then the eval (AUC within 1e-6 of
              the train task's), infer (pred.txt within TOL_PROB of the
              servable) and export (params bit-equal) tasks; xDeepFM
              must launch B1 and B1' every step (its gathers and first-order
              term), DCN-v2 neither (its gather is a plain one).  One
              float32 xDeepFM step through the kernels against the plain
              versions (loss and every gradient within the parity phase's
              limits), B1 and B1' (the zero cotangent of y_v) on the
              unpadded table with their times, plain times and bounds; the
              dense and lazy steps graphed against eager bit for bit (8
              steps of distinct ids) with the graphed step's device ms and
              its split (B1, B1', the CIN or the cross stack, the MLP, the
              optimizer, each timed alone); each exported servable behind
              GraphedPredictor at buckets 8 and 512: graphed vs eager
              within TOL_GRAPH, vs plain within TOL_PROB.  Two-tower on
              ratings written from --seed (65,536 train and 8,192
              validation rows at 162,541 users and 62,423 items): the
              train, eval and export tasks (`--model_name two_tower`), the
              exported encoder through load_retrieval_servable equal to
              the trained model's encode_queries, the step's device ms at
              model_zoo's 8 user and 4 item fields, and a [2, 2] grid of
              gloo ranks on the card (3 float32 steps) held to the
              single-card step on the same global batches.  Then the
              families on the other CTR paths (ROADMAP A12's remainder):
              each family's servable as a [1, 2] psum shard-group member
              (each of its tables in row shards) behind its bucket graphs,
              bit for bit the single-card graphed predict at buckets 8 and
              512; the online trainer of each family over 4 segments of
              distinct ids (commits and publishes every 2 steps), bit for
              bit one pass of the log, its versions of the family, the last
              one's answers the state's; xDeepFM's paged step on the
              tiered store (a hot cache of 65,536 slots that evicts) bit
              for bit the resident lazy step on 4 distinct batches, B1 on
              the hot cache and B1 and B1' on its compact rows against
              their plain versions, publish_tiered scored by a
              TieredScorer within 1e-6 of the resident model with one B1
              launch; phase 8's funnel ranking through the exported
              xDeepFM (FunnelScorer's graphs), held to the plain B2 and B1
              on the same payload; and the xDeepFM elastic drill (lazy,
              six rank processes started as warm standbys when these
              paths begin): [2, 2] -> [1, 2] after 2 steps -> [2, 2] after
              4, 6 steps, 0 table bytes moved on the shrink and more on
              the grow, 6 strictly increasing cursors, every manifest of
              xDeepFM at the true vocabulary, B1 and B1' on each rank's
              first compact rows of an epoch against their plain
              versions.  The `families` line holds the card, each
              family's examples/s, step ms and split, the paths' results
              and seconds, the two-tower metrics, and the phase's
              seconds; the B1, B1' and B2 runs are in the kernels line.
22. fleet   - ROADMAP A18 and A19 at the flagship width (phase 18's
              servable, buckets 8-512): (a) the serve task with
              --serve_groups 1 and --serve_tenants (one [1, 1] member
              process, the router, one swapper a tenant): tenants A and B
              split 50/50, each from its own publish root with its own
              weights from --seed, challenger C shadowing A at 100%; and,
              in this process, a member's predictor at one and two tenants
              (card bytes after capture, graph count); (b) 400 keyed
              requests of 1-4 rows: each answered by the port's
              TrafficSplit arm of its key, each within TOL_PROB of its
              tenant's plain forward on the card; (c) A's version 2
              published under 4 clients (two on A, two on B): A's swapper
              converges, B's answers the same bytes and labels throughout,
              A's labelled (1, 1) or (2, 2) only and held to their
              version's plain forward, the member's graph count unchanged;
              (d) /admin:split to 80/20 moves exactly the keys of the
              shifted window; (e) the shadow scored A's stream with no
              error, and no answer came from C; (f) `--task_type
              region-front` in a subprocess over two regions, each an
              in-process router over the member with its own store that
              the front's replicator fills from a home root: every key
              served by its rendezvous home (X-Region, X-Region-Home), a
              version published at home visible in both stores only with
              its whole tree, and one router stopped: its keys fail over
              with the headers and the client's trace id, which the
              surviving router records.  The `fleet` line holds the card,
              the boot seconds, the member's card bytes at one (phase 18)
              and three tenants, the per-tenant stage, canary and swap ms,
              the shadow's stats, the failover ms and the phase's seconds;
              the member's B1 runs (its exit line) are in the kernels
              line.

The script prints its total seconds; the last three lines of standard
output are the kernels' JSON line, the card's name and power limit, and
{"ok": true, "device": {...}}.  With no
CUDA device, or without the rest of the repository beside it, the script
exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import faulthandler
import io
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet), for the least-time bound
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BUCKETS = (8, 32, 128, 512)
# the train path's batch (DataConfig.batch_size) and a larger one
TRAIN_BATCHES = (1024, 4096)
# the funnel's rank stage: buckets 8 and 64 users x top 32 candidates
RANK_ROWS = (256, 2048)
# kernel vs plain, max abs error: emb is the same float32 product in both
# (exact); y_w and y_v differ only in summation order, relative to magnitude
TOL_EMB = 1e-6
TOL_YW_REL = 1e-5
TOL_YV_REL = 1e-4
# served probabilities vs the plain forward on the same padded bucket: the
# MLP input is bit-equal, only the FM sums' order differs
TOL_PROB = 1e-4
# a bucket graph's probabilities vs the eager kernel forward it captured:
# the same kernels on the same inputs
TOL_GRAPH = 1e-6
# sequential repeats of each :predict, for its latency
SERVE_REPEATS = 30
# backward kernel vs plain, and the parity step's gradients: max abs error
# relative to the output's largest magnitude.  The kernel sums duplicate
# rows with float32 atomics in an order that changes from run to run, the
# plain version in index order
TOL_GRAD_REL = 1e-5
# parity step loss: the same float32 arithmetic, FM sums in another order
TOL_LOSS_REL = 1e-6
# the train phase's synthetic data: 48 train batches in 4 files, 8 val
# batches, the JAX package's Criteo-shaped generator
TRAIN_FILES, TRAIN_RECORDS_PER_FILE = 4, 12 * 1024
VAL_RECORDS = 8 * 1024
LOG_STEPS = 8
# kernel B2 at the funnel's shapes: the served corpus (117,581 items) and
# benchmarks/funnel.py's 2e6-row corpus, tower dim 32, the serving buckets
# 8 and 64, top 32 x oversample 4
B2_CORPORA, B2_BATCHES, B2_DIM, B2_KOS = (117_581, 2_000_000), (8, 64), 32, 128
# kernel vs plain scores, position by position: one float32 dot per row
# summed in another order than cuBLAS's, dots of unit vectors (|s| <= 1)
TOL_B2_RTOL, TOL_B2_ATOL = 1e-4, 1e-5
# the served funnel (benchmarks/funnel.py's geometry at the flagship
# ranker): two-tower query encoder, int8 index of every ranker item
FUNNEL_USER_VOCAB, FUNNEL_FIELDS, FUNNEL_TOWER_EMB = 100_000, 3, 16
FUNNEL_TOWER_LAYERS, FUNNEL_TOWER_DIM = (64,), 32
FUNNEL_TOP_K, FUNNEL_RETURN_N, FUNNEL_OVERSAMPLE = 32, 8, 4
FUNNEL_BUCKETS = (8, 64)
FUNNEL_REQUESTS = (1, 8, 64)
FUNNEL_REPEATS = 10
# served retrieval scores vs the plain pipeline's: the same exact f32
# rescore of the same rows, rounded to 6 decimals in the response
TOL_RETR = 1e-5
# device recall@32 of the int8 path against the exact f32 top-32
RECALL_USERS = 256


def fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke: {msg}")


# the run must end within 1,200 s: still running at WATCHDOG_S, the script
# prints the phase and every thread's stack on stderr, kills the processes
# it started and exits 3 (faulthandler's own timer, which needs no
# interpreter lock, exits 1 a little later if that cannot run)
WATCHDOG_S = 1080
_phase = {"name": "start", "t0": time.perf_counter()}


def begin(name: str) -> None:
    """Name the phase that runs now, on stderr with the script's clock."""
    _phase["name"] = name
    print(f"chip_smoke: phase {name} at {time.perf_counter() - _phase['t0']:.1f} s",
          file=sys.stderr, flush=True)


def _descendants(pid: int) -> list[int]:
    """Every process under ``pid``, read from /proc."""
    children: dict[int, list[int]] = {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
        except (OSError, IndexError, ValueError):
            continue
        children.setdefault(ppid, []).append(int(entry))
    out, todo = [], [pid]
    while todo:
        for child in children.get(todo.pop(), []):
            out.append(child)
            todo.append(child)
    return out


def start_watchdog(seconds: float) -> None:
    def fire():
        print(f"chip_smoke: still in phase {_phase['name']} after {seconds:.0f} s; "
              f"every thread's stack:", file=sys.stderr, flush=True)
        faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
        for pid in _descendants(os.getpid()):
            with contextlib.suppress(OSError):
                os.kill(pid, signal.SIGKILL)
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(3)

    timer = threading.Timer(seconds, fire)
    timer.daemon = True
    timer.start()
    faulthandler.dump_traceback_later(seconds + 30, exit=True)


def reset_kernel_counts() -> None:
    """B1's and B1''s counts to 0: their eager launches, their launches
    captured into graphs, and their runs through train-step graph replays
    (train/step.py ``graph_kernel_runs``)."""
    from deepfm_tpu_torch.ops import fused_ctr
    from deepfm_tpu_torch.train import step

    fused_ctr.launches = fused_ctr.backward_launches = 0
    fused_ctr.captured = fused_ctr.backward_captured = 0
    step.graph_kernel_runs.update(forward=0, backward=0)


def kernel_runs() -> tuple[int, int]:
    """(B1 runs, B1' runs) since :func:`reset_kernel_counts`: eager launches
    plus the runs inside train-step graph replays (a capture itself runs
    nothing)."""
    from deepfm_tpu_torch.ops import fused_ctr
    from deepfm_tpu_torch.train import step

    return (fused_ctr.launches + step.graph_kernel_runs["forward"],
            fused_ctr.backward_launches + step.graph_kernel_runs["backward"])


def reset_funnel_counts() -> None:
    """B2's and B1's counts to 0: their eager launches, their launches
    captured into graphs, and their runs through the funnel's graph
    replays (funnel/graphs.py ``graph_kernel_runs``)."""
    from deepfm_tpu_torch.funnel import graphs
    from deepfm_tpu_torch.ops import fused_ctr, retrieval

    retrieval.launches = retrieval.captured = 0
    fused_ctr.launches = fused_ctr.captured = 0
    graphs.graph_kernel_runs.update(retrieval=0, forward=0)


def funnel_kernel_runs() -> tuple[int, int]:
    """(B2 runs, B1 runs) since :func:`reset_funnel_counts`: eager launches
    (the warm-ups before capture) plus the runs inside funnel graph
    replays (a capture itself runs nothing)."""
    from deepfm_tpu_torch.funnel import graphs
    from deepfm_tpu_torch.ops import fused_ctr, retrieval

    return (retrieval.launches + graphs.graph_kernel_runs["retrieval"],
            fused_ctr.launches + graphs.graph_kernel_runs["forward"])


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[torch.cuda.current_device()].strip()


def _median_event_ms(run, per: int, groups: int) -> float:
    times = []
    for _ in range(groups):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per)
    return float(np.median(times))


def time_ms(fn, reps: int = 50, groups: int = 7) -> tuple[float, float]:
    """(device ms, call ms) per call of ``fn``, each the median over
    ``groups`` of the mean over ``reps`` calls, from CUDA events.

    Device ms replays ``reps`` calls captured in one CUDA graph, so it is
    the GPU's time for the work without the host's launch cost.  Call ms
    times ``reps`` back-to-back Python calls, which is what an eager caller
    pays when the host, not the GPU, is the limit."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    device_ms = _median_event_ms(graph.replay, reps, groups)

    def eager():
        for _ in range(reps):
            fn()

    return device_ms, _median_event_ms(eager, reps, groups)


PROFILE_TRIES = 3


def device_profile(fn, n: int, cpu: bool = False):
    """``fn`` run ``n`` times under torch.profiler, or None when CUPTI gave
    no device activity in PROFILE_TRIES sessions.  A card's machine may
    give the profiler no device events at all; there the profiler's splits
    are printed as not measured and every time stands on CUDA events
    alone.  The kernels' launches and agreement are checked apart
    from this, through their counters and plain versions."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    for attempt in range(PROFILE_TRIES):
        with profile(activities=activities) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        if any(row.device_type == DeviceType.CUDA and row.device_time_total > 0
               for row in prof.key_averages()):
            return prof
        print(f"torch.profiler saw no device time (session {attempt + 1} of "
              f"{PROFILE_TRIES})", file=sys.stderr)
    print("torch.profiler: no device activity from CUPTI; this split is not measured")
    return None


def make_ids(rng: np.random.Generator, b: int, f: int, feature_size: int) -> np.ndarray:
    """Half uniform, half Zipf-skewed ids, with a few out of range and
    negative, as int64."""
    uniform = rng.integers(0, feature_size, size=(b, f))
    zipf = (rng.zipf(1.2, size=(b, f)) - 1) % feature_size
    ids = np.where(rng.random((b, f)) < 0.5, uniform, zipf)
    bad = rng.random((b, f))
    ids = np.where(bad < 0.01, feature_size + rng.integers(0, 10**6, (b, f)), ids)
    ids = np.where(bad > 0.99, -rng.integers(1, 10**6, (b, f)), ids)
    return ids.astype(np.int64)


def make_train_ids(rng: np.random.Generator, b: int, f: int, feature_size: int) -> np.ndarray:
    """make_ids with the 13 numeric fields set to the ids 1..13 that every
    Criteo record (and generate_synthetic_ctr) carries: 13 hot rows."""
    ids = make_ids(rng, b, f, feature_size)
    ids[:, :13] = np.arange(1, 14)
    return ids


def fused_ctr_bound_ms(fm_w, fm_v, ids32, b: int, f: int) -> tuple[float, str, dict]:
    """Least time for this call: each input read once (only the table rows
    this batch touches, each once), each output written once, over the
    HBM rate; or its float32 operations over the f32 peak."""
    k = fm_v.shape[1]
    rows = ids32.long().clamp(0, fm_v.shape[0] - 1)
    uniq_v = int(torch.unique(rows).numel())
    uniq_w = int(torch.unique(rows.clamp(max=fm_w.shape[0] - 1)).numel())
    nbytes = (b * f * 4 * 2                 # ids (int32) + vals
              + uniq_v * k * 4 + uniq_w * 4  # distinct table rows
              + b * f * k * 4 + 2 * b * 4)   # emb, y_w, y_v
    flops = 4 * b * f * k + 2 * b * f        # e = v*x, Σe, Σe² (fma), w*x
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    detail = {"bytes": nbytes, "flops": flops, "unique_rows": uniq_v,
              "lookups": b * f, "bytes_per_lookup_no_dedup": 4 + 4 + 4 + 2 * k * 4}
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations", detail


def phase_kernel(seed: int) -> dict:
    from deepfm_tpu_torch.core.config import ModelConfig
    from deepfm_tpu_torch.models.deepfm import fm_v_rows
    from deepfm_tpu_torch.ops import fused_ctr
    from deepfm_tpu_torch.ops.embedding import narrow_ids

    cfg = ModelConfig(fused_kernel="auto")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    v_rows, k, f = fm_v_rows(cfg), cfg.embedding_size, cfg.field_size
    fm_v = torch.randn((v_rows, k), generator=g, device=dev) * 0.05
    fm_v[cfg.feature_size:] = 0.0
    fm_w = torch.randn((cfg.feature_size,), generator=g, device=dev) * 0.05
    rng = np.random.default_rng(seed)
    result = {"per_bucket": {}}
    worst = 0.0
    for b in BUCKETS + RANK_ROWS + TRAIN_BATCHES:
        mk = make_train_ids if b in TRAIN_BATCHES else make_ids
        ids64 = torch.from_numpy(mk(rng, b, f, cfg.feature_size)).to(dev)
        vals = torch.from_numpy(rng.random((b, f)).astype(np.float32)).to(dev)
        # the serving path's ids: narrowed int32, clipped to feature_size-1
        ids32 = narrow_ids(ids64, cfg.feature_size)
        # and raw int32 ids past the padded rows, which clip inside the kernel
        raw32 = ids64.clamp(-2**31, 2**31 - 1).to(torch.int32)
        errs = {}
        for tag, ids in (("int32_narrowed", ids32), ("int32_raw", raw32), ("int64_raw", ids64)):
            got = fused_ctr.fused_ctr_interaction(fm_w, fm_v, ids, vals)
            want = fused_ctr.fused_ctr_plain(fm_w, fm_v, ids, vals)
            torch.cuda.synchronize()
            e = [float((a - w).abs().max()) for a, w in zip(got, want)]
            scale_w = 1.0 + float(want[1].abs().max())
            scale_v = 1.0 + float(want[2].abs().max())
            if not (e[0] <= TOL_EMB and e[1] <= TOL_YW_REL * scale_w
                    and e[2] <= TOL_YV_REL * scale_v):
                fail(f"fused_ctr_forward disagrees with its plain version at "
                     f"B={b} ({tag}): max abs err emb {e[0]}, y_w {e[1]}, y_v {e[2]}")
            errs[tag] = {"emb": e[0], "y_w": e[1], "y_v": e[2]}
            worst = max(worst, *e)
        ms, call_ms = time_ms(
            lambda: fused_ctr.fused_ctr_interaction(fm_w, fm_v, ids32, vals))
        plain_ms, plain_call_ms = time_ms(
            lambda: fused_ctr.fused_ctr_plain(fm_w, fm_v, ids32, vals))
        bound_ms, bound_by, detail = fused_ctr_bound_ms(fm_w, fm_v, ids32, b, f)
        row = {"max_abs_err": errs, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "bound_share": bound_ms / ms, "layout": fused_ctr.forward_layout(fm_v, b),
               "call_ms": call_ms, "plain_call_ms": plain_call_ms, **detail}
        result["per_bucket"][b] = row
        print("kernel fused_ctr_forward B=%d %s" % (b, json.dumps(row)))
    # the launch floor: one in-place add on one element, timed the same way,
    # is what any kernel launch costs here, whatever its work
    one = torch.zeros(1, device=dev)
    floor_ms, floor_call_ms = time_ms(lambda: one.add_(1.0))
    result["launch_floor"] = {"ms": floor_ms, "call_ms": floor_call_ms}
    print("kernel launch_floor %s" % json.dumps(result["launch_floor"]))
    result["max_abs_err"] = worst
    return result


def fused_ctr_backward_bound_ms(fm_w, fm_v, ids, b: int, f: int,
                                want_vals: bool) -> tuple[float, str, dict]:
    """Least time for one backward: g_emb, ids, vals, g_yw, g_yv and each
    distinct fm_v/fm_w row read once, each distinct gradient row (and
    d_vals) written once, over the HBM rate; or its float32 operations
    over the f32 peak.  The wrapper's zero fill is left out (timed on its
    own line)."""
    k = fm_v.shape[1]
    rows = ids.long().clamp(0, fm_v.shape[0] - 1)
    uniq, counts = torch.unique(rows, return_counts=True)
    uniq_v = int(uniq.numel())
    uniq_w = int(torch.unique(rows.clamp(max=fm_w.shape[0] - 1)).numel())
    nbytes = (b * f * k * 4                          # g_emb
              + b * f * (ids.element_size() + 4)     # ids, vals
              + 2 * b * 4                            # g_yw, g_yv
              + 2 * (uniq_v * k * 4 + uniq_w * 4)    # rows read, grads written
              + (b * f * 4 if want_vals else 0))     # d_vals
    # per element: e (1), sum_f e (1), g_e (3), g_e*val (1), the add (1),
    # d_vals' product and sum (2); per lookup: the fm_w term (2)
    flops = b * f * k * (7 + (2 if want_vals else 0)) + 2 * b * f
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    detail = {"bytes": nbytes, "flops": flops, "unique_rows": uniq_v,
              "lookups": b * f, "max_row_multiplicity": int(counts.max())}
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations", detail


def backward_kernel_only(lib, g_emb, g_yw, g_yv, fm_w, fm_v, ids, vals,
                         d_fm_w, d_fm_v, d_vals) -> None:
    """The backward kernel alone into preallocated outputs (no zero fill,
    no launch count): for timing the kernel apart from its wrapper."""
    b, f = ids.shape
    rc = lib.fused_ctr_backward(
        g_emb.data_ptr(), g_yw.data_ptr(), g_yv.data_ptr(), fm_w.data_ptr(),
        fm_w.shape[0], fm_v.data_ptr(), fm_v.shape[0], fm_v.shape[1],
        ids.data_ptr(), int(ids.dtype == torch.int64), vals.data_ptr(), b, f,
        d_fm_w.data_ptr(), d_fm_v.data_ptr(),
        None if d_vals is None else d_vals.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        fail(f"fused_ctr_backward launch failed: CUDA error {rc}")


def backward_same_row(lib, g_emb, g_yw, g_yv, fm_w, fm_v, vals, d_fm_w, d_fm_v):
    """The backward with every lookup on one row (row 7), int32 and int64
    ids, with d_vals: held to the plain version run in float64, since the
    B·F float32 terms of that one row sum with a rounding error near the
    tolerance in any float32 order (the plain version's atomics included).
    Returns (kernel ms on int32 ids without d_vals, largest abs error)."""
    from deepfm_tpu_torch.ops import fused_ctr

    b, f = vals.shape
    worst = 0.0
    want = fused_ctr.fused_ctr_backward_plain(
        *(t.double() for t in (g_emb, g_yw, g_yv, fm_w, fm_v)),
        torch.full((b, f), 7, device=vals.device), vals.double())
    for dtype in (torch.int32, torch.int64):
        ids = torch.full((b, f), 7, device=vals.device, dtype=dtype)
        got = fused_ctr.fused_ctr_backward(g_emb, g_yw, g_yv, fm_w, fm_v, ids, vals)
        torch.cuda.synchronize()
        for name, a, w in zip(("d_fm_w", "d_fm_v", "d_vals"), got, want):
            err, scale = float((a.double() - w).abs().max()), float(w.abs().max())
            if not err <= TOL_GRAD_REL * scale:
                fail(f"fused_ctr_backward disagrees with its plain version with every "
                     f"lookup on one row (B={b}, {dtype}): {name} max abs err {err}, "
                     f"scale {scale}")
            worst = max(worst, err)
    ids = torch.full((b, f), 7, device=vals.device, dtype=torch.int32)
    ms, _ = time_ms(lambda: backward_kernel_only(
        lib, g_emb, g_yw, g_yv, fm_w, fm_v, ids, vals, d_fm_w, d_fm_v, None))
    return ms, worst


def phase_backward(seed: int) -> dict:
    """fused_ctr_backward against fused_ctr_backward_plain at the train
    batches, full-width table: three id types of the train mix (13 hot
    rows), uniform ids (timed) and every lookup on one row."""
    from deepfm_tpu_torch.core.config import ModelConfig
    from deepfm_tpu_torch.models.deepfm import fm_v_rows
    from deepfm_tpu_torch.ops import fused_ctr
    from deepfm_tpu_torch.ops.embedding import narrow_ids

    cfg = ModelConfig(fused_kernel="auto")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 2)
    v_rows, k, f = fm_v_rows(cfg), cfg.embedding_size, cfg.field_size
    fm_v = torch.randn((v_rows, k), generator=g, device=dev) * 0.05
    fm_v[cfg.feature_size:] = 0.0
    fm_w = torch.randn((cfg.feature_size,), generator=g, device=dev) * 0.05
    rng = np.random.default_rng(seed + 2)
    lib = fused_ctr._library()
    result = {"per_batch": {}}
    worst = 0.0
    for b in TRAIN_BATCHES:
        ids64 = torch.from_numpy(make_train_ids(rng, b, f, cfg.feature_size)).to(dev)
        vals = torch.from_numpy(rng.random((b, f)).astype(np.float32)).to(dev)
        g_emb = torch.randn((b, f, k), generator=g, device=dev)
        g_yw = torch.randn((b,), generator=g, device=dev)
        g_yv = torch.randn((b,), generator=g, device=dev)
        ids32 = narrow_ids(ids64, cfg.feature_size)
        raw32 = ids64.clamp(-2**31, 2**31 - 1).to(torch.int32)
        errs = {}
        for tag, ids in (("int32_narrowed", ids32), ("int32_raw", raw32), ("int64_raw", ids64)):
            got = fused_ctr.fused_ctr_backward(g_emb, g_yw, g_yv, fm_w, fm_v, ids, vals)
            want = fused_ctr.fused_ctr_backward_plain(g_emb, g_yw, g_yv, fm_w, fm_v, ids, vals)
            torch.cuda.synchronize()
            e = {}
            for name, a, w in zip(("d_fm_w", "d_fm_v", "d_vals"), got, want):
                e[name] = float((a - w).abs().max())
                scale = float(w.abs().max())
                if not e[name] <= TOL_GRAD_REL * scale:
                    fail(f"fused_ctr_backward disagrees with its plain version at "
                         f"B={b} ({tag}): {name} max abs err {e[name]}, scale {scale}")
                worst = max(worst, e[name])
            errs[tag] = e
        # the train path's call: narrowed ids, no d_vals (vals take no grad)
        d_fm_w, d_fm_v = torch.zeros_like(fm_w), torch.zeros_like(fm_v)
        d_vals = torch.empty((b, f), device=dev)
        ms, call_ms = time_ms(lambda: backward_kernel_only(
            lib, g_emb, g_yw, g_yv, fm_w, fm_v, ids32, vals, d_fm_w, d_fm_v, None))
        vals_ms, _ = time_ms(lambda: backward_kernel_only(
            lib, g_emb, g_yw, g_yv, fm_w, fm_v, ids32, vals, d_fm_w, d_fm_v, d_vals))
        wrapper_ms, wrapper_call_ms = time_ms(lambda: fused_ctr.fused_ctr_backward(
            g_emb, g_yw, g_yv, fm_w, fm_v, ids32, vals, False))
        fill_ms, _ = time_ms(lambda: (torch.zeros_like(fm_w), torch.zeros_like(fm_v)))
        plain_ms, plain_call_ms = time_ms(lambda: fused_ctr.fused_ctr_backward_plain(
            g_emb, g_yw, g_yv, fm_w, fm_v, ids32, vals, False), reps=20)
        # the same call on uniform ids: no hot rows, so no atomic collisions
        # beyond chance; the difference is what the hot rows cost
        uniform = torch.randint(0, cfg.feature_size, (b, f), generator=g, device=dev,
                                dtype=torch.int32)
        uniform_ms, _ = time_ms(lambda: backward_kernel_only(
            lib, g_emb, g_yw, g_yv, fm_w, fm_v, uniform, vals, d_fm_w, d_fm_v, None))
        uniform_bound_ms = fused_ctr_backward_bound_ms(fm_w, fm_v, uniform, b, f, False)[0]
        same_ms, same_err = backward_same_row(lib, g_emb, g_yw, g_yv, fm_w, fm_v, vals,
                                              d_fm_w, d_fm_v)
        worst = max(worst, same_err)
        bound_ms, bound_by, detail = fused_ctr_backward_bound_ms(
            fm_w, fm_v, ids32, b, f, False)
        vals_bound_ms, _, _ = fused_ctr_backward_bound_ms(fm_w, fm_v, ids32, b, f, True)
        fill_bound_ms = (fm_w.numel() + fm_v.numel()) * 4 / HBM_BYTES_PER_S * 1e3
        row = {"max_abs_err": errs, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by, "call_ms": call_ms,
               "plain_call_ms": plain_call_ms, "with_d_vals_ms": vals_ms,
               "with_d_vals_bound_ms": vals_bound_ms,
               "wrapper_ms": wrapper_ms, "wrapper_call_ms": wrapper_call_ms,
               "zero_fill_ms": fill_ms, "zero_fill_bound_ms": fill_bound_ms,
               "uniform_ids_ms": uniform_ms, "uniform_ids_bound_ms": uniform_bound_ms,
               "train_over_uniform": ms / uniform_ms,
               "same_row_ms": same_ms, "same_row_max_abs_err": same_err, **detail}
        result["per_batch"][b] = row
        print("kernel fused_ctr_backward B=%d %s" % (b, json.dumps(row)))
    result["max_abs_err"] = worst
    return result


def write_synthetic(seed: int, train_dir: str, val_dir: str) -> None:
    """The train phase's TFRecords, from the port's copy of the JAX
    package's generator."""
    from deepfm_tpu_torch.data.libsvm import generate_synthetic_ctr

    t0 = time.perf_counter()
    for i in range(TRAIN_FILES):
        generate_synthetic_ctr(os.path.join(train_dir, f"train-{i}.tfrecords"),
                               num_records=TRAIN_RECORDS_PER_FILE, seed=seed * 100 + i)
    generate_synthetic_ctr(os.path.join(val_dir, "val-0.tfrecords"),
                           num_records=VAL_RECORDS, seed=seed * 100 + 99)
    print(f"data: wrote {TRAIN_FILES * TRAIN_RECORDS_PER_FILE} train and "
          f"{VAL_RECORDS} val records in {time.perf_counter() - t0:.2f} s")


def first_batch(data_dir: str, pattern: str, batch: int, dev) -> dict:
    from deepfm_tpu_torch.data.pipeline import batched_ctr_batches, discover_files, record_stream

    files = discover_files(data_dir, (pattern,), shuffle=False)
    b = next(batched_ctr_batches(record_stream(files), batch_size=batch, field_size=39))
    return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}


def phase_parity(seed: int, train_dir: str) -> dict:
    """One loss.backward() through the kernels and one through the plain
    versions (plain forward, autograd backward), same weights, same card."""
    from deepfm_tpu_torch.core.config import ModelConfig
    from deepfm_tpu_torch.models import DeepFM
    from deepfm_tpu_torch.ops import fused_ctr
    from deepfm_tpu_torch.train.step import loss_terms

    cfg = ModelConfig(fused_kernel="auto", compute_dtype="float32",
                      dropout_keep=(1.0, 1.0, 1.0))
    model = DeepFM(cfg, device="cuda", generator=torch.Generator().manual_seed(seed))
    model.train()
    batch = first_batch(train_dir, "train", 1024, "cuda")
    params = dict(model.named_parameters())
    out = []
    for fused in (fused_ctr.fused_ctr_interaction, fused_ctr.fused_ctr_plain):
        ids, vals = model.prepare(batch["feat_ids"], batch["feat_vals"])
        logits = model.head(*fused(model.fm_w, model.fm_v, ids, vals))
        loss, _ = loss_terms(model, logits, batch["label"])
        out.append((loss, torch.autograd.grad(loss, list(params.values()))))
    torch.cuda.synchronize()
    (loss_k, grads_k), (loss_p, grads_p) = out
    loss_k, loss_p = float(loss_k.detach()), float(loss_p.detach())
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    if not (np.isfinite(loss_k) and loss_err <= TOL_LOSS_REL):
        fail(f"parity: loss through the kernels {loss_k} vs plain {loss_p} "
             f"(relative {loss_err})")
    errs = {}
    for name, a, w in zip(params, grads_k, grads_p):
        err, scale = float((a - w).abs().max()), float(w.abs().max())
        if not err <= TOL_GRAD_REL * scale:
            fail(f"parity: gradient of {name} max abs err {err}, scale {scale}")
        errs[name] = err / scale if scale else err
    print("parity %s" % json.dumps({"loss": loss_k, "loss_rel_err": loss_err,
                                    "grad_rel_err": errs}))
    return {"loss_rel_err": loss_err, "max_grad_rel_err": max(errs.values())}


class _Tee(io.TextIOBase):
    """Writes to the real stdout and keeps a copy."""

    def __init__(self, out):
        self.out, self.lines = out, io.StringIO()

    def write(self, s):
        self.lines.write(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def phase_train(seed: int, train_dir: str, val_dir: str, servable: str) -> dict:
    """The main path of this slice: the CLI's train task at full width."""
    from deepfm_tpu_torch.launch import cli
    from deepfm_tpu_torch.serve.export import load_servable
    from deepfm_tpu_torch.train.step import predict_step

    argv = train_argv(train_dir, val_dir, servable, seed)
    print("train: python -m deepfm_tpu_torch " + " ".join(argv))
    torch.cuda.reset_peak_memory_stats()
    tee = _Tee(sys.stdout)
    # the main path: counts from 0, then the train task, then read
    reset_kernel_counts()
    with contextlib.redirect_stdout(tee):
        state = cli.run(argv)
    launches, backward_launches = kernel_runs()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    records = [json.loads(x) for x in tee.lines.getvalue().splitlines()
               if x.startswith("{")]
    train = [r for r in records if r["kind"] == "train"]
    done = next(r for r in records if r["kind"] == "train_done")
    ev = next(r for r in records if r["kind"] == "eval")
    steps = done["steps"]
    if not train or not all(np.isfinite(r["loss"]) and np.isfinite(r["ce"]) for r in train):
        fail(f"train: a logged loss is not finite: {train}")
    if not train[-1]["ce"] < train[0]["ce"]:
        fail(f"train: the last window's ce {train[-1]['ce']} is not below the "
             f"first's {train[0]['ce']}")
    if launches < steps or backward_launches < steps:
        fail(f"train: {steps} steps launched fused_ctr_forward {launches} and "
             f"fused_ctr_backward {backward_launches} times")
    if not (0.0 <= ev["auc"] <= 1.0 and np.isfinite(ev["loss"])):
        fail(f"train: eval gave {ev}")
    print(f"train: {steps} steps; launches on the main path: fused_ctr_forward "
          f"{launches} (= {steps} train + {launches - steps} eval), "
          f"fused_ctr_backward {backward_launches}; ce {train[0]['ce']} -> "
          f"{train[-1]['ce']}; eval auc {ev['auc']} loss {ev['loss']} over "
          f"{ev['examples']} examples")
    print("train: end to end %s" % json.dumps({
        "examples_per_sec": done["examples_per_sec"],
        "input_wait_share": done["input_wait_share"], "seconds": done["seconds"],
        "peak_memory_gib": peak_gb}))

    # the servable against the trained model, on one val batch
    predict, _ = load_servable(servable, device="cuda")
    batch = first_batch(val_dir, "val", 1024, "cuda")
    want = predict_step(state.model, batch).cpu().numpy()
    got = predict(batch["feat_ids"].cpu().numpy(), batch["feat_vals"].cpu().numpy())
    err = float(np.abs(got - want).max())
    if got.shape != want.shape or not np.all(np.isfinite(got)) or err > TOL_PROB:
        fail(f"train: the servable's probabilities differ from the trained "
             f"model's by {err} (tolerance {TOL_PROB})")
    print(f"train: servable probabilities vs the trained model's predict step: "
          f"max abs diff {err}")
    split = {b: step_breakdown(state, first_batch(train_dir, "train", b, "cuda"))
             for b in TRAIN_BATCHES}
    return {"launches": launches, "backward_launches": backward_launches,
            "steps": steps, "auc": ev["auc"], "breakdown": split,
            "examples_per_sec": done["examples_per_sec"]}


def decode_ms(train_dir: str, reps: int = 5) -> dict:
    """Host time to read and decode one batch of 1,024 records, alone on
    the host (median over ``reps``, host clock): the pipeline's C++ reader
    (``NativeCtrReader``: framing, CRC, decode) and its pure-Python route
    (``record_stream`` + ``decode_ctr_batch``), and the Python decode of
    records already in memory."""
    from deepfm_tpu_torch.data.example_proto import decode_ctr_batch
    from deepfm_tpu_torch.data.pipeline import batched_ctr_batches, discover_files, record_stream
    from deepfm_tpu_torch.native import NativeCtrReader

    files = discover_files(train_dir, ("train",), shuffle=False)[:1]
    records = []
    for rec in record_stream(files):
        records.append(rec)
        if len(records) == 1024:
            break

    def median_ms(fn) -> float:
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))

    out = {
        "native_read_decode_ms": median_ms(lambda: next(iter(NativeCtrReader(
            files, batch_size=1024, field_size=39)))),
        "python_read_decode_ms": median_ms(lambda: next(batched_ctr_batches(
            record_stream(files), batch_size=1024, field_size=39))),
        "python_decode_only_ms": median_ms(lambda: decode_ctr_batch(records, 39)),
    }
    print("decode: one 1,024-record batch, host ms, median of %d (host clock, no "
          "other thread running) %s" % (reps, json.dumps(out)))
    return out


def step_breakdown(state, batch: dict, reps: int = 20) -> dict:
    """One train step with its batch already on the card: device time from
    CUDA events (median of single steps), and its split by kernel from
    torch.profiler (None where it saw no device time).  Returns the
    printed numbers."""
    from torch.autograd import DeviceType

    from deepfm_tpu_torch.train.step import train_step

    for _ in range(3):
        train_step(state, batch)
    torch.cuda.synchronize()
    step_ms = _median_event_ms(lambda: train_step(state, batch), 1, reps)
    rows = batch["feat_ids"].clamp(0, state.model.cfg.feature_size - 1)
    multiplicity = int(torch.unique(rows, return_counts=True)[1].max())
    result = {"step_device_ms": step_ms, "kernel_busy_ms": None,
              "max_row_multiplicity": multiplicity, "idle_share": None, "split_ms": None}
    n = 5
    prof = device_profile(lambda: train_step(state, batch), n, cpu=True)
    if prof is not None:
        kernels = {"forward_kernel": 0.0, "backward_kernel": 0.0, "zero_fill": 0.0}
        total = 0.0
        for row in prof.key_averages():
            if row.device_type != DeviceType.CUDA or row.key == "train.optimizer":
                continue
            us = row.device_time_total
            total += us
            if "fused_ctr_forward_kernel" in row.key:
                kernels["forward_kernel"] += us
            elif "fused_ctr_backward_kernel" in row.key:
                kernels["backward_kernel"] += us
            elif "FillFunctor" in row.key or "Memset" in row.key:
                kernels["zero_fill"] += us
        optimizer = sum(e.device_time_total for e in prof.events()
                        if e.name == "train.optimizer" and e.device_type == DeviceType.CPU)
        split = {k: v / n / 1e3 for k, v in kernels.items()}
        split["optimizer_update"] = optimizer / n / 1e3
        split["mlp_fwd_bwd_and_rest"] = (total - sum(kernels.values()) - optimizer) / n / 1e3
        busy_ms = total / n / 1e3
        result.update(kernel_busy_ms=busy_ms, idle_share=1.0 - busy_ms / step_ms,
                      split_ms=split)
    print("train step breakdown B=%d %s" % (batch["label"].shape[0], json.dumps(result)))
    return result


def train_argv(train_dir: str, val_dir: str, servable: str, seed: int) -> list[str]:
    """The train task's command line; its checkpoints go beside the
    servable, so every run starts from nothing."""
    return ["--task_type", "train", "--training_data_dir", train_dir,
            "--val_data_dir", val_dir, "--servable_model_dir", servable,
            "--model_dir", servable + ".ckpt", "--num_epochs", "1",
            "--log_steps", str(LOG_STEPS),
            "--set", "model.fused_kernel=auto", "--set", f"run.seed={seed}"]


# the prep phase: raw Criteo TSV from --seed, converted by the port's
# converter with the hash encoder at the flagship vocabulary, then trained
PREP_TRAIN_LINES, PREP_VAL_LINES, PREP_SHARD = 98_304, 8_192, 32_768
PREP_FEATURES = 117_581
PREP_LIBSVM_RECORDS = 4_096


def write_criteo_tsv(path: str, n: int, seed: int) -> None:
    """``n`` raw Criteo lines (label, 13 counts, 26 hex tokens): counts
    heavy-tailed with 30% missing and a few negative, tokens Zipf-skewed
    over per-field vocabularies of 10 to 100,000 with 20% missing, the
    label more likely for the first field's hottest tokens, and about one
    line in a hundred ending in CRLF."""
    rng = np.random.default_rng(seed)
    counts = np.minimum(rng.zipf(1.6, (n, 13)) - 1, 10**6)
    counts = np.where(rng.random((n, 13)) < 0.002, -rng.integers(1, 4, (n, 13)), counts)
    vocab = np.array([10 ** (1 + j % 5) for j in range(26)])
    cat = (rng.zipf(1.2, (n, 26)) - 1) % vocab
    tokens = (cat.astype(np.uint64) * np.uint64(2654435761)
              + np.arange(26, dtype=np.uint64) * np.uint64(97)) % np.uint64(2**32)
    labels = rng.random(n) < np.where(cat[:, 0] < 3, 0.45, 0.15)
    int_missing = rng.random((n, 13)) < 0.3
    cat_missing = rng.random((n, 26)) < 0.2
    crlf = rng.random(n) < 0.01
    with open(path, "w", newline="") as f:
        for i in range(n):
            ints = ["" if m else str(c) for c, m in zip(counts[i].tolist(), int_missing[i])]
            cats = ["" if m else f"{t:08x}" for t, m in zip(tokens[i].tolist(), cat_missing[i])]
            f.write("\t".join([str(int(labels[i]))] + ints + cats)
                    + ("\r\n" if crlf[i] else "\n"))


def convert_criteo(tsv: str, out: str, prefix: str, native: bool):
    """``python -m deepfm_tpu_torch.data.criteo`` with the hash encoder,
    started as its own process; returns it (the caller waits)."""
    env = {k: v for k, v in os.environ.items() if k != "DEEPFM_NO_NATIVE"}
    if not native:
        env["DEEPFM_NO_NATIVE"] = "1"
    argv = [sys.executable, "-m", "deepfm_tpu_torch.data.criteo", tsv, out, "--encoder",
            "hash", "--feature_size", str(PREP_FEATURES), "--records_per_shard",
            str(PREP_SHARD), "--prefix", prefix]
    return subprocess.Popen(argv, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def start_conversions(jobs) -> list:
    """Start every ``(tsv, out, prefix, native)`` conversion at once, each
    reaped by a thread of its own that notes its exit time."""
    t0 = time.perf_counter()
    started = []
    for job in jobs:
        proc, done = convert_criteo(*job), {}

        def reap(proc=proc, done=done):
            done["out"], done["err"] = proc.communicate(timeout=600)
            done["s"] = time.perf_counter() - t0

        thread = threading.Thread(target=reap, daemon=True)
        thread.start()
        started.append((job[1], proc, thread, done))
    return started


def wait_conversions(started) -> dict:
    """Wait for :func:`start_conversions`' processes; returns each one's
    seconds (host clock, start to exit) by output directory."""
    secs = {}
    for out, proc, thread, done in started:
        thread.join(timeout=660)
        if proc.returncode != 0 or "s" not in done:
            fail(f"prep: the conversion into {out} failed ({proc.returncode}): "
                 f"{done.get('err', '')[-3000:]}")
        info = json.loads(done["out"].strip().splitlines()[-1])
        if info["encoder"] != "hash" or info["feature_size"] != PREP_FEATURES:
            fail(f"prep: the conversion into {out} printed {info}")
        secs[out] = done["s"]
    return secs


def phase_prep(seed: int, workdir: str, card: str) -> dict:
    """The reference's data preparation through the port: raw Criteo TSV
    from --seed, converted with the hash encoder by the C++ route and by
    the Python route (DEEPFM_NO_NATIVE=1), which must write byte-equal
    shards; a libsvm round trip through both directions of the libsvm
    converter; then the train task at full width on the converted shards,
    one epoch: losses finite and falling, B1 and B1' every step, eval AUC
    in [0, 1]."""
    from deepfm_tpu_torch.data.criteo import CriteoHashEncoder, convert_criteo_to_tfrecords
    from deepfm_tpu_torch.data.example_proto import parse_example
    from deepfm_tpu_torch.data.tfrecord import read_records, write_records
    from deepfm_tpu_torch.launch import cli

    t_phase = time.perf_counter()
    os.makedirs(workdir, exist_ok=True)
    tsv = {"tr": os.path.join(workdir, "train.tsv"), "va": os.path.join(workdir, "val.tsv")}
    t0 = time.perf_counter()
    write_criteo_tsv(tsv["tr"], PREP_TRAIN_LINES, seed * 7 + 1)
    write_criteo_tsv(tsv["va"], PREP_VAL_LINES, seed * 7 + 2)
    print(f"prep: wrote {PREP_TRAIN_LINES} + {PREP_VAL_LINES} raw Criteo lines in "
          f"{time.perf_counter() - t0:.2f} s")
    dirs = {(prefix, route): os.path.join(workdir, f"{route}-{prefix}")
            for prefix in tsv for route in ("native", "python")}
    # each route's two conversions at once: the Python route's in the
    # background while the native route's shards go through the libsvm
    # round trip and the train task
    python_route = start_conversions([(tsv[p], dirs[(p, "python")], p, False) for p in tsv])
    secs = wait_conversions(start_conversions([(tsv[p], dirs[(p, "native")], p, True)
                                               for p in tsv]))
    n_train = -(-PREP_TRAIN_LINES // PREP_SHARD)
    shards = {p: sorted(os.listdir(dirs[(p, "native")])) for p in tsv}
    if shards != {"tr": [f"tr-{i:05d}.tfrecords" for i in range(n_train)],
                  "va": ["va-00000.tfrecords"]}:
        fail(f"prep: the native route wrote {shards}")

    # libsvm: the first records of a converted shard out and back
    first = os.path.join(workdir, "first.tfrecords")
    recs = []
    for r in read_records(os.path.join(dirs[("tr", "native")], "tr-00000.tfrecords")):
        recs.append(r)
        if len(recs) == PREP_LIBSVM_RECORDS:
            break
    write_records(first, recs)
    text, back, again = (os.path.join(workdir, n) for n in ("first.libsvm", "back.tfrecords",
                                                            "again.libsvm"))
    for argv in (["--reverse", first, text], [text, back], ["--reverse", back, again]):
        out = subprocess.run([sys.executable, "-m", "deepfm_tpu_torch.data.libsvm", *argv],
                             cwd=ROOT, capture_output=True, text=True, timeout=300)
        if out.returncode != 0 or json.loads(out.stdout)["records"] != PREP_LIBSVM_RECORDS:
            fail(f"prep: libsvm {argv}: {out.returncode} {out.stdout} {out.stderr[-2000:]}")
    with open(text) as a, open(again) as b:
        if a.read() != b.read():
            fail("prep: the libsvm text is not a fixed point of the round trip")
    worst = 0.0
    for r0, r1 in zip(recs, read_records(back)):
        e0, e1 = parse_example(r0), parse_example(r1)
        if not (np.array_equal(e0["ids"], e1["ids"])
                and np.array_equal(e0["label"], e1["label"])):
            fail("prep: the libsvm round trip changed a record's ids or label")
        worst = max(worst, float(np.max(np.abs(e0["values"] - e1["values"])
                                        / np.maximum(np.abs(e0["values"]), 1e-30))))
    if worst > 1e-5:  # %g keeps six significant digits
        fail(f"prep: the libsvm round trip moved a value by {worst} (relative)")

    # the train task on the converted shards, at full width
    servable = os.path.join(workdir, "servable")
    argv = (train_argv(dirs[("tr", "native")], dirs[("va", "native")], servable, seed)
            + ["--feature_size", str(PREP_FEATURES), "--batch_size", "1024",
               "--device", DEVICE])
    print("prep: python -m deepfm_tpu_torch " + " ".join(argv))
    tee = _Tee(sys.stdout)
    # the main path: counts from 0, then the train task, then read
    reset_kernel_counts()
    with contextlib.redirect_stdout(tee):
        cli.run(argv)
    launches, backward_launches = kernel_runs()
    records = [json.loads(x) for x in tee.lines.getvalue().splitlines() if x.startswith("{")]
    train = [r for r in records if r["kind"] == "train"]
    done = next(r for r in records if r["kind"] == "train_done")
    ev = next(r for r in records if r["kind"] == "eval")
    steps = done["steps"]
    if steps != PREP_TRAIN_LINES // 1024:
        fail(f"prep: the train task took {steps} steps over {PREP_TRAIN_LINES} records")
    if not train or not all(np.isfinite(r["loss"]) and np.isfinite(r["ce"]) for r in train):
        fail(f"prep: a logged loss is not finite: {train}")
    if not train[-1]["ce"] < train[0]["ce"]:
        fail(f"prep: the last window's ce {train[-1]['ce']} is not below the first's "
             f"{train[0]['ce']}")
    if DEVICE == "cuda" and (launches < steps or backward_launches < steps):
        fail(f"prep: {steps} steps launched fused_ctr_forward {launches} and "
             f"fused_ctr_backward {backward_launches} times")
    if not (0.0 <= ev["auc"] <= 1.0 and np.isfinite(ev["loss"])):
        fail(f"prep: eval gave {ev}")
    secs.update(wait_conversions(python_route))
    for prefix in tsv:
        if sorted(os.listdir(dirs[(prefix, "python")])) != shards[prefix]:
            fail(f"prep: the Python route wrote other shards than {shards[prefix]}")
        for name in shards[prefix]:
            with open(os.path.join(dirs[(prefix, "native")], name), "rb") as a, \
                    open(os.path.join(dirs[(prefix, "python")], name), "rb") as b:
                if a.read() != b.read():
                    fail(f"prep: {name} differs between the native and the Python route")
    cli_s = {route: {p: secs[dirs[(p, route)]] for p in tsv} for route in ("native", "python")}
    # the encoders' own rates, in this process (no interpreter start): the
    # native route over the train lines, the Python route over the val lines
    rates = {}
    for route, p, n in (("native", "tr", PREP_TRAIN_LINES), ("python", "va", PREP_VAL_LINES)):
        if route == "python":
            os.environ["DEEPFM_NO_NATIVE"] = "1"
        try:
            t0 = time.perf_counter()
            convert_criteo_to_tfrecords(tsv[p], os.path.join(workdir, f"timed-{route}"),
                                        CriteoHashEncoder(PREP_FEATURES),
                                        records_per_shard=PREP_SHARD, prefix=p)
            rates[route] = {"lines": n, "records_per_s": n / (time.perf_counter() - t0)}
        finally:
            os.environ.pop("DEEPFM_NO_NATIVE", None)
    seconds = time.perf_counter() - t_phase
    print("prep %s" % json.dumps({
        "card": card, "records": {"train": PREP_TRAIN_LINES, "val": PREP_VAL_LINES},
        "shards": shards,
        "routes_byte_equal": True,
        "convert_records_per_s": rates,
        "convert_note": "host clock, convert_criteo_to_tfrecords in this process",
        "cli_seconds": cli_s,
        "cli_note": "host clock, process start to exit; a route's train and val "
                    "conversions run at once, the Python route's beside the native "
                    "route's, the libsvm round trip and the train task",
        "libsvm_round_trip": {"records": PREP_LIBSVM_RECORDS, "max_rel_value_err": worst},
        "train": {"steps": steps, "ce_first": train[0]["ce"], "ce_last": train[-1]["ce"],
                  "eval_auc": ev["auc"], "eval_loss": ev["loss"],
                  "examples_per_sec": done["examples_per_sec"],
                  "input_wait_share": done["input_wait_share"],
                  "note": "host clock, two converter processes beside it"},
        "launches": {"fused_ctr_forward": launches, "fused_ctr_backward": backward_launches},
        "seconds": seconds}))
    return {"launches": launches, "backward_launches": backward_launches}


def phase_lazy(seed: int, train_dir: str, val_dir: str, servable: str,
               dense: dict) -> dict:
    """The train task at full width with lazy Adam on the tables: the
    losses, both kernels launched every step, one lazy step through the
    kernels against the plain versions, and the lazy step's device time
    and split beside the dense step's (``dense``: the train phase's
    breakdown at B=1,024)."""
    from deepfm_tpu_torch.launch import cli

    argv = train_argv(train_dir, val_dir, servable, seed) + [
        "--set", "optimizer.lazy_embedding_updates=true"]
    print("lazy: python -m deepfm_tpu_torch " + " ".join(argv))
    tee = _Tee(sys.stdout)
    # the main path: counts from 0, then the train task, then read
    reset_kernel_counts()
    with contextlib.redirect_stdout(tee):
        state = cli.run(argv)
    launches, backward_launches = kernel_runs()
    records = [json.loads(x) for x in tee.lines.getvalue().splitlines()
               if x.startswith("{")]
    train = [r for r in records if r["kind"] == "train"]
    done = next(r for r in records if r["kind"] == "train_done")
    ev = next(r for r in records if r["kind"] == "eval")
    steps = done["steps"]
    if state.lazy is None:
        fail("lazy: the train task did not build the lazy state")
    if not train or not all(np.isfinite(r["loss"]) and r["loss"] == r["ce"] for r in train):
        fail(f"lazy: a logged loss is not finite or not the CE alone: {train}")
    if not train[-1]["ce"] < train[0]["ce"]:
        fail(f"lazy: the last window's ce {train[-1]['ce']} is not below the "
             f"first's {train[0]['ce']}")
    if launches < steps or backward_launches < steps:
        fail(f"lazy: {steps} steps launched fused_ctr_forward {launches} and "
             f"fused_ctr_backward {backward_launches} times")
    print(f"lazy: {steps} steps; launches on the main path: fused_ctr_forward "
          f"{launches} (= {steps} train + {launches - steps} eval), "
          f"fused_ctr_backward {backward_launches}; ce {train[0]['ce']} -> "
          f"{train[-1]['ce']}; eval auc {ev['auc']}; examples/s "
          f"{done['examples_per_sec']}, input-wait share {done['input_wait_share']}")
    lazy_parity(seed, train_dir)
    batch = first_batch(train_dir, "train", TRAIN_BATCHES[0], "cuda")
    compact = compact_kernels(state, batch, seed)
    lazy_breakdown(state, batch, dense)
    return {"launches": launches, "backward_launches": backward_launches,
            "steps": steps, "examples_per_sec": done["examples_per_sec"], **compact}


def compact_kernels(state, batch: dict, seed: int) -> dict:
    """B1 and B1' at the shapes the lazy step gives them: the compact tables
    fm_v[row_id] [B·F, K] and fm_w[row_id] [B·F], each lookup's segment as
    its id (:func:`compact_kernel_check`)."""
    model = state.model
    ids, vals = model.prepare(batch["feat_ids"], batch["feat_vals"])
    row = compact_kernel_check(model.fm_w.detach(), model.fm_v.detach(), ids, vals, seed,
                               "lazy")
    return {"forward_max_abs_err": max(row["forward_max_abs_err"]),
            "backward_max_abs_err": max(row["backward_max_abs_err"])}


def compact_kernel_check(fm_w, fm_v, ids, vals, seed: int, tag: str) -> dict:
    """The lazy step's segments of ``ids [B, F]`` over the tables ``fm_w``,
    ``fm_v`` (a model's, or the tiered store's hot cache with slot ids),
    the compact rows gathered, and B1 and B1' on them, each against its
    plain version (the forward's tolerances; the backward's TOL_GRAD_REL,
    against the plain version in float64);
    then both kernels' times (kernel alone, CUDA graph), B1''s plain
    version's, their bounds and the compact zero fill's.  Prints and
    returns the ``<tag> compact kernels`` row."""
    from deepfm_tpu_torch.ops import fused_ctr
    from deepfm_tpu_torch.ops.embedding import sort_segments

    b, f = ids.shape
    k = fm_v.shape[1]
    order, seg, row_id, valid = sort_segments(ids.reshape(-1).clamp(0, fm_w.shape[0] - 1))
    slot = torch.empty_like(seg).scatter_(0, order, seg).to(torch.int32).view(b, f)
    fm_w_c, fm_v_c = fm_w[row_id], fm_v[row_id]
    got = fused_ctr.fused_ctr_interaction(fm_w_c, fm_v_c, slot, vals)
    want = fused_ctr.fused_ctr_plain(fm_w_c, fm_v_c, slot, vals)
    g = torch.Generator(device="cuda").manual_seed(seed + 9)
    g_emb = torch.randn((b, f, k), generator=g, device="cuda")
    g_yw = torch.randn((b,), generator=g, device="cuda")
    g_yv = torch.randn((b,), generator=g, device="cuda")
    got_b = fused_ctr.fused_ctr_backward(g_emb, g_yw, g_yv, fm_w_c, fm_v_c, slot, vals, False)
    # held to the plain version run in float64, as backward_same_row is: a
    # hot compact row sums B float32 terms, and the plain version's atomics
    # round them near the tolerance (on an H100 at seed 0 its float32 sum
    # was off the float64 one by up to 1.5e-5 of the largest row, the
    # kernel's by at most 8.4e-7)
    want_b = fused_ctr.fused_ctr_backward_plain(
        *(t.double() for t in (g_emb, g_yw, g_yv, fm_w_c, fm_v_c)), slot, vals.double(),
        False)
    torch.cuda.synchronize()
    e = [float((a - w).abs().max()) for a, w in zip(got, want)]
    if not (e[0] <= TOL_EMB and e[1] <= TOL_YW_REL * (1.0 + float(want[1].abs().max()))
            and e[2] <= TOL_YV_REL * (1.0 + float(want[2].abs().max()))):
        fail(f"{tag}: fused_ctr_forward on the compact tables disagrees with its plain "
             f"version: max abs err emb {e[0]}, y_w {e[1]}, y_v {e[2]}")
    eb = []
    for name, a, w in zip(("d_fm_w", "d_fm_v"), got_b, want_b):
        err, scale = float((a.double() - w).abs().max()), float(w.abs().max())
        if not err <= TOL_GRAD_REL * scale:
            fail(f"{tag}: fused_ctr_backward on the compact tables: {name} max abs err "
                 f"{err}, scale {scale}")
        eb.append(err)
    if got_b[1][~valid].any():
        fail(f"{tag}: fused_ctr_backward wrote into a padding segment")
    lib = fused_ctr._library()
    d_w, d_v = torch.zeros_like(fm_w_c), torch.zeros_like(fm_v_c)
    ms, call_ms = time_ms(lambda: backward_kernel_only(
        lib, g_emb, g_yw, g_yv, fm_w_c, fm_v_c, slot, vals, d_w, d_v, None))
    plain_ms, _ = time_ms(lambda: fused_ctr.fused_ctr_backward_plain(
        g_emb, g_yw, g_yv, fm_w_c, fm_v_c, slot, vals, False), reps=20)
    fill_ms, _ = time_ms(lambda: (torch.zeros_like(fm_w_c), torch.zeros_like(fm_v_c)))
    fwd_ms, _ = time_ms(lambda: fused_ctr.fused_ctr_interaction(fm_w_c, fm_v_c, slot, vals))
    fwd_plain_ms, _ = time_ms(lambda: fused_ctr.fused_ctr_plain(fm_w_c, fm_v_c, slot, vals),
                              reps=20)
    fwd_bound, fwd_by, _ = fused_ctr_bound_ms(fm_w_c, fm_v_c, slot, b, f)
    bound_ms, bound_by, detail = fused_ctr_backward_bound_ms(fm_w_c, fm_v_c, slot, b, f,
                                                             False)
    row = {"forward_max_abs_err": e, "backward_max_abs_err": eb,
           "compact_rows": int(row_id.numel()), "distinct_rows": int(valid.sum()),
           "forward_ms": fwd_ms, "forward_plain_ms": fwd_plain_ms,
           "forward_bound_ms": fwd_bound, "forward_bound_by": fwd_by,
           "backward_ms": ms, "backward_call_ms": call_ms,
           "backward_plain_ms": plain_ms, "backward_bound_ms": bound_ms,
           "backward_bound_by": bound_by, "zero_fill_ms": fill_ms,
           "zero_fill_mb": (fm_w_c.numel() + fm_v_c.numel()) * 4 / 1e6, **detail}
    print("%s compact kernels B=%d %s" % (tag, b, json.dumps(row)))
    return row


def _tables(state) -> dict:
    return {"fm_w": state.model.fm_w, "fm_v": state.model.fm_v,
            **{f"{s}.{k}": getattr(state.lazy, s)[k] for s in ("m", "v")
               for k in ("fm_w", "fm_v")}}


def lazy_parity(seed: int, train_dir: str) -> None:
    """One lazy step of the full-width float32 model (dropout off) through
    the kernels and through the plain versions (plain forward, autograd
    backward), from the same state after one warm-up step: the loss within
    TOL_LOSS_REL, fm_w, fm_v, m and v within TOL_GRAD_REL of each tensor's
    largest magnitude (Adam turns a rounding difference in a near-zero
    gradient into a step of up to lr, so a row is not held alone), and
    every untouched row of each bit for bit as before the step."""
    from deepfm_tpu_torch.core.config import Config
    from deepfm_tpu_torch.data.pipeline import batched_ctr_batches, discover_files, record_stream
    from deepfm_tpu_torch.models import deepfm as deepfm_mod
    from deepfm_tpu_torch.ops import fused_ctr
    from deepfm_tpu_torch.train import step as step_mod

    cfg = Config.from_dict({
        "model": {"fused_kernel": "auto", "compute_dtype": "float32",
                  "dropout_keep": (1.0, 1.0, 1.0)},
        "optimizer": {"lazy_embedding_updates": True}, "run": {"seed": seed}})
    files = discover_files(train_dir, ("train",), shuffle=False)
    warm, batch = (
        {k: torch.from_numpy(v).cuda() for k, v in b.items()}
        for _, b in zip(range(2), batched_ctr_batches(record_stream(files),
                                                      batch_size=1024, field_size=39)))
    kernel = step_mod.create_train_state(cfg, "cuda")
    step_mod.train_step(kernel, warm)
    plain = step_mod.create_train_state(cfg, "cuda")
    plain.model.load_state_dict(kernel.model.state_dict())
    plain.step, plain.optimizer.count = kernel.step, kernel.optimizer.count
    for name, slots in kernel.optimizer.slots.items():
        for slot, t in slots.items():
            plain.optimizer.slots[name][slot].copy_(t)
    for key, t in _tables(kernel).items():
        if "." in key:
            _tables(plain)[key].copy_(t)
    before = {k: t.detach().clone() for k, t in _tables(kernel).items()}
    m_k = step_mod.train_step(kernel, batch)
    # the lazy body reaches B1 through DeepFM's family hook
    saved = deepfm_mod.fused_ctr_interaction
    deepfm_mod.fused_ctr_interaction = fused_ctr.fused_ctr_plain
    try:
        m_p = step_mod.train_step(plain, batch)
    finally:
        deepfm_mod.fused_ctr_interaction = saved
    torch.cuda.synchronize()
    loss_k, loss_p = float(m_k["loss"]), float(m_p["loss"])
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    if not (np.isfinite(loss_k) and loss_err <= TOL_LOSS_REL):
        fail(f"lazy: loss through the kernels {loss_k} vs plain {loss_p}")
    touched = torch.zeros(before["fm_v"].shape[0], dtype=torch.bool, device="cuda")
    touched[batch["feat_ids"].clamp(0, cfg.model.feature_size - 1).reshape(-1)] = True
    untouched_rows = 0
    for state in (kernel, plain):
        for name, t in _tables(state).items():
            rows = ~touched[:t.shape[0]]
            if not torch.equal(t.detach()[rows].view(torch.int32),
                               before[name][rows].view(torch.int32)):
                fail(f"lazy: an untouched row of {name} changed")
            untouched_rows = int(rows.sum())
    errs = {}
    for name, a in _tables(kernel).items():
        a, w = a.detach(), _tables(plain)[name].detach()
        err, scale = float((a - w).abs().max()), float(w.abs().max())
        if not err <= TOL_GRAD_REL * scale:
            fail(f"lazy: {name} through the kernels vs plain: max abs err {err}, "
                 f"scale {scale}")
        errs[name] = err / scale if scale else err
    print("lazy parity %s" % json.dumps({
        "loss": loss_k, "loss_rel_err": loss_err, "rel_err": errs,
        "touched_rows": int(touched.sum()), "untouched_rows_bit_equal": untouched_rows}))


def lazy_breakdown(state, batch: dict, dense: dict, reps: int = 20) -> None:
    """The lazy step with its batch on the card: device time (CUDA events,
    median of single steps) and its split from torch.profiler (None where
    it saw no device time): B1 and B1' on the compact tables, the
    sort/segments/compact gathers, the row update, the rest optimizer, and
    the MLP with the rest; beside the dense step's at the same batch."""
    from torch.autograd import DeviceType

    from deepfm_tpu_torch.train.step import train_step

    for _ in range(3):
        train_step(state, batch)
    torch.cuda.synchronize()
    step_ms = _median_event_ms(lambda: train_step(state, batch), 1, reps)
    busy_ms = split = None
    n = 5
    prof = device_profile(lambda: train_step(state, batch), n, cpu=True)
    if prof is not None:
        labels = {"train.lazy_segments": "sort_segments_gathers",
                  "train.lazy_rows": "row_update", "train.optimizer": "rest_optimizer"}
        split = {"forward_kernel": 0.0, "backward_kernel": 0.0}
        total = 0.0
        for row in prof.key_averages():
            if row.device_type != DeviceType.CUDA or row.key in labels:
                continue
            total += row.device_time_total
            if "fused_ctr_forward_kernel" in row.key:
                split["forward_kernel"] += row.device_time_total
            elif "fused_ctr_backward_kernel" in row.key:
                split["backward_kernel"] += row.device_time_total
        for label, name in labels.items():
            split[name] = sum(e.device_time_total for e in prof.events()
                              if e.name == label and e.device_type == DeviceType.CPU)
        split = {k: v / n / 1e3 for k, v in split.items()}
        busy_ms = total / n / 1e3
        split["mlp_fills_and_rest"] = busy_ms - sum(split.values())
    dense_split = dense["split_ms"] or {}
    print("lazy step breakdown B=%d %s" % (batch["label"].shape[0], json.dumps({
        "step_device_ms": step_ms, "kernel_busy_ms": busy_ms,
        "idle_share": None if busy_ms is None else 1.0 - busy_ms / step_ms,
        "split_ms": split, "dense_step_device_ms": dense["step_device_ms"],
        "dense_optimizer_ms": dense_split.get("optimizer_update"),
        "dense_backward_kernel_ms": dense_split.get("backward_kernel"),
        "dense_zero_fill_ms": dense_split.get("zero_fill")})))


DDP_STEPS = 4


def phase_ddp(seed: int, workdir: str) -> dict:
    """Data-parallel training at world size 1 over NCCL, in this process:
    DDP_STEPS steps of the full-width model through parallel/spmd.py's step
    and the same through the single-card step, from the same weights, on
    batches of distinct ids (B1' then adds no two terms into one row, so
    both runs are deterministic): the parameters must agree within
    TOL_GRAD_REL of their largest magnitude.  Then the fused all-reduce's
    time on the full-width gradient buffer, and both steps' device time."""
    import torch.distributed as dist

    from deepfm_tpu_torch.core.config import Config
    from deepfm_tpu_torch.ops import fused_ctr
    from deepfm_tpu_torch.parallel import spmd
    from deepfm_tpu_torch.parallel.mesh import initialize_distributed
    from deepfm_tpu_torch.train.step import create_train_state, train_step

    dev = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group("nccl", store=dist.FileStore(os.path.join(workdir, "store"), 1),
                            rank=0, world_size=1, device_id=dev)
    try:
        cfg = Config.from_dict({"model": {"fused_kernel": "auto"}, "run": {"seed": seed}})
        ctx = initialize_distributed(cfg.mesh, "cuda")
        if ctx.group is None or ctx.world_size != 1:
            fail(f"ddp: expected a one-rank group, got {ctx}")
        dp = spmd.create_dp_train_state(cfg, ctx)
        one = create_train_state(cfg, "cuda")
        g = torch.Generator(device="cuda").manual_seed(seed + 5)
        batches = []
        for _ in range(DDP_STEPS):
            ids = torch.randperm(cfg.model.feature_size, generator=g, device="cuda")
            batches.append({
                "feat_ids": ids[:1024 * 39].view(1024, 39),
                "feat_vals": torch.rand((1024, 39), generator=g, device="cuda"),
                "label": (torch.rand((1024,), generator=g, device="cuda") < 0.25).float()})
        # the main path: counts from 0, then the data-parallel steps, then read
        fused_ctr.launches = fused_ctr.backward_launches = 0
        losses = [float(spmd.train_step(dp, b, ctx)["loss"]) for b in batches]
        launches, backward_launches = fused_ctr.launches, fused_ctr.backward_launches
        if launches < DDP_STEPS or backward_launches < DDP_STEPS:
            fail(f"ddp: {DDP_STEPS} steps launched fused_ctr_forward {launches} and "
                 f"fused_ctr_backward {backward_launches} times")
        ref = [float(train_step(one, b)["loss"]) for b in batches]
        torch.cuda.synchronize()
        errs = {}
        for (name, a), w in zip(dp.model.state_dict().items(),
                                one.model.state_dict().values()):
            err, scale = float((a - w).abs().max()), float(w.abs().max())
            if not err <= TOL_GRAD_REL * scale:
                fail(f"ddp: {name} after {DDP_STEPS} steps: max abs err {err}, "
                     f"scale {scale}")
            errs[name] = err / scale if scale else err
        if not all(np.isfinite(losses)):
            fail(f"ddp: losses {losses}")
        grads = sum(p.numel() for p in dp.model.parameters())
        flat = torch.zeros(grads + 9, device="cuda")  # + 4 metrics and 5 flags
        for _ in range(3):
            dist.all_reduce(flat)
        torch.cuda.synchronize()
        allreduce_ms = _median_event_ms(lambda: dist.all_reduce(flat), 1, 20)
        dp_ms = _median_event_ms(lambda: spmd.train_step(dp, batches[0], ctx), 1, 10)
        one_ms = _median_event_ms(lambda: train_step(one, batches[0]), 1, 10)
        print("ddp %s" % json.dumps({
            "world_size": ctx.world_size, "backend": dist.get_backend(), "steps": DDP_STEPS,
            "losses": losses, "single_card_losses": ref, "max_rel_err": max(errs.values()),
            "allreduce_buffer_mb": flat.numel() * 4 / 1e6, "allreduce_ms": allreduce_ms,
            "dp_step_ms": dp_ms, "single_step_ms": one_ms,
            "launches": {"fused_ctr_forward": launches,
                         "fused_ctr_backward": backward_launches}}))
    finally:
        dist.destroy_process_group()
    return {"launches": launches, "backward_launches": backward_launches}


# the sharded phase: ROADMAP A9's [data x model] grid as 4 ranks on the one
# card in a gloo group this phase starts (NCCL refuses two ranks of one
# communicator on one card).  Each configuration: (label, data_parallel,
# model_parallel, config sections, skewed steps, times each id comes in a
# data index).  A batch takes exactly its share of ids from each owner's
# rows, so the auto capacity ceil(N/M) holds it; a skewed step moves a 20th
# of a data index's ids from the last owner to the first, past the
# capacity, so it takes the psum fallback.  With every id twice, a data
# index holds N/2 distinct rows: the lazy step's default pack of N/2 holds
# them (update_dedup), and each row's gradient is a sum of two, the same
# in either order.  At four data indices the MLP's gradient is a sum of
# four, in gloo's order, which the single-card reference cannot follow: in
# a bf16 MLP that ulp moves a weight by a bf16 step, every later gradient
# moves, and Adam turns a near-zero row gradient's changed sign into 2·lr
# (on an H100 over gloo, far past TOL_GRAD_REL after 4 steps), so that
# configuration's MLP runs in float32.
# SHARD_VOCAB, SHARD_BATCH and DEVICE let a rehearsal on the CPU run it at
# a small width
SHARD_STEPS, SHARD_RANKS = 4, 4
SHARD_VOCAB, SHARD_BATCH = 117_581, 1024
SHARD_CONFIGS = (
    ("2x2 dense psum", 2, 2, {"model": {"shard_exchange": "psum"},
                              "optimizer": {"zero_sharding": "off"}}, (), 1),
    ("2x2 dense alltoall zero", 2, 2, {"model": {"shard_exchange": "alltoall"},
                                       "optimizer": {"zero_sharding": "on"}}, (), 1),
    ("2x2 lazy alltoall", 2, 2, {"model": {"shard_exchange": "alltoall"},
                                 "optimizer": {"lazy_embedding_updates": True}}, (), 1),
    ("1x4 dense alltoall fallback", 1, 4,
     {"model": {"shard_exchange": "alltoall", "shard_exchange_capacity": 0.25},
      "optimizer": {"zero_sharding": "off"}}, (2, 3), 1),
    ("4x1 lazy alltoall pack f32", 4, 1,
     {"model": {"shard_exchange": "alltoall", "compute_dtype": "float32"},
      "optimizer": {"lazy_embedding_updates": True}}, (), 2),
)


# the configurations that also save through Checkpointer after their steps
# and restore into a fresh state (each rank its own row range)
SHARD_CKPT_CONFIGS = ("1x4 dense alltoall fallback", "2x2 lazy alltoall")
# a rank's device memory rise in a save or a restore, over its shard state
SHARD_CKPT_SLACK_BYTES = 2**20


def checkpoint_round_trip(cfg, state, ctx, directory: str) -> dict:
    """Save ``state`` through Checkpointer (every rank), restore it into a
    fresh state (another seed), and hold the restored state bit for bit to
    the saved one; the rank's row file must hold exactly its rows.  Returns
    the rise of torch.cuda.max_memory_allocated over the allocation before
    the save and before the restore (peak statistics reset before each),
    the rank's shard state (its rows of the tables with their slots or lazy
    moments) in bytes, the host seconds, and the step's files in bytes."""
    import torch.distributed as dist

    from deepfm_tpu_torch.checkpoint import Checkpointer
    from deepfm_tpu_torch.parallel import spmd

    def flat(tree, path=""):
        if isinstance(tree, dict):
            return {k2: v2 for k, v in tree.items() for k2, v2 in flat(v, f"{path}.{k}").items()}
        return {path: tree.detach().cpu().clone() if isinstance(tree, torch.Tensor) else tree}

    def is_table(path: str) -> bool:
        return bool({"fm_w", "fm_v"} & set(path.split(".")))

    sh = state.sharding
    saved = flat(spmd.local_state(state))
    shard_bytes = sum(t.numel() * t.element_size() for k, t in saved.items()
                      if is_table(k) and isinstance(t, torch.Tensor))
    dev = ctx.device
    cuda = dev.type == "cuda"
    out = {"shard_state_bytes": shard_bytes, "step": state.step}
    for what in ("save", "restore"):
        if what == "restore":
            dist.barrier()  # every row file renamed into place
            fresh = spmd.create_dp_train_state(
                cfg.with_overrides(run={"seed": cfg.run.seed + 1}), ctx)
        if cuda:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev) if cuda else 0
        t0 = time.perf_counter()
        if what == "save":
            ckpt = Checkpointer(directory, ctx=ctx)
            ckpt.save(state)
            ckpt.close()
        else:
            Checkpointer(directory, ctx=ctx).restore(fresh)
        if cuda:
            torch.cuda.synchronize(dev)
        out[f"{what}_s"] = time.perf_counter() - t0
        out[f"{what}_rise_bytes"] = (torch.cuda.max_memory_allocated(dev) - base
                                     if cuda else None)
    restored = flat(spmd.local_state(fresh))
    bad = [k for k, v in saved.items() if not (
        torch.equal(v, restored[k]) if isinstance(v, torch.Tensor) else v == restored[k])]
    if restored.keys() != saved.keys() or bad or fresh.step != state.step:
        fail(f"sharded checkpoint: rank {ctx.rank} restored {bad or 'other keys'} "
             f"(step {fresh.step} vs {state.step}) unlike the saved state")
    step_dir = os.path.join(directory, str(state.step))
    out["files_bytes"] = {f: os.path.getsize(os.path.join(step_dir, f))
                          for f in sorted(os.listdir(step_dir))}
    if ctx.data_index == 0:
        rows = flat(torch.load(os.path.join(step_dir, f"rows-{ctx.model_index}.pt"),
                               weights_only=True))
        mine = {k: v for k, v in saved.items() if is_table(k)}
        if ((rows[".offset"], rows[".rows"]) != (sh.offset, sh.rows)
                or {k for k in rows if is_table(k)} != set(mine)
                or any(not torch.equal(rows[k], v) or v.shape[0] != sh.rows
                       for k, v in mine.items())):
            fail(f"sharded checkpoint: rows-{ctx.model_index}.pt does not hold exactly "
                 f"rank {ctx.rank}'s rows [{sh.offset}, {sh.offset + sh.rows})")
    for what in ("save", "restore") if cuda else ():
        if out[f"{what}_rise_bytes"] > shard_bytes + SHARD_CKPT_SLACK_BYTES:
            fail(f"sharded checkpoint: rank {ctx.rank}'s device memory rose "
                 f"{out[f'{what}_rise_bytes']} bytes in the {what}, over its shard "
                 f"state of {shard_bytes} bytes + {SHARD_CKPT_SLACK_BYTES}")
    return out


def sharded_config(seed: int, dp: int, mp: int, sections: dict) -> dict:
    """The phase's config: the full-width model (bf16 MLP, fused_kernel
    "auto", dropout off), Adam 5e-4, L2 1e-4, SHARD_BATCH records a data
    index, on a [dp, mp] grid."""
    return {"model": {"feature_size": SHARD_VOCAB, "fused_kernel": "auto",
                      "dropout_keep": [1.0, 1.0, 1.0], "l2_reg": 1e-4,
                      **sections.get("model", {})},
            "optimizer": {"learning_rate": 5e-4, **sections.get("optimizer", {})},
            "mesh": {"data_parallel": dp, "model_parallel": mp},
            "data": {"batch_size": SHARD_BATCH}, "run": {"seed": seed}}


def sharded_batches(rng: np.random.Generator, dp: int, mp: int, skewed,
                    repeat: int = 1) -> list[dict]:
    """SHARD_STEPS global batches of dp x SHARD_BATCH records, every id of a
    step distinct but for ``repeat`` copies of each within a data index; a
    data index takes SHARD_BATCH·39/mp ids of each owner's rows (n/20 more
    of the first owner's on the steps in ``skewed``)."""
    from deepfm_tpu_torch.parallel.spmd import padded_vocab

    n = SHARD_BATCH * 39
    rows = padded_vocab(SHARD_VOCAB, mp, 128 // 32) // mp
    out = []
    for step in range(SHARD_STEPS):
        share = [n // mp] * mp
        if step in skewed:
            share[0] += n // 20
            share[-1] -= n // 20
        ids = np.empty((dp, n), np.int64)
        for j in range(mp):
            hi = min((j + 1) * rows, SHARD_VOCAB)
            assert share[j] % repeat == 0
            pick = rng.choice(np.arange(j * rows, hi), size=dp * share[j] // repeat,
                              replace=False)
            lo = sum(share[:j])
            ids[:, lo:lo + share[j]] = np.tile(pick.reshape(dp, share[j] // repeat),
                                               repeat)
        for d in range(dp):
            rng.shuffle(ids[d])
        out.append({"feat_ids": ids.reshape(dp * SHARD_BATCH, 39),
                    "feat_vals": rng.random((dp * SHARD_BATCH, 39), dtype=np.float32),
                    "label": (rng.random(dp * SHARD_BATCH) < 0.25).astype(np.float32)})
    return out


def _host_ms(fn, reps: int = 5) -> float:
    """Median wall-clock ms of ``fn`` (which waits for its own result)."""
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        if DEVICE == "cuda":
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return float(np.median(times))


def compact_kernel_errors(w_c, v_c, slot, vals, seed: int) -> dict:
    """B1 and B1' on a compact table and its slots against their plain
    versions: the forward's max abs errors (emb, y_w, y_v) and the
    backward's (d_fm_w, d_fm_v), each with the scale its tolerance reads."""
    from deepfm_tpu_torch.ops import fused_ctr

    b, f = slot.shape
    k = v_c.shape[1]
    got = fused_ctr.fused_ctr_interaction(w_c, v_c, slot, vals)
    want = fused_ctr.fused_ctr_plain(w_c, v_c, slot, vals)
    g = torch.Generator(device=v_c.device).manual_seed(seed + 9)
    cot = (torch.randn((b, f, k), generator=g, device=v_c.device),
           torch.randn((b,), generator=g, device=v_c.device),
           torch.randn((b,), generator=g, device=v_c.device))
    backward = (fused_ctr.fused_ctr_backward if v_c.device.type == "cuda"
                else fused_ctr.fused_ctr_backward_plain)
    got_b = backward(*cot, w_c, v_c, slot, vals, False)
    want_b = fused_ctr.fused_ctr_backward_plain(*cot, w_c, v_c, slot, vals, False)
    return {"forward": [[float((a - w).abs().max()), float(w.abs().max())]
                        for a, w in zip(got, want)],
            "backward": [[float((a - w).abs().max()), float(w.abs().max())]
                         for a, w in zip(got_b[:2], want_b[:2])]}


def compact_rows(state, ids: torch.Tensor):
    """``(fm_w [n], fm_v [n, K], slots)``: the compact table the step's
    kernels run on, from the exchange at more than one model index, else
    from the lazy step's local assembly of the whole tables."""
    from deepfm_tpu_torch.parallel import spmd

    model, sh = state.model, state.sharding
    if model.sharded is not None:
        tables, slot = model.sharded.lookup(model.tables(), ids)
        return tables["fm_w"], tables["fm_v"], slot
    flat = ids.reshape(-1).long()
    mapped = torch.where((flat >= 0) & (flat < sh.true_vocab), flat, sh.total_rows)
    compact, slot, _ = spmd.assemble_rows(state, mapped)
    k = model.fm_v.shape[1]
    return compact[:, k].contiguous(), compact[:, :k].contiguous(), slot.view(ids.shape)


def sharded_rank(rank: int, world: int, store: str, out: str, jobs: list,
                 backend: str = "gloo") -> None:
    """One rank of the sharded phase (a spawned process): each
    configuration's grid state, a check of the exchange's forward rows
    against the dense gather of the whole tables, SHARD_STEPS steps (the
    main path, kernel and exchange counts from 0), then the step's and the
    exchange collectives' times.  Rank 0 keeps the whole tables before and
    after.  Under gloo every rank shares card 0; under NCCL rank r takes
    card r."""
    import torch.distributed as dist

    card = torch.device("cuda", rank if backend == "nccl" else 0)
    if DEVICE == "cuda":
        torch.cuda.set_device(card)
    torch.set_num_threads(2)
    dist.init_process_group(backend, store=dist.FileStore(store, world), rank=rank,
                            world_size=world,
                            **({"device_id": card} if backend == "nccl" else {}))
    try:
        from deepfm_tpu_torch.core.config import Config
        from deepfm_tpu_torch.ops import fused_ctr
        from deepfm_tpu_torch.parallel import embedding as E
        from deepfm_tpu_torch.parallel import spmd
        from deepfm_tpu_torch.parallel.mesh import initialize_distributed

        results = []
        for cfg_dict, batches, ckpt_dir in jobs:
            cfg = Config.from_dict(cfg_dict)
            ctx = initialize_distributed(cfg.mesh, DEVICE)
            state = spmd.create_dp_train_state(cfg, ctx)
            init = {k: v.detach().cpu().clone()
                    for k, v in spmd.full_state(state)["model"].items()}
            n = SHARD_BATCH
            local = [{k: torch.from_numpy(v[ctx.data_index * n:(ctx.data_index + 1) * n])
                      .to(ctx.device) for k, v in b.items()} for b in batches]
            model, sh = state.model, state.sharding
            # the exchange's forward rows against the dense gather, per step
            row_err = 0
            with torch.no_grad():
                for b in local:
                    ids, _ = model.prepare(b["feat_ids"], b["feat_vals"])
                    w_c, v_c, slot = compact_rows(state, ids)
                    flat = ids.long().cpu()
                    slot = slot.long()
                    row_err += int((v_c[slot].cpu() != init["fm_v"][flat]).any())
                    row_err += int((w_c[slot].cpu() != init["fm_w"][flat]).any())
            # the main path: counts from 0, the steps, then read
            E.reset_counters()
            spmd.lazy_updates.update(dedup=0, full=0)
            fused_ctr.launches = fused_ctr.backward_launches = 0
            losses = [float(spmd.train_step(state, b, ctx)["loss"]) for b in local]
            launches, backward = fused_ctr.launches, fused_ctr.backward_launches
            counters = dict(E.counters)
            lazy_updates = dict(spmd.lazy_updates)
            final = {k: v.detach().cpu().clone()
                     for k, v in spmd.full_state(state)["model"].items()}
            # B1 and B1' on the exchange's compact table, against their
            # plain versions (after the counts: these launches are not the
            # main path's)
            with torch.no_grad():
                ids, vals = model.prepare(local[0]["feat_ids"], local[0]["feat_vals"])
                w_c, v_c, slot = compact_rows(state, ids)
            kernel_err = compact_kernel_errors(w_c, v_c, slot, vals, seed=rank)
            step_ms = _host_ms(lambda: spmd.train_step(state, local[0], ctx))
            # the exchange's collectives alone, at this configuration's sizes
            # (whole tables: the lazy update's gather of the pack instead)
            ids, _ = model.prepare(local[0]["feat_ids"], local[0]["feat_vals"])
            width = model.fm_v.shape[1] + 1
            group = ctx.model_group
            if sh.mp == 1:
                cap = E.exchange_capacity(ids.numel(), 1,
                                          cfg.model.shard_exchange_capacity or 0.5)
                pack_ids = torch.zeros(cap, dtype=torch.long, device=ctx.device)
                pack_g = torch.zeros(cap, width, device=ctx.device)

                def legs():
                    for t in (pack_ids, pack_g):
                        dist.all_gather_into_tensor(
                            t.new_empty((sh.dp * cap,) + tuple(t.shape[1:])), t,
                            group=ctx.data_group)
            elif sh.exchange == "alltoall":
                cap = E.exchange_capacity(ids.numel(), sh.mp, cfg.model.shard_exchange_capacity)
                req = torch.zeros(sh.mp * cap, dtype=torch.int32, device=ctx.device)
                got = torch.zeros(sh.mp * cap, width, device=ctx.device)

                def legs():
                    dist.all_to_all_single(torch.empty_like(req), req, group=group)
                    dist.all_to_all_single(torch.empty_like(got), got, group=group)
            else:
                rows = torch.zeros(ids.numel(), width, device=ctx.device)

                def legs():
                    dist.all_reduce(rows, group=group)
            legs()
            ckpt = checkpoint_round_trip(cfg, state, ctx, ckpt_dir) if ckpt_dir else None
            results.append({
                "checkpoint": ckpt,
                "grid": [ctx.data_index, ctx.model_index], "exchange": sh.exchange,
                "zero": sh.zero, "losses": losses, "launches": launches,
                "backward_launches": backward, "counters": counters,
                "lazy_updates": lazy_updates,
                "row_mismatches": row_err, "step_ms": step_ms, "kernel_err": kernel_err,
                "compact_rows": int(v_c.shape[0]),
                "exchange_collectives_ms": _host_ms(legs),
                "init": init if rank == 0 else None, "final": final if rank == 0 else None})
        torch.save(results, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def sharded_reference(cfg, init: dict, batches: list, dp: int, mp: int, lazy: bool):
    """The single-card step on the same global batches from the same
    weights, in the data-parallel step's arithmetic: the dense step's
    gradient is the mean over the data indices of the single-card gradient
    of each index's records, with the tables' multiplied by mp (the factor
    the exchange's transpose gives them on the grid, as in JAX); the lazy
    step runs the whole batch but its MLP head on each index's records
    apart (the GEMM shapes the ranks run).  Returns the losses and the
    final state_dict."""
    from deepfm_tpu_torch.parallel import spmd
    from deepfm_tpu_torch.train.step import (apply_dense, create_train_state, dense_grads,
                                             train_step)

    pcfg = spmd.sharded_model_config(cfg.with_overrides(mesh={"model_parallel": 1}), mp)
    one = create_train_state(pcfg, DEVICE)
    one.model.load_state_dict(init)
    n = SHARD_BATCH
    losses = []
    if lazy:
        head = one.model.head

        def split_head(emb, y_w, y_v):
            return torch.cat([head(emb[i * n:(i + 1) * n], y_w[i * n:(i + 1) * n],
                                   y_v[i * n:(i + 1) * n]) for i in range(dp)])

        one.model.head = split_head
    for b in batches:
        batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in b.items()}
        if lazy:
            losses.append(float(train_step(one, batch)["loss"]))
            continue
        total, loss = None, 0.0
        for d in range(dp):
            grads, metrics = dense_grads(one, {k: v[d * n:(d + 1) * n]
                                               for k, v in batch.items()})
            for k in ("fm_w", "fm_v"):
                grads[k] = grads[k] * mp
            total = grads if total is None else {k: total[k] + g for k, g in grads.items()}
            loss += float(metrics["loss"]) / dp
        apply_dense(one, {k: g / dp for k, g in total.items()})
        losses.append(loss)
    return losses, {k: v.detach().cpu() for k, v in one.model.state_dict().items()}


def phase_sharded(seed: int, workdir: str, backend: str = "gloo") -> dict:
    """The [data x model] grid (parallel/spmd.py, parallel/embedding.py) on
    the card: SHARD_RANKS ranks spawned on cuda:0 in a gloo group run each
    of SHARD_CONFIGS for SHARD_STEPS steps through spmd.train_step; every
    rank's exchange must return rows bit-equal to the dense gather of the
    whole tables, B1 and B1' must launch every step and, on the exchange's
    compact table, agree with their plain versions, the fallback config
    must fall back on its skewed steps (and only there), and the final
    whole tables and MLP must agree with the single-card reference
    (sharded_reference) within TOL_GRAD_REL of each tensor's largest
    magnitude.  One line a configuration: agreement, launches, step ms,
    the bytes an exchange sent a step (counted, forward and backward,
    beside JAX's forward estimate exchange_wire_bytes_est) and the
    exchange collectives' ms, all over gloo on one card (``backend="nccl"``:
    over NCCL, one rank a card, on a machine with SHARD_RANKS cards)."""
    import torch.multiprocessing as tmp

    from deepfm_tpu_torch.core.config import Config
    from deepfm_tpu_torch.parallel.embedding import exchange_wire_bytes_est

    os.makedirs(workdir, exist_ok=True)
    rng = np.random.default_rng(seed + 23)
    jobs, plans = [], []
    for label, dp, mp, sections, skewed, repeat in SHARD_CONFIGS:
        batches = sharded_batches(rng, dp, mp, skewed, repeat)
        ckpt_dir = (os.path.join(workdir, "ckpt-" + label.replace(" ", "-"))
                    if label in SHARD_CKPT_CONFIGS else None)
        jobs.append((sharded_config(seed, dp, mp, sections), batches, ckpt_dir))
        plans.append((label, dp, mp, sections, skewed, batches))
    t0 = time.perf_counter()
    ctx = tmp.start_processes(sharded_rank, args=(SHARD_RANKS, os.path.join(workdir, "store"),
                                                  workdir, jobs, backend),
                              nprocs=SHARD_RANKS, join=False, start_method="spawn")
    deadline = time.monotonic() + 600
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                fail("sharded: the ranks did not end within 600 s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    ranks = [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False)
             for r in range(SHARD_RANKS)]
    spawn_s = time.perf_counter() - t0
    total = {"launches": 0, "backward_launches": 0}
    for i, (label, dp, mp, sections, skewed, batches) in enumerate(plans):
        runs = [r[i] for r in ranks]
        lazy = sections["optimizer"].get("lazy_embedding_updates", False)
        packs = SHARD_STEPS if lazy and SHARD_CONFIGS[i][5] > 1 else 0
        for r in runs:
            if lazy and r["lazy_updates"] != {"dedup": packs, "full": SHARD_STEPS - packs}:
                fail(f"sharded {label}: rank {r['grid']}: lazy updates "
                     f"{r['lazy_updates']}, expected {packs} by the unique pack")
            if r["row_mismatches"]:
                fail(f"sharded {label}: rank {r['grid']}: the exchange's rows differ "
                     f"from the dense gather on {r['row_mismatches']} lookups")
            if DEVICE == "cuda" and (r["launches"] < SHARD_STEPS
                                     or r["backward_launches"] < SHARD_STEPS):
                fail(f"sharded {label}: rank {r['grid']} launched B1 {r['launches']} and "
                     f"B1' {r['backward_launches']} times in {SHARD_STEPS} steps")
            if r["counters"]["fallbacks"] != len(skewed):
                fail(f"sharded {label}: {r['counters']['fallbacks']} psum fallbacks, "
                     f"expected {len(skewed)}")
            (emb, _), (y_w, sw), (y_v, sv) = r["kernel_err"]["forward"]
            if not (emb <= TOL_EMB and y_w <= TOL_YW_REL * (1.0 + sw)
                    and y_v <= TOL_YV_REL * (1.0 + sv)):
                fail(f"sharded {label}: fused_ctr_forward on the exchange's compact "
                     f"table disagrees with its plain version: {r['kernel_err']}")
            for err, scale in r["kernel_err"]["backward"]:
                if not err <= TOL_GRAD_REL * scale:
                    fail(f"sharded {label}: fused_ctr_backward on the exchange's compact "
                         f"table disagrees with its plain version: {r['kernel_err']}")
            total["launches"] += r["launches"]
            total["backward_launches"] += r["backward_launches"]
            total["max_abs_err"] = max(total.get("max_abs_err", 0.0), emb, y_w, y_v)
            total["backward_max_abs_err"] = max(total.get("backward_max_abs_err", 0.0),
                                                *(e for e, _ in r["kernel_err"]["backward"]))
        cfg = Config.from_dict(sharded_config(seed, dp, mp, sections))
        ref_losses, ref = sharded_reference(cfg, runs[0]["init"], batches, dp, mp, lazy)
        errs = {}
        for name, w in ref.items():
            a = runs[0]["final"][name]
            err, scale = float((a - w).abs().max()), float(w.abs().max())
            if not err <= TOL_GRAD_REL * scale:
                fail(f"sharded {label}: {name} after {SHARD_STEPS} steps: max abs err "
                     f"{err}, scale {scale}")
            errs[name] = err / scale if scale else err
        if runs[0]["checkpoint"] is not None:
            ck = [r["checkpoint"] for r in runs]
            print("sharded checkpoint %s" % json.dumps({
                "config": label, "grid": [dp, mp], "step": ck[0]["step"],
                "restored_bit_equal": True, "row_files_exact": True,
                "shard_state_bytes_per_rank": [c["shard_state_bytes"] for c in ck],
                "save_rise_bytes_per_rank": [c["save_rise_bytes"] for c in ck],
                "restore_rise_bytes_per_rank": [c["restore_rise_bytes"] for c in ck],
                "bound": f"shard state + {SHARD_CKPT_SLACK_BYTES} bytes",
                "save_s_per_rank": [c["save_s"] for c in ck],
                "restore_s_per_rank": [c["restore_s"] for c in ck],
                "files_bytes": ck[0]["files_bytes"],
                "memory": "torch.cuda.max_memory_allocated rise per rank process, "
                          "peak statistics reset before each"}))
        losses = runs[0]["losses"]
        if not all(np.isfinite(losses)):
            fail(f"sharded {label}: losses {losses}")
        n_ids = SHARD_BATCH * 39
        est = {ex: exchange_wire_bytes_est(n_ids, mp, cfg.model.shard_exchange_capacity,
                                           (32, 1), exchange=ex)
               for ex in ("alltoall", "psum")}
        c = runs[0]["counters"]
        print("sharded %s" % json.dumps({
            "config": label, "grid": [dp, mp], "exchange": runs[0]["exchange"],
            "zero": runs[0]["zero"], "lazy": lazy, "steps": SHARD_STEPS,
            "losses": losses, "single_card_losses": ref_losses,
            "max_rel_err": max(errs.values()), "tolerance": TOL_GRAD_REL,
            "fallbacks": c["fallbacks"], "lazy_updates": runs[0]["lazy_updates"],
            "launches": {"fused_ctr_forward": sum(r["launches"] for r in runs),
                         "fused_ctr_backward": sum(r["backward_launches"] for r in runs)},
            "compact_rows": [r["compact_rows"] for r in runs],
            "kernel_vs_plain_max_abs_err": {
                "forward": max(e for r in runs for e, _ in r["kernel_err"]["forward"]),
                "backward": max(e for r in runs for e, _ in r["kernel_err"]["backward"])},
            "step_ms_per_rank": [r["step_ms"] for r in runs],
            "bytes_per_step_rank0": {"alltoall": c["alltoall_bytes"] / SHARD_STEPS,
                                     "allreduce": c["allreduce_bytes"] / SHARD_STEPS},
            "jax_fwd_estimate_bytes": est,
            "exchange_collectives_ms": [r["exchange_collectives_ms"] for r in runs],
            "collectives_timed": ("the lazy pack's all_gather over the data group"
                                  if mp == 1 else f"the {runs[0]['exchange']} exchange's"),
            "ranks": SHARD_RANKS,
            "backend": ("gloo on one card (host-staged)" if backend == "gloo"
                        else f"{backend}, one rank a card")}))
    print(f"sharded: {len(plans)} configurations on {SHARD_RANKS} ranks ({backend}) in "
          f"{spawn_s:.1f} s of spawned ranks")
    return total


def b2_corpus(rows: int, seed: int, ties_and_pads: bool = False, dim: int = B2_DIM,
              all_equal: bool = False, live: int | None = None):
    """An int8 corpus on the card: random unit rows, quantized per row as
    funnel/quant.py does (codes = round(emb / scale), scale = max|row| /
    127).  With ``ties_and_pads``: ten equal rows, a tie far apart, and
    pad ids; with ``all_equal``: every row the same; with ``live``: only
    that many rows, spread over the corpus, have an id (the rest pads)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    emb = torch.randn((rows, dim), generator=g, device=dev)
    emb /= emb.norm(dim=1, keepdim=True)
    ids = torch.arange(rows, device=dev, dtype=torch.int32)
    if ties_and_pads:
        emb[20:30] = emb[7]
        emb[rows - 12] = emb[5]
        ids[-1000:] = -1
        ids[3::97] = -5
    if all_equal:
        emb[:] = emb[0]
    if live is not None:
        keep = torch.zeros(rows, dtype=torch.bool, device=dev)
        keep[torch.linspace(0, rows - 1, live, device=dev).long()] = True
        ids = torch.where(keep, ids, torch.full_like(ids, -1))
    scales = emb.abs().amax(dim=1) / 127.0
    safe = torch.where(scales > 0, scales, torch.ones_like(scales))
    codes = torch.round(emb / safe[:, None]).clamp(-127, 127).to(torch.int8)
    return codes.contiguous(), scales.contiguous(), ids, emb


def b2_queries(b: int, seed: int, emb=None, dim: int = B2_DIM) -> torch.Tensor:
    """Unit queries, as the user tower gives them; with ``emb``, query 0
    is row 7 (the ten equal rows of the tie mix)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    u = torch.randn((b, dim), generator=g, device="cuda")
    if emb is not None:
        u[0] = emb[7]
    return (u / u.norm(dim=1, keepdim=True)).contiguous()


def retrieval_bound_ms(rows: int, b: int, kos: int) -> tuple[float, str, dict]:
    """Least time for one call: codes, scales and ids read once, the
    queries read and the [B, kos] pair written once, over the HBM rate; or
    the dequantizing multiply and 2·B·R·D FMA flops over the f32 peak."""
    nbytes = rows * (B2_DIM + 4 + 4) + b * B2_DIM * 4 + b * kos * 8
    flops = 2 * b * rows * B2_DIM + rows * B2_DIM
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            {"bytes": nbytes, "flops": flops})


# B2's kernels by the names torch.profiler gives them: the counting scans
# (histogram levels 0-3), the filter scan, the per-query selects, the rank
B2_KERNELS = {"scan_count": ("scan_kernel<", ", false>"),
              "scan_filter": ("scan_kernel<", ", true>"),
              "select": ("select_kernel", ""), "rank": ("rank_kernel", "")}


def b2_pass_split(fn, n: int = 10) -> dict | None:
    """Device ms per call of each of B2's kernels (and its workspace
    memset), from torch.profiler; None where it saw no device time."""
    from torch.autograd import DeviceType

    prof = device_profile(fn, n)
    if prof is None:
        return None
    split = dict.fromkeys(B2_KERNELS, 0.0)
    split["memset"] = 0.0
    for row in prof.key_averages():
        if row.device_type != DeviceType.CUDA:
            continue
        for name, (stem, mode) in B2_KERNELS.items():
            if stem in row.key and mode in row.key:
                split[name] += row.device_time_total / n / 1e3
        if "Memset" in row.key:
            split["memset"] += row.device_time_total / n / 1e3
    if not all(split[name] for name in B2_KERNELS):
        fail(f"torch.profiler saw device time but none in one of B2's kernels: {split}")
    return split


def phase_b2(seed: int) -> dict:
    """Kernel B2 (retrieval_topk) against its plain version on the card at
    the funnel's corpus (117,581 rows) and the benchmark's (2,000,000),
    D 32, kos 128, B 8 and 64, plus a mix with ties and pads; with the
    kernel's device and call time, the plain version's, the least time and
    one PyTorch composition of the same function, torch.topk(q @ (codes ·
    scale)^T), which the port never calls."""
    from deepfm_tpu_torch.ops import retrieval

    def check(tag, u, codes, scales, ids):
        got = retrieval.retrieval_topk(u, codes, scales, ids, B2_KOS)
        want = retrieval.retrieval_topk_plain(u, codes, scales, ids, B2_KOS)
        torch.cuda.synchronize()
        agree = retrieval.topk_agreement(u, codes, scales, ids, got, want,
                                         TOL_B2_RTOL, TOL_B2_ATOL)
        if not agree["ok"]:
            fail(f"retrieval_topk disagrees with its plain version ({tag}): {agree}")
        print(f"b2 check {tag}: {json.dumps(agree)} (near-ties: {agree['swapped']} "
              f"swapped in place, {agree['boundary']} traded at the kos-th score)")
        return agree, got

    result = {"per_shape": {}, "max_abs_err": 0.0}
    for rows in B2_CORPORA:
        codes, scales, ids, emb = b2_corpus(rows, seed + 3)
        for b in B2_BATCHES:
            u = b2_queries(b, seed + b)
            tag = f"R={rows} B={b}"
            agree, _ = check(tag, u, codes, scales, ids)
            result["max_abs_err"] = max(result["max_abs_err"], agree["max_abs_err"])

            def library():
                s = u @ (codes.to(torch.float32) * scales[:, None]).T
                s = torch.where(ids[None, :] >= 0, s, float("-inf"))
                return torch.topk(s, B2_KOS, dim=1)

            ms, call_ms = time_ms(
                lambda: retrieval.retrieval_topk(u, codes, scales, ids, B2_KOS))
            plain_ms, _ = time_ms(
                lambda: retrieval.retrieval_topk_plain(u, codes, scales, ids, B2_KOS),
                reps=5, groups=3)
            library_ms, _ = time_ms(library, reps=10, groups=5)
            bound_ms, bound_by, detail = retrieval_bound_ms(rows, b, B2_KOS)
            row = {"rows": rows, "dim": B2_DIM, "queries": b, "kos": B2_KOS,
                   "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "library_ms": library_ms, "max_abs_err": agree["max_abs_err"],
                   "pass_ms": b2_pass_split(
                       lambda: retrieval.retrieval_topk(u, codes, scales, ids, B2_KOS)),
                   **detail}
            result["per_shape"][(rows, b)] = row
            print("kernel retrieval_topk %s %s" % (tag, json.dumps(row)))
        del codes, scales, ids, emb
    codes, scales, ids, emb = b2_corpus(B2_CORPORA[0], seed + 4, ties_and_pads=True)
    u = b2_queries(8, seed + 5, emb)
    agree, got = check("ties and pads", u, codes, scales, ids)
    top = got[1][0, :10].tolist()
    if top != sorted(top):
        fail(f"retrieval_topk: the ten equal rows came back out of row order: {top}")
    result["max_abs_err"] = max(result["max_abs_err"], agree["max_abs_err"])
    result["max_abs_err"] = max(result["max_abs_err"], b2_adversarial(seed))
    return result


def b2_adversarial(seed: int) -> float:
    """B2 on inputs that fill the select's threshold bin or empty it, at
    the served corpus, B 8: every score equal (the first kos rows, in row
    order), fewer live rows than kos, kos 1 and 1,024, D 16 and 128.  Each
    is held to the plain version by topk_agreement and timed."""
    from deepfm_tpu_torch.ops import retrieval

    rows, worst = B2_CORPORA[0], 0.0
    cases = (("all scores equal", {"all_equal": True}, B2_KOS),
             ("100 live rows", {"live": 100}, B2_KOS),
             ("kos 1", {}, 1), ("kos 1024", {}, 1024),
             ("D 16", {"dim": 16}, B2_KOS), ("D 128", {"dim": 128}, B2_KOS))
    for i, (tag, kw, kos) in enumerate(cases):
        codes, scales, ids, _ = b2_corpus(rows, seed + 20 + i, **kw)
        u = b2_queries(8, seed + 30 + i, dim=codes.shape[1])
        got = retrieval.retrieval_topk(u, codes, scales, ids, kos)
        want = retrieval.retrieval_topk_plain(u, codes, scales, ids, kos)
        torch.cuda.synchronize()
        agree = retrieval.topk_agreement(u, codes, scales, ids, got, want,
                                         TOL_B2_RTOL, TOL_B2_ATOL)
        if not agree["ok"]:
            fail(f"retrieval_topk disagrees with its plain version ({tag}): {agree}")
        if kw.get("all_equal") and got[1].tolist() != [list(range(kos))] * 8:
            fail(f"retrieval_topk ({tag}): not the first {kos} rows in row order")
        if "live" in kw and int(torch.isfinite(got[0]).sum()) != 8 * kw["live"]:
            fail(f"retrieval_topk ({tag}): {int(torch.isfinite(got[0]).sum())} finite "
                 f"slots, not {8 * kw['live']}")
        ms, call_ms = time_ms(lambda: retrieval.retrieval_topk(u, codes, scales, ids, kos))
        print(f"b2 check {tag} (R={rows} B=8 D={codes.shape[1]} kos={kos}): "
              f"{json.dumps(agree)} ms {ms} call_ms {call_ms}")
        worst = max(worst, agree["max_abs_err"])
    return worst


def post(url: str, body: bytes, timeout: float = 120.0) -> tuple[int, dict]:
    req = urllib.request.Request(url, data=body, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e)


def get(url: str) -> dict:
    with urllib.request.urlopen(url, timeout=60) as r:
        return json.load(r)


def _serve_thread(servable: str, name: str, buckets=BUCKETS, device="cuda", **kw):
    """serve_forever on ``device`` in a thread; returns its ready event
    (with .port, .server, .scorer, .predictor, .swapper) and the thread."""
    from deepfm_tpu_torch.serve.server import serve_forever

    ready = threading.Event()
    errors = []

    def run():
        try:
            serve_forever(servable, port=0, buckets=buckets, max_wait_ms=2.0,
                          device=device, ready=ready, **kw)
        except BaseException as e:  # reported by the main thread
            errors.append(e)
            ready.set()

    thread = threading.Thread(target=run, name=name, daemon=True)
    thread.start()
    if not ready.wait(timeout=600) or errors:
        fail(f"server did not come up: {errors}")
    return ready, thread


def _instances_body(ids: np.ndarray, vals: np.ndarray) -> bytes:
    return json.dumps({"instances": [{"feat_ids": i.tolist(), "feat_vals": v.tolist()}
                                     for i, v in zip(ids, vals)]}).encode()


class _Client:
    """One keep-alive connection to a server on this host."""

    def __init__(self, port: int):
        import http.client

        self.conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)

    def post(self, path: str, body: bytes, headers: dict | None = None):
        self.conn.request("POST", path, body, headers or {})
        r = self.conn.getresponse()
        return r.status, dict(r.getheaders()), r.read()

    def close(self):
        self.conn.close()


def http_p50(port: int, requests, repeats: int = SERVE_REPEATS) -> dict:
    """:predict and :predict_binary p50 (ms, host clock, client to client,
    one keep-alive connection, sequential) for each request size."""
    from deepfm_tpu_torch.serve.server import encode_binary_request

    client = _Client(port)
    out = {}
    try:
        for ids, vals in requests:
            for path, body in ((":predict", _instances_body(ids, vals)),
                               (":predict_binary", encode_binary_request(ids, vals))):
                lat = []
                for _ in range(1 + repeats):
                    t0 = time.perf_counter()
                    code, _, raw = client.post(f"/v1/models/deepfm{path}", body)
                    lat.append((time.perf_counter() - t0) * 1e3)
                    if code != 200:
                        fail(f"{path} with {len(ids)} instances answered {code}: {raw[:200]}")
                out[f"{path[1:]} n={len(ids)}"] = float(np.percentile(lat[1:], 50))
    finally:
        client.close()
    return out


# the closed-loop load generator, run in its own process so that its
# threads do not share the server's interpreter lock:
#   python -c LOAD_CLIENT port path body_file content_type threads seconds
LOAD_CLIENT = r"""
import http.client, json, sys, threading, time
port, path, body_file, ctype = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
threads, seconds = int(sys.argv[5]), float(sys.argv[6])
body = open(body_file, "rb").read()
lat, bad, lock = [], [], threading.Lock()
start = threading.Barrier(threads + 1)
def worker():
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    mine = []
    start.wait()
    end = time.perf_counter() + seconds
    while True:
        t0 = time.perf_counter()
        if t0 >= end:
            break
        conn.request("POST", path, body, {"Content-Type": ctype})
        r = conn.getresponse()
        r.read()
        if r.status != 200:
            bad.append(r.status)
            break
        mine.append(time.perf_counter() - t0)
    conn.close()
    with lock:
        lat.extend(mine)
ts = [threading.Thread(target=worker) for _ in range(threads)]
for t in ts:
    t.start()
start.wait()
t0 = time.perf_counter()
for t in ts:
    t.join()
wall = time.perf_counter() - t0
lat.sort()
q = lambda p: 1e3 * lat[min(len(lat) - 1, int(p * (len(lat) - 1)))] if lat else None
doc = {"requests": len(lat), "seconds": wall, "rps": len(lat) / wall,
       "p50_ms": q(0.5), "p99_ms": q(0.99), "errors": len(bad)}
if len(sys.argv) > 7:  # the raw latencies too, for a caller that merges processes
    doc["lat"] = lat
print(json.dumps(doc))
"""
LOAD_THREADS, LOAD_SECONDS, LOAD_ROWS = 16, 3.0, 8


def closed_loop(port: int, body: bytes, binary: bool, workdir: str, procs: int = 1) -> dict:
    """16 client threads in ``procs`` other processes (16/procs each, all
    started together), each posting one request after the other for
    LOAD_SECONDS: requests/s (summed over the processes), p50 and p99 (host
    clock, over every request)."""
    path = os.path.join(workdir, "load_body.bin")
    with open(path, "wb") as f:
        f.write(body)
    argv = [sys.executable, "-c", LOAD_CLIENT, str(port),
            "/v1/models/deepfm:" + ("predict_binary" if binary else "predict"), path,
            "application/octet-stream" if binary else "application/json",
            str(LOAD_THREADS // procs), str(LOAD_SECONDS)]
    if procs == 1:
        out = subprocess.run(argv, capture_output=True, text=True, timeout=300, check=True)
        doc = json.loads(out.stdout.strip().splitlines()[-1])
    else:
        running = [subprocess.Popen(argv + ["raw"], stdout=subprocess.PIPE, text=True)
                   for _ in range(procs)]
        docs = [json.loads(p.communicate(timeout=300)[0].strip().splitlines()[-1])
                for p in running]
        lat = sorted(x for d in docs for x in d.pop("lat"))
        q = lambda p: 1e3 * lat[min(len(lat) - 1, int(p * (len(lat) - 1)))] if lat else None  # noqa: E731
        doc = {"requests": len(lat), "seconds": max(d["seconds"] for d in docs),
               "rps": sum(d["rps"] for d in docs), "p50_ms": q(0.5), "p99_ms": q(0.99),
               "errors": sum(d["errors"] for d in docs), "client_processes": procs}
    if doc["errors"] or not doc["requests"]:
        fail(f"closed-loop load failed: {doc}")
    return doc


def phase_serve(seed: int, workdir: str) -> dict:
    """The full-width DeepFM served over HTTP through the bucket graphs,
    with hot reload from a publish root; then the graphs against the eager
    and plain forwards, the obs surface, the graphed server against an
    eager one, hot swaps under traffic and the reloader's refusals."""
    from deepfm_tpu_torch.core.config import ModelConfig
    from deepfm_tpu_torch.models import DeepFM
    from deepfm_tpu_torch.ops import fused_ctr
    from deepfm_tpu_torch.serve.export import export_servable

    cfg = ModelConfig(fused_kernel="auto")
    servable = os.path.join(workdir, "v0")
    publish = os.path.join(workdir, "publish")
    t0 = time.perf_counter()
    model = DeepFM(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    export_servable(cfg, model.state_dict(), servable)
    del model
    print(f"serve: exported the full-width servable in {time.perf_counter() - t0:.2f} s")

    rng = np.random.default_rng(seed + 1)
    requests = []
    for n in (1, 8, 100):
        ids = make_ids(rng, n, cfg.field_size, cfg.feature_size)
        vals = rng.random((n, cfg.field_size)).astype(np.float32)
        requests.append((ids, vals))

    # the main path: counts from 0, then load + graph capture + warm-up +
    # requests through the graphs.  B1 runs there inside the graphs' replays,
    # which its wrapper does not see: its runs are replays x the launches a
    # replay holds (the wrapper counts the captured launches apart)
    fused_ctr.launches = fused_ctr.captured = 0
    t0 = time.perf_counter()
    ready, thread = _serve_thread(servable, "chip-smoke-server", reload_url=publish,
                                  reload_interval_secs=0.1)
    predictor = ready.predictor
    warm_launches, captured = fused_ctr.launches, fused_ctr.captured
    start_replays = predictor.replays
    print(f"serve: server up on port {ready.port} in {time.perf_counter() - t0:.2f} s "
          f"(load + {predictor.graph_count} graph captures + warm-up)")
    base = f"http://127.0.0.1:{ready.port}"
    served = []
    try:
        # readiness first: the client's own first-use cost stays out of
        # the first :predict's time
        if not get(f"{base}/readyz").get("ready"):
            fail("/readyz is not ready")
        for ids, vals in requests:
            body = _instances_body(ids, vals)
            lat_ms = []
            for rep in range(1 + SERVE_REPEATS):
                t1 = time.perf_counter()
                code, doc = post(f"{base}/v1/models/deepfm:predict", body)
                lat_ms.append((time.perf_counter() - t1) * 1e3)
                if code != 200:
                    fail(f":predict with {len(ids)} instances answered {code}: {doc}")
                probs = np.asarray(doc["predictions"], np.float32)
                if rep == 0:
                    served.append(probs)
                elif not np.array_equal(probs, served[-1]):
                    fail(f":predict with {len(ids)} instances is not repeatable")
            print(f"serve: :predict {len(ids)} instances -> 200; first "
                  f"{lat_ms[0]:.3f} ms, then over {SERVE_REPEATS} sequential "
                  f"repeats p50 {np.percentile(lat_ms[1:], 50):.3f} ms, "
                  f"max {max(lat_ms[1:]):.3f} ms (host clock, client to client)")
        eager, replays = fused_ctr.launches, predictor.replays
        per_replay = predictor.kernel_launches_per_replay
        launches = replays * per_replay
        code, doc = post(f"{base}/v1/models/deepfm:predict",
                         b'{"instances": [{"feat_ids": [1, 2], "feat_vals": [1.0]}]}')
        if code != 400:
            fail(f"a ragged body answered {code}, not 400")
        metrics = get(f"{base}/v1/metrics")
        if get(f"{base}/healthz").get("status") != "alive":
            fail("/healthz is not alive")
        if per_replay <= 0 or replays <= start_replays:
            fail(f"the served path replayed {replays} graphs ({start_replays} at start-up), "
                 f"each holding {per_replay} fused_ctr_forward launches")
        if captured != per_replay * predictor.graph_count or eager != warm_launches:
            fail(f"fused_ctr_forward: {captured} launches captured into "
                 f"{predictor.graph_count} graphs; {warm_launches} eager at start-up, "
                 f"{eager} after the requests (the graphed path launches none)")
        print(f"serve: fused_ctr_forward runs on the main path: {launches} = {replays} "
              f"graph replays ({start_replays} warm-up, {replays - start_replays} "
              f"requests) x {per_replay}; not counted: {warm_launches} eager side-stream "
              f"warm-ups before capture, {captured} recorded into the graphs; dispatches "
              f"by bucket: {metrics['batch_size_hist']}; latency_ms: {metrics['latency_ms']}")
        # (b) one graph a (slot, bucket)
        if predictor.graph_count != 2 * len(BUCKETS):
            fail(f"{predictor.graph_count} graphs after precompile, not {2 * len(BUCKETS)}")
        print(f"serve graphs: {predictor.graph_count} after precompile")
        check_served(cfg, servable, requests, served)
        breakdown(cfg, servable, ready, rng)                       # (a)
        serve_obs(base)                                            # (g)
        ab = serve_ab(cfg, servable, ready, requests, workdir)     # (c), (d)
        swap = serve_reload(cfg, servable, publish, ready, seed, workdir)  # (e), (f)
    finally:
        ready.server.shutdown()
        thread.join(timeout=60)
    if thread.is_alive():
        fail("server thread did not stop")
    return {"launches": launches, "replays": replays, "ab": ab, "swap": swap}


def check_served(cfg, servable: str, requests, served) -> None:
    """The served predictions against the plain forward of the same weights
    on the same padded bucket."""
    from deepfm_tpu_torch.serve.batcher import pick_bucket
    from deepfm_tpu_torch.serve.export import load_model

    ref = load_model(servable, device="cuda")
    max_err = 0.0
    for (ids, vals), got in zip(requests, served):
        n = len(ids)
        if got.shape != (n,) or not np.all(np.isfinite(got)):
            fail(f"predictions for {n} instances: shape {got.shape}, finite "
                 f"{bool(np.all(np.isfinite(got)))}")
        want = plain_probs(ref, ids, vals, pick_bucket(BUCKETS, n))
        err = float(np.abs(want - got).max())
        max_err = max(max_err, err)
        if err > TOL_PROB:
            fail(f"served predictions for {n} instances differ from the plain "
                 f"forward by {err} (tolerance {TOL_PROB})")
    print(f"serve: predictions finite; max abs diff vs the plain forward {max_err}")


def plain_probs(model, ids: np.ndarray, vals: np.ndarray, bucket: int,
                fused=None) -> np.ndarray:
    """``model``'s probabilities for the rows, zero-padded to ``bucket`` as
    a dispatch pads them, through the plain B1 (or ``fused``)."""
    from deepfm_tpu_torch.ops import fused_ctr

    n, f = ids.shape
    pid = np.zeros((bucket, f), np.int64)
    pval = np.zeros((bucket, f), np.float32)
    pid[:n], pval[:n] = ids, vals
    fused = fused or fused_ctr.fused_ctr_plain
    dev = model.fm_v.device
    with torch.inference_mode():
        i, v = model.prepare(torch.from_numpy(pid).to(dev), torch.from_numpy(pval).to(dev))
        return torch.sigmoid(model.head(*fused(model.fm_w, model.fm_v, i, v))).cpu().numpy()[:n]


def breakdown(cfg, servable: str, ready, rng: np.random.Generator) -> None:
    """(a) Where a dispatch's time goes, per bucket, on the serve mix: the
    forward on the device (graph replay of the eager forward) and as eager
    calls; the graphed dispatch (pinned copies in, replay, copy out, on the
    server's worker thread) against the eager servable's predict (numpy in,
    copy, eager forward, copy back), host clock, with the graphed answer's
    largest difference from the eager kernel forward and the plain one."""
    from deepfm_tpu_torch.serve.export import load_model, load_servable

    model = load_model(servable, device="cuda")
    predict, _ = load_servable(servable, device="cuda")
    predictor, run = ready.predictor, ready.scorer.run_on_worker
    for b in BUCKETS:
        ids = make_ids(rng, b, cfg.field_size, cfg.feature_size)
        vals = rng.random((b, cfg.field_size)).astype(np.float32)
        tids, tvals = torch.from_numpy(ids).to(DEVICE), torch.from_numpy(vals).to(DEVICE)
        with torch.inference_mode():
            fwd_ms, fwd_call_ms = time_ms(lambda: model(tids, tvals), reps=20)

        def graphed():
            times, out = [], None
            for _ in range(30):
                t0 = time.perf_counter()
                out = predictor.predict_with(0, ids, vals)
                times.append((time.perf_counter() - t0) * 1e3)
            return out, float(np.percentile(times, 50))

        got, graphed_ms = run(graphed)
        eager = []
        for _ in range(30):
            t0 = time.perf_counter()
            want_k = predict(ids, vals)
            eager.append((time.perf_counter() - t0) * 1e3)
        want_p = plain_probs(model, ids, vals, b)
        err_k = float(np.abs(got - want_k).max())
        err_p = float(np.abs(got - want_p).max())
        if err_k > TOL_GRAPH or err_p > TOL_PROB:
            fail(f"graphed dispatch at bucket {b}: {err_k} from the eager kernel forward "
                 f"(tolerance {TOL_GRAPH}), {err_p} from the plain (tolerance {TOL_PROB})")
        print("breakdown B=%d %s" % (b, json.dumps({
            "forward_ms": fwd_ms, "forward_call_ms": fwd_call_ms,
            "graphed_dispatch_p50_ms": graphed_ms,
            "predict_p50_ms": float(np.percentile(eager, 50)),
            "graphed_vs_eager_kernel_max_abs": err_k,
            "graphed_vs_plain_max_abs": err_p})))


def serve_obs(base: str) -> None:
    """(g) /metrics parses as Prometheus text; a request with a trace id
    gets it back and its queue and dispatch spans are in the ring."""
    with urllib.request.urlopen(f"{base}/metrics", timeout=60) as r:
        text = r.read().decode()
    samples = {}
    for line in text.splitlines():
        if line.startswith("#"):
            if line.split()[1] not in ("HELP", "TYPE"):
                fail(f"/metrics: bad comment line {line!r}")
            continue
        name, value = line.rsplit(" ", 1)
        if not name or name[0] in "{ " or not np.isfinite(float(value)):
            fail(f"/metrics: bad sample line {line!r}")
        samples[name] = float(value)
    if samples.get('deepfm_serve_requests_total{engine="predict"}', 0) <= 0:
        fail("/metrics counts no request")
    trace_id = "c41b5e0fc41b5e0f"
    req = urllib.request.Request(
        f"{base}/v1/models/deepfm:predict",
        data=b'{"instances": [{"feat_ids": ' + json.dumps([1] * 39).encode()
        + b', "feat_vals": ' + json.dumps([1.0] * 39).encode() + b"}]}",
        headers={"X-Trace-Id": trace_id})
    with urllib.request.urlopen(req, timeout=60) as r:
        if r.headers.get("X-Trace-Id") != trace_id:
            fail("the traced response does not carry its trace id")
    traces = [t for t in get(f"{base}/v1/trace/recent")["traces"] if t["trace_id"] == trace_id]
    spans = sorted(s["name"] for t in traces for s in t["spans"])
    if spans != ["predict.dispatch", "predict.queue"]:
        fail(f"the traced request's spans are {spans}")
    flight = get(f"{base}/v1/flight")["events"]
    print(f"serve obs: /metrics {len(samples)} samples parsed; trace {trace_id} spans "
          f"{[(s['name'], s['duration_ms']) for t in traces for s in t['spans']]}; "
          f"flight events {len(flight)}")


def serve_ab(cfg, servable: str, ready, requests, workdir: str) -> dict:
    """(c), (d) The graphed server against an eager micro-batcher over
    load_model in the same process: :predict and :predict_binary p50 at
    1, 8 and 100 instances, then a closed loop of 16 clients on each."""
    from deepfm_tpu_torch.serve.batcher import MicroBatcher
    from deepfm_tpu_torch.serve.export import load_servable
    from deepfm_tpu_torch.serve.server import (ScoringHTTPServer, encode_binary_request,
                                               make_handler)

    predict, _ = load_servable(servable, device="cuda")
    eager = MicroBatcher(predict, cfg.field_size, buckets=BUCKETS, max_wait_ms=2.0,
                         name="eager")
    eager.precompile()
    httpd = ScoringHTTPServer(("127.0.0.1", 0), make_handler(eager, "deepfm"))
    thread = threading.Thread(target=httpd.serve_forever, name="chip-smoke-eager",
                              daemon=True)
    thread.start()
    rng = np.random.default_rng(99)
    ids = make_ids(rng, LOAD_ROWS, cfg.field_size, cfg.feature_size)
    vals = rng.random((LOAD_ROWS, cfg.field_size)).astype(np.float32)
    out = {}
    try:
        ports = {"graphed": ready.port, "eager": httpd.server_address[1]}
        for name, port in ports.items():
            out[name] = {"p50_ms": http_p50(port, requests)}
        for name, port in ports.items():
            for binary in (False, True):
                body = (encode_binary_request(ids, vals) if binary
                        else _instances_body(ids, vals))
                out[name][f"load_{'binary' if binary else 'json'}"] = closed_loop(
                    port, body, binary, workdir)
        for name in ports:
            print(f"serve http {name}: {json.dumps(out[name])}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)
        eager.close()
    return out


def serve_reload(cfg, servable: str, publish: str, ready, seed: int, workdir: str) -> dict:
    """(e) Versions 1 and 2, published through the port's ModelPublisher
    with their own weights, swap in under concurrent :predict traffic:
    every response equals the plain answer of the version it reports or
    the one before it (1e-4), and after the swaps every response is the new
    version's; the graph count stays 8.  (f) A version with NaN weights is
    rolled back, one with a corrupted params.npz refused on its hash."""
    from deepfm_tpu_torch.models import DeepFM
    from deepfm_tpu_torch.online.publisher import ModelPublisher, version_location
    from deepfm_tpu_torch.serve.export import load_model, model_from_state

    swapper, predictor = ready.swapper, ready.predictor
    states = [None] + [DeepFM(cfg, device="cpu", generator=torch.Generator().manual_seed(
        seed + v)).state_dict() for v in (1, 2)]
    models = [load_model(servable, device="cuda")] + [
        model_from_state(cfg, states[v], "cuda") for v in (1, 2)]
    rng = np.random.default_rng(seed + 5)
    clients = []
    for k, n in enumerate((1, 3, 8, 20)):
        ids = make_ids(rng, n, cfg.field_size, cfg.feature_size)
        vals = rng.random((n, cfg.field_size)).astype(np.float32)
        # each version's plain answer at every bucket the rows may land in
        want = [{b: plain_probs(m, ids, vals, b) for b in BUCKETS if b >= n} for m in models]
        clients.append((_instances_body(ids, vals), want))
    stop = threading.Event()
    bad, counts = [], [0] * 3
    lock = threading.Lock()

    def client(body, want):
        conn = _Client(ready.port)
        try:
            while not stop.is_set():
                code, _, raw = conn.post("/v1/models/deepfm:predict", body)
                doc = json.loads(raw)
                if code != 200:
                    bad.append(f"{code}: {doc}")
                    return
                got = np.asarray(doc["predictions"], np.float32)
                mv = doc["model_version"]
                ok = [v for v in {mv, max(0, mv - 1)} if any(
                    float(np.abs(got - w).max()) <= TOL_PROB for w in want[v].values())]
                with lock:
                    counts[mv] += 1
                if not ok:
                    bad.append(f"reported version {mv}: matches neither it nor the one before")
                    return
        finally:
            conn.close()

    threads = [threading.Thread(target=client, args=c, daemon=True) for c in clients]
    for t in threads:
        t.start()
    pub = ModelPublisher(publish)
    for v in (1, 2):
        time.sleep(0.3)
        pub.publish(cfg, states[v], step=v)
        deadline = time.monotonic() + 120
        while swapper.status()["swaps_total"] < v:  # swapped and drained
            if time.monotonic() > deadline or bad:
                fail(f"version {v} did not swap in: {swapper.status()} {bad[:2]}")
            time.sleep(0.01)
        st = swapper.status()
        print(f"serve reload: version {v} live; last_swap_ms {st['last_swap_ms']}, "
              f"last_stage_ms {st['last_stage_ms']}, last_canary_ms {st['last_canary_ms']}, "
              f"graphs {predictor.graph_count}, slot {st['live_slot']}")
        if predictor.graph_count != 2 * len(BUCKETS):
            fail(f"{predictor.graph_count} graphs after swap {v}")
    time.sleep(0.3)
    stop.set()
    for t in threads:
        t.join(timeout=60)
    if bad or any(t.is_alive() for t in threads):
        fail(f"responses during the swaps: {bad[:3]}")
    # after the swaps: every response is version 2's
    conn = _Client(ready.port)
    try:
        for body, want in clients:
            code, _, raw = conn.post("/v1/models/deepfm:predict", body)
            doc = json.loads(raw)
            got = np.asarray(doc["predictions"], np.float32)
            if doc["model_version"] != 2 or not any(
                    float(np.abs(got - w).max()) <= TOL_PROB for w in want[2].values()):
                fail(f"after the swaps a response is not version 2's: {doc}")
    finally:
        conn.close()
    st = swapper.status()
    swap = {k: st[k] for k in ("last_swap_ms", "last_stage_ms", "last_canary_ms")}
    print(f"serve reload: responses by reported version {counts}, all the old or the new "
          f"version's within {TOL_PROB}; {json.dumps(swap)}")

    # (f) refusals, polled by hand
    swapper.stop()
    nan_state = dict(states[2])
    nan_state["fm_v"] = torch.full_like(states[2]["fm_v"], float("nan"))
    pub.publish(cfg, nan_state, step=3)
    if swapper.poll_once() or swapper.status()["model_version"] != 2 \
            or "non-finite" not in (swapper.status()["last_error"] or ""):
        fail(f"a NaN version was not rolled back: {swapper.status()}")
    pub.publish(cfg, states[1], step=4)
    path = os.path.join(version_location(publish, 4), "params.npz")
    with np.load(path) as npz:
        arrays = {k: npz[k] for k in npz.files}
    arrays["fm_b"] = arrays["fm_b"] + 1.0  # the bytes no longer match the manifest
    np.savez(path, **arrays)
    if swapper.poll_once() or "hash mismatch" not in (swapper.status()["last_error"] or ""):
        fail(f"a corrupted version was not refused on its hash: {swapper.status()}")
    st = swapper.status()
    if st["model_version"] != 2 or st["rollbacks_total"] != 2 or predictor.graph_count != 8:
        fail(f"after the refusals: {st}")
    print(f"serve refusals: NaN version rolled back, corrupted version refused on its "
          f"hash; live version {st['model_version']}, rollbacks {st['rollbacks_total']}, "
          f"graphs {predictor.graph_count}")
    return swap


def build_funnel(seed: int, workdir: str) -> str:
    """The full-width funnel servable: the flagship ranker (random weights
    from --seed) over an int8 index of all 117,581 ranker items, encoded on
    the card through a random two-tower item tower from seeded random item
    features; top 32 -> 8, oversample 4.  The int8 export runs the recall
    gate."""
    from deepfm_tpu_torch.core.config import ModelConfig
    from deepfm_tpu_torch.funnel import build_index, export_funnel_servable
    from deepfm_tpu_torch.models import DeepFM, TwoTower

    rank_cfg = ModelConfig(fused_kernel="auto")
    n = rank_cfg.feature_size
    query_cfg = ModelConfig(
        model_name="two_tower", user_vocab_size=FUNNEL_USER_VOCAB, item_vocab_size=n,
        user_field_size=FUNNEL_FIELDS, item_field_size=FUNNEL_FIELDS,
        embedding_size=FUNNEL_TOWER_EMB, tower_layers=FUNNEL_TOWER_LAYERS,
        tower_dim=FUNNEL_TOWER_DIM, compute_dtype="float32")
    rank = DeepFM(rank_cfg, device="cpu", generator=torch.Generator().manual_seed(seed + 10))
    query = TwoTower(query_cfg, device="cuda",
                     generator=torch.Generator().manual_seed(seed + 11))
    rng = np.random.default_rng(seed + 12)
    feats = rng.integers(0, n, (n, FUNNEL_FIELDS))
    t0 = time.perf_counter()
    index = build_index(query, np.arange(n), feats, np.ones((n, FUNNEL_FIELDS), np.float32))
    torch.cuda.synchronize()
    t_index = time.perf_counter() - t0
    t0 = time.perf_counter()
    export_funnel_servable(workdir, rank_cfg, rank.state_dict(), query_cfg,
                           query.state_dict(), index, top_k=FUNNEL_TOP_K,
                           return_n=FUNNEL_RETURN_N, retrieval="int8",
                           oversample=FUNNEL_OVERSAMPLE)
    with open(os.path.join(workdir, "funnel.json")) as f:
        section = json.load(f)["retrieval"]
    print(f"funnel: index of {n} items built on the card in {t_index:.3f} s; "
          f"export with the recall gate {time.perf_counter() - t0:.3f} s; "
          f"funnel.json retrieval {json.dumps(section)}")
    return workdir


def funnel_requests(rng: np.random.Generator, n: int) -> tuple[np.ndarray, ...]:
    """n users: query ids over the user vocabulary (vals 1), and ranking
    rows drawn like the serve phase's."""
    uids = rng.integers(0, FUNNEL_USER_VOCAB, (n, FUNNEL_FIELDS))
    uvals = np.ones((n, FUNNEL_FIELDS), np.float32)
    fids = make_ids(rng, n, 39, 117_581)
    fvals = rng.random((n, 39)).astype(np.float32)
    return uids, uvals, fids, fvals


def phase_funnel(seed: int, workdir: str) -> dict:
    """The funnel served over HTTP on the card, at full width: /v1/recommend
    with 1, 8 and 64 users, checked against the same payload run through
    the plain versions of B2 and B1; stage times, latency, device recall."""
    from deepfm_tpu_torch.funnel import graphs as funnel_graphs
    from deepfm_tpu_torch.funnel.index import build_rank_topn_with, build_retrieve_with
    from deepfm_tpu_torch.funnel.recall import recall_at_k
    from deepfm_tpu_torch.ops import fused_ctr, retrieval
    from deepfm_tpu_torch.serve.server import serve_forever

    servable = build_funnel(seed, workdir)
    rng = np.random.default_rng(seed + 13)
    requests = [funnel_requests(rng, n) for n in FUNNEL_REQUESTS]

    # the main path: counts from 0, then load + capture + warm-up + requests
    reset_funnel_counts()
    ready = threading.Event()
    errors = []

    def run():
        try:
            serve_forever(servable, port=0, buckets=FUNNEL_BUCKETS, max_wait_ms=2.0,
                          device="cuda", ready=ready)
        except BaseException as e:  # reported by the main thread
            errors.append(e)
            ready.set()

    t0 = time.perf_counter()
    thread = threading.Thread(target=run, name="chip-smoke-funnel", daemon=True)
    thread.start()
    if not ready.wait(timeout=600) or errors:
        fail(f"funnel server did not come up: {errors}")
    print(f"funnel: server up on port {ready.port} in {time.perf_counter() - t0:.2f} s "
          f"(load, staging, bucket warm-up)")
    base = f"http://127.0.0.1:{ready.port}"
    served = []
    try:
        if not get(f"{base}/readyz").get("ready"):
            fail("funnel /readyz is not ready")
        for uids, uvals, fids, fvals in requests:
            n = len(uids)
            body = json.dumps({"instances": [
                {"user_ids": a.tolist(), "user_vals": b.tolist(),
                 "feat_ids": c.tolist(), "feat_vals": d.tolist()}
                for a, b, c, d in zip(uids, uvals, fids, fvals)]}).encode()
            lat_ms = []
            for rep in range(1 + FUNNEL_REPEATS):
                t1 = time.perf_counter()
                code, doc = post(f"{base}/v1/recommend", body)
                lat_ms.append((time.perf_counter() - t1) * 1e3)
                if code != 200:
                    fail(f"/v1/recommend with {n} users answered {code}: {doc}")
                if rep == 0:
                    served.append(doc)
                elif doc != served[-1]:
                    fail(f"/v1/recommend with {n} users is not repeatable")
            print(f"funnel: /v1/recommend {n} users -> 200; first {lat_ms[0]:.3f} ms, "
                  f"then over {FUNNEL_REPEATS} sequential repeats p50 "
                  f"{np.percentile(lat_ms[1:], 50):.3f} ms, max {max(lat_ms[1:]):.3f} ms "
                  f"(host clock, client to client)")
        code, doc = post(f"{base}/v1/recommend", json.dumps({"instances": [
            {"user_ids": [1], "user_vals": [1.0], "feat_ids": [1] * 39,
             "feat_vals": [1.0] * 39}]}).encode())
        if code != 400:
            fail(f"a mis-sized recommend body answered {code}, not 400")
        metrics = get(f"{base}/v1/metrics")
    finally:
        ready.server.shutdown()
        thread.join(timeout=60)
    retr_launches, fwd_launches = funnel_kernel_runs()
    if thread.is_alive():
        fail("funnel server thread did not stop")
    if min(funnel_graphs.graph_kernel_runs.values()) <= 0:
        fail(f"the funnel's graphs ran retrieval_topk and fused_ctr_forward "
             f"{funnel_graphs.graph_kernel_runs} times")
    fm = metrics["funnel"]
    print(f"funnel: runs on the main path: retrieval_topk {retr_launches}, "
          f"fused_ctr_forward {fwd_launches} (eager warm-ups before capture: "
          f"{retrieval.launches}, {fused_ctr.launches}; through graph replays: "
          f"{funnel_graphs.graph_kernel_runs}); dispatches by bucket "
          f"{metrics['batch_size_hist']}")
    print("funnel: stages (stream time a dispatch between the graphs' CUDA events, "
          "host gaps before a launch included, /v1/metrics) %s" % json.dumps({
        "retrieval_ms": fm["retrieval_ms"], "rank_ms": fm["rank_ms"],
        "engine_latency_ms": metrics["latency_ms"],
        "candidates_per_sec": fm["candidates_per_sec"],
        "score_read_bytes": fm["score_read_bytes"]}))

    # check: the same payload through the plain versions of B2 and B1
    scorer = ready.scorer
    ctx, payload = scorer.ctx, scorer.graphs.payload(scorer.holder.get())
    fu = ctx.user_fields
    kernel_retrieve = build_retrieve_with(ctx)
    stats = check_funnel_answers(ctx, payload, requests, served, FUNNEL_BUCKETS, "funnel")
    print(f"funnel: served vs plain B2 + plain B1 on the same payload: {json.dumps(stats)}")

    funnel_breakdown(ctx, payload, kernel_retrieve, build_rank_topn_with(ctx), rng)

    # device recall@32 of the int8 path against the exact f32 top-32
    exact_retrieve = build_retrieve_with(ctx._replace(retrieval_mode="exact"))
    g = np.random.default_rng(seed + 14)
    uids = torch.from_numpy(g.integers(0, FUNNEL_USER_VOCAB, (RECALL_USERS, fu))).cuda()
    uvals = torch.ones((RECALL_USERS, fu), device="cuda")
    with torch.inference_mode():
        _, exact_ids = exact_retrieve(payload, uids, uvals)
        _, int8_ids = kernel_retrieve(payload, uids, uvals)
    per_user = recall_at_k(int8_ids.cpu().numpy(), exact_ids.cpu().numpy())
    print(f"funnel: device recall@{ctx.top_k} of int8 vs exact f32 over {RECALL_USERS} "
          f"users: mean {per_user.mean()}, worst {per_user.min()}")
    task = funnel_serve_task(servable, rng)
    return {"retrieval_launches": retr_launches, "forward_launches": fwd_launches,
            "task_retrieval_launches": task["retrieval_launches"],
            "task_forward_launches": task["forward_launches"],
            "recall": float(per_user.mean())}


# the serve task over the funnel servable (stamped 32 -> 8), overriding it
FUNNEL_TASK_TOP_K, FUNNEL_TASK_RETURN_N = 16, 4
FUNNEL_TASK_BUCKETS = "16,64"
FUNNEL_TASK_REQUESTS = (1, 8)


def funnel_serve_task(servable: str, rng: np.random.Generator) -> dict:
    """The serve task (train/loop.py run_serve, as `python -m
    deepfm_tpu_torch --task_type serve --funnel_top_k 16 --funnel_return_n
    4` runs it) over the funnel servable: every /v1/recommend answer must
    hold 4 items, agree with the plain B2 + plain B1 pipeline at top 16 ->
    4, and B2 and B1 must run (eager warm-ups plus graph replays)."""
    from deepfm_tpu_torch.launch.cli import resolve_config
    from deepfm_tpu_torch.train.loop import run_serve

    cfg, _ = resolve_config(["--task_type", "serve", "--servable_model_dir", servable,
                             "--funnel_top_k", str(FUNNEL_TASK_TOP_K),
                             "--funnel_return_n", str(FUNNEL_TASK_RETURN_N),
                             "--set", "run.serve_port=0",
                             "--set", f"run.serve_buckets=\"{FUNNEL_TASK_BUCKETS}\""])
    if cfg.run.funnel_top_k != FUNNEL_TASK_TOP_K:
        fail(f"funnel task: the flags resolved to {cfg.run}")
    requests = [funnel_requests(rng, n) for n in FUNNEL_TASK_REQUESTS]
    # the main path: counts from 0, then the serve task and its requests
    reset_funnel_counts()
    ready, errors = threading.Event(), []

    def run():
        try:
            run_serve(cfg, device="cuda", ready=ready)
        except BaseException as e:  # reported by the main thread
            errors.append(e)
            ready.set()

    thread = threading.Thread(target=run, name="chip-smoke-funnel-task", daemon=True)
    thread.start()
    if not ready.wait(timeout=600) or errors:
        fail(f"funnel task: the serve task did not come up: {errors}")
    served = []
    try:
        for uids, uvals, fids, fvals in requests:
            body = json.dumps({"instances": [
                {"user_ids": a.tolist(), "user_vals": b.tolist(),
                 "feat_ids": c.tolist(), "feat_vals": d.tolist()}
                for a, b, c, d in zip(uids, uvals, fids, fvals)]}).encode()
            code, doc = post(f"http://127.0.0.1:{ready.port}/v1/recommend", body)
            if code != 200 or any(len(x) != FUNNEL_TASK_RETURN_N for x in doc["items"]):
                fail(f"funnel task: /v1/recommend with {len(uids)} users answered "
                     f"{code}: {doc}")
            served.append(doc)
    finally:
        ready.server.shutdown()
        thread.join(timeout=60)
    retr, fwd = funnel_kernel_runs()
    if thread.is_alive():
        fail("funnel task: the server thread did not stop")
    scorer = ready.scorer
    if (scorer.ctx.top_k, scorer.ctx.return_n) != (FUNNEL_TASK_TOP_K, FUNNEL_TASK_RETURN_N):
        fail(f"funnel task: served top {scorer.ctx.top_k} -> {scorer.ctx.return_n}")
    if fwd <= 0 or retr <= 0:
        fail(f"funnel task: the serve task launched retrieval_topk {retr} and "
             f"fused_ctr_forward {fwd} times")
    buckets = tuple(int(b) for b in FUNNEL_TASK_BUCKETS.split(","))
    stats = check_funnel_answers(scorer.ctx, scorer.graphs.payload(scorer.holder.get()),
                                 requests, served, buckets, "funnel task")
    print("funnel task %s" % json.dumps({
        "argv": "--task_type serve --funnel_top_k 16 --funnel_return_n 4",
        "top_k": scorer.ctx.top_k, "return_n": scorer.ctx.return_n,
        "users": list(FUNNEL_TASK_REQUESTS),
        "launches": {"retrieval_topk": retr, "fused_ctr_forward": fwd},
        "vs_plain": stats}))
    return {"retrieval_launches": retr, "forward_launches": fwd}


def check_funnel_answers(ctx, payload, requests, served, buckets, what: str) -> dict:
    """Hold a funnel server's /v1/recommend answers (``served``, one per
    request of ``requests``) to the same payload (one index shard) run
    through the plain versions of B2 and B1 at the context's top_k ->
    return_n: every user's items, probabilities and retrieval scores,
    near-ties counted.  Returns the agreement counts."""
    from deepfm_tpu_torch.funnel.index import build_rank_topn_with, build_retrieve_with
    from deepfm_tpu_torch.models.two_tower import encode_queries
    from deepfm_tpu_torch.ops import retrieval
    from deepfm_tpu_torch.serve.batcher import pick_bucket

    fu = ctx.user_fields
    kernel_retrieve = build_retrieve_with(ctx)
    rank = build_rank_topn_with(ctx)
    # every candidate ranked, so a served item is found whatever its place
    rank_all = build_rank_topn_with(ctx._replace(return_n=ctx.top_k))
    kos = ctx.top_k * ctx.oversample
    index = payload["shards"][0]
    int8 = ctx.retrieval_mode == "int8"
    stats = {"rows": 0, "rows_equal": 0, "near_tie_rows": 0, "shortlist_swapped": 0,
             "shortlist_boundary": 0, "max_rank_err": 0.0, "max_retr_err": 0.0}
    for (uids, uvals, fids, fvals), doc in zip(requests, served):
        n = len(uids)
        b = pick_bucket(buckets, n)
        ids = np.zeros((b, fu + 39), np.int64)
        vals = np.zeros((b, fu + 39), np.float32)
        ids[:n] = np.concatenate([uids, fids], axis=1)
        vals[:n] = np.concatenate([uvals, fvals], axis=1)
        tids, tvals = torch.from_numpy(ids).to(DEVICE), torch.from_numpy(vals).to(DEVICE)
        with torch.inference_mode():
            agree = {"ok": True, "swapped": 0, "boundary": 0, "traded": [0] * b}
            if int8:
                u = encode_queries(payload["query"], tids[:, :fu], tvals[:, :fu])
                args = (u, index["item_codes"], index["item_scales"], index["item_ids"], kos)
                agree = retrieval.topk_agreement(
                    *args[:4], retrieval.retrieval_topk(*args),
                    retrieval.retrieval_topk_plain(*args), TOL_B2_RTOL, TOL_B2_ATOL)
            ks, kcand = kernel_retrieve(payload, tids[:, :fu], tvals[:, :fu])
            with plain_kernels():
                s, cand = kernel_retrieve(payload, tids[:, :fu], tvals[:, :fu])
                ref = rank(payload, tids[:, fu:], tvals[:, fu:], cand, s).cpu().numpy()
                # plain B1 on the candidates the kernel pipeline retrieved
                ref_k = rank_all(payload, tids[:, fu:], tvals[:, fu:], kcand, ks).cpu().numpy()
        if not agree["ok"]:
            fail(f"{what}: the served shortlist disagrees with plain B2 for {n} users: {agree}")
        stats["shortlist_swapped"] += agree["swapped"]
        stats["shortlist_boundary"] += agree["boundary"]
        cand_differs = (kcand != cand).any(dim=1).cpu().numpy()
        items = np.asarray(doc["items"])
        if items.shape != (n, ctx.return_n) or not np.isfinite(doc["scores"]).all():
            fail(f"{what}: {n} users answered items of shape {items.shape}")
        for q in range(n):
            stats["rows"] += 1
            if cand_differs[q] and agree["traded"][q] == 0:
                fail(f"{what}: user {q} of {n}: the kernel's candidates differ from plain "
                     f"B2's with no near-tie in the user's own shortlist")
            r_err, t_err = check_served_user(
                items[q], np.asarray(doc["scores"][q]), np.asarray(doc["retrieval_scores"][q]),
                ref_k[q], ctx.return_n, f"{what}: user {q} of {n}")
            stats["max_rank_err"] = max(stats["max_rank_err"], r_err)
            stats["max_retr_err"] = max(stats["max_retr_err"], t_err)
            if np.array_equal(items[q], ref[q, 0].astype(np.int64)):
                stats["rows_equal"] += 1
            else:
                # a near-tie in the user's own shortlist or among its ranked
                # probabilities (both held to their tolerances above)
                stats["near_tie_rows"] += 1
    return stats


@contextlib.contextmanager
def plain_kernels():
    """The funnel's B2 and B1 calls swapped for their plain versions, on the
    same card, for a reference run of the served payload."""
    from deepfm_tpu_torch.funnel import index
    from deepfm_tpu_torch.models import deepfm, xdeepfm
    from deepfm_tpu_torch.ops import fused_ctr, retrieval

    saved = index.retrieval_topk, deepfm.fused_ctr_interaction, xdeepfm.fused_ctr_interaction
    index.retrieval_topk = retrieval.retrieval_topk_plain
    deepfm.fused_ctr_interaction = xdeepfm.fused_ctr_interaction = fused_ctr.fused_ctr_plain
    try:
        yield
    finally:
        index.retrieval_topk, deepfm.fused_ctr_interaction, xdeepfm.fused_ctr_interaction = saved


def check_served_user(items, rank_s, retr_s, ranked, n: int, what: str) -> tuple[float, float]:
    """Hold one user's served top ``n`` to ``ranked`` [3, K], the plain
    ranking of all the candidates the kernel pipeline retrieved: distinct
    candidates, each with its own probability (TOL_PROB) and retrieval
    score (TOL_RETR), in non-increasing order, and none of them below the
    n-th plain probability by more than TOL_PROB (a rank near-tie may trade
    places).  Returns the largest probability and retrieval errors."""
    place = {int(c): j for j, c in enumerate(ranked[0])}
    if len(set(items.tolist())) != n or any(int(c) not in place for c in items):
        fail(f"{what} served {items.tolist()}, not {n} distinct retrieved candidates "
             f"{ranked[0].astype(np.int64).tolist()}")
    at = [place[int(c)] for c in items]
    r_err = float(np.abs(rank_s - ranked[1, at]).max())
    t_err = float(np.abs(retr_s - ranked[2, at]).max())
    if r_err > TOL_PROB or t_err > TOL_RETR:
        fail(f"{what}: rank score err {r_err}, retrieval score err {t_err}")
    if np.any(np.diff(rank_s) > 0) or ranked[1, at].min() < ranked[1, n - 1] - TOL_PROB:
        fail(f"{what} served {items.tolist()} with probabilities {rank_s.tolist()}; the "
             f"plain ranking's top {n} is {ranked[0, :n].astype(np.int64).tolist()} "
             f"with {ranked[1, :n].tolist()}")
    return r_err, t_err


def funnel_breakdown(ctx, payload, retrieve, rank, rng: np.random.Generator) -> None:
    """Where a funnel dispatch's time goes, per bucket: each stage on the
    device (graph replay) and as eager calls, kernels included."""
    fu = ctx.user_fields
    for b in FUNNEL_BUCKETS:
        uids, uvals, fids, fvals = (torch.from_numpy(a).cuda()
                                    for a in funnel_requests(rng, b))
        with torch.inference_mode():
            scores, cand = retrieve(payload, uids, uvals)
            retr_ms, retr_call_ms = time_ms(lambda: retrieve(payload, uids, uvals), reps=20)
            rank_ms, rank_call_ms = time_ms(
                lambda: rank(payload, fids, fvals, cand, scores), reps=20)
        print("funnel breakdown B=%d %s" % (b, json.dumps({
            "retrieval_ms": retr_ms, "retrieval_call_ms": retr_call_ms,
            "rank_ms": rank_ms, "rank_call_ms": rank_call_ms,
            "rank_rows": b * ctx.top_k})))


# phase funnel_swap: 8 closed-loop HTTP clients (one user each, so every
# dispatch is the 8-row bucket and an answer depends on its version alone),
# the swapper's poll interval, dispatches timed per bucket and mode
SWAP_CLIENTS, SWAP_POLL_S, SWAP_TIMED = 8, 0.3, 30
SHARD_COUNTS, SHARD_USERS = (2, 4), 64
# a sharded score against brute force's f32 dot of the same pair (cuBLAS
# and numpy sum D = 32 products in other orders)
TOL_SHARD = 1e-5


def pack_doc(pack: np.ndarray) -> dict:
    """A graphed [B, 3, N] pack as /v1/recommend's answer fields."""
    return {"items": pack[:, 0].astype(np.int64).tolist(),
            "scores": np.round(np.where(np.isfinite(pack[:, 1]), pack[:, 1], 0.0), 6).tolist(),
            "retrieval_scores": np.round(np.where(np.isfinite(pack[:, 2]), pack[:, 2], 0.0),
                                         6).tolist()}


def swap_graphed_vs_eager(art, rng: np.random.Generator) -> dict:
    """Part 1: the funnel's graphs at full width, exact and int8, against
    the same stages run eagerly (ids equal, probabilities and retrieval
    scores within TOL_GRAPH) and against the plain B2 and B1 on the same
    payload (check_funnel_answers); dispatch times, graphed and eager, and
    each stage's stream time between the graphs' CUDA events (its device
    time plus the gap before its launch, small with no other thread)."""
    from deepfm_tpu_torch.funnel import graphs as funnel_graphs
    from deepfm_tpu_torch.funnel import make_funnel_context

    meta = art.meta
    out = {}
    for mode in ("exact", "int8"):
        ctx = make_funnel_context(art.rank_cfg, art.query_cfg, capacity=meta["capacity"],
                                  top_k=FUNNEL_TOP_K, return_n=FUNNEL_RETURN_N,
                                  retrieval=mode, oversample=FUNNEL_OVERSAMPLE)
        graphs = funnel_graphs.FunnelGraphs(ctx, art.rank_state, art.query_state, art.index,
                                            device=DEVICE, buckets=FUNNEL_BUCKETS)
        t0 = time.perf_counter()
        graphs.precompile()
        capture_s = time.perf_counter() - t0
        per_bucket = {}
        for b in FUNNEL_BUCKETS:
            requests = [funnel_requests(rng, b)]
            uids, uvals, fids, fvals = requests[0]
            ids = np.concatenate([uids, fids], axis=1)
            vals = np.concatenate([uvals, fvals], axis=1)
            packs = []
            for slot in (0, 1):
                pack, overflow, _ = graphs.dispatch(slot, ids, vals)
                want, want_overflow = graphs.eager(slot, ids, vals)
                if not np.array_equal(pack[:, 0], want[:, 0]) or overflow != want_overflow:
                    fail(f"funnel_swap {mode} B={b} slot {slot}: graphed ids differ from eager")
                err = float(np.abs(pack[:, 1:] - want[:, 1:]).max())
                if err > TOL_GRAPH:
                    fail(f"funnel_swap {mode} B={b} slot {slot}: graphed vs eager {err}")
                packs.append(pack)
            stats = check_funnel_answers(ctx, graphs.payload(0), requests, [pack_doc(packs[0])],
                                         FUNNEL_BUCKETS, f"funnel_swap {mode} B={b}")
            host, dev_r, dev_k = [], [], []
            for _ in range(SWAP_TIMED):
                t1 = time.perf_counter()
                _, _, (r_s, k_s) = graphs.dispatch(0, ids, vals)
                host.append(time.perf_counter() - t1)
                dev_r.append(r_s)
                dev_k.append(k_s)
            eager = []
            for _ in range(SWAP_TIMED):
                t1 = time.perf_counter()
                graphs.eager(0, ids, vals)
                eager.append(time.perf_counter() - t1)
            per_bucket[b] = {
                "graphed_dispatch_ms": 1e3 * float(np.median(host)),
                "eager_dispatch_ms": 1e3 * float(np.median(eager)),
                "retrieve_stream_us": 1e6 * float(np.median(dev_r)),
                "rank_stream_us": 1e6 * float(np.median(dev_k)),
                "vs_eager_max_abs": err, "vs_plain": stats}
        out[mode] = {"capture_s": capture_s, "graphs": graphs.graph_count,
                     "launches_per_replay": graphs.launches_per_replay,
                     "retrieve_pool_bytes": graphs.retrieve_pool_bytes,
                     "per_bucket": per_bucket}
        print("funnel_swap graphed %s %s" % (mode, json.dumps(out[mode])))
        del graphs
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
    return out


def perturbed_version(art, seed: int):
    """Version 2 of the served funnel: every ranker weight moved by 0.01,
    every query-tower weight scaled by 1 + 0.05·N(0, 1) (a shift of the
    whole tower would crowd the items' embeddings together: at +0.01 the
    int8 corpus measured recall 0.9421, under the 0.95 publish gate), and the
    index rebuilt on the card through the new item tower from
    build_funnel's item features."""
    from deepfm_tpu_torch.funnel import build_index
    from deepfm_tpu_torch.serve.export import model_from_state

    g = np.random.default_rng(seed + 17)
    rank = {k: v + np.float32(0.01) for k, v in art.rank_state.items()}
    query = {k: (v * (1 + 0.05 * g.standard_normal(v.shape))).astype(np.float32)
             for k, v in art.query_state.items()}
    n = art.rank_cfg.feature_size
    feats = np.random.default_rng(seed + 12).integers(0, n, (n, FUNNEL_FIELDS))
    tower = model_from_state(art.query_cfg, query, DEVICE)
    index = build_index(tower, np.arange(n), feats, np.ones((n, FUNNEL_FIELDS), np.float32))
    return rank, query, index


def swap_under_traffic(art, servable: str, workdir: str, seed: int,
                       card: str) -> tuple[dict, dict]:
    """Part 2: versions 1 (the servable's own) and 2 (perturbed_version)
    published by FunnelPublisher into a local root and swapped in under 8
    HTTP clients: every response of version 1 or 2 with equal model and
    index versions and the answer of its version; then a NaN ranker and a
    corrupted index.npz, both rolled back while version 2 keeps serving."""
    from deepfm_tpu_torch.funnel import FunnelPublisher
    from deepfm_tpu_torch.online.publisher import version_location

    root = os.path.join(workdir, "publish")
    pub = FunnelPublisher(root, keep=8)
    kw = dict(top_k=FUNNEL_TOP_K, return_n=FUNNEL_RETURN_N, capacity=art.meta["capacity"],
              retrieval="int8", oversample=FUNNEL_OVERSAMPLE)
    t0 = time.perf_counter()
    pub.publish_funnel(art.rank_cfg, art.rank_state, art.query_cfg, art.query_state,
                       art.index, step=1, **kw)
    publish_s = time.perf_counter() - t0
    v2 = perturbed_version(art, seed)
    ready, thread = _serve_thread(servable, "chip-smoke-funnel-swap", buckets=FUNNEL_BUCKETS,
                                  device=DEVICE, reload_url=root,
                                  reload_interval_secs=SWAP_POLL_S)
    base = f"http://127.0.0.1:{ready.port}"
    scorer, swapper = ready.scorer, ready.swapper
    rng = np.random.default_rng(seed + 15)
    requests, bodies = [funnel_requests(rng, 1) for _ in range(SWAP_CLIENTS)], []
    for uids, uvals, fids, fvals in requests:
        bodies.append(json.dumps({"instances": [{
            "user_ids": uids[0].tolist(), "user_vals": uvals[0].tolist(),
            "feat_ids": fids[0].tolist(), "feat_vals": fvals[0].tolist()}]}).encode())
    stop = threading.Event()
    results, errors = [], []

    def client(i):
        while not stop.is_set():
            code, doc = post(f"{base}/v1/recommend", bodies[i])
            (results if code == 200 else errors).append((i, code, doc))

    try:
        if scorer.versions() != (1, 1):
            fail(f"funnel_swap: the server adopted {scorer.versions()}, not version 1")
        ref = {1: [post(f"{base}/v1/recommend", b)[1] for b in bodies]}
        threads = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(SWAP_CLIENTS)]
        for t in threads:
            t.start()
        time.sleep(1.0)
        t0 = time.perf_counter()
        pub.publish_funnel(art.rank_cfg, v2[0], art.query_cfg, v2[1], v2[2], step=2, **kw)
        while scorer.versions()[0] < 2 and time.perf_counter() - t0 < 120:
            time.sleep(0.05)
        swapped_s = time.perf_counter() - t0
        time.sleep(1.0)
        stop.set()
        for t in threads:
            t.join(timeout=60)
        status = swapper.status()
        ref[2] = [post(f"{base}/v1/recommend", b)[1] for b in bodies]
        # the bad versions: a NaN ranker, then a corrupted index.npz
        nan = dict(v2[0], fm_b=np.full_like(v2[0]["fm_b"], np.nan))
        rollbacks = {}
        for version, what, reason in ((3, "nan", "non-finite"), (4, "corrupt", "hash|CRC|zip")):
            if what == "nan":
                pub.publish_funnel(art.rank_cfg, nan, art.query_cfg, v2[1], v2[2], step=3, **kw)
            else:
                # the tree of version 2 under a new manifest, its index.npz torn
                loc = version_location(root, 4)
                shutil.copytree(version_location(root, 2), loc)
                npz = os.path.join(loc, "index.npz")
                blob = bytearray(open(npz, "rb").read())
                blob[len(blob) // 2] ^= 0xFF
                open(npz, "wb").write(bytes(blob))
                m = json.load(open(os.path.join(root, "MANIFEST-00000002.json")))
                m["version"], m["step"] = 4, 4
                with open(os.path.join(root, "MANIFEST-00000004.json"), "w") as f:
                    json.dump(m, f)
            t1 = time.perf_counter()
            while time.perf_counter() - t1 < 60:
                if re.search(reason, swapper.status()["last_error"] or ""):
                    break
                time.sleep(0.05)
            else:
                fail(f"funnel_swap: version {version} ({what}) was not rolled back: "
                     f"{swapper.status()}")
            if scorer.versions() != (2, 2):
                fail(f"funnel_swap: after the {what} version the server is on "
                     f"{scorer.versions()}")
            now = [post(f"{base}/v1/recommend", b)[1] for b in bodies]
            if now != ref[2]:
                fail(f"funnel_swap: the answers changed after the {what} version")
            rollbacks[what] = swapper.status()["last_error"]
        metrics = get(f"{base}/v1/metrics")
    finally:
        stop.set()
        ready.server.shutdown()
        thread.join(timeout=60)
    if thread.is_alive():
        fail("funnel_swap: the server thread did not stop")
    if errors:
        fail(f"funnel_swap: {len(errors)} failed responses, first {errors[:2]}")
    pairs = {(d["model_version"], d["index_version"]) for _, _, d in results}
    mixed = [d for _, _, d in results if d["model_version"] != d["index_version"]]
    outside = [d for _, _, d in results if d["model_version"] not in (1, 2)]
    strip = lambda d: {k: d[k] for k in ("items", "scores", "retrieval_scores")}  # noqa: E731
    neither = [(i, d) for i, _, d in results
               if strip(d) not in (strip(ref[1][i]), strip(ref[2][i]))]
    if mixed or outside or neither or pairs != {(1, 1), (2, 2)}:
        fail(f"funnel_swap: {len(results)} responses, version pairs {pairs}: {len(mixed)} "
             f"mixed, {len(outside)} outside (1, 2), {len(neither)} matching neither "
             f"version's answer")
    if any(strip(ref[1][i]) == strip(ref[2][i]) for i in range(SWAP_CLIENTS)):
        fail("funnel_swap: versions 1 and 2 answer alike; the drill could not tell them apart")
    graphs = scorer.graphs.graph_count
    want = 2 * 2 * len(FUNNEL_BUCKETS) if DEVICE == "cuda" else 0
    if graphs != want or status["graphs"] != graphs:
        fail(f"funnel_swap: {graphs} graphs after the swaps ({status['graphs']} at the swap)")
    line = {"card": card, "responses": len(results), "failed": len(errors),
            "mixed": len(mixed), "outside": len(outside), "neither": len(neither),
            "publish_s": publish_s, "swapped_after_publish_s": swapped_s,
            "stage_ms": status["last_stage_ms"], "canary_ms": status["last_canary_ms"],
            "swap_ms": status["last_swap_ms"], "swaps": status["swaps_total"],
            "rollbacks": metrics["reload"]["rollbacks_total"], "graphs": graphs,
            "rolled_back": rollbacks, "funnel": {k: metrics["funnel"][k] for k in (
                "retrieval_ms", "rank_ms", "merge_overflow_total", "index_items")}}
    print("funnel_swap traffic %s" % json.dumps(line))
    return line, {"ctx": scorer.ctx, "requests": requests, "ref": ref, "v2": v2}


def check_version_answers(art, answers: dict) -> dict:
    """The traffic drill's answers of versions 1 and 2 (the server's own
    reference answers, one per client) held to each version's weights and
    index staged afresh from the publisher's inputs, not from a server
    slot, and run through the plain B2 and B1 (check_funnel_answers): a
    version copied into a slot wrongly fails here."""
    from deepfm_tpu_torch.funnel import stage_funnel_payload
    from deepfm_tpu_torch.serve.export import model_from_state

    ctx, v2 = answers["ctx"], answers["v2"]
    out = {}
    for version, (rank, query, index) in ((1, (art.rank_state, art.query_state, art.index)),
                                          (2, v2)):
        payload = stage_funnel_payload(ctx, model_from_state(art.rank_cfg, rank, DEVICE),
                                       model_from_state(art.query_cfg, query, DEVICE), index)
        out[version] = check_funnel_answers(ctx, payload, answers["requests"],
                                            answers["ref"][version], FUNNEL_BUCKETS,
                                            f"funnel_swap version {version}")
        del payload
    print("funnel_swap versions vs plain %s" % json.dumps(out))
    return out


def swap_sharded(art, seed: int) -> dict:
    """Part 3: the index row-sharded over 2 and 4 shards on the one card,
    exact and int8, against one shard and brute force: exact ids equal one
    shard's; every returned id a real item whose brute-force f32 score is
    the reported one within TOL_SHARD, the set brute force's top K but for
    near-ties at its K-th score; no pad row.  The same sharded retrieve
    inside FunnelGraphs' graphs: its ids equal the eager call's at the
    same shard count (scores within TOL_GRAPH) and, in exact mode, one
    shard's past near-ties; its pack equals the eager stages'."""
    from deepfm_tpu_torch.funnel import (brute_force_topk, build_retrieve_with,
                                         make_funnel_context, stage_funnel_payload)
    from deepfm_tpu_torch.funnel.graphs import FunnelGraphs
    from deepfm_tpu_torch.models.two_tower import encode_queries
    from deepfm_tpu_torch.serve.export import model_from_state

    rank = model_from_state(art.rank_cfg, art.rank_state, DEVICE)
    query = model_from_state(art.query_cfg, art.query_state, DEVICE)
    rng = np.random.default_rng(seed + 16)
    _, _, fids, fvals = funnel_requests(rng, SHARD_USERS)
    h_uids = rng.integers(0, FUNNEL_USER_VOCAB, (SHARD_USERS, FUNNEL_FIELDS))
    uids = torch.from_numpy(h_uids).to(DEVICE)
    uvals = torch.ones((SHARD_USERS, FUNNEL_FIELDS), device=DEVICE)
    ids = np.concatenate([h_uids, fids], axis=1)
    vals = np.concatenate([np.ones((SHARD_USERS, FUNNEL_FIELDS), np.float32), fvals], axis=1)
    with torch.no_grad():
        u = encode_queries(query, uids, uvals).cpu().numpy()
    n = art.index.item_ids.shape[0]
    out = {}
    for mode in ("exact", "int8"):
        got, graphed = {}, {}
        for mp in (1, *SHARD_COUNTS):
            ctx = make_funnel_context(art.rank_cfg, art.query_cfg, capacity=n,
                                      top_k=FUNNEL_TOP_K, return_n=FUNNEL_RETURN_N,
                                      retrieval=mode, oversample=FUNNEL_OVERSAMPLE,
                                      model_parallel=mp)
            payload = stage_funnel_payload(ctx, rank, query, art.index)
            with torch.no_grad():
                s, c = build_retrieve_with(ctx)(payload, uids, uvals)
            got[mp] = (s.cpu().numpy(), c.cpu().numpy(), ctx.capacity)
            del payload
            if mp == 1:
                continue
            graphs = FunnelGraphs(ctx, art.rank_state, art.query_state, art.index,
                                  device=DEVICE, buckets=FUNNEL_BUCKETS)
            graphs.precompile()
            pack, _, _, gs, gc = graphs.dispatch(0, ids, vals, full=True)
            want, _ = graphs.eager(0, ids, vals)
            del graphs
            if not np.array_equal(gc, got[mp][1]) or not np.array_equal(pack[:, 0], want[:, 0]):
                fail(f"funnel_swap sharded {mode} M={mp}: the graphed ids differ from eager")
            err = max(float(np.abs(gs - got[mp][0]).max()),
                      float(np.abs(pack[:, 1:] - want[:, 1:]).max()))
            if err > TOL_GRAPH:
                fail(f"funnel_swap sharded {mode} M={mp}: graphed vs eager {err}")
            graphed[mp] = {"vs_eager_max_abs": err, "ids_moved_vs_one_shard": int(
                (gc != got[1][1]).sum())}
            if mode == "exact" and (np.abs(gs - got[1][0])[gc != got[1][1]] > TOL_SHARD).any():
                fail(f"funnel_swap sharded exact M={mp}: graphed ids differ from one "
                     f"shard's past near-ties")
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
        _, ref_ids = brute_force_topk(art.index.item_emb, art.index.item_ids, u, FUNNEL_TOP_K)
        row = {item: i for i, item in enumerate(art.index.item_ids.tolist())}
        full = u @ art.index.item_emb.T                              # [B, N]
        kth = np.sort(full, axis=1)[:, -FUNNEL_TOP_K]
        stats = {}
        for mp in SHARD_COUNTS:
            s, c, cap = got[mp]
            if (c < 0).any():
                fail(f"funnel_swap sharded {mode} M={mp}: a pad row was returned")
            s1, c1, _ = got[1]
            moved = c != c1
            if mode == "exact" and (np.abs(s - s1)[moved] > TOL_SHARD).any():
                fail(f"funnel_swap sharded exact M={mp}: ids differ from one shard's "
                     f"past near-ties")
            own = full[np.arange(SHARD_USERS)[:, None], np.vectorize(row.get)(c)]
            err = float(np.abs(own - s).max())
            missed = [(q, set(ref_ids[q]) - set(c[q])) for q in range(SHARD_USERS)]
            # an id of brute force's top K missing here must sit at the K-th score
            far = [(q, m) for q, ms in missed for m in ms
                   if full[q, row[m]] > kth[q] + TOL_SHARD]
            if err > TOL_SHARD or (mode == "exact" and far):
                fail(f"funnel_swap sharded {mode} M={mp}: score err {err}, missed {far[:3]}")
            recall = float(np.mean([1 - len(ms) / FUNNEL_TOP_K for _, ms in missed]))
            stats[mp] = {"capacity": cap, "max_abs_err": err, "recall": recall,
                         "ids_moved_vs_one_shard": int(moved.sum()),
                         "near_tie_misses": sum(len(ms) for _, ms in missed) - len(far),
                         "graphed": graphed[mp]}
        out[mode] = stats
    print("funnel_swap sharded %s" % json.dumps(out))
    return out


def phase_funnel_swap(seed: int, workdir: str, card: str, servable: str) -> dict:
    """Phase 17: the funnel's versioned hot swap at the funnel phase's
    width (117,581 items, top 32 -> 8, oversample 4, buckets 8 and 64):
    graphed vs eager vs plain, publish and swap under traffic with two
    rollbacks, the sharded index, and their times."""
    from deepfm_tpu_torch.funnel import graphs as funnel_graphs
    from deepfm_tpu_torch.funnel import load_funnel_artifact

    t_phase = time.perf_counter()
    os.makedirs(workdir, exist_ok=True)
    art = load_funnel_artifact(servable)
    rng = np.random.default_rng(seed + 14)
    graphed = swap_graphed_vs_eager(art, rng)
    # the main path: counts from 0, then boot, capture, traffic, swaps
    reset_funnel_counts()
    traffic, answers = swap_under_traffic(art, servable, workdir, seed, card)
    retr, fwd = funnel_kernel_runs()
    graph_runs = dict(funnel_graphs.graph_kernel_runs)
    if DEVICE == "cuda" and min(graph_runs.values()) <= 0:
        fail(f"funnel_swap: the graphs ran {graph_runs}")
    traffic["vs_plain"] = check_version_answers(art, answers)
    sharded = swap_sharded(art, seed)
    seconds = time.perf_counter() - t_phase
    print("funnel_swap %s" % json.dumps({
        "card": card, "seconds": seconds, "runs": {"retrieval_topk": retr,
                                                   "fused_ctr_forward": fwd},
        "graph_runs": graph_runs,
        "responses": traffic["responses"], "swap_ms": traffic["swap_ms"],
        "stage_ms": traffic["stage_ms"], "canary_ms": traffic["canary_ms"]}))
    return {"retrieval_launches": retr, "forward_launches": fwd, "graphed": graphed,
            "traffic": traffic, "sharded": sharded, "seconds": seconds}


# phase 18, the serving pools (ROADMAP A14): the process pool's workers,
# the shard-group pool's members and the in-process members, at the
# flagship width; POOL_* may be patched for a rehearsal on the CPU
POOL_BUCKETS = (8, 32, 128, 512)
POOL_WORKERS, POOL_GROUPS, POOL_CLIENTS = 2, 2, 8
POOL_MEMBER_PORT_BASE = 8601  # the supervisor's --member-port-base default
POOL_SHARDED = ((1, 2, "psum"), (1, 2, "alltoall"), (2, 2, "psum"), (2, 2, "alltoall"))
POOL_SHARDED_REPEATS = 50
# the funnel member's forced degrade: any queued row engages level 2
POOL_FUNNEL_SLO = {"shed_shadow_util": 0.001, "degrade_util": 0.002,
                   "shed_predict_util": 1.0, "degrade_floor_pct": 50.0}
POOL_FUNNEL_BURST, POOL_FUNNEL_BURST_ROWS, POOL_FUNNEL_CHECKS = 32, 320, 12
POOL_FUNNEL_MAX_BURSTS = 8


def _pool_env(workdir: str, name: str) -> dict:
    """A subprocess's own HOME and TMPDIR under ``workdir``."""
    env = {}
    for var in ("HOME", "TMPDIR"):
        env[var] = os.path.join(workdir, f"{name}_{var.lower()}")
        os.makedirs(env[var], exist_ok=True)
    return env


def _wait_ready(url: str, cli=None, timeout: float = 600.0, want=None) -> dict:
    """Poll ``url``/readyz until it answers ready (and ``want(doc)``)."""
    deadline = time.monotonic() + timeout
    while True:
        try:
            doc = get(f"{url}/readyz")
            if doc.get("ready") and (want is None or want(doc)):
                return doc
        except (OSError, ValueError):
            pass
        if (cli is not None and cli.proc.poll() is not None) or time.monotonic() > deadline:
            (cli.fail if cli is not None else fail)(f"{url} did not become ready")
        time.sleep(0.2)


def _stop_tree(cli) -> None:
    """Stop a pool process and everything under it: SIGTERM (a pool stops
    its workers or members itself), then SIGKILL to what is left."""
    if cli.proc.poll() is None:
        tree = _descendants(cli.proc.pid)
        cli.proc.send_signal(signal.SIGTERM)
        try:
            cli.proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            cli.proc.kill()
            cli.proc.wait(timeout=60)
        for pid in tree:
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass


def _check_ports_free(ports, what: str) -> None:
    """Fail, naming ``what``, unless every port can be bound on this host
    now (with the servers' own SO_REUSEADDR, so only a listener refuses)."""
    import socket

    for port in ports:
        with socket.socket() as sock:
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            try:
                sock.bind(("127.0.0.1", port))
            except OSError as e:
                fail(f"{what} {port} is taken ({e}): a server left over from an "
                     f"earlier run owns it; stop it first")


def _router_member_urls(base: str, cli, timeout: float = 120.0,
                        n: int = POOL_GROUPS) -> list[str]:
    """The ``n`` member URLs the router at ``base`` routes to, group by
    group, from its ``/v1/metrics`` groups section (the router serves it
    before its members are ready)."""
    deadline = time.monotonic() + timeout
    while True:
        try:
            groups = get(f"{base}/v1/metrics")["groups"]
            urls = [u for g in sorted(groups) for u in groups[g]["member_urls"]]
            if len(urls) == n:
                return urls
        except (OSError, ValueError, KeyError):
            pass
        if cli.proc.poll() is not None or time.monotonic() > deadline:
            cli.fail(f"{base}/v1/metrics did not list {n} members")
        time.sleep(0.2)


def _pid_of(port: int, path: str, body: bytes) -> tuple[int, dict]:
    client = _Client(port)
    try:
        code, headers, raw = client.post(path, body, {"Content-Type": "application/json"})
    finally:
        client.close()
    if code != 200:
        fail(f"pool: {path} on port {port} answered {code}: {raw[:200]}")
    return int(headers["X-Serving-Pid"]), json.loads(raw)


def _kernel_lines(clis) -> list[dict]:
    return [r for cli in clis for r in cli.kind("kernel_runs")]


def pool_servable(seed: int, workdir: str):
    """The flagship CTR servable (random weights from --seed), the publish
    root with version 1 (its weights) and 2 (moved by 0.01·N(0, 1)), and
    the host copies of both versions."""
    from deepfm_tpu_torch.core.config import ModelConfig
    from deepfm_tpu_torch.models import DeepFM
    from deepfm_tpu_torch.online.publisher import ModelPublisher
    from deepfm_tpu_torch.serve.export import export_servable

    cfg = ModelConfig(fused_kernel="auto")
    sd1 = {k: v.numpy() for k, v in DeepFM(
        cfg, device="cpu", generator=torch.Generator().manual_seed(seed + 40)).state_dict().items()}
    rng = np.random.default_rng(seed + 41)
    sd2 = {k: (v + 0.01 * rng.standard_normal(v.shape)).astype(v.dtype) for k, v in sd1.items()}
    servable = export_servable(cfg, sd1, os.path.join(workdir, "v0"))
    publish = os.path.join(workdir, "publish")
    ModelPublisher(publish, keep=8).publish(cfg, sd1, step=1)
    return cfg, servable, publish, {0: sd1, 1: sd1, 2: sd2}


def pool_reference(cfg, servable: str, rng: np.random.Generator):
    """One request a bucket and the single-process graphed predictor's
    answers to them (the bit-for-bit reference of every pool)."""
    from deepfm_tpu_torch.serve.export import read_params
    from deepfm_tpu_torch.serve.graphs import GraphedPredictor

    requests = [(make_ids(rng, b, cfg.field_size, cfg.feature_size),
                 rng.random((b, cfg.field_size)).astype(np.float32)) for b in POOL_BUCKETS]
    single = GraphedPredictor(cfg, read_params(servable), device=DEVICE, buckets=POOL_BUCKETS)
    single.precompile()
    return requests, [single.predict_with(0, ids, vals) for ids, vals in requests], single


def pool_load(port: int, cfg, workdir: str) -> dict:
    """16 closed-loop clients of LOAD_ROWS rows by JSON and by binary from
    four client processes (so the client's own interpreter lock does not
    cap a pool; the runs from one process, phase 4's setting, were cut to
    keep the whole script within its time budget)."""
    from deepfm_tpu_torch.serve.server import encode_binary_request

    rng = np.random.default_rng(99)
    ids = make_ids(rng, LOAD_ROWS, cfg.field_size, cfg.feature_size)
    vals = rng.random((LOAD_ROWS, cfg.field_size)).astype(np.float32)
    out = {}
    for procs in (4,):
        for binary in (False, True):
            body = encode_binary_request(ids, vals) if binary else _instances_body(ids, vals)
            out[f"load_{'binary' if binary else 'json'}_{procs}proc"] = closed_loop(
                port, body, binary, workdir, procs)
    return out


def pool_start(servable: str, publish: str, funnel_servable: str, workdir: str) -> dict:
    """Phase 18's four servers started at once, so that their boots
    (interpreters, the card, graph captures: 18-30 s each when started one
    after another) overlap: the serve task with one worker and with
    POOL_WORKERS, the shard-group pool and the funnel group.  Each check
    below waits for its own server's readiness, then runs alone.  Returns
    each server's ``_Cli``, ports and start time by name."""
    device_args = ["--device", "cpu"] if DEVICE == "cpu" else []
    buckets = ["--set", "run.serve_buckets=" + ",".join(map(str, POOL_BUCKETS))]
    # the serve task's members bind the supervisor's default ports (JAX's
    # argv sets no member port base): a leftover member there would answer
    # in place of this run's
    _check_ports_free([POOL_MEMBER_PORT_BASE + i for i in range(POOL_GROUPS)],
                      "pool groups: the shard-group members' port")
    ports = set(range(POOL_MEMBER_PORT_BASE, POOL_MEMBER_PORT_BASE + POOL_GROUPS))

    def port() -> int:
        while (p := _free_port()) in ports:
            pass
        ports.add(p)
        return p

    started = {}
    single, workers, rport, fport, fmport = port(), port(), port(), port(), port()
    started["single"] = (_Cli("pool single", [
        "--task_type", "serve", "--servable_model_dir", servable,
        "--set", f"run.serve_port={single}", *buckets, *device_args],
        workdir, env=_pool_env(workdir, "single_server")), single, time.perf_counter())
    started["workers"] = (_Cli("pool workers", [
        "--task_type", "serve", "--servable_model_dir", servable,
        "--set", f"run.serve_workers={POOL_WORKERS}", "--set", f"run.serve_port={workers}",
        *buckets, *device_args], workdir, env=_pool_env(workdir, "process_pool")),
        workers, time.perf_counter())
    imps = os.path.join(workdir, "impressions")
    started["groups"] = (_Cli("pool groups", [
        "--task_type", "serve", "--servable_model_dir", servable,
        "--set", f"run.serve_groups={POOL_GROUPS}", "--set", f"run.serve_router_port={rport}",
        *buckets,
        "--set", f"run.serve_reload_url={publish}", "--set", "run.serve_reload_interval_secs=0.3",
        "--set", "run.serve_health_interval_secs=0.3",
        "--set", "flywheel.enabled=true", "--set", f"flywheel.impression_log_url={imps}",
        "--set", "flywheel.segment_roll_age_secs=0.5", *device_args],
        workdir, env=_pool_env(workdir, "group_pool")), rport, time.perf_counter())
    started["funnel"] = (_Cli("pool funnel", [
        "--servable", funnel_servable, "--router", "--groups", "1", "--port", str(fport),
        "--member-port-base", str(fmport), "--buckets", ",".join(map(str, FUNNEL_BUCKETS)),
        "--slo", json.dumps(POOL_FUNNEL_SLO), "--health-interval", "0.3", *device_args],
        workdir, module="deepfm_tpu_torch.serve.pool", env=_pool_env(workdir, "funnel_pool")),
        (fport, fmport), time.perf_counter())
    return started


def pool_single(cfg, started: tuple, workdir: str) -> dict:
    """The serve task with one worker (the single-process server) under
    pool_load: the same call's baseline for the process pool."""
    cli, port, _ = started
    try:
        _wait_ready(f"http://127.0.0.1:{port}", cli)
        out = pool_load(port, cfg, workdir)
        cli.proc.send_signal(signal.SIGTERM)
        cli.finish(timeout=120)
    finally:
        _stop_tree(cli)
    print("pool single %s" % json.dumps(out))
    return out


def pool_process(cfg, started: dict, requests, want, workdir: str, single_ab: dict) -> dict:
    """(a) The process pool through the serve task: POOL_WORKERS workers on
    one port, every bucket's answer (JSON and binary, sampling both
    workers) bit-equal to the single-process graphed answer, the load of
    pool_load beside a one-worker server's (pool_single) and phase 4's,
    one worker killed and respawned."""
    from deepfm_tpu_torch.serve.server import encode_binary_request

    single = pool_single(cfg, started["single"], workdir)
    cli, port, t0 = started["workers"]
    out = {}
    try:
        base = f"http://127.0.0.1:{port}"
        _wait_ready(base, cli)
        pids = set()
        for _ in range(60):  # until both workers are up and answering
            pid, _ = _pid_of(port, "/v1/models/deepfm:predict", _instances_body(*requests[0]))
            pids.add(pid)
            if len(pids) == POOL_WORKERS:
                break
            time.sleep(0.5)
        out["boot_s"] = time.perf_counter() - t0
        seen = set()
        for (ids, vals), ref in zip(requests, want):
            for _ in range(4):
                pid, doc = _pid_of(port, "/v1/models/deepfm:predict", _instances_body(ids, vals))
                seen.add(pid)
                if not np.array_equal(np.asarray(doc["predictions"], np.float32), ref):
                    fail(f"pool workers: :predict of {len(ids)} rows from pid {pid} differs "
                         f"from the single-process graphed answer")
                client = _Client(port)
                code, headers, raw = client.post("/v1/models/deepfm:predict_binary",
                                                 encode_binary_request(ids, vals))
                client.close()
                if code != 200 or not np.array_equal(np.frombuffer(raw, "<f4"), ref):
                    fail(f"pool workers: :predict_binary of {len(ids)} rows differs ({code})")
        out["load"] = pool_load(port, cfg, workdir)
        # kill one worker: the pool restarts it
        victim = sorted(pids)[0]
        os.kill(victim, signal.SIGKILL)
        t1 = time.perf_counter()
        fresh = set()
        while not fresh and time.perf_counter() - t1 < 300:
            try:
                pid, _ = _pid_of(port, "/v1/models/deepfm:predict", _instances_body(*requests[0]))
                if pid not in pids:
                    fresh.add(pid)
            except (OSError, ValueError):
                pass
            time.sleep(0.2)
        if not fresh:
            cli.fail(f"worker {victim} was killed and no new worker answered")
        out["respawn_s"] = time.perf_counter() - t1
        cli.proc.send_signal(signal.SIGTERM)
        if cli.finish(timeout=120) != 0:
            cli.fail("SIGTERM did not stop the pool with exit 0")
    finally:
        _stop_tree(cli)
    lines = cli.kind("kernel_runs")
    if len(lines) != POOL_WORKERS:
        fail(f"pool workers: {len(lines)} kernel_runs lines, not {POOL_WORKERS}: {lines}")
    out.update(workers=lines, pids_seen=len(seen), single_worker=single, phase4=single_ab)
    print("pool workers %s" % json.dumps(out))
    return out


def pool_groups(cfg, started: tuple, publish: str, weights: dict, requests, want,
                workdir: str, seed: int) -> dict:
    """(b) The shard-group pool through the serve task: a router and
    POOL_GROUPS [1, 1] members, the swapper adopting version 1; every
    bucket bit-equal to the single-process answer; version 2 swapped in
    under POOL_CLIENTS clients (0 failed, 0 skew-mixed, 0 outside {1, 2},
    version 2's answers held to its own weights through the plain
    pipeline); a member killed (ejected until ready, repaired to the
    group's version); a NaN version aborted group-wide; the impression log
    (flywheel.enabled) joined afterwards."""
    from deepfm_tpu_torch.flywheel import JoinService, parse_impression, serialize_click
    from deepfm_tpu_torch.online.publisher import ModelPublisher
    from deepfm_tpu_torch.online.stream import SegmentWriter, open_tail
    from deepfm_tpu_torch.data.tfrecord import read_records
    from deepfm_tpu_torch.serve.batcher import pick_bucket
    from deepfm_tpu_torch.serve.export import model_from_state

    cli, rport, t0 = started
    imps = os.path.join(workdir, "impressions")
    base = f"http://127.0.0.1:{rport}"
    out, results, errors = {}, [], []
    stop = threading.Event()
    try:
        member_urls = _router_member_urls(base, cli)
        for url in member_urls:
            _wait_ready(url, cli, want=lambda d: d.get("model_version") == 1)
        _wait_ready(base, cli)
        out["boot_to_version_1_s"] = time.perf_counter() - t0
        for (ids, vals), ref in zip(requests, want):
            for key in range(4):
                code, doc = post(f"{base}/v1/models/deepfm:predict", json.dumps({
                    "key": f"b{key}", "instances": [{"feat_ids": i.tolist(),
                                                     "feat_vals": v.tolist()}
                                                    for i, v in zip(ids, vals)]}).encode())
                if code != 200 or not np.array_equal(np.asarray(doc["predictions"],
                                                                np.float32), ref):
                    fail(f"pool groups: {len(ids)} rows via {doc.get('shard_group')} differ "
                         f"from the single-process graphed answer ({code})")
        rng = np.random.default_rng(seed + 42)
        bodies = []
        for i in range(POOL_CLIENTS):
            ids = make_ids(rng, 1 + i, cfg.field_size, cfg.feature_size)
            vals = rng.random((1 + i, cfg.field_size)).astype(np.float32)
            bodies.append((ids, vals, json.dumps({"key": f"c{i}", "instances": [
                {"feat_ids": a.tolist(), "feat_vals": b.tolist()}
                for a, b in zip(ids, vals)]}).encode()))

        def client(i):
            conn = _Client(rport)
            try:
                while not stop.is_set():
                    # a trace id a request: the impression log's ids
                    code, _, raw = conn.post("/v1/models/deepfm:predict", bodies[i][2],
                                             {"Content-Type": "application/json",
                                              "X-Trace-Id": os.urandom(8).hex()})
                    (results if code == 200 else errors).append((i, code, json.loads(raw)))
            finally:
                conn.close()

        threads = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(POOL_CLIENTS)]
        for t in threads:
            t.start()
        time.sleep(1.0)
        t1 = time.perf_counter()
        ModelPublisher(publish, keep=8).publish(cfg, weights[2], step=2)
        for url in member_urls:
            _wait_ready(url, cli, timeout=120, want=lambda d: d.get("model_version") == 2)
        out["swapped_after_publish_s"] = time.perf_counter() - t1
        time.sleep(1.0)
        stop.set()
        for t in threads:
            t.join(timeout=60)
        metrics = [get(f"{url}/v1/metrics") for url in member_urls]
        out["swap_ms"] = [m["reload"]["last_swap_ms"] for m in metrics]
        out["stage_ms"] = [m["reload"]["last_stage_ms"] for m in metrics]
        out["canary_ms"] = [m["reload"]["last_canary_ms"] for m in metrics]
        out["member_device_bytes"] = [m["router"].get("device_max_reserved_bytes") for m in metrics]
        # a member killed: ejected by the router until ready, repaired by
        # its group's swapper to version 2
        victim_url = member_urls[0]
        pid, _ = _pid_of(urllib.parse.urlsplit(victim_url).port,
                         "/v1/models/deepfm:predict", bodies[0][2])
        before = get(f"{base}/v1/metrics")["router"]
        os.kill(pid, signal.SIGKILL)
        t2 = time.perf_counter()
        while get(f"{base}/v1/metrics")["router"]["ejections_total"] <= before["ejections_total"]:
            if time.perf_counter() - t2 > 60:
                fail("pool groups: the killed member was not ejected")
            time.sleep(0.1)
        for _ in range(8):  # the router answers from the other group meanwhile
            code, doc = post(f"{base}/v1/models/deepfm:predict", bodies[0][2])
            if code != 200:
                fail(f"pool groups: {code} while a member was down: {doc}")
        _wait_ready(victim_url, cli, timeout=300,
                    want=lambda d: (d.get("model_version"), d.get("group_generation")) == (2, 2))
        out["repaired_after_kill_s"] = time.perf_counter() - t2
        while get(f"{base}/v1/metrics")["router"]["readmissions_total"] <= before[
                "readmissions_total"]:
            if time.perf_counter() - t2 > 360:
                fail("pool groups: the repaired member was not readmitted")
            time.sleep(0.1)
        # a NaN version: every group's stage fails its canary and aborts
        nan = dict(weights[2], fm_b=np.full_like(weights[2]["fm_b"], np.nan))
        ModelPublisher(publish, keep=8).publish(cfg, nan, step=3)
        t3 = time.perf_counter()
        while any(get(f"{u}/v1/metrics")["reload"]["stage_failures_total"] < 1
                  for u in member_urls):
            if time.perf_counter() - t3 > 60:
                fail("pool groups: the NaN version was not refused by every member")
            time.sleep(0.1)
        for url in member_urls:
            doc = get(f"{url}/readyz")
            if (doc["model_version"], doc["group_generation"]) != (2, 2):
                fail(f"pool groups: after the NaN version {url} is on {doc}")
        router_metrics = get(f"{base}/v1/metrics")
        cli.proc.send_signal(signal.SIGTERM)
        if cli.finish(timeout=120) != 0:
            cli.fail("SIGTERM did not stop the pool with exit 0")
    finally:
        stop.set()
        _stop_tree(cli)
    pairs = {(d["group_generation"], d["model_version"]) for _, _, d in results}
    mixed = [d for _, _, d in results if (d["group_generation"], d["model_version"])
             not in ((1, 1), (2, 2))]
    outside = [d for _, _, d in results if d["model_version"] not in (1, 2)]
    if errors or mixed or outside or (2, 2) not in pairs or len(results) < 50:
        fail(f"pool groups: {len(results)} answered, {len(errors)} failed (first "
             f"{errors[:2]}), pairs {pairs}, {len(mixed)} mixed, {len(outside)} outside")
    # each version's answers against its own weights through the plain B1
    models = {v: model_from_state(cfg, weights[v], DEVICE) for v in (1, 2)}
    worst = {1: 0.0, 2: 0.0}
    for i, _, doc in results[::max(1, len(results) // 200)]:
        ids, vals, _ = bodies[i]
        v = doc["model_version"]
        err = float(np.abs(plain_probs(models[v], ids, vals, pick_bucket(POOL_BUCKETS, len(ids)))
                           - np.asarray(doc["predictions"], np.float32)).max())
        worst[v] = max(worst[v], err)
    if max(worst.values()) > TOL_PROB:
        fail(f"pool groups: answers differ from their version's plain pipeline by {worst}")
    del models
    # the impression log through the join: every logged impression joins,
    # the clicked half positive
    logged = []
    tail = open_tail(imps)
    for name in tail.list_segments():
        with tail.open_segment(name) as f:
            logged += [parse_impression(r).impression_id for r in read_records(f)]
    # requests without a trace id log under their routing key, so the
    # bucket checks' repeated keys log duplicates, which the join drops
    unique = list(dict.fromkeys(logged))
    clicked = unique[::2]
    clicks = os.path.join(workdir, "clicks")
    writer = SegmentWriter(clicks, roll_bytes=0, roll_age_secs=0)
    for imp in clicked:
        writer.append(serialize_click(impression_id=imp, ts_ms=int(time.time() * 1000)))
    writer.flush()
    join = JoinService(imps, clicks, os.path.join(workdir, "joined"),
                       attribution_window_secs=600)
    join.run(drain_at_eof=True)
    stats = join.stats()
    rows = sum(len(bodies[i][0]) for i, _, _ in results)
    dropped = router_metrics["flywheel"]["dropped_total"]  # a full queue drops, counted
    if (len(unique) + dropped < rows or stats["positive_total"] != len(clicked)
            or stats["positive_total"] + stats["negative_total"] != len(unique)
            or stats["duplicate_total"] != len(logged) - len(unique)):
        fail(f"pool groups: {len(logged)} impressions logged ({len(unique)} distinct, "
             f"{dropped} dropped) for {rows} rows answered under traffic; join {stats}")
    lines = cli.kind("kernel_runs")
    if len(lines) != POOL_GROUPS:
        fail(f"pool groups: {len(lines)} kernel_runs lines, not {POOL_GROUPS}: {lines}")
    out.update(answered=len(results), failed=len(errors), mixed=len(mixed),
               outside=len(outside), pairs=sorted(pairs), vs_plain_max_err=worst,
               impressions=len(logged), joined={k: stats[k] for k in (
                   "positive_total", "negative_total", "duplicate_total")},
               router={k: router_metrics["router"][k] for k in (
                   "requests_total", "retries_total", "skew_aborts_total", "ejections_total",
                   "readmissions_total")}, members=lines)
    print("pool groups %s" % json.dumps(out))
    return out


def _dispatch_p50(pred, requests) -> dict:
    """Each request's dispatch p50 through slot 0's graphs (ms, host clock,
    the answer copied back), over POOL_SHARDED_REPEATS replays."""
    out = {}
    for ids, vals in requests:
        lat = []
        for _ in range(POOL_SHARDED_REPEATS):
            t0 = time.perf_counter()
            pred.predict_with(0, ids, vals)
            lat.append(1e3 * (time.perf_counter() - t0))
        out[len(ids)] = float(np.median(lat))
    return out


def pool_sharded(cfg, servable: str, single, requests, want) -> dict:
    """(c) In-process members at POOL_SHARDED on the card: every bucket's
    answer through the member's graphs bit-equal to the single-process
    graphed predict, and a batch whose ids crowd the first shard past the
    all-to-all's capacity (the device-side psum fallback) too; each
    exchange's dispatch times beside the single-process graphs'."""
    from deepfm_tpu_torch.serve.pool.sharded import load_sharded_servable

    out = {}
    for dp, mp, exchange in POOL_SHARDED:
        tag = f"[{dp}, {mp}] {exchange}"
        t0 = time.perf_counter()
        _, pred, _, ctx = load_sharded_servable(servable, dp, mp, device=DEVICE,
                                                exchange=exchange, buckets=POOL_BUCKETS)
        capture = pred.precompile()
        boot = time.perf_counter() - t0
        for (ids, vals), ref in zip(requests, want):
            if not np.array_equal(pred.predict_with(0, ids, vals), ref):
                fail(f"pool sharded {tag}: {len(ids)} rows differ from the single-process "
                     f"graphed predict")
        b = POOL_BUCKETS[-1]
        skewed = (np.arange(b * cfg.field_size) % ctx.rows_local).reshape(b, -1)
        vals = np.ones(skewed.shape, np.float32)
        if not np.array_equal(pred.predict_with(0, skewed, vals),
                              single.predict_with(0, skewed, vals)):
            fail(f"pool sharded {tag}: the overflowing batch differs")
        out[tag] = {"boot_s": boot, "graphs": pred.graph_count,
                    "b1_per_replay": pred.kernel_launches_per_replay,
                    "capture_s": sum(capture.values()),
                    "dispatch_ms_p50": _dispatch_p50(pred, requests)}
        del pred
    out["single-process dispatch_ms_p50"] = _dispatch_p50(single, requests)
    print("pool sharded %s" % json.dumps(out))
    return out


def pool_funnel(seed: int, servable: str, started: tuple) -> dict:
    """(d) A funnel group with an SLO whose ladder degrades at a few
    queued rows: a burst of POOL_FUNNEL_BURST concurrent requests of
    POOL_FUNNEL_BURST_ROWS users engages it, then users one at a time
    (another burst whenever one was not degraded); POOL_FUNNEL_CHECKS
    dispatches the member counts as degraded are held to the plain
    pipeline at the degraded oversample (check_funnel_answers at os_d)."""
    from deepfm_tpu_torch.funnel import load_funnel_artifact, make_funnel_context
    from deepfm_tpu_torch.funnel import stage_funnel_payload
    from deepfm_tpu_torch.serve.export import model_from_state

    cli, (rport, mport), t0 = started
    murl, base = f"http://127.0.0.1:{mport}", f"http://127.0.0.1:{rport}"
    rng = np.random.default_rng(seed + 43)
    checked, served, degraded_requests = [], [], 0
    try:
        _wait_ready(murl, cli)
        _wait_ready(base, cli)
        boot = time.perf_counter() - t0

        def body(req):
            uids, uvals, fids, fvals = req
            return json.dumps({"instances": [{
                "user_ids": u.tolist(), "user_vals": uv.tolist(), "feat_ids": f.tolist(),
                "feat_vals": fv.tolist()} for u, uv, f, fv in zip(uids, uvals, fids, fvals)]
            }).encode()

        # a burst of requests of POOL_FUNNEL_BURST_ROWS users each: every
        # one queues several buckets at once, so the admissions that follow
        # it see a deep queue and the ladder engages (requests past the
        # queue bound answer 503 and count for nothing)
        burst = [body(funnel_requests(rng, POOL_FUNNEL_BURST_ROWS))
                 for _ in range(POOL_FUNNEL_BURST)]

        def fire_burst():
            threads = [threading.Thread(target=post, args=(f"{base}/v1/recommend", b),
                                        daemon=True) for b in burst]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)

        # then users one at a time (each admission decays the ladder's
        # average); a dispatch the member did not degrade fires a new burst
        bursts, need_burst = 0, True
        while len(checked) < POOL_FUNNEL_CHECKS and bursts <= POOL_FUNNEL_MAX_BURSTS:
            if need_burst:
                fire_burst()
                bursts, need_burst = bursts + 1, False
            req = funnel_requests(rng, 1)
            before = get(f"{murl}/v1/metrics")["funnel"]["degraded_dispatch_total"]
            code, doc = post(f"{base}/v1/recommend", body(req))
            if code != 200:
                fail(f"pool funnel: /v1/recommend answered {code}: {doc}")
            if get(f"{murl}/v1/metrics")["funnel"]["degraded_dispatch_total"] == before + 1:
                checked.append(req)
                served.append(doc)
            else:
                need_burst = True
        funnel = get(f"{murl}/v1/metrics")["funnel"]
        cli.proc.send_signal(signal.SIGTERM)
        if cli.finish(timeout=120) != 0:
            cli.fail("SIGTERM did not stop the pool with exit 0")
    finally:
        _stop_tree(cli)
    if len(checked) < POOL_FUNNEL_CHECKS:
        fail(f"pool funnel: {len(checked)} degraded dispatches seen one at a time after "
             f"{bursts} bursts; {funnel['degraded_dispatch_total']} in all")
    art = load_funnel_artifact(servable)
    meta = art.meta
    os_d = funnel["oversample_degraded"]
    ctx = make_funnel_context(art.rank_cfg, art.query_cfg, capacity=int(meta["capacity"]),
                              top_k=int(meta["top_k"]), return_n=int(meta["return_n"]),
                              item_field=int(meta["item_field"]), retrieval="int8",
                              oversample=os_d)
    payload = stage_funnel_payload(ctx, model_from_state(art.rank_cfg, art.rank_state, DEVICE),
                                   model_from_state(art.query_cfg, art.query_state, DEVICE),
                                   art.index)
    stats = check_funnel_answers(ctx, payload, checked, served, FUNNEL_BUCKETS,
                                 f"pool funnel at oversample {os_d}")
    del payload
    lines = cli.kind("kernel_runs")
    out = {"boot_s": boot, "oversample": funnel["oversample"], "oversample_degraded": os_d,
           "degraded_dispatch_total": funnel["degraded_dispatch_total"], "bursts": bursts,
           "checked": len(checked), "vs_plain": stats, "members": lines}
    print("pool funnel %s" % json.dumps(out))
    return out


def phase_pool(seed: int, workdir: str, card: str, funnel_servable: str,
               single_ab: dict) -> dict:
    """Phase 18: the serving pools (ROADMAP A14) at the flagship width:
    (a) the process pool, (b) the shard-group pool with its swap, repair,
    abort and impression log, (c) in-process members on [dp, mp] shards,
    (d) a funnel group degrading under forced load.  Kernel runs: the
    worker and member processes' own, from their exit lines (a killed
    process's are lost); this process's references and comparisons are
    printed apart and not counted."""
    from deepfm_tpu_torch.serve.server import kernel_counts

    t_phase = time.perf_counter()
    os.makedirs(workdir, exist_ok=True)
    reset_kernel_counts()
    reset_funnel_counts()
    from deepfm_tpu_torch.serve import graphs as serve_graphs

    serve_graphs.graph_kernel_runs.update(forward=0)
    cfg, servable, publish, weights = pool_servable(seed, workdir)
    started = pool_start(servable, publish, funnel_servable, workdir)
    try:
        requests, want, single = pool_reference(cfg, servable,
                                                np.random.default_rng(seed + 44))
        process = pool_process(cfg, started, requests, want, workdir, single_ab)
        groups = pool_groups(cfg, started["groups"], publish, weights, requests, want,
                             workdir, seed)
        sharded = pool_sharded(cfg, servable, single, requests, want)
        del single
        funnel = pool_funnel(seed, funnel_servable, started["funnel"])
    finally:  # a check that failed leaves the other servers up: stop them
        for cli, _, _ in started.values():
            _stop_tree(cli)
    # the main path is the pool's processes; this process's runs (the
    # reference predictor, the in-process members held to it, the plain
    # checks' kernel pipeline) are comparisons, printed apart
    split = {}
    for line in process["workers"] + groups["members"] + funnel["members"]:
        split[f"{line['role']} pid {line['pid']}"] = {k: line[k] for k in ("forward",
                                                                           "retrieval")}
    forward = sum(v["forward"] for v in split.values())
    retrieval = sum(v["retrieval"] for v in split.values())
    if DEVICE == "cuda" and (min(line["forward"] for line in process["workers"]
                                 + groups["members"] + funnel["members"]) <= 0
                             or min(line["retrieval"] for line in funnel["members"]) <= 0):
        fail(f"pool: a worker or member launched no kernel: {split}")
    seconds = time.perf_counter() - t_phase
    print("pool kernel runs by process %s; not counted, this process's comparisons %s"
          % (json.dumps(split), json.dumps(kernel_counts())))
    print("pool %s" % json.dumps({
        "card": card, "seconds": seconds, "runs": {"fused_ctr_forward": forward,
                                                   "retrieval_topk": retrieval},
        "process_pool": {k: process[k] for k in ("boot_s", "respawn_s", "load")},
        "single_worker": process["single_worker"],
        "phase4_single_process": {k: single_ab.get(k) for k in ("load_json", "load_binary")},
        "group_pool": {k: groups[k] for k in ("boot_to_version_1_s", "swapped_after_publish_s",
                                              "swap_ms", "stage_ms", "canary_ms",
                                              "repaired_after_kill_s", "answered", "failed",
                                              "mixed", "outside")},
        "worker_device_bytes": [w.get("device_max_reserved_bytes") for w in process["workers"]],
        "member_device_bytes": [m.get("device_max_reserved_bytes") for m in groups["members"]],
        "funnel_member_boot_s": funnel["boot_s"]}))
    return {"forward_launches": forward, "retrieval_launches": retrieval, "seconds": seconds,
            "member_device_bytes": [m.get("device_max_reserved_bytes")
                                    for m in groups["members"]]}


# the lifecycle phase: 24 steps of 1,024 records in 2 files, each batch's
# 39,936 ids distinct, a checkpoint every 8 steps, a SIGTERM after step 12.
# LIFE_ARGS, LIFE_VOCAB, LIFE_BATCH and DEVICE let a rehearsal on the CPU
# run the phase at a small width; the card runs it as set here
LIFE_FILES, LIFE_BATCHES_PER_FILE, LIFE_EVERY, LIFE_STOP = 2, 12, 8, 12
LIFE_STEPS = LIFE_FILES * LIFE_BATCHES_PER_FILE
LIFE_ARGS: tuple[str, ...] = ()
LIFE_VOCAB, LIFE_BATCH, DEVICE = 117_581, 1024, "cuda"


def write_distinct(seed: int, life_dir: str) -> None:
    """The lifecycle phase's TFRecords: every batch of 1,024 records holds
    39,936 distinct ids (a random permutation of the vocabulary), so B1''s
    float atomics never add two terms into one row and a run is
    bit-reproducible, as in the ddp phase."""
    from deepfm_tpu_torch.data.example_proto import serialize_ctr_example
    from deepfm_tpu_torch.data.tfrecord import TFRecordWriter

    rng = np.random.default_rng(seed + 17)
    for i in range(LIFE_FILES):
        with TFRecordWriter(os.path.join(life_dir, f"train-{i}.tfrecords")) as w:
            for _ in range(LIFE_BATCHES_PER_FILE):
                ids = rng.permutation(LIFE_VOCAB)[:LIFE_BATCH * 39].reshape(LIFE_BATCH, 39)
                vals = rng.random((LIFE_BATCH, 39), dtype=np.float32)
                labels = (rng.random(LIFE_BATCH) < 0.25).astype(np.float32)
                for r in range(LIFE_BATCH):
                    w.write(serialize_ctr_example(float(labels[r]), ids[r].tolist(),
                                                  vals[r].tolist()))


def run_logged(argv: list[str], env: dict | None = None):
    """``cli.run(argv)`` with its JSON lines kept (and printed), the kernels'
    counts set to 0 just before and read just after: (result or the
    PreemptedError, lines, forward launches, backward launches)."""
    from deepfm_tpu_torch.launch import cli
    from deepfm_tpu_torch.launch.preemption import PreemptedError

    saved = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    tee = _Tee(sys.stdout)
    reset_kernel_counts()
    try:
        with contextlib.redirect_stdout(tee):
            try:
                result = cli.run(argv)
            except PreemptedError as e:
                result = e
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    lines = [json.loads(x) for x in tee.lines.getvalue().splitlines() if x.startswith("{")]
    return (result, lines, *kernel_runs())


def _kind(lines: list[dict], kind: str) -> list[dict]:
    return [r for r in lines if r["kind"] == kind]


def state_tensors(state) -> dict:
    """What a resume must restore: parameters, BN statistics, Adam's
    moments, the lazy moments."""
    out = dict(state.model.state_dict())
    for name, slots in state.optimizer.slots.items():
        out.update({f"{name}.{s}": t for s, t in slots.items()})
    if state.lazy is not None:
        for slot, tables in state.lazy.state_dict().items():
            out.update({f"lazy.{slot}.{k}": t for k, t in tables.items()})
    return out


def phase_lifecycle(seed: int, workdir: str, val_dir: str, train_dir: str,
                    servable_dir: str) -> dict:
    """The train task's lifecycle at full width through ``cli.run``, dense
    and lazy: (a) stopped by a real SIGTERM from inside the loop after step
    12, then resumed by the same command; (b) the resumed run held against
    an uninterrupted one bit for bit; (c) the eval task against the train
    task's final eval; (d) the infer task's pred.txt against the servable;
    (e) the export task against the train task's export; (f) the save's
    blocking and write times, the decode times, and the train phase's
    command with the C++ reader and with DEEPFM_NO_NATIVE=1."""
    from deepfm_tpu_torch.checkpoint import Checkpointer
    from deepfm_tpu_torch.data.pipeline import eval_batches
    from deepfm_tpu_torch.core.config import DataConfig
    from deepfm_tpu_torch.serve.export import load_servable, read_params
    from deepfm_tpu_torch.train import loop
    from deepfm_tpu_torch.utils.logging import MetricLogger

    life_dir = os.path.join(workdir, "life")
    os.makedirs(life_dir)
    t0 = time.perf_counter()
    write_distinct(seed, life_dir)
    print(f"lifecycle: wrote {LIFE_STEPS * LIFE_BATCH} records of distinct ids a batch in "
          f"{time.perf_counter() - t0:.2f} s")
    launches = backward = 0

    class SignalAt(MetricLogger):
        def step(self, step, *a, **kw):
            super().step(step, *a, **kw)
            if step == LIFE_STOP:
                os.kill(os.getpid(), signal.SIGTERM)

    def argv(name: str, *extra: str) -> list[str]:
        return ["--task_type", "train", "--training_data_dir", life_dir,
                "--val_data_dir", val_dir, "--model_dir", os.path.join(workdir, name),
                "--servable_model_dir", os.path.join(workdir, name + ".servable"),
                "--num_epochs", "1", "--log_steps", str(LOG_STEPS),
                "--checkpoint_every_steps", str(LIFE_EVERY),
                "--set", "model.fused_kernel=auto", "--set", f"run.seed={seed}",
                *LIFE_ARGS, *extra]

    def run(args: list[str], env: dict | None = None, steps: int = 0):
        nonlocal launches, backward
        result, lines, fwd, bwd = run_logged(args, env)
        if fwd < steps or bwd < steps:
            fail(f"lifecycle: {steps} steps launched fused_ctr_forward {fwd} and "
                 f"fused_ctr_backward {bwd} times")
        launches, backward = launches + fwd, backward + bwd
        return result, lines

    from deepfm_tpu_torch.launch.preemption import PreemptedError

    out = {}
    for mode, extra in (("dense", ()), ("lazy", ("--set", "optimizer.lazy_embedding_updates=true"))):
        split = argv(f"{mode}_split", *extra)
        real = loop.MetricLogger
        loop.MetricLogger = SignalAt
        try:
            stopped, lines = run(split, steps=LIFE_STOP)
        finally:
            loop.MetricLogger = real
        if not isinstance(stopped, PreemptedError):
            fail(f"lifecycle {mode}: the SIGTERM after step {LIFE_STOP} did not stop "
                 f"the run: {stopped!r}")
        steps_on_disk = Checkpointer(os.path.join(workdir, f"{mode}_split")).all_steps()
        if steps_on_disk != [LIFE_EVERY, LIFE_STOP] or \
                _kind(lines, "preempted") != [{"kind": "preempted", "step": LIFE_STOP}]:
            fail(f"lifecycle {mode}: checkpoints {steps_on_disk}, events "
                 f"{_kind(lines, 'preempted')}")
        resumed, lines = run(split, steps=LIFE_STEPS - LIFE_STOP)
        final_eval = _kind(lines, "eval")[-1]
        if _kind(lines, "resume") != [{"kind": "resume", "step": LIFE_STOP}] or \
                resumed.step != LIFE_STEPS:
            fail(f"lifecycle {mode}: resume {_kind(lines, 'resume')}, finished at "
                 f"{resumed.step}")
        whole, _ = run(argv(f"{mode}_whole", *extra), steps=LIFE_STEPS)
        got, want = state_tensors(resumed), state_tensors(whole)
        if got.keys() != want.keys() or whole.step != resumed.step:
            fail(f"lifecycle {mode}: the resumed state's tensors or step differ")
        err = max(float((got[k].float() - want[k].float()).abs().max()) for k in want)
        if err != 0.0:
            fail(f"lifecycle {mode}: resumed vs uninterrupted max abs err {err}")
        out[mode] = {"resume_max_abs_err": err, "tensors": len(want),
                     "step": resumed.step, "final_eval": final_eval}
        # (f) one save of the full-width state, timed
        ckpt = Checkpointer(os.path.join(workdir, f"{mode}_timed"))
        ckpt.save(resumed)
        ckpt.wait_until_finished()
        out[mode]["save"] = dict(ckpt.last_save)
        print(f"lifecycle {mode}: stopped at {LIFE_STOP} (checkpoints {steps_on_disk}), "
              f"resumed to {resumed.step}; resumed vs uninterrupted over {len(want)} "
              f"tensors: max abs err {err}; save %s" % json.dumps(out[mode]["save"]))

    # (c)-(e) on the dense run's final checkpoint
    base = argv("dense_split")[2:]
    result, _ = run(["--task_type", "eval", *base])
    final = out["dense"]["final_eval"]
    if abs(result["auc"] - final["auc"]) > 1e-6 or \
            abs(result["loss"] - final["loss"]) > 1e-6 * abs(final["loss"]) or \
            result["examples"] != final["examples"]:
        fail(f"lifecycle: the eval task gave {result}, the train task {final}")
    path, _ = run(["--task_type", "infer", *base])
    probs = np.array([float(x) for x in open(path).read().splitlines()])
    predict, _ = load_servable(os.path.join(workdir, "dense_split.servable"), device=DEVICE)
    ref = np.concatenate([predict(b["feat_ids"], b["feat_vals"]) for b in eval_batches(
        DataConfig(batch_size=LIFE_BATCH), field_size=39, data_dir=val_dir)])
    infer_err = float(np.abs(probs - ref).max()) if probs.shape == ref.shape else np.inf
    if probs.shape != (VAL_RECORDS,) or not infer_err <= TOL_PROB:
        fail(f"lifecycle: pred.txt holds {probs.shape[0]} lines, max abs diff "
             f"{infer_err} from the servable")
    export_dir = os.path.join(workdir, "exported")
    run(["--task_type", "export", *base, "--servable_model_dir", export_dir])
    got, want = read_params(export_dir), read_params(os.path.join(workdir,
                                                                  "dense_split.servable"))
    if got.keys() != want.keys() or not all(np.array_equal(got[k], want[k]) for k in want):
        fail("lifecycle: the export task's params.npz differs from the train task's")
    print("lifecycle tasks %s" % json.dumps({
        "eval": result, "train_final_eval": out["dense"]["final_eval"],
        "infer_lines": int(probs.shape[0]), "infer_max_abs_diff": infer_err,
        "export_bit_equal": True}))

    # (f) decode, and the train phase's command through each reader
    out["decode"] = decode_ms(train_dir)
    readers = {}
    for reader, env in (("native", None), ("python", {"DEEPFM_NO_NATIVE": "1"})):
        args = train_argv(train_dir, val_dir, os.path.join(servable_dir, reader),
                          seed) + list(LIFE_ARGS)
        _, lines = run(args, env, steps=1)
        done = _kind(lines, "train_done")[0]
        readers[reader] = {k: done[k] for k in ("examples_per_sec", "input_wait_share",
                                                "steps", "seconds")}
    print("lifecycle readers %s" % json.dumps(readers))
    out.update(readers=readers, launches=launches, backward_launches=backward)
    return out


# the online phase: 32 segments of 1,024 records (each segment's 39,936 ids
# distinct, as write_distinct's batches), a commit and a publish every 8
# steps, a SIGTERM after the trainer's second publish, the same command
# again, and the flywheel's join feeding feedback-train.  It reads
# LIFE_ARGS, LIFE_VOCAB, LIFE_BATCH and DEVICE too, so a rehearsal on the
# CPU runs it at a small width
ROOT = os.path.dirname(os.path.abspath(__file__))
ONLINE_SEGMENTS, ONLINE_EVERY, ONLINE_IDLE_S = 32, 8, 3.0
ONLINE_WRITE_EVERY_S = 0.3  # the writer thread's pace over the second half
ONLINE_STOP_DELAY_S = 0.05  # from the second publish to the SIGTERM
ONLINE_ROWS = (1, 3, 8, 20)  # the closed-loop clients' request sizes
FEEDBACK_IMPRESSIONS, FEEDBACK_WINDOW_S, FEEDBACK_SAMPLE = 4096, 60.0, 0.5


def online_records(seed: int, seq: int) -> list[bytes]:
    """Segment ``seq``'s LIFE_BATCH records: 39 distinct ids a record and
    across the segment, so B1''s float atomics add at most two terms into
    a row even in a batch that spans two segments (after a cut), and a run
    is bit-reproducible."""
    from deepfm_tpu_torch.data.example_proto import serialize_ctr_example

    rng = np.random.default_rng([seed, 23, seq])
    ids = rng.permutation(LIFE_VOCAB)[:LIFE_BATCH * 39].reshape(LIFE_BATCH, 39)
    vals = rng.random((LIFE_BATCH, 39), dtype=np.float32)
    labels = (rng.random(LIFE_BATCH) < 0.25).astype(np.float32)
    return [serialize_ctr_example(float(labels[r]), ids[r].tolist(), vals[r].tolist())
            for r in range(LIFE_BATCH)]


def write_online(stream: str, segments, pace_s: float = 0.0) -> None:
    """Publish each list of records as the next segment of ``stream``
    through the port's SegmentWriter, ``pace_s`` apart."""
    from deepfm_tpu_torch.online.stream import SegmentWriter

    writer = SegmentWriter(stream, roll_bytes=0, roll_age_secs=0)
    for records in segments:
        for r in records:
            writer.append(r)
        writer.flush()
        time.sleep(pace_s)


class _Cli:
    """``python -m deepfm_tpu_torch ARGV`` in its own process; a thread
    keeps its JSON lines (printing all but the per-step ``train`` lines),
    its standard error goes to a file."""

    def __init__(self, name: str, argv: list[str], workdir: str, *,
                 module: str = "deepfm_tpu_torch", env: dict | None = None):
        self.name, self.lines = name, []
        self.err_path = os.path.join(workdir, f"{name}.stderr")
        self._cond = threading.Condition()
        env = dict(os.environ, **(env or {}), PYTHONPATH=os.pathsep.join(
            [ROOT, *filter(None, [os.environ.get("PYTHONPATH")])]))
        with open(self.err_path, "w") as err:
            self.proc = subprocess.Popen([sys.executable, "-m", module, *argv],
                                         cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                         stderr=err, text=True)
        self._reader = threading.Thread(target=self._read, name=f"{name}-stdout", daemon=True)
        self._reader.start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            if not line.startswith("{"):
                continue
            rec = json.loads(line)
            with self._cond:
                self.lines.append(rec)
                self._cond.notify_all()
            if rec["kind"] not in ("train", "rank_step"):
                print(f"{self.name}: {line.strip()}")
        with self._cond:
            self._cond.notify_all()

    def kind(self, kind: str) -> list[dict]:
        with self._cond:
            return [r for r in self.lines if r["kind"] == kind]

    def wait_for(self, kind: str, n: int = 1, timeout: float = 600) -> dict:
        deadline = time.monotonic() + timeout
        with self._cond:
            while len([r for r in self.lines if r["kind"] == kind]) < n:
                if not self._reader.is_alive() or time.monotonic() > deadline:
                    self.fail(f"no {n} {kind!r} lines")
                self._cond.wait(0.5)
        return self.kind(kind)[n - 1]

    def finish(self, timeout: float = 300) -> int:
        try:
            rc = self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.fail(f"did not end within {timeout} s")
        self._reader.join(timeout=60)
        return rc

    def fail(self, msg: str) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=60)
        with open(self.err_path) as f:
            tail = f.read()[-3000:]
        fail(f"{self.name}: {msg} (exit {self.proc.returncode}); stderr:\n{tail}")


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def phase_online(seed: int, workdir: str, card: str) -> dict:
    """Online training at full width through the CLI, into a graphed server
    in another process: (a) 16 segments, then `--task_type online-train`
    (a commit and a publish every 8 steps); on its first version a serve
    process with hot reload from the publish root, and a writer thread
    appending the other 16 segments; (b) a SIGTERM after the second
    publish (exit 0, online_done), then the same command again
    (online_resume at the committed cursor) under 4 closed-loop clients of
    1, 3, 8 and 20 rows; (c) every response within 1e-4 of the plain
    answer of the version it reports or the one before, every reported
    version published, the server on the last version and its graph count
    8 throughout, B1 and B1' launched once a step in each trainer, the
    final commit bit-equal to one pass over the records cut at the
    committed cursor (parameters, moments, step, cursor) and the last
    manifest's param_hash that state's; (d) the flywheel: impressions and
    clicks through `python -m deepfm_tpu_torch.flywheel.join --drain`, then
    `--task_type feedback-train` on its output."""
    from deepfm_tpu_torch.checkpoint import Checkpointer
    from deepfm_tpu_torch.convert import params_to_jax
    from deepfm_tpu_torch.launch.cli import resolve_config
    from deepfm_tpu_torch.online import (OnlinePayload, StreamCursor, latest_manifest,
                                         list_versions, param_tree_hash, version_location)
    from deepfm_tpu_torch.online.stream import segment_name
    from deepfm_tpu_torch.online.trainer import replay_to_state
    from deepfm_tpu_torch.serve.export import load_model
    from deepfm_tpu_torch.train.step import create_train_state

    t_phase = time.perf_counter()
    stream, pub, ckpt = (os.path.join(workdir, d) for d in ("events", "publish", "ckpt"))
    os.makedirs(workdir)
    device_args = ["--device", "cpu"] if DEVICE == "cpu" else []
    argv = ["--task_type", "online-train", "--training_data_dir", stream,
            "--model_dir", ckpt, "--servable_model_dir", pub,
            "--batch_size", str(LIFE_BATCH), "--log_steps", str(ONLINE_EVERY),
            "--checkpoint_every_steps", str(ONLINE_EVERY),
            "--set", f"run.online_publish_every_steps={ONLINE_EVERY}",
            "--set", f"run.online_idle_timeout_secs={ONLINE_IDLE_S}",
            "--set", "regions.publish_keep_window=64",  # every version stays to be checked
            "--set", "model.fused_kernel=auto", "--set", f"run.seed={seed}",
            *LIFE_ARGS, *device_args]
    t0 = time.perf_counter()
    records = [online_records(seed, seq) for seq in range(ONLINE_SEGMENTS)]
    half = ONLINE_SEGMENTS // 2
    write_online(stream, records[:half])
    print(f"online: wrote {half} segments of {LIFE_BATCH} records in "
          f"{time.perf_counter() - t0:.2f} s")

    clis: list[_Cli] = []  # every process started here, stopped on the way out
    stop = threading.Event()
    try:
        # (a) the trainer, the server on its first version, the writer thread
        first = _Cli("trainer1", argv, workdir)
        clis.append(first)
        first.wait_for("publish")
        port = _free_port()
        server = _Cli("server", ["--task_type", "serve", "--servable_model_dir",
                                 version_location(pub, 1), "--set", f"run.serve_port={port}",
                                 "--set", f"run.serve_reload_url={pub}",
                                 "--set", "run.serve_reload_interval_secs=0.05", *device_args],
                      workdir)
        clis.append(server)
        writer = threading.Thread(target=write_online, args=(stream, records[half:],
                                                             ONLINE_WRITE_EVERY_S),
                                  name="online-writer", daemon=True)
        writer.start()
        # (b) SIGTERM 50 ms after the second publish, while the trainer reads
        # the next batch's records if the writer got ahead: it then trains them
        # as a short batch before its final commit
        first.wait_for("publish", 2)
        time.sleep(ONLINE_STOP_DELAY_S)
        first.proc.send_signal(signal.SIGTERM)
        if first.finish() != 0:
            first.fail("SIGTERM did not end it with exit 0")
        done1 = first.wait_for("online_done")
        cut = StreamCursor(done1["segment"], done1["record"])

        base = f"http://127.0.0.1:{port}"
        deadline = time.monotonic() + 600
        while True:
            try:
                if get(f"{base}/readyz").get("ready"):
                    break
            except OSError:
                pass
            if server.proc.poll() is not None or time.monotonic() > deadline:
                server.fail("the server did not come up")
            time.sleep(0.2)
        rng = np.random.default_rng(seed + 29)
        requests = [(make_ids(rng, n, 39, LIFE_VOCAB),
                     rng.random((n, 39)).astype(np.float32)) for n in ONLINE_ROWS]
        responses, bad, samples = [], [], []
        lock = threading.Lock()

        def client(k: int) -> None:
            conn = _Client(port)
            body = _instances_body(*requests[k])
            try:
                while not stop.is_set():
                    code, _, raw = conn.post("/v1/models/deepfm:predict", body)
                    t = time.time()
                    if code != 200:
                        bad.append(f"{code}: {raw[:200]}")
                        return
                    doc = json.loads(raw)
                    with lock:
                        responses.append((k, doc["model_version"],
                                          np.asarray(doc["predictions"], np.float32), t))
            finally:
                conn.close()

        def monitor() -> None:
            while not stop.is_set():
                samples.append(get(f"{base}/v1/metrics")["reload"])
                stop.wait(0.1)

        threads = [threading.Thread(target=client, args=(k,), daemon=True)
                   for k in range(len(ONLINE_ROWS))]
        threads.append(threading.Thread(target=monitor, daemon=True))
        for t in threads:
            t.start()
        t_clients = time.time()
        second = _Cli("trainer2", argv, workdir)
        clis.append(second)
        resume = second.wait_for("online_resume")
        if (resume["segment"], resume["record"]) != tuple(cut) or resume["step"] != done1["step"]:
            second.fail(f"resumed at {resume}, the first run committed {done1}")
        if second.finish() != 0:
            second.fail("it did not end with exit 0")
        done2 = second.wait_for("online_done")
        writer.join(timeout=60)
        versions = list_versions(pub)
        deadline = time.monotonic() + 120
        while not samples or samples[-1]["model_version"] != versions[-1]:
            if time.monotonic() > deadline or bad:
                fail(f"online: the server did not reach version {versions[-1]}: "
                     f"{samples[-1:]} {bad[:2]}")
            time.sleep(0.05)
        time.sleep(0.3)
        stop.set()
        for t in threads:
            t.join(timeout=60)
        if bad or any(t.is_alive() for t in threads):
            fail(f"online: client errors {bad[:3]}")
        final_status = get(f"{base}/v1/metrics")["reload"]
        server.proc.send_signal(signal.SIGTERM)
        server.finish(timeout=60)
    finally:
        stop.set()
        for cli in clis:
            if cli.proc.poll() is None:
                cli.proc.kill()
                cli.proc.wait(timeout=60)

    # (c) the checks
    graphs = 2 * len(BUCKETS) if DEVICE == "cuda" else 0
    if {s["graphs"] for s in samples} != {graphs} or final_status["rollbacks_total"]:
        fail(f"online: graph counts {sorted({s['graphs'] for s in samples})}, status "
             f"{final_status}")
    if versions != list(range(1, versions[-1] + 1)):
        fail(f"online: published versions {versions}")
    want = {}
    for v in versions:
        model = load_model(version_location(pub, v), device=DEVICE)
        want[v] = [[plain_probs(model, ids, vals, b) for b in BUCKETS if b >= len(ids)]
                   for ids, vals in requests]
        del model
    served, worst = {}, 0.0
    for k, mv, got, t in responses:
        if mv not in want:
            fail(f"online: a response reports version {mv}, never published ({versions})")
        errs = [float(np.abs(got - w).max()) for v in (mv, mv - 1) if v in want
                for w in want[v][k]]
        if min(errs) > TOL_PROB:
            fail(f"online: a response of version {mv} matches neither it nor the one "
                 f"before (min abs err {min(errs)})")
        worst = max(worst, min(errs))
        served[mv] = min(served.get(mv, t), t)
    marker = {v: os.path.getmtime(os.path.join(pub, f"MANIFEST-{v:08d}.json"))
              for v in versions}
    fresh = [1e3 * (served[v] - marker[v]) for v in versions
             if v in served and marker[v] > t_clients]
    if not fresh:
        fail("online: no version was published and served while the clients ran")

    launches = backward = 0
    for name, done in (("trainer1", done1), ("trainer2", done2)):
        if DEVICE == "cuda" and not (done["forward_launches"] == done["backward_launches"]
                                     == done["applied"] > 0):
            fail(f"online {name}: {done['applied']} steps launched fused_ctr_forward "
                 f"{done['forward_launches']} and fused_ctr_backward "
                 f"{done['backward_launches']} times")
        launches += done["forward_launches"]
        backward += done["backward_launches"]
    cfg, _ = resolve_config(argv)
    oracle = replay_to_state(cfg, cuts=[cut], device=DEVICE)
    final = Checkpointer(ckpt).restore(
        OnlinePayload.wrap(create_train_state(cfg, DEVICE), StreamCursor()))
    got, ref = state_tensors(final.train), state_tensors(oracle)
    end = StreamCursor(segment_name(ONLINE_SEGMENTS - 1), LIFE_BATCH)
    if got.keys() != ref.keys() or not final.step == oracle.step == done2["step"] \
            or final.cursor() != end:
        fail(f"online: the final commit (step {final.step}, {final.cursor()}) against one "
             f"cut pass (step {oracle.step}, {end})")
    err = max(float((got[k].float() - ref[k].float()).abs().max()) for k in ref)
    if err != 0.0:
        fail(f"online: the resumed run vs one pass cut at {cut}: max abs err {err}")
    manifest = latest_manifest(pub)
    if manifest.param_hash != param_tree_hash(*params_to_jax(oracle.model.state_dict(),
                                                             cfg.model)) \
            or manifest.step != oracle.step or manifest.cursor != end._asdict():
        fail(f"online: the last manifest {manifest} is not the final state's")
    print(f"online: stopped at {tuple(cut)} (step {done1['step']}), resumed to step "
          f"{final.step}; the final commit equals one pass cut there over {len(ref)} "
          f"tensors, bit for bit; {len(responses)} responses, all of a published version "
          f"and within {TOL_PROB} of it or the one before (max {worst}); versions "
          f"{versions}, the server on {final_status['model_version']}")

    # (d) the flywheel: join, then feedback-train on its output
    feedback = phase_feedback(seed, workdir, device_args)
    launches += feedback.pop("forward_launches")
    backward += feedback.pop("backward_launches")
    swaps = [s for s in samples if s["last_swap_ms"] is not None]
    last = {s["model_version"]: s for s in swaps}
    line = {
        "card": card,
        "records": ONLINE_SEGMENTS * LIFE_BATCH, "segments": ONLINE_SEGMENTS,
        "stop_cursor": list(cut), "stop_batch_rows": done1["examples"] - LIFE_BATCH * (
            done1["applied"] - 1),
        "trainers": [{**{k: d[k] for k in (
            "applied", "examples", "examples_per_sec", "input_wait_share", "commits",
            "commit_ms_p50", "commit_ms_max", "publishes", "publish_ms_p50",
            "publish_ms_max")},
            # the train lines: examples/s over each 8 steps, the commit and
            # publish of the step before them included
            "examples_per_sec_by_8_steps": [r["examples_per_sec"] for r in cli.kind("train")]}
            for d, cli in ((done1, first), (done2, second))],
        "freshness_ms_p50": float(np.percentile(fresh, 50)), "freshness_ms_max": max(fresh),
        "freshness_versions": len(fresh), "versions": len(versions),
        "swaps": final_status["swaps_total"],
        "swap_ms": [last[v]["last_swap_ms"] for v in sorted(last)],
        "stage_ms": [last[v]["last_stage_ms"] for v in sorted(last)],
        "canary_ms": [last[v]["last_canary_ms"] for v in sorted(last)],
        "responses": len(responses), "responses_outside_versions": 0,
        "max_abs_err": worst, "graphs": graphs,
        **feedback,
        "wall_s": time.perf_counter() - t_phase,
    }
    print("online " + json.dumps(line))
    return {**line, "launches": launches, "backward_launches": backward}


def phase_feedback(seed: int, workdir: str, device_args: list[str]) -> dict:
    """The flywheel at width 39: 4,096 impressions in 4 segments, 25% of
    them clicked inside the window, 5% clicked after it (label flips), 64
    clicks of impressions never shown (orphans), sampled at 0.5; the join
    CLI one shot with --drain, then feedback-train on its output.  The
    segments' publish times (mtimes) are set, so the schedule is fixed."""
    from deepfm_tpu_torch.flywheel.records import (impression_sampled, serialize_click,
                                                   serialize_impression)
    from deepfm_tpu_torch.online import list_versions
    from deepfm_tpu_torch.online.stream import SegmentWriter

    imps, clicks, joined = (os.path.join(workdir, d) for d in ("imps", "clicks", "joined"))
    rng = np.random.default_rng(seed + 31)
    pids = [f"fb-{i}#0" for i in range(FEEDBACK_IMPRESSIONS)]
    clicked = rng.random(len(pids)) < 0.25
    late = (rng.random(len(pids)) < 0.05) & ~clicked
    ghosts = [f"ghost-{i}#0" for i in range(64)]
    t0 = float(int(time.time()) - 10_000)

    def segment(root: str, recs: list[bytes], at: float) -> None:
        writer = SegmentWriter(root, roll_bytes=0, roll_age_secs=0)
        for r in recs:
            writer.append(r)
        name = writer.flush()
        os.utime(os.path.join(root, name), (t0 + at, t0 + at))

    per = FEEDBACK_IMPRESSIONS // 4
    for s in range(4):
        segment(imps, [serialize_impression(
            impression_id=p, trace_id=p.rsplit("#", 1)[0], tenant="base", model_version=1,
            ids=rng.integers(0, LIFE_VOCAB, 39).tolist(),
            values=rng.random(39, dtype=np.float32).tolist(), score=0.5,
            deadline_class="default", ts_ms=int((t0 + s) * 1000))
            for p in pids[s * per:(s + 1) * per]], s)
    def click(p: str, at: float) -> bytes:
        return serialize_click(impression_id=p, ts_ms=int((t0 + at) * 1000))

    segment(clicks, [click(p, 30) for p, c in zip(pids, clicked) if c]
            + [click(p, 30) for p in ghosts[:32]], 30)
    segment(clicks, [click(p, 100) for p in ghosts[32:]], 100)
    segment(clicks, [click(p, 200) for p, c in zip(pids, late) if c], 200)
    kept = np.array([impression_sampled(p.rsplit("#", 1)[0], FEEDBACK_SAMPLE) for p in pids])
    expect = {"positive_total": int((kept & clicked).sum()),
              "negative_total": int((kept & ~clicked).sum()),
              "flip_total": int((kept & late).sum()),
              "orphan_click_total": sum(impression_sampled(g.rsplit("#", 1)[0],
                                                           FEEDBACK_SAMPLE) for g in ghosts)}
    n_records = FEEDBACK_IMPRESSIONS + int(clicked.sum()) + int(late.sum()) + len(ghosts)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT, *filter(None, [os.environ.get("PYTHONPATH")])]))
    out = subprocess.run([sys.executable, "-m", "deepfm_tpu_torch.flywheel.join",
                          "--impressions", imps, "--clicks", clicks, "--out", joined,
                          "--window", str(FEEDBACK_WINDOW_S),
                          "--sample-rate", str(FEEDBACK_SAMPLE), "--drain"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        fail(f"online join: exit {out.returncode}\n{out.stderr[-3000:]}")
    stats = json.loads(out.stdout)
    got = {k: stats[k] for k in expect}
    if got != expect or stats["emitted_total"] != int(kept.sum()) \
            or stats["pending_window"] or stats["early_clicks"]:
        fail(f"online join: {stats}, expected {expect} and {int(kept.sum())} emitted")
    trainer = _Cli("feedback", [
        "--task_type", "feedback-train", "--model_dir", os.path.join(workdir, "fb_ckpt"),
        "--servable_model_dir", os.path.join(workdir, "fb_publish"),
        "--batch_size", str(LIFE_BATCH), "--log_steps", str(ONLINE_EVERY),
        "--set", f"flywheel.join_output_url={joined}",
        "--set", "run.online_idle_timeout_secs=1", "--set", "model.fused_kernel=auto",
        "--set", f"run.seed={seed}", *LIFE_ARGS, *device_args], workdir)
    if trainer.finish() != 0:
        trainer.fail("it did not end with exit 0")
    done = trainer.wait_for("online_done")
    published = list_versions(os.path.join(workdir, "fb_publish"))
    if done["examples"] != stats["emitted_total"] or not published or (
            DEVICE == "cuda" and not done["forward_launches"] == done["backward_launches"]
            == done["applied"] > 0):
        fail(f"online feedback-train: {done}, versions {published}, "
             f"{stats['emitted_total']} joined records")
    print(f"online feedback: join {json.dumps(got)}, {stats['emitted_total']} labeled "
          f"records from {FEEDBACK_IMPRESSIONS} impressions in {stats['seconds']:.3f} s; "
          f"feedback-train consumed all in {done['applied']} steps, versions {published}")
    return {"join_records_per_sec": n_records / stats["seconds"],
            "join_emitted": stats["emitted_total"], "join_flips": stats["flip_total"],
            "feedback_steps": done["applied"], "feedback_versions": len(published),
            "forward_launches": done["forward_launches"],
            "backward_launches": done["backward_launches"]}


# phase 15: the graphed single-card step at the train phase's configuration,
# on batches of distinct ids (B1''s atomics then add one term a row, so a
# step is bit-reproducible and graphed = eager can hold bit for bit)
GRAPH_STEPS = 8


def distinct_host_batches(seed: int, n: int, b: int = 1024, f: int = 39,
                          vocab: int = 117_581) -> list[dict]:
    """``n`` pinned host batches of ``b`` records whose ``b·f`` ids are
    distinct within each batch."""
    rng = np.random.default_rng(seed)
    return [{"feat_ids": torch.from_numpy(rng.permutation(vocab)[:b * f].reshape(b, f))
             .pin_memory(),
             "feat_vals": torch.from_numpy(rng.random((b, f), dtype=np.float32)).pin_memory(),
             "label": torch.from_numpy((rng.random(b) < 0.25).astype(np.float32)).pin_memory()}
            for _ in range(n)]


def busy_ms(fn, n: int = 5) -> float | None:
    """Device time of ``fn``'s kernels a call from torch.profiler, or None
    where it saw none."""
    from torch.autograd import DeviceType

    prof = device_profile(fn, n)
    if prof is None:
        return None
    return sum(r.device_time_total for r in prof.key_averages()
               if r.device_type == DeviceType.CUDA) / n / 1e3


def phase_graphed(seed: int, train: dict, lazy: dict) -> dict:
    """The dense and the lazy single-card step of the train phase's model
    (flagship widths, bf16 MLP, dropout 0.5, Adam, batch 1,024), each from
    one initial state and one dropout generator state: GRAPH_STEPS steps
    through ``graphed_train_step`` (WARMUP_STEPS eager on a side stream,
    then the capture and replays) against as many eager ``train_step``s,
    metrics and every carried tensor bit for bit; a step's device time
    (CUDA events) and idle share, graphed and eager, beside the train
    task's examples/s; then the port's analyser, ``python -m
    deepfm_tpu_torch.analysis deepfm_tpu_torch/ --concurrency --trace-audit``
    (engines 1 and 3 over the package, and engine 2's audits, the
    observability of the captured bodies among them, on the card), must
    exit 0."""
    from deepfm_tpu_torch.analysis.trace_audit import state_tensors as carried
    from deepfm_tpu_torch.core.config import Config
    from deepfm_tpu_torch.train.step import (WARMUP_STEPS, create_train_state,
                                             graphed_train_step, train_step)

    t0 = time.perf_counter()
    batches = distinct_host_batches(seed + 23, GRAPH_STEPS)
    on_card = [{k: v.cuda() for k, v in b.items()} for b in batches]
    out = {}
    for mode, examples in (("dense", train["examples_per_sec"]),
                           ("lazy", lazy["examples_per_sec"])):
        cfg = Config.from_dict({"model": {"fused_kernel": "auto"},
                                "optimizer": {"lazy_embedding_updates": mode == "lazy"},
                                "run": {"seed": seed}})
        eager, graphed = create_train_state(cfg, "cuda"), create_train_state(cfg, "cuda")
        graphed.generator.set_state(eager.generator.get_state())
        for i, (host, dev) in enumerate(zip(batches, on_card)):
            mg, me = graphed_train_step(graphed, host), train_step(eager, dev)
            for k in mg:
                if not torch.equal(mg[k], me[k]):
                    fail(f"graphed {mode}: step {i + 1}'s {k} {float(mg[k])} differs from "
                         f"the eager step's {float(me[k])}")
        got, want = carried(graphed), carried(eager)
        differs = [k for k in want if not torch.equal(got[k], want[k])]
        if differs or got.keys() != want.keys():
            fail(f"graphed {mode}: after {GRAPH_STEPS} steps these tensors differ from "
                 f"the eager steps': {differs[:8]}")
        if graphed.graph.replays != GRAPH_STEPS - WARMUP_STEPS:
            fail(f"graphed {mode}: {graphed.graph.replays} replays in {GRAPH_STEPS} steps")
        host, dev = batches[0], on_card[0]
        eager_ms = _median_event_ms(lambda: train_step(eager, dev), 1, 20)
        graphed_ms = _median_event_ms(lambda: graphed_train_step(graphed, host), 1, 20)
        busy_e = busy_ms(lambda: train_step(eager, dev))
        busy_g = busy_ms(lambda: graphed_train_step(graphed, host))
        row = {"steps_bit_equal": GRAPH_STEPS, "tensors_bit_equal": len(want),
               "replays": graphed.graph.replays,
               "kernels_a_replay": list(graphed.graph.per_replay),
               "eager_step_device_ms": eager_ms, "graphed_step_device_ms": graphed_ms,
               "eager_kernel_busy_ms": busy_e, "graphed_kernel_busy_ms": busy_g,
               "eager_idle_share": None if busy_e is None else 1.0 - busy_e / eager_ms,
               "graphed_idle_share": None if busy_g is None else 1.0 - busy_g / graphed_ms,
               "train_task_examples_per_sec": examples}
        print("graphed %s %s" % (mode, json.dumps(row)))
        out[mode] = row
    out["analysis"] = run_analysis()
    out["seconds"] = time.perf_counter() - t0
    print(f"graphed: the analyser found nothing; phase {out['seconds']:.1f} s")
    return out


def run_analysis() -> dict:
    """``python -m deepfm_tpu_torch.analysis deepfm_tpu_torch/ --concurrency
    --trace-audit`` (the device at its cuda default) from the repo root;
    fails unless it exits 0 and its audit waives neither of the grid step's
    collective contracts (``audit_spmd_exchange``, ``audit_zero_update``: they
    run on a spawned [2, 2] world of gloo ranks on the card).  Prints its
    counts and the seconds of engines 1 and 3 and of the trace audit (the
    CLI's stderr lines), and the collective world's seconds, its stages and
    how long the audit waited for it after its other contracts (the world
    runs beside them) on a line of their own."""
    torch.cuda.empty_cache()  # the audit's process shares the card
    argv = [sys.executable, "-m", "deepfm_tpu_torch.analysis", "deepfm_tpu_torch/",
            "--concurrency", "--trace-audit", "--format", "json"]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True, timeout=300)
    except subprocess.TimeoutExpired:
        fail("graphed: the analyser ran past 300 s")
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"graphed: the analyser exited {proc.returncode}:\n{proc.stdout[-4000:]}"
             f"\n{proc.stderr[-4000:]}")
    counts = json.loads(proc.stdout)["counts"]
    m = re.search(r"analysis: (\d+) files; engines 1\+3 ([0-9.]+) s; trace audit "
                  r"([0-9.]+) s on cuda", proc.stderr)
    if m is None:
        fail(f"graphed: the analyser printed no timing line:\n{proc.stderr[-2000:]}")
    w = re.search(r"analysis: trace audit waives (.*)", proc.stderr)
    g = re.search(r"analysis: the collective world took ([0-9.]+) s on cuda; its ranks "
                  r"launched B1 (\d+), B1' (\d+) times", proc.stderr)
    st = re.search(r"analysis: the collective world's stages \(s\): (.*); waited for "
                   r"([0-9.]+)", proc.stderr)
    if w is None or g is None or st is None:
        fail(f"graphed: the analyser printed no waiver or collective world lines:\n"
             f"{proc.stderr[-2000:]}")
    waived = [name.strip() for name in w.group(1).split(",")]
    if {"audit_spmd_exchange", "audit_zero_update"} & set(waived):
        fail(f"graphed: the trace audit still waives {waived}")
    row = {"files": int(m.group(1)), **counts, "engines_1_3_s": float(m.group(2)),
           "trace_audit_s": float(m.group(3)), "process_s": wall, "waived": waived,
           "collective_world_s": float(g.group(1)),
           "collective_world_launches": [int(g.group(2)), int(g.group(3))],
           "collective_world_stages": {k: float(v) for k, v in (
               x.rsplit(" ", 1) for x in st.group(1).split(", "))},
           "collective_world_waited_s": float(st.group(2))}
    print("analysis %s" % json.dumps(row))
    print(f"analysis: the [2, 2] collective world (audit_spmd_exchange, "
          f"audit_zero_update) took {row['collective_world_s']:.3f} s on the card; its "
          f"ranks launched B1 {g.group(2)}, B1' {g.group(3)} times (not in the kernels line); "
          f"it ran beside the other audits, which then waited {st.group(2)} s for it; its "
          f"stages (s): {st.group(1)}")
    return row


# phase 16: the tiered store at the flagship width, its hot cache about half
# the vocabulary (so the distinct-id batches evict) and its host tier as large
# (so the host tier flushes pages to the cold directory).  The train data's 48
# batches touch 55,480 rows in all, fewer than 65,536 slots, so their run
# takes a cache that still holds one batch (39,936 rows) but not all of them:
# repeated ids then evict, write back and stage again on the card too
TIERED_SLOTS, TIERED_HOST_ROWS, TIERED_PAGE_ROWS = 65_536, 65_536, 1024
TIERED_TRAIN_SLOTS = 49_152
# the tiered train task's depth: the lifecycle's first file (12 batches of
# distinct ids), a SIGTERM after step 6 (cut from both files and step 12
# to keep the whole script within its time budget)
TIERED_TASK_FILES, TIERED_TASK_STOP = 1, 6
# the paged step against the resident one on the lifecycle's first 12
# batches of distinct ids (cut from 24 for the same budget)
TIERED_DISTINCT_BATCHES = 12
TIERED_SERVE_ROWS = (1, 8, 100)


def tiered_cfg(seed: int, slots: int = TIERED_SLOTS):
    from deepfm_tpu_torch.core.config import Config

    return Config.from_dict({
        "model": {"fused_kernel": "off", "tiered_embeddings": True,
                  "tiered_hot_slots": slots, "tiered_host_rows": TIERED_HOST_ROWS,
                  "tiered_page_rows": TIERED_PAGE_ROWS},
        "optimizer": {"lazy_embedding_updates": True}, "run": {"seed": seed}})


def host_batches(data_dir: str, pattern: str) -> list[dict]:
    """Every whole 1,024-record batch of the files as numpy arrays."""
    from deepfm_tpu_torch.data.pipeline import batched_ctr_batches, discover_files, record_stream

    files = discover_files(data_dir, (pattern,), shuffle=False)
    return list(batched_ctr_batches(record_stream(files), batch_size=1024, field_size=39))


def sync_resident(resident, tr) -> None:
    """Make the resident lazy state the paged trainer's: every row the hot
    cache holds (with its moments) into the resident tables, the rest of
    the model, its optimizer and the dropout generator.  Rows outside the
    cache are already equal (they left it with these values)."""
    from deepfm_tpu_torch.tiered.trainer import rest_state_dict

    slots, rows = tr.pager.resident()
    s_idx, r_idx = torch.from_numpy(slots).cuda(), torch.from_numpy(rows).cuda()
    hot = tr.state.hot
    with torch.no_grad():
        for k in ("fm_w", "fm_v"):
            getattr(resident.model, k)[r_idx] = hot.rows[k][s_idx]
            resident.lazy.m[k][r_idx] = hot.m[k][s_idx]
            resident.lazy.v[k][r_idx] = hot.v[k][s_idx]
        resident.model.load_state_dict(rest_state_dict(tr.state.model), strict=False)
        for name, slots_ in resident.optimizer.slots.items():
            for slot, t in slots_.items():
                t.copy_(tr.state.optimizer.slots[name][slot])
    resident.generator.set_state(tr.state.generator.get_state())


def hot_errors(resident, tr) -> dict:
    """Max abs difference of every row the hot cache holds (and its
    moments) from the resident state's, with each tensor's scale."""
    slots, rows = tr.pager.resident()
    s_idx, r_idx = torch.from_numpy(slots).cuda(), torch.from_numpy(rows).cuda()
    hot = tr.state.hot
    out = {}
    for k in ("fm_w", "fm_v"):
        for part, got, want in (("rows", hot.rows[k], getattr(resident.model, k).detach()),
                                ("m", hot.m[k], resident.lazy.m[k]),
                                ("v", hot.v[k], resident.lazy.v[k])):
            w = want[r_idx]
            out[f"{part}.{k}"] = (float((got[s_idx] - w).abs().max()), float(w.abs().max()))
    return out


def paged_against_resident(cfg, batches: list[dict], cold: str, tag: str, exact: bool):
    """A TieredTrainer seeded from a fresh resident lazy state and the
    resident lazy step from the same state, on ``batches``.  ``exact``
    (batches of distinct ids): one trajectory each, every loss and the
    final tables and moments bit for bit.  Otherwise B1''s atomics add a
    batch's repeated ids in any order, so the two are held step by step
    from one state, as the lazy phase holds the kernels to the plain
    versions: each step's loss within TOL_LOSS_REL and the cache's rows
    and moments within TOL_GRAD_REL of each tensor's largest magnitude,
    then the resident state takes the paged one's (``sync_resident``).
    With each paged step's time.  Returns (trainer, resident state, row)."""
    from deepfm_tpu_torch.tiered import TieredTrainer
    from deepfm_tpu_torch.train.step import create_train_state, train_step

    resident = create_train_state(cfg, "cuda")
    tr = TieredTrainer.from_resident_state(cfg, create_train_state(cfg, "cuda"), cold)
    step_ms, host_ms, worst, worst_rel = [], [], 0.0, 0.0
    for i, b in enumerate(batches):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        mp = tr.train_batch(b)
        end.record()
        end.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        step_ms.append(start.elapsed_time(end))
        mr = train_step(resident, {k: torch.from_numpy(v).cuda() for k, v in b.items()})
        lp, lr = float(mp["loss"]), float(mr["loss"])
        worst = max(worst, abs(lp - lr) / abs(lr))
        if (lp != lr) if exact else not worst <= TOL_LOSS_REL:
            fail(f"tiered {tag}: step {i + 1}'s loss {lp} vs the resident lazy step's {lr}")
        if not exact:
            for name, (err, scale) in hot_errors(resident, tr).items():
                worst_rel = max(worst_rel, err / scale if scale else err)
                if not err <= TOL_GRAD_REL * scale:
                    fail(f"tiered {tag}: step {i + 1}'s {name} vs the resident lazy step: "
                         f"max abs err {err}, scale {scale}")
            sync_resident(resident, tr)
    errs = {}
    if exact:
        rows, m, v = tr.export_tables()
        for part, got in (("rows", rows), ("m", m), ("v", v)):
            for k in ("fm_w", "fm_v"):
                want = (getattr(resident.model, k) if part == "rows"
                        else getattr(resident.lazy, part)[k]).detach().cpu().numpy()
                errs[f"{part}.{k}"] = err = float(np.abs(got[k] - want).max())
                if err != 0.0:
                    fail(f"tiered {tag}: {part} {k} vs the resident lazy state: max abs "
                         f"err {err}")
    stats = tr.pager.stats()
    # both runs touch more rows than their caches keep: slots evict and
    # write back
    if stats["evictions"] == 0 or stats["writeback_rows"] == 0:
        fail(f"tiered {tag}: the cache never evicted: {stats}")
    row = {"steps": len(batches), "exact": exact, "loss_max_rel_err": worst,
           "table_max_rel_err": worst_rel if not exact else errs,
           "step_device_ms_median": float(np.median(step_ms)),
           "step_host_ms_median": float(np.median(host_ms)), "pager": stats,
           "host": tr.host.stats(), "cold": tr.cold.stats()}
    print("tiered %s %s" % (tag, json.dumps(row)))
    return tr, resident, row


def phase_tiered(seed: int, workdir: str, train_dir: str, life_dir: str) -> dict:
    """ROADMAP A11 on the card: (a) the paged step against the resident
    lazy step on the train phase's 48 batches (within the lazy phase's
    tolerances: B1''s atomics add repeated ids in any order; a cache
    smaller than the rows they touch, so repeated ids evict) and on the
    lifecycle's first TIERED_DISTINCT_BATCHES batches of distinct ids (bit
    for bit), with the hit
    rate, the staged and written-back bytes and the step's time; (b) B1
    and B1' on the hot cache against their plain versions; (c) the tiered
    train task through ``cli.run`` on TIERED_TASK_FILES of the lifecycle's
    files: stopped by a SIGTERM after step TIERED_TASK_STOP, resumed, and
    held bit for bit against an uninterrupted run; (d)
    ``publish_tiered`` of (a)'s trainer and a TieredScorer behind the
    port's server answering requests within 1e-6 of the resident model."""
    from deepfm_tpu_torch.ops import fused_ctr
    from deepfm_tpu_torch.online.publisher import ModelPublisher
    from deepfm_tpu_torch.serve.server import ScoringHTTPServer, make_handler
    from deepfm_tpu_torch.tiered import TieredScorer, TieredTrainer
    from deepfm_tpu_torch.train import loop
    from deepfm_tpu_torch.train.step import predict_step
    from deepfm_tpu_torch.utils.logging import MetricLogger

    t_phase = time.perf_counter()
    cfg = tiered_cfg(seed)
    out = {}
    tr, _, out["train_data"] = paged_against_resident(
        tiered_cfg(seed, TIERED_TRAIN_SLOTS), host_batches(train_dir, "train"),
        os.path.join(workdir, "cold_a"),
        "train data", exact=False)
    tr.close()
    distinct = host_batches(life_dir, "train")[:TIERED_DISTINCT_BATCHES]
    tr, resident, out["distinct"] = paged_against_resident(
        cfg, distinct, os.path.join(workdir, "cold_b"), "distinct ids", exact=True)

    # (b) the kernels on the hot cache, at the last batch's slots
    slot_ids, _ = tr.pager.translate(distinct[-1]["feat_ids"], tr.state.hot)
    hot = tr.state.hot.rows
    ids = torch.from_numpy(slot_ids).cuda()
    vals = torch.from_numpy(distinct[-1]["feat_vals"]).cuda()
    b, f = ids.shape
    got = fused_ctr.fused_ctr_interaction(hot["fm_w"], hot["fm_v"], ids, vals)
    want = fused_ctr.fused_ctr_plain(hot["fm_w"], hot["fm_v"], ids, vals)
    torch.cuda.synchronize()
    e = [float((a - w).abs().max()) for a, w in zip(got, want)]
    if not e[0] <= TOL_EMB or not e[1] <= TOL_YW_REL * (1 + float(want[1].abs().max())) \
            or not e[2] <= TOL_YV_REL * (1 + float(want[2].abs().max())):
        fail(f"tiered: fused_ctr_forward on the hot cache disagrees with its plain "
             f"version: {e}")
    fwd_ms, _ = time_ms(lambda: fused_ctr.fused_ctr_interaction(hot["fm_w"], hot["fm_v"],
                                                                ids, vals))
    fwd_plain_ms, _ = time_ms(lambda: fused_ctr.fused_ctr_plain(hot["fm_w"], hot["fm_v"],
                                                                ids, vals), reps=20)
    fwd_bound, fwd_by, _ = fused_ctr_bound_ms(hot["fm_w"], hot["fm_v"], ids, b, f)
    out["hot_forward"] = {"table": list(hot["fm_v"].shape), "max_abs_err": e,
                          "ms": fwd_ms, "plain_ms": fwd_plain_ms, "bound_ms": fwd_bound,
                          "bound_by": fwd_by}
    print("tiered hot-cache forward B=%d %s" % (b, json.dumps(out["hot_forward"])))
    out["compact"] = compact_kernel_check(hot["fm_w"], hot["fm_v"], ids, vals, seed,
                                          "tiered")

    # (d) publish the distinct run's trainer and serve it
    pub = os.path.join(workdir, "pub")
    manifest = ModelPublisher(pub).publish_tiered(cfg, tr)
    tr.close()
    scorer = TieredScorer.from_publish(pub, os.path.join(workdir, "staging"))
    server = ScoringHTTPServer(("127.0.0.1", 0), make_handler(scorer, "deepfm"))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    # the resident model's predictions first: its forward launches B1 too,
    # and the count read below is the scorer's alone
    requests = []
    for j, n in enumerate(TIERED_SERVE_ROWS):
        ids_n, vals_n = distinct[j]["feat_ids"][:n], distinct[j]["feat_vals"][:n]
        want = predict_step(resident.model, {
            "feat_ids": torch.from_numpy(ids_n).cuda(),
            "feat_vals": torch.from_numpy(vals_n).cuda()}).cpu().numpy()
        requests.append((n, ids_n, vals_n, want))
    fused_ctr.launches = 0
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}"
        worst = 0.0
        for n, ids_n, vals_n, want in requests:
            code, doc = post(f"{url}/v1/models/deepfm:predict",
                             _instances_body(ids_n, vals_n))
            if code != 200:
                fail(f"tiered: the scorer answered {code}: {doc}")
            err = float(np.abs(np.asarray(doc["predictions"]) - want).max())
            worst = max(worst, err)
            if not err <= 1e-6:
                fail(f"tiered: {n} instances served within {err} of the resident "
                     f"model's predict (tolerance 1e-6)")
        paging = get(f"{url}/v1/metrics")["paging"]
        with urllib.request.urlopen(f"{url}/metrics", timeout=60) as r:
            gauges = r.read().decode()
        if 'deepfm_serving_paging{kind="hit_rate"}' not in gauges:
            fail("tiered: /metrics carries no paging gauges")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    serve_launches = fused_ctr.launches
    if serve_launches != len(TIERED_SERVE_ROWS):
        fail(f"tiered: {len(TIERED_SERVE_ROWS)} requests launched B1 {serve_launches} "
             f"times, not once each")
    out["serve"] = {"version": manifest.version, "step": manifest.step,
                    "max_abs_diff": worst, "paging": {k: paging[k] for k in (
                        "requests", "hits", "misses", "hit_rate", "refill_bytes")},
                    "forward_launches": serve_launches}
    print("tiered serve %s" % json.dumps(out["serve"]))

    # (c) the tiered train task: a SIGTERM after step TIERED_TASK_STOP, the
    # resume, and an uninterrupted run, on the lifecycle's first files
    task_dir = os.path.join(workdir, "task_data")
    os.makedirs(task_dir)
    for name in sorted(f for f in os.listdir(life_dir)
                       if f.startswith("train"))[:TIERED_TASK_FILES]:
        os.symlink(os.path.join(life_dir, name), os.path.join(task_dir, name))
    task_steps = TIERED_TASK_FILES * LIFE_BATCHES_PER_FILE

    class SignalAt(MetricLogger):
        def step(self, step, *a, **kw):
            super().step(step, *a, **kw)
            if step == TIERED_TASK_STOP:
                os.kill(os.getpid(), signal.SIGTERM)

    def argv(name: str) -> list[str]:
        return ["--task_type", "train", "--training_data_dir", task_dir,
                "--model_dir", os.path.join(workdir, name),
                "--servable_model_dir", os.path.join(workdir, name + ".pub"),
                "--num_epochs", "1", "--log_steps", str(LOG_STEPS),
                "--checkpoint_every_steps", str(LIFE_EVERY),
                "--set", "model.fused_kernel=off", "--set", "model.tiered_embeddings=true",
                "--set", f"model.tiered_hot_slots={TIERED_SLOTS}",
                "--set", f"model.tiered_host_rows={TIERED_HOST_ROWS}",
                "--set", f"model.tiered_page_rows={TIERED_PAGE_ROWS}",
                "--set", "optimizer.lazy_embedding_updates=true", "--set", f"run.seed={seed}"]

    from deepfm_tpu_torch.launch.preemption import PreemptedError

    launches = backward = 0
    real = loop.MetricLogger
    loop.MetricLogger = SignalAt
    try:
        stopped, lines, fwd, bwd = run_logged(argv("split"))
    finally:
        loop.MetricLogger = real
    launches, backward = launches + fwd, backward + bwd
    if not isinstance(stopped, PreemptedError) or _kind(lines, "preempted") != [
            {"kind": "preempted", "step": TIERED_TASK_STOP}]:
        fail(f"tiered task: the SIGTERM after step {TIERED_TASK_STOP} did not stop the "
             f"run: {stopped!r}")
    resumed, lines, fwd, bwd = run_logged(argv("split"))
    launches, backward = launches + fwd, backward + bwd
    if _kind(lines, "resume") != [{"kind": "resume", "step": TIERED_TASK_STOP}] or \
            resumed.step != task_steps:
        fail(f"tiered task: resume {_kind(lines, 'resume')}, finished at {resumed.step}")
    whole, lines, fwd, bwd = run_logged(argv("whole"))
    launches, backward = launches + fwd, backward + bwd
    done = _kind(lines, "tiered_done")[0]
    if fwd < task_steps or bwd < task_steps or not _kind(lines, "publish_tiered"):
        fail(f"tiered task: {task_steps} steps ran B1 {fwd} and B1' {bwd} times, "
             f"events {[r['kind'] for r in lines]}")
    finals = []
    for name in ("split", "whole"):
        t = TieredTrainer.restore(cfg, os.path.join(workdir, name, "tiered_ckpt"),
                                  virtual=True)
        rest = {k: v.cpu() for k, v in t.state.model.state_dict().items()}
        rest.update({f"{n}.{s}": v.cpu() for n, slots in t.state.optimizer.slots.items()
                     for s, v in slots.items()})
        finals.append((t.export_tables(), rest, t.state.step))
        t.close()
    (ta, ra, sa), (tb, rb, sb) = finals
    err = max(float(np.abs(x[k] - y[k]).max()) for x, y in zip(ta, tb) for k in x)
    err = max(err, max(float((ra[k] - rb[k]).abs().max()) for k in ra))
    if sa != sb or err != 0.0:
        fail(f"tiered task: resumed vs uninterrupted: steps {sa}/{sb}, max abs err {err}")
    out["task"] = {"resume_max_abs_err": err, "step": sa,
                   "examples_per_sec": done["examples_per_sec"],
                   "hit_rate": done["hit_rate"], "stage_bytes": done["stage_bytes"],
                   "writeback_bytes": done["writeback_bytes"],
                   "launches": {"fused_ctr_forward": launches,
                                "fused_ctr_backward": backward}}
    print("tiered task %s" % json.dumps(out["task"]))
    out["launches"] = launches + serve_launches
    out["backward_launches"] = backward
    out["seconds"] = time.perf_counter() - t_phase
    print(f"tiered: phase {out['seconds']:.1f} s")
    return out


# the elastic phase: ELASTIC_SEGMENTS segments of LIFE_BATCH records
# (online_records: each segment's ids distinct), four rank processes on
# the card in a gloo group at [2, 2]; after ELASTIC_SHRINK steps devices 2
# and 3 leave the board (-> [1, 2]), after ELASTIC_GROW two new rank
# processes join (-> [2, 2]).  Commits every ELASTIC_EVERY steps.  The
# script writes the log in three parts and changes the board only while
# the ranks tail an idle log, so each change lands after its step
ELASTIC_SEGMENTS, ELASTIC_SHRINK, ELASTIC_GROW, ELASTIC_EVERY = 12, 4, 8, 4
ELASTIC_IDS = (0, 1, 2, 3, 4, 5)
ELASTIC_JOINERS = (4, 5)
ELASTIC_TIMEOUT_S = 300
# (e): ranks 2 and 3 are killed ELASTIC_KILL_TAIL steps after the commit at
# ELASTIC_SHRINK, under a lease TTL of ELASTIC_KILL_TTL_S
ELASTIC_KILL_TAIL, ELASTIC_KILL_TTL_S = 2, 6.0


def elastic_doc(seed: int, root: str, coord_url: str, lazy: bool, split: bool) -> dict:
    """The phase's config: the flagship width (bf16 MLP 256/128/64,
    fused_kernel "auto", dropout off, L2 1e-4), Adam 5e-4, a global batch
    of LIFE_BATCH, prefer_model_parallel 2, under the coordinator, tailing
    its log until SIGTERM."""
    from deepfm_tpu_torch.launch.cli import resolve_config

    model = resolve_config(list(LIFE_ARGS))[0].to_dict()["model"]
    return {"model": {**model, "feature_size": LIFE_VOCAB, "fused_kernel": "auto",
                      "dropout_keep": [1.0] * len(model["deep_layers"]), "l2_reg": 1e-4},
            "optimizer": {"learning_rate": 5e-4, "lazy_embedding_updates": lazy},
            "data": {"training_data_dir": os.path.join(root, "stream"),
                     "batch_size": LIFE_BATCH},
            "run": {"model_dir": os.path.join(root, "ckpt"),
                    "servable_model_dir": os.path.join(root, "publish"),
                    "checkpoint_every_steps": ELASTIC_EVERY,
                    "online_publish_every_steps": ELASTIC_EVERY, "keep_checkpoints": 10,
                    "online_idle_timeout_secs": 0.0, "seed": seed, "log_steps": 1000},
            "elastic": {"enabled": True, "prefer_model_parallel": 2,
                        "coordinator_url": coord_url, "lease_ttl_secs": 240.0,
                        "heartbeat_interval_secs": 0.5, "registry_debounce_polls": 1,
                        "poll_interval_secs": 0.05, "publisher_split": split,
                        "publish_poll_secs": 0.1}}


def elastic_cli_rank(out: str, release: str, argv: list[str]) -> int:
    """One rank process of the elastic phase, started as ``python -m
    chip_smoke --elastic-rank OUT RELEASE ARGV`` with its own HOME and
    TMPDIR and the launcher's environment (MASTER_ADDR/MASTER_PORT,
    ELASTIC_DEVICE_ID): once the file ``release`` exists ("-": at once) it
    runs ``python -m deepfm_tpu_torch ARGV`` (the online-train task with
    elastic.enabled, run_elastic_train) in this process, its interpreter,
    package and card already up (a warm standby), with two instruments: at
    this rank's first step of each epoch, B1 and B1' on that step's compact
    rows against their plain versions (launches not counted), a
    ``rank_step`` line once each step returned, and, at exit, the kernel
    counts and the trainer's record written to ``out``.  Returns the
    task's exit code."""
    import runpy
    import traceback

    from deepfm_tpu_torch.elastic import controller
    from deepfm_tpu_torch.launch import cli  # noqa: F401  (imported before the release)
    from deepfm_tpu_torch.parallel import spmd

    if DEVICE == "cuda":
        torch.cuda.set_device(0)
        torch.zeros(1, device=DEVICE)
    torch.set_num_threads(2)
    while release != "-" and not os.path.exists(release):
        time.sleep(0.02)
    device_id = int(os.environ["ELASTIC_DEVICE_ID"])
    trainers, steps, checked, kernel_err, check_runs = [], [], set(), [], [0, 0]
    run, train_step = controller.ElasticTrainer.run, spmd.train_step

    def recorded_run(self, *args, **kwargs):
        trainers.append(self)
        state = run(self, *args, **kwargs)
        steps.append(int(state.step))
        return state

    def checked_step(state, batch, ctx):
        epoch = int(trainers[-1]._m_epoch.value)
        if epoch not in checked:  # every rank's first step of the epoch
            checked.add(epoch)
            before = kernel_runs()
            with torch.no_grad():
                ids, vals = state.model.prepare(batch["feat_ids"], batch["feat_vals"])
                w_c, v_c, slot = compact_rows(state, ids)
            kernel_err.append(compact_kernel_errors(w_c, v_c, slot, vals, seed=device_id))
            after = kernel_runs()
            check_runs[0] += after[0] - before[0]
            check_runs[1] += after[1] - before[1]
        metrics = train_step(state, batch, ctx)
        print(json.dumps({"kind": "rank_step", "step": int(state.step)}), flush=True)
        return metrics

    controller.ElasticTrainer.run = recorded_run
    spmd.train_step = checked_step
    reset_kernel_counts()
    sys.argv = ["deepfm_tpu_torch", *argv]
    code, result = 1, {"device_id": device_id, "error": None}
    try:
        runpy.run_module("deepfm_tpu_torch", run_name="__main__", alter_sys=True)
        code = 0
    except SystemExit as e:
        code = e.code if isinstance(e.code, int) else int(e.code is not None)
    except BaseException as e:  # reported by the parent
        result["error"] = f"{type(e).__name__}: {e}\n{traceback.format_exc()}"
    if code and result["error"] is None:
        result["error"] = f"exit code {code}"
    runs = kernel_runs()
    result.update(launches=runs[0] - check_runs[0], backward_launches=runs[1] - check_runs[1],
                  kernel_err=kernel_err)
    if trainers:
        t = trainers[-1]
        result.update(
            step=steps[-1] if steps else None, reshards=t.reshards, left=t.left,
            lineage=[tuple(c) for c in t.cursor_lineage],
            lifecycle=[e["kind"] for e in t.lifecycle],
            step_ms={k: float(np.median(v)) for k, v in t.step_ms.items()},
            drain_commit_ms=t.drain_commit_ms, reform_ms=t.reform_ms,
            metrics=t.metrics_snapshot())
    torch.save(result, out)
    return code


def elastic_reference(cfg, init: dict, batches: list, dps: list, mp: int, lazy: bool):
    """:func:`sharded_reference` over a run whose data-parallel size
    changes between steps (``dps[i]`` for step i): the single-card step on
    the same global batches from the same weights, in each step's grid
    arithmetic.  Returns the final state_dict."""
    from deepfm_tpu_torch.parallel import spmd
    from deepfm_tpu_torch.train.step import (apply_dense, create_train_state, dense_grads,
                                             train_step)

    one = create_train_state(spmd.sharded_model_config(cfg, mp), DEVICE)
    one.model.load_state_dict(init)
    head = one.model.head
    for b, dp in zip(batches, dps):
        batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in b.items()}
        n = batch["label"].shape[0] // dp
        if lazy:
            one.model.head = lambda emb, y_w, y_v, dp=dp, n=n: torch.cat(
                [head(emb[i * n:(i + 1) * n], y_w[i * n:(i + 1) * n], y_v[i * n:(i + 1) * n])
                 for i in range(dp)])
            train_step(one, batch)
            continue
        total = None
        for d in range(dp):
            grads, _ = dense_grads(one, {k: v[d * n:(d + 1) * n] for k, v in batch.items()})
            for k in ("fm_w", "fm_v"):
                grads[k] = grads[k] * mp
            total = grads if total is None else {k: total[k] + g for k, g in grads.items()}
        apply_dense(one, {k: g / dp for k, g in total.items()})
    return {k: v.detach().cpu() for k, v in one.model.state_dict().items()}


class _ElasticJob:
    """An elastic job's services in this process (the rendezvous TCPStore,
    the coordinator over HTTP with lease TTL ``ttl``, the device board
    listing ``ids``) and its rank processes: ``python -m chip_smoke
    --elastic-rank`` (:func:`elastic_cli_rank`) with the online-train
    task's argv and the launcher's environment."""

    def __init__(self, root: str, ids, doc_fn, ttl: float = 240.0):
        import datetime

        import torch.distributed as dist

        from deepfm_tpu_torch.elastic.coord import Coordinator, serve_coordinator
        from deepfm_tpu_torch.elastic.registry import DeviceBoard

        os.makedirs(root, exist_ok=True)
        self.root, self.stream = root, os.path.join(root, "stream")
        self.store = dist.TCPStore("127.0.0.1", 0, is_master=True, wait_for_workers=False,
                                   timeout=datetime.timedelta(seconds=120))
        self.server, url, self.coord = serve_coordinator(Coordinator(
            lease_ttl_secs=ttl, barrier_timeout_secs=0))
        self.board = DeviceBoard(self.store)
        self.board.write(ids)
        self.doc = doc_fn(url)
        self.config = os.path.join(root, "config.json")
        with open(self.config, "w") as f:  # the trainers' config file, as an operator hands it
            json.dump(self.doc, f)
        self.outs = {i: os.path.join(root, f"rank{i}.pt") for i in ELASTIC_IDS}
        self.ranks: dict[int, _Cli] = {}
        self.others: list[_Cli] = []

    def start(self, i: int, release: str = "-") -> None:
        """Start the rank of device ``i``, which waits for the file
        ``release`` ("-": none) before it runs the task."""
        env = {**_pool_env(self.root, f"rank{i}"), "MASTER_ADDR": "127.0.0.1",
               "MASTER_PORT": str(self.store.port), "ELASTIC_DEVICE_ID": str(i)}
        self.ranks[i] = _Cli(f"elastic rank {i}", [
            "--elastic-rank", self.outs[i], release, "--config", self.config, "--task_type",
            "online-train", "--device", DEVICE], self.root, module="chip_smoke", env=env)

    def feed(self, seed: int, lo: int, hi: int) -> None:
        write_online(self.stream, (online_records(seed, s) for s in range(lo, hi)))

    def wait_until(self, what: str, ready) -> None:
        deadline = time.monotonic() + ELASTIC_TIMEOUT_S
        while not ready():
            for r in self.ranks.values():
                if r.proc.poll() not in (None, 0, -signal.SIGKILL):
                    r.fail(f"died while the phase waited for {what}")
            if time.monotonic() > deadline:
                fail(f"elastic: no {what} within {ELASTIC_TIMEOUT_S} s")
            time.sleep(0.05)

    def committed(self, step: int):
        from deepfm_tpu_torch.checkpoint import Checkpointer

        return lambda: (Checkpointer(self.doc["run"]["model_dir"]).latest_step() or 0) >= step

    def epoch_of(self, ids):
        def settled():
            c = self.coord.status()["consensus"]
            return c["phase"] == "steady" and c["devices"] == list(ids)
        return settled

    def stop(self, ids) -> None:
        """SIGTERM the ranks of ``ids``, each of which must then exit 0."""
        for i in ids:
            self.ranks[i].proc.send_signal(signal.SIGTERM)
        for i in ids:
            self.finish(i)

    def finish(self, i: int) -> None:
        if self.ranks[i].finish(timeout=120) != 0:
            self.ranks[i].fail("did not exit 0")

    def close(self) -> None:
        for r in [*self.ranks.values(), *self.others]:
            if r.proc.poll() is None:
                r.proc.kill()
        if self.server is not None:
            self.server.shutdown()
            self.server.server_close()
            self.server = None

    def results(self) -> list:
        """Each rank's record (None for a rank never started or killed)."""
        return [torch.load(self.outs[i], weights_only=False) if os.path.exists(self.outs[i])
                else None for i in ELASTIC_IDS]


def elastic_run(seed: int, root: str, lazy: bool, split: bool) -> dict:
    """One shrink-and-grow run of ELASTIC_SEGMENTS batches through the
    online-train task's command line (and, with ``split``, the publish task
    beside it).  The log comes in three parts; after each part the script
    waits for its last commit, then changes the board (devices 2 and 3 off;
    4 and 5 on, and their rank processes, started with the others, released)
    and waits for the coordinator's new epoch before it writes the next
    part; after the last,
    a SIGTERM ends every rank, which must exit 0, as must ranks 2 and 3
    after they leave.  Returns the ranks' results, the publish task's lines
    and the seconds."""
    job = _ElasticJob(root, [0, 1, 2, 3],
                      lambda url: elastic_doc(seed, root, url, lazy, split))
    publisher = None
    t0 = time.perf_counter()
    try:
        if split:
            publisher = _Cli("elastic publish", [
                "--config", job.config, "--task_type", "publish", "--device", "cpu"], root,
                env=_pool_env(root, "publisher"))
            job.others.append(publisher)
        job.feed(seed, 0, ELASTIC_SHRINK)
        release = os.path.join(root, "release")
        for i in ELASTIC_IDS:
            job.start(i, release if i in ELASTIC_JOINERS else "-")
        job.wait_until(f"commit of step {ELASTIC_SHRINK}", job.committed(ELASTIC_SHRINK))
        job.board.remove(2, 3)
        job.wait_until("the epoch of devices 0 and 1", job.epoch_of([0, 1]))
        for i in (2, 3):
            job.finish(i)
        job.feed(seed, ELASTIC_SHRINK, ELASTIC_GROW)
        job.wait_until(f"commit of step {ELASTIC_GROW}", job.committed(ELASTIC_GROW))
        job.board.add(*ELASTIC_JOINERS)
        open(release, "w").close()
        job.wait_until("the epoch of devices 0, 1, 4 and 5", job.epoch_of([0, 1, 4, 5]))
        job.feed(seed, ELASTIC_GROW, ELASTIC_SEGMENTS)
        job.wait_until(f"commit of step {ELASTIC_SEGMENTS}", job.committed(ELASTIC_SEGMENTS))
        if publisher is not None:
            # it tails until stopped: once it has published the last
            # commit, SIGTERM, after which it must exit 0
            job.wait_until(f"the publish task's publish of step {ELASTIC_SEGMENTS}",
                           lambda: any(r["step"] == ELASTIC_SEGMENTS
                                       for r in publisher.kind("publish")))
            publisher.proc.send_signal(signal.SIGTERM)
            if publisher.finish(timeout=120) != 0:
                publisher.fail("the publish task did not exit 0 after its SIGTERM")
        job.stop((0, 1, *ELASTIC_JOINERS))
    finally:
        job.close()
    seconds = time.perf_counter() - t0
    results = job.results()
    for i, r in zip(ELASTIC_IDS, results):
        if r is None or r["error"] is not None:
            fail(f"elastic: device {i}: {r and r['error']}")
    return {"doc": job.doc, "results": results, "seconds": seconds,
            "publisher": publisher.lines if publisher is not None else None}


def elastic_kill_standby(seed: int, root: str) -> _ElasticJob:
    """(e)'s job: the dense run's config with a lease TTL of
    ELASTIC_KILL_TTL_S, its four ranks started as warm standbys (released
    by :func:`elastic_kill`, so their start overlaps (a) and (b))."""
    def doc_fn(url):
        doc = elastic_doc(seed, root, url, False, False)
        doc["elastic"]["lease_ttl_secs"] = ELASTIC_KILL_TTL_S
        return doc

    job = _ElasticJob(root, [0, 1, 2, 3], doc_fn, ttl=ELASTIC_KILL_TTL_S)
    for i in (0, 1, 2, 3):
        job.start(i, os.path.join(root, "release"))
    return job


def elastic_kill(seed: int, job: _ElasticJob) -> dict:
    """(e) A death without notice, on the standby job at [2, 2]: after
    ELASTIC_SHRINK committed steps and ELASTIC_KILL_TAIL more, ranks 2 and
    3 are SIGKILLed while the board still lists them.  Their leases
    expire, the survivors' next agreement fails, the coordinator opens
    [1, 2] without their devices, and the survivors resume from the
    commit, replaying the tail once: one reshard with ELASTIC_KILL_TAIL
    steps replayed, a strictly increasing lineage of every step once, and
    the final tables and MLP equal to the single-card reference in each
    step's grid arithmetic on that lineage."""
    from deepfm_tpu_torch.core.config import Config
    from deepfm_tpu_torch.elastic.mpmd import read_payload_tree
    from deepfm_tpu_torch.online.stream import EventLogReader, open_tail

    steps = ELASTIC_SHRINK + ELASTIC_KILL_TAIL
    t0 = time.perf_counter()
    try:
        job.feed(seed, 0, steps)
        open(os.path.join(job.root, "release"), "w").close()
        for i in (0, 1, 2, 3):  # every rank's step `steps` done, so none is inside it
            job.ranks[i].wait_for("rank_step", steps, timeout=ELASTIC_TIMEOUT_S)
        t_kill = time.perf_counter()
        for i in (2, 3):
            job.ranks[i].proc.kill()
        job.wait_until("the epoch of devices 0 and 1", job.epoch_of([0, 1]))
        detect_s = time.perf_counter() - t_kill
        for i in (0, 1):
            job.ranks[i].wait_for("rank_step", 2 * steps - ELASTIC_SHRINK,
                                  timeout=ELASTIC_TIMEOUT_S)
        job.stop((0, 1))
    finally:
        job.close()
    seconds = time.perf_counter() - t0
    results = job.results()
    if results[2] is not None or results[3] is not None:
        fail("elastic kill: a killed rank wrote its record")
    for r in results[:2]:
        if r is None or r["error"] is not None:
            fail(f"elastic kill: device {r and r['device_id']}: {r and r['error']}")
        shapes = [(x["from_mesh"], x["to_mesh"], x["steps_replayed"], x["resume_step"])
                  for x in r["reshards"]]
        if shapes != [([2, 2], [1, 2], ELASTIC_KILL_TAIL, ELASTIC_SHRINK)] or r["step"] != steps:
            fail(f"elastic kill: device {r['device_id']}: reshards {shapes}, step {r['step']}")
        if not {"group_failed", "drain_commit_failed"} <= set(r["lifecycle"]):
            fail(f"elastic kill: device {r['device_id']}: lifecycle {r['lifecycle']}")
        lineage = r["lineage"]
        if len(lineage) != steps or not all(a < b for a, b in zip(lineage, lineage[1:])):
            fail(f"elastic kill: cursor lineage of {len(lineage)}: {lineage}")
    cfg = Config.from_dict(job.doc)
    reader = EventLogReader(open_tail(job.stream), field_size=cfg.model.field_size,
                            batch_size=LIFE_BATCH)
    batches = [b for b, _ in reader.batches(follow=False)]
    init = read_payload_tree(job.doc["run"]["model_dir"], step=0)[1]["model"]
    final = read_payload_tree(job.doc["run"]["model_dir"], step=steps)[1]["model"]
    ref = elastic_reference(cfg, {k: v.clone() for k, v in init.items()}, batches,
                            [2] * ELASTIC_SHRINK + [1] * ELASTIC_KILL_TAIL, 2, False)
    rel = 0.0
    for name, w in ref.items():
        e, scale = float((final[name].float() - w.float()).abs().max()), float(w.abs().max())
        if not e <= TOL_GRAD_REL * scale:
            fail(f"elastic kill: {name} after {steps} steps: max abs err {e}, scale {scale}")
        rel = max(rel, e / scale if scale else e)
    r0 = results[0]
    return {"reshard_s": r0["reshards"][0]["wall_secs"], "kill_to_epoch_s": detect_s,
            "ttl_s": ELASTIC_KILL_TTL_S, "steps_replayed": ELASTIC_KILL_TAIL,
            "max_rel_err": rel, "seconds": seconds,
            "launches": sum(r["launches"] for r in results[:2]),
            "backward_launches": sum(r["backward_launches"] for r in results[:2])}


def check_elastic_run(run: dict, lazy: bool) -> dict:
    """(a)'s checks on one run: the reshards, the lineage, the manifests,
    the kernels at each epoch, and the final tables and MLP against
    elastic_reference within TOL_GRAD_REL of each tensor's largest
    magnitude."""
    from deepfm_tpu_torch.core.config import Config
    from deepfm_tpu_torch.elastic.mpmd import read_payload_tree
    from deepfm_tpu_torch.online import list_versions, read_manifest
    from deepfm_tpu_torch.online.stream import EventLogReader, open_tail

    doc, results = run["doc"], run["results"]
    tag = "lazy" if lazy else "dense"
    r0 = results[0]
    shapes = [(r["from_mesh"], r["to_mesh"]) for r in r0["reshards"]]
    if shapes != [([2, 2], [1, 2]), ([1, 2], [2, 2])]:
        fail(f"elastic {tag}: reshards {shapes}")
    if not (r0["reshards"][0]["moved_bytes"] == 0 < r0["reshards"][1]["moved_bytes"]) \
            or any(r["steps_replayed"] for r in r0["reshards"]):
        fail(f"elastic {tag}: reshards %s" % json.dumps(r0["reshards"]))
    lineage = r0["lineage"]
    if len(lineage) != ELASTIC_SEGMENTS or not all(a < b for a, b in zip(lineage, lineage[1:])):
        fail(f"elastic {tag}: cursor lineage of {len(lineage)}: {lineage}")
    if [r["left"] for r in results] != [i in (2, 3) for i in ELASTIC_IDS]:
        fail(f"elastic {tag}: left {[r['left'] for r in results]}")
    pub = doc["run"]["servable_model_dir"]
    versions = list_versions(pub)
    manifests = [read_manifest(pub, v) for v in versions]
    if len(versions) < 2 or any(m.feature_size != LIFE_VOCAB for m in manifests):
        fail(f"elastic {tag}: manifests {[(m.version, m.feature_size) for m in manifests]}")
    err = {"emb": 0.0, "y_w": 0.0, "y_v": 0.0, "backward": 0.0}
    epochs = 0
    for r in results:
        for e in r["kernel_err"]:
            epochs += 1
            (emb, _), (y_w, sw), (y_v, sv) = e["forward"]
            if not (emb <= TOL_EMB and y_w <= TOL_YW_REL * (1.0 + sw)
                    and y_v <= TOL_YV_REL * (1.0 + sv)):
                fail(f"elastic {tag}: fused_ctr_forward on a rank's compact rows: {e}")
            for b_err, scale in e["backward"]:
                if not b_err <= TOL_GRAD_REL * scale:
                    fail(f"elastic {tag}: fused_ctr_backward on a rank's compact rows: {e}")
            err.update(emb=max(err["emb"], emb), y_w=max(err["y_w"], y_w),
                       y_v=max(err["y_v"], y_v),
                       backward=max(err["backward"], *(x for x, _ in e["backward"])))
    if DEVICE == "cuda" and any(r["launches"] < 1 or r["backward_launches"] < 1
                                for r in results):
        fail(f"elastic {tag}: B1/B1' launches by rank "
             f"{[(r['launches'], r['backward_launches']) for r in results]}")
    cfg = Config.from_dict(doc)
    reader = EventLogReader(open_tail(doc["data"]["training_data_dir"]),
                            field_size=cfg.model.field_size, batch_size=LIFE_BATCH)
    batches = [b for b, _ in reader.batches(follow=False)]
    dps = [2] * ELASTIC_SHRINK + [1] * (ELASTIC_GROW - ELASTIC_SHRINK) \
        + [2] * (ELASTIC_SEGMENTS - ELASTIC_GROW)
    init = read_payload_tree(doc["run"]["model_dir"], step=0)[1]["model"]
    final = read_payload_tree(doc["run"]["model_dir"], step=ELASTIC_SEGMENTS)[1]["model"]
    ref = elastic_reference(cfg, {k: v.clone() for k, v in init.items()}, batches, dps, 2,
                            lazy)
    rel = {}
    for name, w in ref.items():
        e, scale = float((final[name].float() - w.float()).abs().max()), float(w.abs().max())
        if not e <= TOL_GRAD_REL * scale:
            fail(f"elastic {tag}: {name} after {ELASTIC_SEGMENTS} steps: max abs err {e}, "
                 f"scale {scale}")
        rel[name] = e / scale if scale else e
    return {"launches": sum(r["launches"] for r in results),
            "backward_launches": sum(r["backward_launches"] for r in results),
            "max_rel_err": max(rel.values()), "kernel_err": err, "epochs_checked": epochs,
            "versions": len(versions), "manifests": manifests}


def elastic_publish_checks(run: dict) -> dict:
    """(b): the publish task exited 0, published at least 2 versions, and
    each published step's param_hash equals the hash of that commit read
    here; a commit and a publish with a token under the roots' marks are
    refused."""
    from deepfm_tpu_torch.checkpoint import Checkpointer
    from deepfm_tpu_torch.convert import params_to_jax
    from deepfm_tpu_torch.core.config import Config
    from deepfm_tpu_torch.elastic import coord
    from deepfm_tpu_torch.elastic.mpmd import read_payload_tree, servable_from_payload
    from deepfm_tpu_torch.online import ModelPublisher, list_versions, read_manifest
    from deepfm_tpu_torch.online.publisher import param_tree_hash
    from deepfm_tpu_torch.online.stream import StreamCursor
    from deepfm_tpu_torch.online.trainer import commit_payload
    from deepfm_tpu_torch.train.step import create_train_state

    doc = run["doc"]
    cfg = Config.from_dict(doc)
    model_dir, pub = doc["run"]["model_dir"], doc["run"]["servable_model_dir"]
    published = [read_manifest(pub, v) for v in list_versions(pub)]
    if len(published) < 2:
        fail(f"elastic publish: {len(published)} versions published")
    for m in published:
        _, tree = read_payload_tree(model_dir, step=m.step)
        sd, _ = servable_from_payload(cfg, tree)
        want = param_tree_hash(*params_to_jax(sd, cfg.model))
        if m.param_hash != want or "fence_token" not in m.extra:
            fail(f"elastic publish: version {m.version} (step {m.step}) hash "
                 f"{m.param_hash[:12]}, the commit's {want[:12]}")
    refused = {}
    state = create_train_state(cfg, "cpu")
    marks = {"model_dir": coord.read_fence(model_dir), "publish": coord.read_fence(pub)}
    for root, attempt in (
            ("model_dir", lambda: commit_payload(
                Checkpointer(model_dir), state, StreamCursor("x", 1),
                fence=coord.Fence(model_dir, marks["model_dir"] - 1))),
            ("publish", lambda: ModelPublisher(pub).publish(
                cfg, state.model.state_dict(), step=99,
                fence=coord.Fence(pub, marks["publish"] - 1)))):
        try:
            attempt()
            fail(f"elastic publish: a token under {root}'s mark {marks[root]} was not "
                 f"refused")
        except coord.StaleFencingTokenError:
            refused[root] = marks[root]
    lags = [r["lag_s"] for r in run["publisher"] if r["kind"] == "publish"]
    return {"versions": len(published), "steps": [m.step for m in published],
            "stale_refused_at_marks": refused, "lag_s": lags}


def elastic_remote(seed: int, root: str, life_dir: str) -> dict:
    """(c): the lifecycle's dense train task with ``--model_dir`` on the
    port's dev store (a URL): SIGTERMed after LIFE_STOP, resumed, held bit
    for bit to an uninterrupted local run; every remote step with its
    marker; then one save of the final state to the store and one restore
    from it into a fresh process-like staging directory, timed."""
    from deepfm_tpu_torch.checkpoint import RemoteCheckpointer
    from deepfm_tpu_torch.data.object_store import get_store
    from deepfm_tpu_torch.launch.cli import resolve_config
    from deepfm_tpu_torch.launch.preemption import PreemptedError
    from deepfm_tpu_torch.train import loop
    from deepfm_tpu_torch.train.step import create_train_state
    from deepfm_tpu_torch.utils.dev_object_store import serve
    from deepfm_tpu_torch.utils.logging import MetricLogger

    server, base = serve(os.path.join(root, "store"))
    url = f"{base}/bucket/run"

    class SignalAt(MetricLogger):
        def step(self, step, *a, **kw):
            super().step(step, *a, **kw)
            if step == LIFE_STOP:
                os.kill(os.getpid(), signal.SIGTERM)

    def argv(model_dir: str) -> list[str]:
        return ["--task_type", "train", "--training_data_dir", life_dir,
                "--model_dir", model_dir, "--num_epochs", "1", "--log_steps", str(LOG_STEPS),
                "--checkpoint_every_steps", str(LIFE_EVERY), "--set", "model.fused_kernel=auto",
                "--set", f"run.seed={seed}", *LIFE_ARGS]

    try:
        real = loop.MetricLogger
        loop.MetricLogger = SignalAt
        try:
            stopped, _, fwd, bwd = run_logged(argv(url))
        finally:
            loop.MetricLogger = real
        if not isinstance(stopped, PreemptedError):
            fail(f"elastic remote: the SIGTERM after step {LIFE_STOP} did not stop the run")
        resumed, lines, fwd2, bwd2 = run_logged(argv(url))
        whole, _, fwd3, bwd3 = run_logged(argv(os.path.join(root, "local")))
        got, want = state_tensors(resumed), state_tensors(whole)
        err = max(float((got[k].float() - want[k].float()).abs().max()) for k in want)
        if got.keys() != want.keys() or err != 0.0 or resumed.step != LIFE_STEPS \
                or _kind(lines, "resume") != [{"kind": "resume", "step": LIFE_STOP}]:
            fail(f"elastic remote: resumed vs uninterrupted max abs err {err}, step "
                 f"{resumed.step}, events {_kind(lines, 'resume')}")
        listed = get_store().list_prefix(url + "/")
        steps = sorted(int(u.rsplit("_", 1)[-1]) for u in listed if "/_COMMIT_" in u)
        if steps != [LIFE_EVERY, LIFE_STOP, 2 * LIFE_EVERY, LIFE_STEPS][-3:] \
                or any(f"{url}/{s}/state.pt" not in listed for s in steps):
            fail(f"elastic remote: committed steps {steps}")
        timed = RemoteCheckpointer(f"{url}-timed", staging_dir=os.path.join(root, "stage1"))
        t0 = time.perf_counter()
        timed.save(resumed, block=True)
        save_ms = 1e3 * (time.perf_counter() - t0)
        timed.close()
        fresh = create_train_state(resolve_config(argv(url))[0], DEVICE)
        t0 = time.perf_counter()
        RemoteCheckpointer(f"{url}-timed", staging_dir=os.path.join(root, "stage2")).restore(fresh)
        restore_ms = 1e3 * (time.perf_counter() - t0)
        if any(not torch.equal(a, b) for a, b in zip(state_tensors(fresh).values(),
                                                     state_tensors(resumed).values())):
            fail("elastic remote: the timed restore differs from the saved state")
    finally:
        server.shutdown()
        server.server_close()
    return {"resume_max_abs_err": err, "remote_steps": steps, "save_ms": save_ms,
            "restore_ms": restore_ms, "launches": fwd + fwd2 + fwd3,
            "backward_launches": bwd + bwd2 + bwd3}


def elastic_restore_rank(rank: int, world: int, store: str, out: str, jobs: list) -> None:
    """(d) on a rank of a [1, world] gloo group on the card: restore the
    [1, 2] commit into a fresh state, its device memory rise measured."""
    import torch.distributed as dist

    if DEVICE == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        results = [elastic_restore_once(job, out) for job in jobs]
        torch.save(results, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def elastic_restore_once(job: dict, out: str) -> dict:
    """One restore of (d) in this process (a rank of the group, or the one
    card without one): this rank's local state after the restore, its
    window, and the memory rise against its shard state."""
    from deepfm_tpu_torch.checkpoint import Checkpointer
    from deepfm_tpu_torch.core.config import Config
    from deepfm_tpu_torch.parallel import spmd
    from deepfm_tpu_torch.parallel.mesh import initialize_distributed
    from deepfm_tpu_torch.train.step import create_train_state

    cfg = Config.from_dict(job["cfg"])
    if cfg.mesh.model_parallel > 1:
        ctx = initialize_distributed(cfg.mesh, DEVICE)
        fresh = spmd.create_dp_train_state(cfg, ctx)
    else:
        fresh = create_train_state(cfg, DEVICE)
    local = spmd.local_state(fresh)
    shard = sum(t.numel() * t.element_size() for k, t in _flat_tensors(local).items()
                if {"fm_w", "fm_v"} & set(k.split(".")))
    cuda = DEVICE == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() if cuda else 0
    t0 = time.perf_counter()
    Checkpointer(job["dir"], ctx=ctx if cfg.mesh.model_parallel > 1 else None).restore(
        fresh, step=job["step"])
    if cuda:
        torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - base if cuda else None
    sh = fresh.sharding
    return {"local": _flat_tensors(spmd.local_state(fresh), cpu=True),
            "offset": sh.offset if sh is not None and sh.mp > 1 else 0,
            "shard_bytes": shard, "rise": rise, "seconds": time.perf_counter() - t0}


def _flat_tensors(tree, path: str = "", cpu: bool = False) -> dict:
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat_tensors(v, f"{path}.{k}", cpu).items()}
    if isinstance(tree, torch.Tensor):
        return {path: tree.detach().cpu().clone() if cpu else tree}
    return {}


def elastic_reshard_restore(seed: int, root: str, run: dict) -> dict:
    """(d): the dense run's [1, 2] commit (the drain at ELASTIC_GROW)
    restored at [1, 4] (four gloo ranks) and at [1, 1] (here): every
    rank's tables, slots and moments equal the commit's rows at its window
    bit for bit, and its device memory rose no more than its shard state +
    SHARD_CKPT_SLACK_BYTES in the restore."""
    import torch.multiprocessing as tmp

    from deepfm_tpu_torch.checkpoint import reshard
    from deepfm_tpu_torch.checkpoint.ckpt import STATE_FILE

    model_dir = run["doc"]["run"]["model_dir"]
    step_dir = os.path.join(model_dir, str(ELASTIC_GROW))
    payload = torch.load(os.path.join(step_dir, STATE_FILE), weights_only=True, mmap=True)
    if payload["grid"] != [1, 2]:
        fail(f"elastic reshard restore: step {ELASTIC_GROW} was written at {payload['grid']}")
    whole = {p: torch.cat([t for _, t in sorted(srcs, key=lambda x: x[0])])
             for p, srcs in reshard._leaf_sources(payload, step_dir).items()}

    def local_key(path: tuple) -> str:
        """A table leaf's path in ``_flat_tensors(spmd.local_state(...))``."""
        if path[0] == "optimizer":
            return f".optimizer.slots.{path[1]}.{path[2]}"
        return "." + ".".join(path)

    def doc(mp: int) -> dict:
        d = {**run["doc"], "mesh": {"data_parallel": 1, "model_parallel": mp}}
        return {**d, "run": {**d["run"], "seed": seed + 3}}

    out_dir = os.path.join(root, "restore14")
    os.makedirs(out_dir, exist_ok=True)
    job = {"dir": model_dir, "step": ELASTIC_GROW}
    ctx = tmp.start_processes(elastic_restore_rank, args=(
        4, os.path.join(root, "store14"), out_dir, [{**job, "cfg": doc(4)}]), nprocs=4,
        join=False, start_method="spawn")
    deadline = time.monotonic() + 300
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                fail("elastic reshard restore: the [1, 4] ranks did not end within 300 s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)[0]
             for r in range(4)]
    one = elastic_restore_once({**job, "cfg": doc(1)}, root)
    line = {}
    for grid, results in (("1x4", ranks), ("1x1", [one])):
        for i, r in enumerate(results):
            for path, rows in whole.items():
                k = local_key(path)
                t = r["local"][k]
                want = torch.zeros_like(t)
                n = max(0, min(t.shape[0], rows.shape[0] - r["offset"]))
                want[:n] = rows[r["offset"]:r["offset"] + n]
                if not torch.equal(t, want):
                    fail(f"elastic reshard restore at {grid}: rank {i} {k} differs from "
                         f"the commit's rows")
            if DEVICE == "cuda" and r["rise"] > r["shard_bytes"] + SHARD_CKPT_SLACK_BYTES:
                fail(f"elastic reshard restore at {grid}: rank {i}'s device memory rose "
                     f"{r['rise']} bytes, over its shard state of {r['shard_bytes']} + "
                     f"{SHARD_CKPT_SLACK_BYTES}")
        line[grid] = {"rise_bytes": [r["rise"] for r in results],
                      "shard_state_bytes": [r["shard_bytes"] for r in results],
                      "seconds": [r["seconds"] for r in results]}
    return line


def phase_elastic(seed: int, workdir: str, card: str, life_dir: str) -> dict:
    """The elastic phase (module docstring): (a) shrink and grow, dense
    with inline publishes; (a)+(b) the same with lazy Adam and
    ``elastic.publisher_split``, a ``--task_type publish`` process
    publishing; (c) the train task on a URL model_dir; (d) the dense run's
    [1, 2] commit restored at [1, 4] and [1, 1]; (e) two ranks killed
    without notice.  One ``elastic`` line."""
    t0 = time.perf_counter()
    runs, checks = {}, {}
    standby = elastic_kill_standby(seed, os.path.join(workdir, "kill"))
    try:
        for tag, lazy, split in (("dense", False, False), ("lazy", True, True)):
            runs[tag] = elastic_run(seed, os.path.join(workdir, tag), lazy, split)
            checks[tag] = check_elastic_run(runs[tag], lazy)
        publish = elastic_publish_checks(runs["lazy"])
        kill = elastic_kill(seed, standby)
    finally:
        standby.close()
    remote = elastic_remote(seed, os.path.join(workdir, "remote"), life_dir)
    restore = elastic_reshard_restore(seed, os.path.join(workdir, "restore"), runs["dense"])
    seconds = time.perf_counter() - t0
    r0 = {tag: run["results"][0] for tag, run in runs.items()}
    line = {
        "card": card, "grid": "[2, 2] -> [1, 2] -> [2, 2], gloo ranks on one card",
        "reshards": {tag: [{k: r[k] for k in ("from_mesh", "to_mesh", "moved_bytes",
                                              "kept_bytes", "steps_replayed", "wall_secs")}
                           for r in r0[tag]["reshards"]] for tag in runs},
        "reshard_s": {tag: [r["wall_secs"] for r in r0[tag]["reshards"]] for tag in runs},
        "drain_commit_ms": {tag: r0[tag]["drain_commit_ms"] for tag in runs},
        "group_reform_ms": {tag: r0[tag]["reform_ms"] for tag in runs},
        "step_host_ms": {tag: r0[tag]["step_ms"] for tag in runs},
        "max_rel_err_vs_single_card": {tag: checks[tag]["max_rel_err"] for tag in runs},
        "tolerance": TOL_GRAD_REL,
        "kernel_vs_plain_max_abs_err": {tag: checks[tag]["kernel_err"] for tag in runs},
        "epochs_kernel_checked": {tag: checks[tag]["epochs_checked"] for tag in runs},
        "launches": {**{tag: [checks[tag]["launches"], checks[tag]["backward_launches"]]
                        for tag in runs}, "kill": [kill["launches"], kill["backward_launches"]]},
        "death_without_notice": {k: v for k, v in kill.items() if "launches" not in k},
        "publisher": publish, "remote": {k: remote[k] for k in (
            "resume_max_abs_err", "remote_steps", "save_ms", "restore_ms")},
        "reshard_restore": restore,
        "run_s": {tag: run["seconds"] for tag, run in runs.items()},
        "seconds": seconds}
    print("elastic %s" % json.dumps(line))
    return {"launches": sum(c["launches"] for c in checks.values()) + kill["launches"]
            + remote["launches"],
            "backward_launches": sum(c["backward_launches"] for c in checks.values())
            + kill["backward_launches"] + remote["backward_launches"],
            "max_abs_err": max(max(c["kernel_err"]["emb"], c["kernel_err"]["y_w"],
                                   c["kernel_err"]["y_v"]) for c in checks.values()),
            "backward_max_abs_err": max(c["kernel_err"]["backward"] for c in checks.values()),
            "seconds": seconds}


# the stream phase (20): the train phase's first STREAM_FILES training files
# (STREAM_FILES x 12,288 records: STREAM_FILES * 12 batches a route) and its
# validation file, read (a) as S3 channels from the port's dev object store
# (a subprocess on localhost) through FifoBridge into the C++ reader, and (b)
# in Pipe mode from FIFOs that writer threads fill; (c) the two runs' weights
# served from a URL publish root.  Every FIFO open, write and join, and the
# store's start, wait at most STREAM_DEADLINE_S.
STREAM_FILES, STREAM_SHUFFLE, STREAM_DEADLINE_S = 3, 8192, 60.0
STREAM_BUCKETS = (8, 64)
# the S3 run against the same files read from disk: the batches are
# byte-equal, but B1''s float atomics add a hot row's terms (the 13 numeric
# ids of every record, the generator's Zipf ids) in an order that changes
# from run to run (csrc/fused_ctr.cu), and Adam carries the last bits into
# the weights, so no two runs' final losses are bit-equal, not even two of
# one route.  The phase runs the disk route twice and the S3 route once and
# holds the disk-vs-disk and the S3-vs-disk differences of the final train
# loss, the final eval loss (relative) and the final eval AUC (absolute) to
# these limits: twice the largest gap of 28 disk/disk and 28 S3/S3 pairs
# that scripts/stream_route_spread.py --repeats 8 read on an "NVIDIA H100
# 80GB HBM3, 700.00 W" (loss 1.65e-4, eval loss 3.63e-5, AUC 5.05e-4;
# S3/disk at most 1.72e-4, 3.85e-5, 5.82e-4), rounded up (PERF.md, PR 16)
TOL_ROUTE = {"loss": 4e-4, "eval_loss": 8e-5, "eval_auc": 2e-3}


def _join_writer(writer, what: str):
    """``writer.join()`` (utils/channel_writer.py), a failure of the phase."""
    try:
        return writer.join()
    except BaseException as e:
        fail(f"stream: {what}: the channel writer of {writer.path}: {e}")


def start_dev_store(workdir: str):
    """``python -m deepfm_tpu_torch.utils.dev_object_store`` on a free
    localhost port, in its own process with its own HOME and TMPDIR;
    returns (process, base URL) once it lists its bucket."""
    root = os.path.join(workdir, "store_root")
    os.makedirs(os.path.join(root, "bucket"))
    port = _free_port()
    env = dict(os.environ, **_pool_env(workdir, "store"), PYTHONPATH=os.pathsep.join(
        [ROOT, *filter(None, [os.environ.get("PYTHONPATH")])]))
    with open(os.path.join(workdir, "store.log"), "w") as log:
        proc = subprocess.Popen([sys.executable, "-m", "deepfm_tpu_torch.utils.dev_object_store",
                                 "--root", root, "--port", str(port)], cwd=ROOT, env=env,
                                stdout=log, stderr=subprocess.STDOUT)
    base = f"http://127.0.0.1:{port}"
    deadline = time.monotonic() + STREAM_DEADLINE_S
    while True:
        try:
            with urllib.request.urlopen(f"{base}/bucket?list-type=2", timeout=2) as r:
                r.read()
            return proc, base
        except OSError:
            if proc.poll() is not None or time.monotonic() > deadline:
                proc.kill()
                proc.wait(timeout=30)
                with open(os.path.join(workdir, "store.log")) as f:
                    fail(f"stream: the dev object store did not start: {f.read()[-2000:]}")
            time.sleep(0.1)


def _same_batches(got: list, want: list, what: str) -> int:
    if len(got) != len(want) or not got:
        fail(f"stream: {what}: {len(got)} batches against {len(want)}")
    for i, (a, b) in enumerate(zip(got, want)):
        for k in ("feat_ids", "feat_vals", "label"):
            if a[k].dtype != b[k].dtype or a[k].tobytes() != b[k].tobytes():
                fail(f"stream: {what}: batch {i}'s {k} is not byte-equal")
    return len(got)


def _route_run(argv: list[str], what: str, records: int, val_records: int) -> dict:
    """The train task through ``run_logged``: its steps must be ``records``
    over the batch, B1 and B1' launched every step, the final eval over
    ``val_records`` examples."""
    state, lines, fwd, bwd = run_logged(argv)
    done, evals = _kind(lines, "train_done"), _kind(lines, "eval")
    steps = records // LIFE_BATCH
    if not done or done[0]["steps"] != steps or state.step != steps:
        fail(f"stream: {what}: {done} against {steps} steps")
    if not evals or evals[-1]["examples"] != val_records:
        fail(f"stream: {what}: final eval {evals}, not {val_records} examples")
    if fwd < steps or bwd < steps:
        fail(f"stream: {what}: {steps} steps launched fused_ctr_forward {fwd} and "
             f"fused_ctr_backward {bwd} times")
    train = _kind(lines, "train")
    if not train or not all(np.isfinite(r["loss"]) for r in train):
        fail(f"stream: {what}: a logged loss is not finite: {train}")
    return {"state": state, "done": done[0], "eval": evals[-1], "loss": train[-1]["loss"],
            "launches": fwd, "backward_launches": bwd}


def route_argv(seed: int, data: str, model_dir: str, servable: str) -> list[str]:
    """The stream phase's train task over the files or objects under
    ``data`` (its training and validation records), one epoch at the
    flagship width with the record shuffle."""
    return ["--task_type", "train", "--training_data_dir", data, "--val_data_dir", data,
            "--model_dir", model_dir, "--servable_model_dir", servable,
            "--num_epochs", "1", "--log_steps", str(LOG_STEPS),
            "--set", "model.fused_kernel=auto", "--set", f"run.seed={seed}",
            "--set", f"data.shuffle_buffer={STREAM_SHUFFLE}", *LIFE_ARGS]


def upload_route_files(store, prefix: str, local: str, files: list, val: str) -> float:
    """``files`` as ``prefix/tr-<i>.tfrecords`` and ``val`` as
    ``prefix/va-0.tfrecords`` in the store, and linked under the same names
    in the directory ``local``; returns the upload's seconds."""
    os.makedirs(local)
    t0 = time.perf_counter()
    for name, path in [*((f"tr-{i}.tfrecords", f) for i, f in enumerate(files)),
                       ("va-0.tfrecords", val)]:
        with open(path, "rb") as f:
            store.put(f"{prefix}/{name}", f.read())
        os.symlink(path, os.path.join(local, name))
    return time.perf_counter() - t0


def route_diffs(a: dict, b: dict) -> dict:
    """Two route runs' (``_route_run``) final train and eval losses apart,
    relative to ``b``'s, and their final eval AUCs apart."""
    return {"loss": abs(a["loss"] - b["loss"]) / abs(b["loss"]),
            "eval_loss": abs(a["eval"]["loss"] - b["eval"]["loss"]) / abs(b["eval"]["loss"]),
            "eval_auc": abs(a["eval"]["auc"] - b["eval"]["auc"])}


def _kernel_check(model, batch: dict, seed: int, tag: str) -> dict:
    """B1 and B1' against their plain versions on ``batch``'s lookups of
    ``model``'s tables (compact_kernel_check)."""
    ids, vals = model.prepare(torch.from_numpy(batch["feat_ids"]).to(DEVICE),
                              torch.from_numpy(batch["feat_vals"]).to(DEVICE))
    row = compact_kernel_check(model.fm_w.detach(), model.fm_v.detach(), ids, vals, seed, tag)
    return {"forward_max_abs_err": max(row["forward_max_abs_err"]),
            "backward_max_abs_err": max(row["backward_max_abs_err"])}


def stream_s3(seed: int, workdir: str, base: str, files: list, val: str) -> dict:
    """(a) S3 channels: the files uploaded under one prefix; one epoch of
    the URL route's batches (FifoBridge, the C++ readers, the record
    shuffle), its first GET of tr-1 cut at half by the store (a dropped
    connection, resumed), byte-equal to the same files' from disk; the
    train task from disk, then from the prefix into a URL model_dir; the
    eval task over that checkpoint and the validation file from disk;
    the infer task's pred.txt in the store against the plain forward of
    the exported weights."""
    from deepfm_tpu_torch.core.config import DataConfig
    from deepfm_tpu_torch.data import object_store
    from deepfm_tpu_torch.data.pipeline import make_input_pipeline
    from deepfm_tpu_torch.serve.export import load_model

    store = object_store.get_store()
    prefix, local = f"{base}/bucket/s3", os.path.join(workdir, "s3_local")
    upload_s = upload_route_files(store, prefix, local, files, val)
    records = len(files) * TRAIN_RECORDS_PER_FILE
    bridges: dict[str, list] = {"compare": [], "train": []}
    counting = bridges["compare"]

    class Counted(object_store.FifoBridge):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            counting.append(self)

    def counted(key: str) -> dict:
        return {"bridges": len(bridges[key]), "bytes": sum(b.bytes for b in bridges[key]),
                "resumes": sum(b.resumes for b in bridges[key])}

    cfg = DataConfig(batch_size=LIFE_BATCH, shuffle_buffer=STREAM_SHUFFLE, num_epochs=1)
    servable = os.path.join(workdir, "servable_s3")
    # the compared read's first GET of tr-1 is cut at half (a dropped
    # connection): its bridge resumes it, and the batches stay byte-equal
    post(f"{base}/__faults__", json.dumps({"rules": [{
        "verb": "GET", "key": "bucket/s3/tr-1.tfrecords", "times": 1,
        "truncate": 0.5}]}).encode())
    saved, object_store.FifoBridge = object_store.FifoBridge, Counted
    try:
        url_batches = list(make_input_pipeline(cfg, field_size=39, data_dir=prefix, seed=seed))
        fired = get(f"{base}/__faults__")["fired_total"]
        # the disk runs first: neither route's run is the phase's first
        disk = [_route_run(route_argv(seed, local, os.path.join(workdir, f"model_disk{i}"),
                                      os.path.join(workdir, f"servable_disk{i}")),
                           f"disk train {i}", records, VAL_RECORDS) for i in range(2)]
        counting = bridges["train"]
        s3 = _route_run(route_argv(seed, prefix, f"{base}/bucket/model_s3", servable),
                        "S3 train", records, VAL_RECORDS)
    finally:
        object_store.FifoBridge = saved
    n = _same_batches(url_batches, list(make_input_pipeline(
        cfg, field_size=39, data_dir=local, seed=seed)), "the URL route against disk")
    if fired != 1 or counted("compare")["resumes"] != 1:
        fail(f"stream: the cut GET fired {fired} times, the bridges resumed "
             f"{counted('compare')['resumes']}")
    diffs = {"disk_vs_disk": route_diffs(disk[1], disk[0]),
             "s3_vs_disk": route_diffs(s3, disk[0])}
    over = [f"{pair} {k} {v}" for pair, d in diffs.items() for k, v in d.items()
            if not v <= TOL_ROUTE[k]]
    if over:
        fail(f"stream: route runs apart past TOL_ROUTE {TOL_ROUTE}: {over}")
    # the S3 run's checkpoint, restored from the store, over the validation
    # file from disk: its final eval (which read va-0 through a bridge) exactly
    model_args = ["--model_dir", f"{base}/bucket/model_s3", "--set", "model.fused_kernel=auto",
                  *LIFE_ARGS]
    again, _, fwd_e, _ = run_logged(["--task_type", "eval", "--val_data_dir", local,
                                     *model_args])
    if (again["auc"], again["loss"], again["examples"]) != (
            s3["eval"]["auc"], s3["eval"]["loss"], s3["eval"]["examples"]):
        fail(f"stream: the S3 checkpoint's eval over the disk file {again} is not the S3 "
             f"run's final eval {s3['eval']}")
    # the infer task: va* under the prefix, pred.txt into the store
    out, _, fwd, _ = run_logged(["--task_type", "infer", "--test_data_dir", prefix,
                                 *model_args])
    if out != f"{prefix}/pred.txt":
        fail(f"stream: infer wrote {out}")
    probs = np.array(store.get(out).split(), np.float64)
    model = load_model(servable, device=DEVICE)
    from deepfm_tpu_torch.data.pipeline import eval_batches

    ref = np.concatenate([plain_probs(model, b["feat_ids"], b["feat_vals"],
                                      len(b["label"])) for b in eval_batches(
        DataConfig(batch_size=LIFE_BATCH), field_size=39, data_dir=local)])
    infer_err = float(np.abs(probs - ref).max()) if probs.shape == ref.shape else np.inf
    if probs.shape != (VAL_RECORDS,) or not infer_err <= TOL_PROB:
        fail(f"stream: pred.txt holds {probs.shape} lines, max abs diff {infer_err} "
             f"from the plain forward of the exported weights")
    return {"s3": s3, "disk": disk[0], "route_diffs": diffs, "batches_equal": n,
            "upload_s": upload_s, "first_batch": url_batches[0], "servable": servable,
            "bridges": {k: counted(k) for k in bridges}, "infer_max_abs_diff": infer_err,
            "launches": s3["launches"] + sum(d["launches"] for d in disk) + fwd_e + fwd,
            "backward_launches": s3["backward_launches"] + sum(d["backward_launches"]
                                                               for d in disk)}


def stream_pipe(seed: int, workdir: str, files: list, val: str) -> dict:
    """(b) Pipe mode: the train task with data.stream_mode from the
    ``training`` FIFO, its final eval from the ``evaluation`` FIFO, both
    filled by writer threads; the eval task over the same checkpoint and
    the validation records as files; the eval task with
    eval_max_batches=2 over a channel whose writer never closes it; the
    first batch through a FIFO against the same records from disk."""
    from deepfm_tpu_torch.core.config import DataConfig
    from deepfm_tpu_torch.data.pipeline import ctr_batches_from_sources, make_input_pipeline
    from deepfm_tpu_torch.utils.channel_writer import ChannelWriter

    def channel(path, payload, **kw):
        return ChannelWriter(path, payload, deadline_s=STREAM_DEADLINE_S, **kw)

    def read(paths):
        out = []
        for p in paths:
            with open(p, "rb") as f:
                out.append(f.read())
        return b"".join(out)

    pipe, live, first = (os.path.join(workdir, d) for d in ("pipe", "pipe_live", "pipe_first"))
    for d in (pipe, live, first):
        os.makedirs(d)
    records = len(files) * TRAIN_RECORDS_PER_FILE
    model_dir = os.path.join(workdir, "model_pipe")
    servable = os.path.join(workdir, "servable_pipe")
    writers = [channel(os.path.join(pipe, "training"), read(files)),
               channel(os.path.join(pipe, "evaluation"), read([val]))]
    try:
        run = _route_run(["--task_type", "train", "--training_data_dir", pipe,
                          "--model_dir", model_dir, "--servable_model_dir", servable,
                          "--num_epochs", "1", "--log_steps", str(LOG_STEPS),
                          "--set", "model.fused_kernel=auto", "--set", f"run.seed={seed}",
                          "--set", "data.stream_mode=true", *LIFE_ARGS],
                         "Pipe train", records, VAL_RECORDS)
        for w in writers:
            _join_writer(w, "Pipe train")
    finally:
        for w in writers:
            w.close()
    base = ["--model_dir", model_dir, "--set", "model.fused_kernel=auto", *LIFE_ARGS]
    files_eval, _, fwd_a, _ = run_logged(["--task_type", "eval", "--val_data_dir",
                                          os.path.dirname(val), *base])
    if files_eval["examples"] != run["eval"]["examples"] or \
            abs(files_eval["auc"] - run["eval"]["auc"]) > 1e-6:
        fail(f"stream: the channel's eval {run['eval']} against the files' {files_eval}")
    writer = channel(os.path.join(live, "evaluation"), read([val]), forever=True)
    try:
        t0 = time.perf_counter()
        bounded, _, fwd_b, _ = run_logged(["--task_type", "eval", "--training_data_dir", live,
                                           "--set", "data.stream_mode=true",
                                           "--set", "data.eval_max_batches=2", *base])
        bounded_s = time.perf_counter() - t0
        _join_writer(writer, "the bounded read")
    finally:
        writer.close()
    if bounded["examples"] != 2 * LIFE_BATCH or not writer.reader_closed:
        fail(f"stream: the bounded read gave {bounded}; the writer saw the reader close: "
             f"{writer.reader_closed}")
    writer = channel(os.path.join(first, "training"), read(files[:1]))
    try:
        batches = make_input_pipeline(DataConfig(batch_size=LIFE_BATCH, stream_mode=True),
                                      field_size=39, data_dir=first, seed=seed)
        fifo_batch = next(batches)
        batches.close()
        _join_writer(writer, "the first FIFO batch")
    finally:
        writer.close()
    _same_batches([fifo_batch], [next(ctr_batches_from_sources(
        files[:1], batch_size=LIFE_BATCH, field_size=39))], "the first FIFO batch")
    return {"run": run, "files_eval": files_eval, "bounded": bounded, "bounded_s": bounded_s,
            "first_batch": fifo_batch, "servable": servable,
            "launches": run["launches"] + fwd_a + fwd_b,
            "backward_launches": run["backward_launches"]}


def stream_reload(seed: int, base: str, s3_servable: str, states: list) -> dict:
    """(c) The serve task over the S3 run's servable with
    run.serve_reload_url on a URL publish root: version 1 (the S3 run's
    weights) published before it starts is adopted before its socket
    opens, version 2 (the Pipe run's) published while it serves is swapped
    in; every answer is within TOL_PROB of the plain forward of the version
    it reports; B1's runs are the bucket graphs' replays."""
    from deepfm_tpu_torch.launch import cli
    from deepfm_tpu_torch.online.publisher import ModelPublisher
    from deepfm_tpu_torch.ops import fused_ctr
    from deepfm_tpu_torch.serve.export import model_from_state
    from deepfm_tpu_torch.train import loop

    root = f"{base}/bucket/publish"
    cfg, _ = cli.resolve_config([
        "--task_type", "serve", "--servable_model_dir", s3_servable, "--set", "run.serve_port=0",
        "--set", f"run.serve_reload_url={root}", "--set", "run.serve_reload_interval_secs=0.1",
        "--set", "run.serve_buckets=" + ",".join(map(str, STREAM_BUCKETS)),
        "--set", "model.fused_kernel=auto", *LIFE_ARGS])
    sds = [{k: v.detach().cpu() for k, v in s.model.state_dict().items()} for s in states]
    models = [model_from_state(cfg.model, sd, DEVICE) for sd in sds]
    pub = ModelPublisher(root)
    t0 = time.perf_counter()
    pub.publish(cfg.model, sds[0], step=states[0].step)
    publish_ms = [1e3 * (time.perf_counter() - t0)]
    rng = np.random.default_rng(seed + 20)
    requests = [(make_ids(rng, n, cfg.model.field_size, cfg.model.feature_size),
                 rng.random((n, cfg.model.field_size)).astype(np.float32)) for n in (1, 8, 50)]
    fused_ctr.launches = fused_ctr.captured = 0
    ready, errors = threading.Event(), []

    def serve():
        try:
            loop.run_serve(cfg, device=DEVICE, ready=ready)
        except BaseException as e:  # reported below
            errors.append(e)
            ready.set()

    thread = threading.Thread(target=serve, name="stream-serve", daemon=True)
    thread.start()
    if not ready.wait(STREAM_DEADLINE_S) or errors:
        fail(f"stream: the serve task did not come up: {errors}")
    url = f"http://127.0.0.1:{ready.port}/v1/models/deepfm:predict"
    answers = []

    def ask(version: int) -> None:
        for ids, vals in requests:
            code, doc = post(url, _instances_body(ids, vals))
            got = np.asarray(doc.get("predictions"), np.float32)
            v = doc.get("model_version")
            if code != 200 or v != version:
                fail(f"stream: :predict answered {code}, version {v} (expected {version})")
            err = min(float(np.abs(got - plain_probs(models[v - 1], ids, vals, b)).max())
                      for b in STREAM_BUCKETS if b >= len(ids))
            if not err <= TOL_PROB:
                fail(f"stream: a version {v} answer is {err} from its plain forward")
            answers.append(err)

    try:
        ask(1)  # adopted before the socket opened
        t0 = time.perf_counter()
        pub.publish(cfg.model, sds[1], step=states[1].step)
        publish_ms.append(1e3 * (time.perf_counter() - t0))
        deadline = time.monotonic() + STREAM_DEADLINE_S
        while ready.swapper.status()["model_version"] != 2:
            if time.monotonic() > deadline:
                fail(f"stream: version 2 did not swap in: {ready.swapper.status()}")
            time.sleep(0.02)
        swap_s = time.perf_counter() - t0
        ask(2)
        predictor = ready.predictor
        launches = predictor.replays * predictor.kernel_launches_per_replay
        st = ready.swapper.status()
    finally:
        ready.server.shutdown()
        thread.join(timeout=60)
    if thread.is_alive() or errors:
        fail(f"stream: the serve task did not stop: {errors}")
    if launches <= 0 or st["rollbacks_total"] or st["poll_errors_total"]:
        fail(f"stream: the served path: {launches} B1 runs, status {st}")
    return {"swap_ms": st["last_swap_ms"], "stage_ms": st["last_stage_ms"],
            "canary_ms": st["last_canary_ms"], "publish_ms": publish_ms,
            "published_to_live_s": swap_s, "answers": len(answers),
            "max_abs_diff": max(answers), "launches": launches,
            "graphs": predictor.graph_count}


def phase_stream(seed: int, workdir: str, card: str, train_dir: str, val_dir: str,
                 readers: dict) -> dict:
    """Phase 20 (module docstring): (a) S3 channels, (b) Pipe mode, (c) a
    URL publish root, at the flagship width; B1 and B1' held against their
    plain versions on the first batch through a bridge and the first
    through a FIFO.  One ``stream`` line."""
    from deepfm_tpu_torch.data.pipeline import discover_files

    t_phase = time.perf_counter()
    os.makedirs(workdir)
    files = sorted(discover_files(train_dir, ("train",), shuffle=False))[:STREAM_FILES]
    val = discover_files(val_dir, ("val",), shuffle=False)[0]
    proc, base = start_dev_store(workdir)
    try:
        s3 = stream_s3(seed, workdir, base, files, val)
        pipe = stream_pipe(seed, workdir, files, val)
        reload = stream_reload(seed, base, s3["servable"],
                               [s3["s3"]["state"], pipe["run"]["state"]])
        checks = {"bridge": _kernel_check(s3["s3"]["state"].model, s3["first_batch"], seed,
                                          "stream bridge"),
                  "fifo": _kernel_check(pipe["run"]["state"].model, pipe["first_batch"],
                                        seed, "stream fifo")}
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
    seconds = time.perf_counter() - t_phase
    route = lambda r: {k: r["done"][k] for k in ("examples_per_sec", "input_wait_share",  # noqa: E731
                                                 "steps", "seconds")}
    launches = s3["launches"] + pipe["launches"] + reload["launches"]
    backward = s3["backward_launches"] + pipe["backward_launches"]
    print("stream %s" % json.dumps({
        "card": card, "records_a_route": len(files) * TRAIN_RECORDS_PER_FILE,
        "s3": route(s3["s3"]), "pipe": route(pipe["run"]),
        "lifecycle_local_files": readers.get("native"),
        "s3_batches_byte_equal_to_disk": s3["batches_equal"],
        "route_diffs": s3["route_diffs"], "tolerance": TOL_ROUTE,
        "disk": route(s3["disk"]), "upload_s": s3["upload_s"], "bridges": s3["bridges"],
        "infer_max_abs_diff": s3["infer_max_abs_diff"],
        "eval": {"examples": pipe["run"]["eval"]["examples"], "auc": pipe["run"]["eval"]["auc"],
                 "files_auc": pipe["files_eval"]["auc"]},
        "bounded_eval": {"examples": pipe["bounded"]["examples"], "seconds": pipe["bounded_s"]},
        "reload": {k: reload[k] for k in ("swap_ms", "stage_ms", "canary_ms", "publish_ms",
                                          "published_to_live_s", "answers", "max_abs_diff",
                                          "graphs")},
        "kernels_vs_plain": checks,
        "runs": {"fused_ctr_forward": launches, "fused_ctr_backward": backward},
        "seconds": seconds}))
    return {"launches": launches, "backward_launches": backward,
            "max_abs_err": max(c["forward_max_abs_err"] for c in checks.values()),
            "backward_max_abs_err": max(c["backward_max_abs_err"] for c in checks.values()),
            "seconds": seconds}


# phase 21: the other model families (ROADMAP A12) at benchmarks/model_zoo.py's
# widths: xDeepFM and DCN-v2 on the train phase's records (117,581 x 39 x 32,
# MLP 128/64/32, dropout 0.5, bf16, Adam 5e-4, batch 1,024; CIN 128/128,
# 3 cross layers), two-tower on synthetic ratings at MovieLens-25M's
# vocabularies (162,541 users, 62,423 items; towers 64/32 -> 16, temperature
# 0.05)
FAM_FAMILIES = ("xdeepfm", "dcnv2")
# the CLI's device flags (none on the card: its entry points default to it)
FAM_DEVICE_ARGS: tuple[str, ...] = ()
FAM_ARGS: tuple[str, ...] = ("--deep_layers", "128,64,32", "--dropout", "0.5,0.5,0.5",
                             "--set", "model.cin_layers=[128,128]",
                             "--set", "model.cross_layers=3")
FAM_MODEL = {"deep_layers": (128, 64, 32), "dropout_keep": (0.5, 0.5, 0.5),
             "cin_layers": (128, 128), "cross_layers": 3}
FAM_TRAIN_FILES = 2
FAM_BUCKETS = (8, 512)
FAM_BATCH = 1024
TT_USERS, TT_ITEMS = 162_541, 62_423
TT_TRAIN_ROWS, TT_VAL_ROWS = 65_536, 8_192
TT_MODEL = {"model_name": "two_tower", "embedding_size": 32, "tower_layers": (64, 32),
            "tower_dim": 16, "temperature": 0.05}
TT_STEP_FIELDS = (8, 4)
TT_GRID, TT_GRID_STEPS, TT_GRID_LR = (2, 2), 3, 5e-4
# the drill's loss limits by step, and its temperature: JAX's own sharded
# vs dense two-tower test (tests/test_two_tower.py:138-186) holds its first
# step within 2e-5 and later ones within 5e-4 at tau 0.5, since Adam
# amplifies float32 reduction-order differences from the second step on
TT_GRID_LOSS_RTOL, TT_GRID_TEMPERATURE = (2e-5, 5e-4, 5e-4), 0.5


def family_argv(name: str, train_dir: str, val_dir: str, root: str, seed: int,
                lazy: bool, task: str = "train") -> list[str]:
    """The CLI's command line for ``name`` at phase 21's widths; its
    checkpoints and servable under ``root``."""
    return ["--task_type", task, "--model_name", name, "--training_data_dir", train_dir,
            "--val_data_dir", val_dir, "--servable_model_dir", os.path.join(root, "servable"),
            "--model_dir", os.path.join(root, "ckpt"), "--num_epochs", "1",
            "--batch_size", str(FAM_BATCH), "--log_steps", str(LOG_STEPS), *FAM_ARGS,
            *FAM_DEVICE_ARGS,
            "--set", f"run.seed={seed}",
            "--set", f"optimizer.lazy_embedding_updates={'true' if lazy else 'false'}"]


def family_config(name: str, seed: int, lazy: bool = False, **model):
    from deepfm_tpu_torch.core.config import Config

    return Config.from_dict({"model": {"model_name": name, "feature_size": LIFE_VOCAB,
                                       **FAM_MODEL, **model},
                             "optimizer": {"lazy_embedding_updates": lazy},
                             "data": {"batch_size": FAM_BATCH}, "run": {"seed": seed}})


def family_tasks(name: str, seed: int, train_dir: str, val_dir: str, root: str) -> dict:
    """The train task through the CLI, dense then lazy, each counted from 0;
    then the eval, infer and export tasks from the dense run's
    checkpoint, held to the train task's eval, servable and params."""
    from deepfm_tpu_torch.serve.export import PARAMS_FILE, load_servable

    kernel = name == "xdeepfm"
    out = {"launches": 0, "backward_launches": 0}
    for mode in ("dense", "lazy"):
        argv = family_argv(name, train_dir, val_dir, os.path.join(root, mode), seed,
                           mode == "lazy")
        print(f"families {name} {mode}: python -m deepfm_tpu_torch " + " ".join(argv))
        _, lines, fwd, bwd = run_logged(argv)
        train, done = _kind(lines, "train"), _kind(lines, "train_done")[0]
        ev = _kind(lines, "eval")[-1]
        steps = done["steps"]
        if not train or not all(np.isfinite(r["loss"]) for r in train):
            fail(f"families {name} {mode}: a logged loss is not finite: {train}")
        if not (0.0 <= ev["auc"] <= 1.0 and np.isfinite(ev["loss"])):
            fail(f"families {name} {mode}: eval gave {ev}")
        if not _kind(lines, "export"):
            fail(f"families {name} {mode}: the train task exported no servable")
        # xDeepFM gathers through B1 and B1'; DCN-v2's gather is a plain one
        if DEVICE == "cuda" and ((kernel and (fwd < steps or bwd < steps))
                                 or (not kernel and fwd + bwd)):
            fail(f"families {name} {mode}: {steps} steps launched fused_ctr_forward "
                 f"{fwd} and fused_ctr_backward {bwd} times")
        out["launches"] += fwd
        out["backward_launches"] += bwd
        out[mode] = {"steps": steps, "examples_per_sec": done["examples_per_sec"],
                     "input_wait_share": done["input_wait_share"], "eval_auc": ev["auc"],
                     "eval_loss": ev["loss"], "ce_first": train[0]["ce"],
                     "ce_last": train[-1]["ce"], "launches": [fwd, bwd]}
    dense = os.path.join(root, "dense")
    base = family_argv(name, train_dir, val_dir, dense, seed, False)
    _, lines, fwd, _ = run_logged(base[:1] + ["eval"] + base[2:])
    ev = _kind(lines, "eval")[-1]
    if abs(ev["auc"] - out["dense"]["eval_auc"]) > 1e-6:
        fail(f"families {name}: the eval task's AUC {ev['auc']} differs from the train "
             f"task's {out['dense']['eval_auc']}")
    out["launches"] += fwd
    _, lines, fwd, _ = run_logged(base[:1] + ["infer"] + base[2:])
    out["launches"] += fwd
    preds = np.loadtxt(os.path.join(val_dir, "pred.txt"), dtype=np.float32)
    predict, _ = load_servable(os.path.join(dense, "servable"), device=DEVICE)
    batch = first_batch(val_dir, "val", FAM_BATCH, "cpu")
    want = predict(batch["feat_ids"].numpy(), batch["feat_vals"].numpy())
    infer_err = float(np.abs(preds[:FAM_BATCH] - want).max())
    if preds.shape != (VAL_RECORDS,) or infer_err > TOL_PROB:
        fail(f"families {name}: the infer task wrote {preds.shape} probabilities, "
             f"{infer_err} from the servable's")
    export = list(base)
    export[export.index("--servable_model_dir") + 1] = os.path.join(dense, "exported")
    run_logged(export[:1] + ["export"] + export[2:])
    with np.load(os.path.join(dense, "servable", PARAMS_FILE)) as a, \
            np.load(os.path.join(dense, "exported", PARAMS_FILE)) as b:
        if a.files != b.files or any(not np.array_equal(a[k], b[k]) for k in a.files):
            fail(f"families {name}: the export task's params differ from the train task's")
    out["infer_max_abs_err"] = infer_err
    return out


def family_kernels(seed: int, train_dir: str) -> dict:
    """xDeepFM through the kernels against the plain versions: one float32
    forward and backward (loss, every gradient), and B1 and B1' (with the
    zero cotangent of y_v xDeepFM's head gives them) at B = 1,024 on the
    unpadded table, with their times, the plain versions' and their
    bounds."""
    from deepfm_tpu_torch.models.base import get_model
    from deepfm_tpu_torch.ops import fused_ctr
    from deepfm_tpu_torch.train.step import loss_terms

    cfg = family_config("xdeepfm", seed, compute_dtype="float32",
                        dropout_keep=(1.0, 1.0, 1.0)).model
    model = get_model(cfg).build(cfg, device=DEVICE,
                                 generator=torch.Generator().manual_seed(seed))
    model.train()
    batch = first_batch(train_dir, "train", FAM_BATCH, DEVICE)
    params = dict(model.named_parameters())
    ids, vals = model.prepare(batch["feat_ids"], batch["feat_vals"])
    runs = []
    for fused in (fused_ctr.fused_ctr_interaction, fused_ctr.fused_ctr_plain):
        outs = fused(model.fm_w, model.fm_v, ids, vals)
        loss, _ = loss_terms(model, model.head(*outs), batch["label"])
        runs.append((outs, loss, torch.autograd.grad(loss, list(params.values()))))
    (outs_k, loss_k, grads_k), (outs_p, loss_p, grads_p) = runs
    e = [float((a - w).detach().abs().max()) for a, w in zip(outs_k, outs_p)]
    if not (e[0] <= TOL_EMB and e[1] <= TOL_YW_REL * (1.0 + float(outs_p[1].abs().max()))):
        fail(f"families: B1 on xDeepFM's table disagrees with its plain version: emb "
             f"{e[0]}, y_w {e[1]}")
    loss_err = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    if not loss_err <= TOL_LOSS_REL:
        fail(f"families: xDeepFM's loss through the kernels {float(loss_k)} vs plain "
             f"{float(loss_p)}")
    grad_err = {}
    for name, a, w in zip(params, grads_k, grads_p):
        err, scale = float((a - w).abs().max()), float(w.abs().max())
        if not err <= TOL_GRAD_REL * scale:
            fail(f"families: xDeepFM's gradient of {name} through the kernels: max abs "
                 f"err {err}, scale {scale}")
        grad_err[name] = err / scale if scale else err
    fm_w, fm_v = model.fm_w.detach(), model.fm_v.detach()
    ids32 = ids.to(torch.int32)
    b, f = ids.shape
    g = torch.Generator(device=DEVICE).manual_seed(seed + 5)
    g_emb = torch.randn((b, f, fm_v.shape[1]), generator=g, device=DEVICE)
    g_yw = torch.randn((b,), generator=g, device=DEVICE)
    g_yv = torch.zeros((b,), device=DEVICE)
    # the CPU (a rehearsal) has no kernel: its plain version stands there
    backward = (fused_ctr.fused_ctr_backward if DEVICE == "cuda"
                else fused_ctr.fused_ctr_backward_plain)
    got = backward(g_emb, g_yw, g_yv, fm_w, fm_v, ids32, vals, False)
    want = fused_ctr.fused_ctr_backward_plain(
        *(t.double() for t in (g_emb, g_yw, g_yv, fm_w, fm_v)), ids32, vals.double(), False)
    eb = []
    for name, a, w in zip(("d_fm_w", "d_fm_v"), got, want):
        err, scale = float((a.double() - w).abs().max()), float(w.abs().max())
        if not err <= TOL_GRAD_REL * scale:
            fail(f"families: B1' with g_yv = 0: {name} max abs err {err}, scale {scale}")
        eb.append(err)
    row = {"table_rows": int(fm_v.shape[0]), "forward_max_abs_err": e,
           "backward_max_abs_err": eb, "loss_rel_err": loss_err,
           "max_grad_rel_err": max(grad_err.values())}
    if DEVICE == "cuda":
        lib = fused_ctr._library()
        d_w, d_v = torch.zeros_like(fm_w), torch.zeros_like(fm_v)
        row["forward_ms"], _ = time_ms(lambda: fused_ctr.fused_ctr_interaction(
            fm_w, fm_v, ids32, vals))
        row["forward_plain_ms"], _ = time_ms(lambda: fused_ctr.fused_ctr_plain(
            fm_w, fm_v, ids32, vals), reps=20)
        row["forward_bound_ms"], row["forward_bound_by"], _ = fused_ctr_bound_ms(
            fm_w, fm_v, ids32, b, f)
        row["backward_ms"], row["backward_call_ms"] = time_ms(lambda: backward_kernel_only(
            lib, g_emb, g_yw, g_yv, fm_w, fm_v, ids32, vals, d_w, d_v, None))
        row["backward_plain_ms"], _ = time_ms(lambda: fused_ctr.fused_ctr_backward_plain(
            g_emb, g_yw, g_yv, fm_w, fm_v, ids32, vals, False), reps=20)
        row["backward_bound_ms"], row["backward_bound_by"], _ = fused_ctr_backward_bound_ms(
            fm_w, fm_v, ids32, b, f, False)
    print("families xdeepfm kernels B=%d %s" % (b, json.dumps(row)))
    return row


def family_batches(seed: int, n: int, vocab: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    b, f = FAM_BATCH, 39
    pin = DEVICE == "cuda"
    out = []
    for _ in range(n):
        batch = {"feat_ids": torch.from_numpy(rng.permutation(vocab)[:b * f].reshape(b, f)),
                 "feat_vals": torch.from_numpy(rng.random((b, f), dtype=np.float32)),
                 "label": torch.from_numpy((rng.random(b) < 0.25).astype(np.float32))}
        out.append({k: v.pin_memory() if pin else v for k, v in batch.items()})
    return out


def family_graphed(name: str, seed: int) -> dict:
    """The dense and lazy single-card steps of ``name`` graphed against
    eager, GRAPH_STEPS steps of distinct ids from one state, metrics and
    every carried tensor bit for bit; the graphed dense step's device ms
    and its split, each part timed alone at the step's shapes (CUDA
    graphs of that part; the MLP without dropout)."""
    from deepfm_tpu_torch.analysis.trace_audit import state_tensors as carried
    from deepfm_tpu_torch.ops import fused_ctr
    from deepfm_tpu_torch.train.step import (WARMUP_STEPS, create_train_state,
                                             graphed_train_step, train_step)

    batches = family_batches(seed + 31, GRAPH_STEPS, LIFE_VOCAB)
    on_card = [{k: v.to(DEVICE) for k, v in b.items()} for b in batches]
    out = {}
    for mode in ("dense", "lazy"):
        cfg = family_config(name, seed, lazy=mode == "lazy")
        eager, graphed = create_train_state(cfg, DEVICE), create_train_state(cfg, DEVICE)
        graphed.generator.set_state(eager.generator.get_state())
        for i, (host, dev) in enumerate(zip(batches, on_card)):
            mg, me = graphed_train_step(graphed, host), train_step(eager, dev)
            for k in mg:
                if not torch.equal(mg[k], me[k]):
                    fail(f"families {name} graphed {mode}: step {i + 1}'s {k} "
                         f"{float(mg[k])} differs from the eager step's {float(me[k])}")
        got, want = carried(graphed), carried(eager)
        differs = [k for k in want if not torch.equal(got[k], want[k])]
        if differs or got.keys() != want.keys():
            fail(f"families {name} graphed {mode}: these tensors differ from the eager "
                 f"steps': {differs[:8]}")
        row = {"steps_bit_equal": GRAPH_STEPS, "tensors_bit_equal": len(want)}
        if DEVICE == "cuda":
            if graphed.graph.replays != GRAPH_STEPS - WARMUP_STEPS:
                fail(f"families {name} graphed {mode}: {graphed.graph.replays} replays")
            row["kernels_a_replay"] = list(graphed.graph.per_replay)
            row["graphed_step_device_ms"] = _median_event_ms(
                lambda: graphed_train_step(graphed, batches[0]), 1, 20)
            row["eager_step_device_ms"] = _median_event_ms(
                lambda: train_step(eager, on_card[0]), 1, 10)
        out[mode] = row
    if DEVICE == "cuda":
        out["split_ms"] = family_split(name, seed, on_card[0])
        out["dense"]["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    print("families %s graphed %s" % (name, json.dumps(out)))
    return out


def family_split(name: str, seed: int, batch: dict) -> dict:
    """Each part of ``name``'s dense step at B = 1,024 alone, device ms from
    a CUDA graph of it (time_ms): B1, B1' (kernel alone, g_yv = 0), the
    CIN or the cross stack forward and backward, the MLP forward and
    backward, the optimizer's update."""
    from deepfm_tpu_torch.ops import fused_ctr
    from deepfm_tpu_torch.ops.embedding import scaled_embedding
    from deepfm_tpu_torch.train.step import _scalar_buffer, create_train_state, load_scalars

    state = create_train_state(family_config(name, seed), DEVICE)
    model = state.model
    ids, vals = model.prepare(batch["feat_ids"], batch["feat_vals"])
    split = {}
    emb = scaled_embedding(model.fm_v.detach(), ids, vals)
    if name == "xdeepfm":
        fm_w, fm_v = model.fm_w.detach(), model.fm_v.detach()
        split["b1"], _ = time_ms(lambda: fused_ctr.fused_ctr_interaction(fm_w, fm_v, ids, vals),
                                 reps=20)
        g_emb = torch.randn_like(emb)
        g_yw, g_yv = torch.randn_like(vals[:, 0]), torch.zeros_like(vals[:, 0])
        lib = fused_ctr._library()
        d_w, d_v = torch.zeros_like(fm_w), torch.zeros_like(fm_v)
        split["b1_backward"], _ = time_ms(lambda: backward_kernel_only(
            lib, g_emb, g_yw, g_yv, fm_w, fm_v, ids, vals, d_w, d_v, None), reps=20)
    head = model.cin if name == "xdeepfm" else model.cross
    x = emb.clone().requires_grad_()
    flat = emb.reshape(emb.shape[0], -1).clone().requires_grad_()
    head_in = x if name == "xdeepfm" else flat
    head_params = list(head.parameters())
    split["cin" if name == "xdeepfm" else "cross"], _ = time_ms(
        lambda: torch.autograd.grad(head(head_in).sum(), [head_in, *head_params]), reps=10)
    model.eval()  # the MLP alone, without dropout's generator in the graph
    mlp_params = list(model.mlp.parameters())
    split["mlp"], _ = time_ms(
        lambda: torch.autograd.grad(model.deep(flat).sum(), [flat, *mlp_params]), reps=10)
    params = dict(model.named_parameters())
    grads = {k: torch.zeros_like(p) for k, p in params.items()}
    scalars = _scalar_buffer(state)
    load_scalars(state, scalars)
    split["optimizer"], _ = time_ms(
        lambda: state.optimizer.update(params, grads, scalars[:3]), reps=10)
    return split


def write_ratings(path: str, rows: int, seed: int) -> None:
    """``rows`` ratings at TT_USERS x TT_ITEMS from ``seed``: user u rates
    items near 7·u (so the towers have something to learn), a CSV with
    MovieLens's header."""
    rng = np.random.default_rng(seed)
    users = rng.integers(0, TT_USERS, rows)
    items = (users * 7 + rng.integers(0, 64, rows)) % TT_ITEMS
    stars = rng.integers(1, 11, rows) / 2
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write("userId,movieId,rating,timestamp\n")
        f.writelines(f"{u},{i},{r},0\n" for u, i, r in zip(users, items, stars))


def tt_argv(task: str, train_dir: str, val_dir: str, root: str, seed: int) -> list[str]:
    return ["--task_type", task, "--model_name", "two_tower",
            "--training_data_dir", train_dir, "--val_data_dir", val_dir,
            "--model_dir", os.path.join(root, "ckpt"),
            "--servable_model_dir", os.path.join(root, "servable"),
            "--batch_size", str(FAM_BATCH), "--num_epochs", "1",
            "--log_steps", str(LOG_STEPS), "--embedding_size", "32",
            *FAM_DEVICE_ARGS,
            "--set", f"model.user_vocab_size={TT_USERS}",
            "--set", f"model.item_vocab_size={TT_ITEMS}",
            "--set", "model.tower_layers=[64,32]", "--set", "model.tower_dim=16",
            "--set", "model.temperature=0.05", "--set", f"run.seed={seed}"]


def two_tower_tasks(seed: int, root: str) -> dict:
    """The two-tower train, eval and export tasks through the CLI on
    ratings written from ``seed``; the exported servable through the
    two-tower loader against the trained model's query encoder."""
    from deepfm_tpu_torch.models.two_tower import encode_queries
    from deepfm_tpu_torch.serve.export import load_retrieval_servable

    train_dir, val_dir = os.path.join(root, "train"), os.path.join(root, "val")
    write_ratings(os.path.join(train_dir, "ratings.csv"), TT_TRAIN_ROWS, seed + 41)
    write_ratings(os.path.join(val_dir, "ratings.csv"), TT_VAL_ROWS, seed + 42)
    argv = tt_argv("train", train_dir, val_dir, root, seed)
    print("families two_tower: python -m deepfm_tpu_torch " + " ".join(argv))
    state, lines, fwd, bwd = run_logged(argv)
    train, done = _kind(lines, "train"), _kind(lines, "train_done")[0]
    ev = _kind(lines, "eval")[-1]
    if not train or not all(np.isfinite(r["loss"]) for r in train):
        fail(f"families two_tower: a logged loss is not finite: {train}")
    if done["steps"] != TT_TRAIN_ROWS // FAM_BATCH or ev["examples"] != TT_VAL_ROWS:
        fail(f"families two_tower: {done['steps']} steps, eval over {ev['examples']} rows")
    if not (np.isfinite(ev["loss"]) and 0 <= ev["top1_acc"] <= ev["recall_at_10"] <= 1):
        fail(f"families two_tower: eval gave {ev}")
    _, lines, _, _ = run_logged(tt_argv("eval", train_dir, val_dir, root, seed))
    if _kind(lines, "eval")[-1] != ev:
        fail(f"families two_tower: the eval task gave {_kind(lines, 'eval')[-1]}, the "
             f"train task {ev}")
    export = tt_argv("export", train_dir, val_dir, root, seed)
    export[export.index("--servable_model_dir") + 1] = os.path.join(root, "exported")
    run_logged(export)
    encode_user, _, cfg = load_retrieval_servable(os.path.join(root, "exported"),
                                                  device=DEVICE)
    users = np.random.default_rng(seed + 43).integers(0, TT_USERS, (64, 1))
    got = encode_user(users, np.ones((64, 1), np.float32))
    with torch.no_grad():
        want = encode_queries(state.model, torch.from_numpy(users).to(DEVICE),
                              torch.ones(64, 1, device=DEVICE)).cpu().numpy()
    enc_err = float(np.abs(got - want).max())
    if got.shape != (64, 16) or enc_err > TOL_GRAPH:
        fail(f"families two_tower: the exported encoder is {enc_err} from the trained "
             f"model's")
    if fwd + bwd:
        fail(f"families two_tower: the retrieval task launched B1 {fwd}, B1' {bwd} times")
    return {"steps": done["steps"], "examples_per_sec": done["examples_per_sec"],
            "loss_first": train[0]["loss"], "loss_last": train[-1]["loss"],
            "eval": {k: ev[k] for k in ("loss", "top1_acc", "recall_at_10")},
            "encoder_max_abs_err": enc_err}


def two_tower_step_ms(seed: int) -> float | None:
    """The single-card retrieval step's device ms (CUDA events) at
    model_zoo's 8 user and 4 item fields, batch 1,024."""
    from deepfm_tpu_torch.core.config import Config
    from deepfm_tpu_torch.train import retrieval

    cfg = Config.from_dict({"model": {**TT_MODEL, "user_vocab_size": TT_USERS,
                                      "item_vocab_size": TT_ITEMS,
                                      "user_field_size": TT_STEP_FIELDS[0],
                                      "item_field_size": TT_STEP_FIELDS[1]},
                            "run": {"seed": seed}})
    state = retrieval.create_retrieval_state(cfg, DEVICE)
    rng = np.random.default_rng(seed + 44)
    fu, fi = TT_STEP_FIELDS
    batch = {"user_ids": torch.from_numpy(rng.integers(0, TT_USERS, (FAM_BATCH, fu))),
             "user_vals": torch.ones(FAM_BATCH, fu),
             "item_ids": torch.from_numpy(rng.integers(0, TT_ITEMS, (FAM_BATCH, fi))),
             "item_vals": torch.ones(FAM_BATCH, fi)}
    batch = {k: v.to(DEVICE) for k, v in batch.items()}
    for _ in range(3):
        retrieval.train_step(state, batch)
    if DEVICE != "cuda":
        return None
    return _median_event_ms(lambda: retrieval.train_step(state, batch), 1, 20)


def tt_grid_config(seed: int) -> dict:
    from deepfm_tpu_torch.core.config import Config

    return Config.from_dict({
        "model": {**TT_MODEL, "user_vocab_size": TT_USERS, "item_vocab_size": TT_ITEMS,
                  "compute_dtype": "float32", "temperature": TT_GRID_TEMPERATURE},
        "optimizer": {"learning_rate": TT_GRID_LR},
        "mesh": {"data_parallel": TT_GRID[0], "model_parallel": TT_GRID[1]},
        "data": {"batch_size": FAM_BATCH}, "run": {"seed": seed}}).to_dict()


def tt_grid_rank(rank: int, world: int, store: str, out: str, cfg_dict: dict,
                 init: dict, batches: list) -> None:
    """One rank of the two-tower drill (a spawned process, gloo on card 0):
    the whole weights cut to its rows, TT_GRID_STEPS steps through
    parallel/retrieval.py on its slice of each global batch, then the
    metrics and the whole tables (gathered)."""
    import torch.distributed as dist

    if DEVICE == "cuda":
        torch.cuda.set_device(0)
    torch.set_num_threads(2)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        from deepfm_tpu_torch.core.config import Config
        from deepfm_tpu_torch.parallel import retrieval, spmd
        from deepfm_tpu_torch.parallel.mesh import initialize_distributed

        cfg = Config.from_dict(cfg_dict)
        ctx = initialize_distributed(cfg.mesh, DEVICE)
        state = retrieval.create_retrieval_dp_state(cfg, ctx)
        sh = state.sharding
        keys = sh.sharded_keys(init)
        state.model.load_state_dict({
            k: t[sh.window(k)[0]:sum(sh.window(k))] if k in keys else t
            for k, t in init.items()})
        metrics = []
        for batch in batches:
            m = retrieval.train_step(state, retrieval.local_batch(batch, ctx), ctx)
            metrics.append({k: float(v) for k, v in m.items()})
        full = {k: v.cpu() for k, v in spmd.full_state(state)["model"].items()}
        torch.save({"metrics": metrics, "full": full if rank == 0 else None},
                   os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def start_two_tower_grid(seed: int, root: str) -> dict:
    """Spawn the two-tower drill's TT_GRID ranks (gloo, on the card) on
    their weights and global batches and return at once: their start
    (an interpreter, torch and a card context each, most of the drill's
    time) overlaps the rest of phase 21; :func:`finish_two_tower_grid`
    joins and checks them."""
    import torch.multiprocessing as tmp

    from deepfm_tpu_torch.core.config import Config
    from deepfm_tpu_torch.parallel.retrieval import padded_model_config
    from deepfm_tpu_torch.train import retrieval

    os.makedirs(root, exist_ok=True)
    cfg_dict = tt_grid_config(seed)
    cfg = Config.from_dict(cfg_dict)
    ref = retrieval.create_retrieval_state(
        cfg, DEVICE, model_cfg=padded_model_config(cfg, TT_GRID[1]))
    with torch.no_grad():
        for key, true in (("user_embedding", TT_USERS), ("item_embedding", TT_ITEMS)):
            getattr(ref.model, key)[true:] = 0.0
    init = {k: v.detach().cpu().clone() for k, v in ref.model.state_dict().items()}
    rng = np.random.default_rng(seed + 45)
    batches = [{"user_ids": rng.integers(0, TT_USERS, (FAM_BATCH, 1)),
                "user_vals": np.ones((FAM_BATCH, 1), np.float32),
                "item_ids": rng.integers(0, TT_ITEMS, (FAM_BATCH, 1)),
                "item_vals": np.ones((FAM_BATCH, 1), np.float32)}
               for _ in range(TT_GRID_STEPS)]
    world = TT_GRID[0] * TT_GRID[1]
    t0 = time.perf_counter()
    ctx = tmp.start_processes(tt_grid_rank, args=(world, os.path.join(root, "store"), root,
                                                  cfg_dict, init, batches),
                              nprocs=world, join=False, start_method="spawn")
    return {"ctx": ctx, "ref": ref, "batches": batches, "root": root, "t0": t0}


def finish_two_tower_grid(started: dict) -> dict:
    """The drill's ranks joined and held to the single-card step on the
    same global batches from the same weights (float32, temperature
    TT_GRID_TEMPERATURE): each step's loss within TT_GRID_LOSS_RTOL, every
    weight within Adam's reach of a rounding difference (a near-zero
    gradient's sign can flip a step by 2·lr; printed beside the measured
    gap)."""
    from deepfm_tpu_torch.train import retrieval

    ctx, ref, batches, root = (started[k] for k in ("ctx", "ref", "batches", "root"))
    world = TT_GRID[0] * TT_GRID[1]
    deadline = time.monotonic() + 300
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                fail("families two_tower grid: the ranks did not end within 300 s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    ranks = [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False)
             for r in range(world)]
    want = [{k: float(v) for k, v in retrieval.train_step(ref, b).items()} for b in batches]
    loss_err = 0.0
    for r in ranks:
        for got, w, rtol in zip(r["metrics"], want, TT_GRID_LOSS_RTOL):
            err = abs(got["loss"] - w["loss"]) / abs(w["loss"])
            if not err <= rtol:
                fail(f"families two_tower grid: loss {got['loss']} vs the single-card "
                     f"step's {w['loss']}")
            loss_err = max(loss_err, err)
    gap = max(float((ranks[0]["full"][k] - v.cpu()).abs().max())
              for k, v in ref.model.state_dict().items())
    if not gap <= 2 * TT_GRID_LR * TT_GRID_STEPS:
        fail(f"families two_tower grid: a weight is {gap} from the single-card step's")
    row = {"grid": list(TT_GRID), "steps": TT_GRID_STEPS, "loss_rel_err": loss_err,
           "max_weight_gap": gap, "seconds": time.perf_counter() - started["t0"]}
    print("families two_tower grid %s" % json.dumps(row))
    return row


def family_buckets(name: str, seed: int, servable: str) -> dict:
    """The exported servable behind GraphedPredictor at FAM_BUCKETS: each
    bucket's graphed answer against the eager forward (TOL_GRAPH) and the
    plain one (TOL_PROB), and B1's runs through the replays."""
    from deepfm_tpu_torch.core.config import load_config
    from deepfm_tpu_torch.ops.fused_ctr import fused_ctr_plain
    from deepfm_tpu_torch.serve import graphs
    from deepfm_tpu_torch.serve.export import model_from_state, read_params

    cfg, sd = load_config(servable), read_params(servable)
    eager = model_from_state(cfg, sd, DEVICE)
    predictor = graphs.GraphedPredictor(cfg, sd, device=DEVICE, buckets=FAM_BUCKETS)
    predictor.precompile()
    graphs.graph_kernel_runs["forward"] = 0
    rng = np.random.default_rng(seed + 51)
    errs = {}
    for b in FAM_BUCKETS:
        ids = make_ids(rng, b, 39, cfg.feature_size)
        vals = rng.random((b, 39), dtype=np.float32)
        got = predictor.predict_with(0, ids, vals)
        with torch.no_grad():
            t_ids, t_vals = eager.prepare(torch.from_numpy(ids).to(DEVICE),
                                          torch.from_numpy(vals).to(DEVICE))
            tables = eager.tables()
            want = torch.sigmoid(eager.table_logits(tables, t_ids, t_vals)).cpu().numpy()
            plain = (eager.head(*fused_ctr_plain(tables["fm_w"], tables["fm_v"], t_ids, t_vals))
                     if name == "xdeepfm" else eager.table_logits(tables, t_ids, t_vals))
            plain = torch.sigmoid(plain).cpu().numpy()
        e_g, e_p = float(np.abs(got - want).max()), float(np.abs(got - plain).max())
        if not (np.all(np.isfinite(got)) and e_g <= TOL_GRAPH and e_p <= TOL_PROB):
            fail(f"families {name}: bucket {b} graphed vs eager {e_g}, vs plain {e_p}")
        errs[b] = [e_g, e_p]
    runs = graphs.graph_kernel_runs["forward"]
    if DEVICE == "cuda" and (name == "xdeepfm") != (runs == len(FAM_BUCKETS)):
        fail(f"families {name}: {runs} B1 runs through {len(FAM_BUCKETS)} replays")
    return {"graphed_vs_eager_vs_plain": errs, "b1_runs": runs}


# phase 21's other paths (ROADMAP A12's remainder): xDeepFM's paged step on
# FAM_TIERED_STEPS batches of distinct ids through a hot cache of about half
# the vocabulary (so it evicts) and its tiered scorer on FAM_TIERED_SERVE
# rows; a [1, 2] psum member of each family; the funnel with xDeepFM ranking;
# a short online run of each family (FAM_ONLINE_SEGMENTS of LIFE_BATCH
# distinct-id records, a commit and a publish every FAM_ONLINE_EVERY); the
# elastic drill of xDeepFM, lazy, [2, 2] -> [1, 2] after FAM_ELASTIC[0]
# steps -> [2, 2] after FAM_ELASTIC[1], FAM_ELASTIC[2] steps in all, its rank
# processes started as warm standbys when the phase begins
FAM_TIERED_SLOTS, FAM_TIERED_STEPS, FAM_TIERED_SERVE = 65_536, 4, 100
FAM_MEMBER = (1, 2, "psum")
FAM_FUNNEL_REQUESTS = (1, 8)
FAM_ONLINE_SEGMENTS, FAM_ONLINE_EVERY = 4, 2
FAM_ELASTIC = (2, 4, 6)


def family_tiered(seed: int, workdir: str) -> dict:
    """xDeepFM on the tiered store: the paged step from a resident lazy
    state against the resident lazy step on FAM_TIERED_STEPS batches of
    distinct ids (one trajectory each: every loss, the final tables and
    moments and the rest of the model bit for bit), the cache evicting; B1
    on the hot cache with slot ids (the scorer's lookup) and B1 and B1' on
    the compact rows gathered from it against their plain versions; then
    ``publish_tiered`` and a TieredScorer of it answering FAM_TIERED_SERVE
    rows within 1e-6 of the resident model, one B1 launch.  Counts: the
    paged steps' and the scorer's runs."""
    from deepfm_tpu_torch.online.publisher import ModelPublisher
    from deepfm_tpu_torch.ops import fused_ctr
    from deepfm_tpu_torch.tiered import TieredScorer, TieredTrainer
    from deepfm_tpu_torch.tiered.trainer import rest_state_dict
    from deepfm_tpu_torch.train.step import create_train_state, predict_step, train_step

    cfg = family_config("xdeepfm", seed, lazy=True, fused_kernel="off",
                        tiered_embeddings=True, tiered_hot_slots=FAM_TIERED_SLOTS,
                        tiered_host_rows=FAM_TIERED_SLOTS, tiered_page_rows=TIERED_PAGE_ROWS)
    batches = [{k: v.numpy() for k, v in b.items()}
               for b in family_batches(seed + 61, FAM_TIERED_STEPS, LIFE_VOCAB)]
    resident = create_train_state(cfg, DEVICE)
    tr = TieredTrainer.from_resident_state(cfg, create_train_state(cfg, DEVICE),
                                           os.path.join(workdir, "cold"))
    try:
        reset_kernel_counts()
        t0 = time.perf_counter()
        paged = [float(tr.train_batch(b)["loss"]) for b in batches]  # float() waits
        step_s = (time.perf_counter() - t0) / len(batches)
        fwd, bwd = kernel_runs()
        ref = [float(train_step(resident, {k: torch.from_numpy(v).to(DEVICE)
                                           for k, v in b.items()})["loss"]) for b in batches]
        if paged != ref:
            fail(f"families tiered: the paged xDeepFM step's losses {paged} vs the resident "
                 f"lazy step's {ref}")
        if DEVICE == "cuda" and (fwd < len(batches) or bwd < len(batches)):
            fail(f"families tiered: {len(batches)} paged steps ran B1 {fwd} and B1' {bwd} "
                 f"times")
        stats = tr.pager.stats()
        if stats["evictions"] == 0 or stats["writeback_rows"] == 0:
            fail(f"families tiered: the cache never evicted: {stats}")
        rows, m, v = tr.export_tables()
        for part, got in (("rows", rows), ("m", m), ("v", v)):
            for k in ("fm_w", "fm_v"):
                want = (getattr(resident.model, k) if part == "rows"
                        else getattr(resident.lazy, part)[k]).detach().cpu().numpy()
                if not np.array_equal(got[k], want):
                    fail(f"families tiered: {part} {k} differ from the resident lazy state")
        rest = rest_state_dict(resident.model)
        for k, t in rest_state_dict(tr.state.model).items():
            if not torch.equal(t, rest[k]):
                fail(f"families tiered: {k} differs from the resident lazy state")
        # the kernels on the hot cache at the last batch's slots
        slot_ids, _ = tr.pager.translate(batches[-1]["feat_ids"], tr.state.hot)
        hot = tr.state.hot.rows
        ids = torch.from_numpy(slot_ids).to(DEVICE)
        vals = torch.from_numpy(batches[-1]["feat_vals"]).to(DEVICE)
        got = fused_ctr.fused_ctr_interaction(hot["fm_w"], hot["fm_v"], ids, vals)
        want = fused_ctr.fused_ctr_plain(hot["fm_w"], hot["fm_v"], ids, vals)
        e = [float((a - w).abs().max()) for a, w in zip(got, want)]
        if not (e[0] <= TOL_EMB and e[1] <= TOL_YW_REL * (1 + float(want[1].abs().max()))):
            fail(f"families tiered: fused_ctr_forward on the hot cache: {e}")
        compact = (compact_kernel_check(hot["fm_w"], hot["fm_v"], ids, vals, seed,
                                        "families tiered") if DEVICE == "cuda" else None)
        pub = os.path.join(workdir, "pub")
        manifest = ModelPublisher(pub).publish_tiered(cfg, tr)
    finally:
        tr.close()
    scorer = TieredScorer.from_publish(pub, os.path.join(workdir, "staging"), device=DEVICE)
    n = FAM_TIERED_SERVE
    want = predict_step(resident.model, {
        "feat_ids": torch.from_numpy(batches[0]["feat_ids"][:n]).to(DEVICE),
        "feat_vals": torch.from_numpy(batches[0]["feat_vals"][:n]).to(DEVICE)}).cpu().numpy()
    before = fused_ctr.launches
    probs = scorer.score(batches[0]["feat_ids"][:n], batches[0]["feat_vals"][:n])
    serve_runs = fused_ctr.launches - before
    serve_err = float(np.abs(probs - want).max())
    if not serve_err <= 1e-6 or (DEVICE == "cuda" and serve_runs != 1):
        fail(f"families tiered: the scorer's {n} rows within {serve_err} of the resident "
             f"model (1e-6), B1 launched {serve_runs} times")
    out = {"steps": len(batches), "losses_bit_equal": True, "step_host_s": step_s,
           "pager": stats, "hot_forward_max_abs_err": e, "published": manifest.version,
           "serve_max_abs_err": serve_err, "serve_launches": serve_runs,
           "launches": [fwd + serve_runs, bwd],
           "compact_max_abs_err": compact and [compact["forward_max_abs_err"],
                                               compact["backward_max_abs_err"]]}
    print("families tiered %s" % json.dumps(out))
    out["forward_errs"] = e + (compact["forward_max_abs_err"] if compact else [])
    out["backward_errs"] = compact["backward_max_abs_err"] if compact else []
    return out


def family_member(name: str, servable: str) -> dict:
    """A FAM_MEMBER shard-group member of ``name``'s exported servable (its
    tables cut into row shards) behind its bucket graphs against the
    single-card graphed predictor at FAM_BUCKETS: bit for bit, on a spread
    batch and on ids past the vocabulary.  Counts: B1's runs through the
    member's replays (xDeepFM once a replay, DCN-v2 none)."""
    from deepfm_tpu_torch.core.config import load_config
    from deepfm_tpu_torch.serve import graphs
    from deepfm_tpu_torch.serve.export import read_params
    from deepfm_tpu_torch.serve.pool.sharded import load_sharded_servable

    dp, mp, exchange = FAM_MEMBER
    cfg, sd = load_config(servable), read_params(servable)
    single = graphs.GraphedPredictor(cfg, sd, device=DEVICE, buckets=FAM_BUCKETS)
    single.precompile()
    rng = np.random.default_rng(71 + FAM_FAMILIES.index(name))
    requests = [(make_ids(rng, b, 39, cfg.feature_size),
                 rng.random((b, 39), dtype=np.float32)) for b in FAM_BUCKETS]
    want = [single.predict_with(0, ids, vals) for ids, vals in requests]
    del single
    t0 = time.perf_counter()
    _, pred, _, ctx = load_sharded_servable(servable, dp, mp, device=DEVICE,
                                            exchange=exchange, buckets=FAM_BUCKETS)
    pred.precompile()
    boot = time.perf_counter() - t0
    graphs.graph_kernel_runs["forward"] = 0
    for (ids, vals), ref in zip(requests, want):
        if not np.array_equal(pred.predict_with(0, ids, vals), ref):
            fail(f"families {name}: the [{dp}, {mp}] member's {len(ids)} rows differ from "
                 f"the single-card graphed predict")
    runs = graphs.graph_kernel_runs["forward"]
    if DEVICE == "cuda" and (name == "xdeepfm") != (runs == len(FAM_BUCKETS)):
        fail(f"families {name}: {runs} B1 runs through the member's {len(FAM_BUCKETS)} "
             f"replays")
    out = {"grid": [dp, mp], "exchange": ctx.exchange, "rows_local": ctx.rows_local,
           "graphs": pred.graph_count, "boot_s": boot, "b1_runs": runs,
           "bit_equal_buckets": list(FAM_BUCKETS)}
    print(f"families {name} member %s" % json.dumps(out))
    return out


def family_funnel(seed: int, workdir: str, funnel_servable: str, servable: str) -> dict:
    """The funnel of phase 8 (its query tower and int8 index of 117,581
    items) ranking through the exported xDeepFM: a FunnelScorer on the card
    (each stage a CUDA graph) answering FAM_FUNNEL_REQUESTS users, held to
    the same payload through the plain B2 and B1.  Counts: B2's and B1's
    runs on that path."""
    from deepfm_tpu_torch.core.config import load_config
    from deepfm_tpu_torch.funnel import load_funnel_artifact
    from deepfm_tpu_torch.funnel.publish import write_funnel_tree
    from deepfm_tpu_torch.funnel.serve import FunnelScorer
    from deepfm_tpu_torch.serve.export import read_params

    art = load_funnel_artifact(funnel_servable)
    directory = write_funnel_tree(os.path.join(workdir, "funnel"), load_config(servable),
                                  read_params(servable), art.query_cfg, art.query_state,
                                  art.index, art.meta)
    rng = np.random.default_rng(seed + 62)
    requests = [funnel_requests(rng, n) for n in FAM_FUNNEL_REQUESTS]
    reset_funnel_counts()
    scorer = FunnelScorer(directory, device=DEVICE, buckets=FUNNEL_BUCKETS, max_wait_ms=2.0)
    try:
        served = [scorer.recommend_instances([
            {"user_ids": a.tolist(), "user_vals": b.tolist(), "feat_ids": c.tolist(),
             "feat_vals": d.tolist()} for a, b, c, d in zip(*req)]) for req in requests]
        retr, fwd = funnel_kernel_runs()
        ctx, payload = scorer.ctx, scorer.graphs.payload(scorer.holder.get())
    finally:
        scorer.close()
    if ctx.rank_cfg.model_name != "xdeepfm" or (DEVICE == "cuda" and min(retr, fwd) <= 0):
        fail(f"families funnel: ranker {ctx.rank_cfg.model_name}, B2 {retr} and B1 {fwd} "
             f"runs")
    stats = check_funnel_answers(ctx, payload, requests, served, FUNNEL_BUCKETS,
                                 "families funnel")
    out = {"ranker": ctx.rank_cfg.model_name, "retrieval": ctx.retrieval_mode,
           "launches": [retr, fwd], "vs_plain": stats}
    print("families funnel %s" % json.dumps(out))
    return out


def family_online(name: str, seed: int, workdir: str) -> dict:
    """The online trainer of ``name`` (OnlineTrainer.run, the graphed
    single-card step) over FAM_ONLINE_SEGMENTS segments of distinct ids,
    committing and publishing every FAM_ONLINE_EVERY steps: every segment
    trained, the final state bit-equal to one pass of the log
    (replay_to_state), the versions of the family with the last one's
    param_hash that state's, and its servable's answers that state's (the
    serve task's reload source).  Counts: the trainer's B1 and B1' runs."""
    from deepfm_tpu_torch.convert import params_to_jax
    from deepfm_tpu_torch.core.config import Config
    from deepfm_tpu_torch.data.example_proto import parse_example
    from deepfm_tpu_torch.online import (OnlineTrainer, latest_manifest, list_versions,
                                         param_tree_hash, read_manifest, version_location)
    from deepfm_tpu_torch.online.trainer import replay_to_state
    from deepfm_tpu_torch.serve.export import load_servable
    from deepfm_tpu_torch.train.step import predict_step

    stream, pub = os.path.join(workdir, "events"), os.path.join(workdir, "publish")
    write_online(stream, (online_records(seed + 63, s) for s in range(FAM_ONLINE_SEGMENTS)))
    cfg = Config.from_dict({
        "model": {"model_name": name, "feature_size": LIFE_VOCAB, **FAM_MODEL},
        "optimizer": {"learning_rate": 5e-4},
        "data": {"training_data_dir": stream, "batch_size": LIFE_BATCH},
        "run": {"model_dir": os.path.join(workdir, "ckpt"), "servable_model_dir": pub,
                "checkpoint_every_steps": FAM_ONLINE_EVERY,
                "online_publish_every_steps": FAM_ONLINE_EVERY, "seed": seed,
                "log_steps": 1000}})
    reset_kernel_counts()
    state = OnlineTrainer(cfg, device=DEVICE).run(follow=False)
    fwd, bwd = kernel_runs()
    steps = FAM_ONLINE_SEGMENTS
    if state.step != steps:
        fail(f"families {name} online: {state.step} steps over {steps} segments")
    if DEVICE == "cuda" and ((name == "xdeepfm" and min(fwd, bwd) < steps)
                             or (name != "xdeepfm" and fwd + bwd)):
        fail(f"families {name} online: {steps} steps ran B1 {fwd} and B1' {bwd} times")
    oracle = replay_to_state(cfg, device=DEVICE)
    got, want = state.model.state_dict(), oracle.model.state_dict()
    if any(not torch.equal(got[k], want[k]) for k in want):
        fail(f"families {name} online: the trained state differs from one pass of the log")
    versions = list_versions(pub)
    manifests = [read_manifest(pub, v) for v in versions]
    last = latest_manifest(pub)
    if (len(versions) != steps // FAM_ONLINE_EVERY
            or any(m.model_name != name for m in manifests)
            or last.param_hash != param_tree_hash(*params_to_jax(
                {k: v.cpu() for k, v in got.items()}, cfg.model))):
        fail(f"families {name} online: manifests {[(m.version, m.model_name) for m in manifests]}")
    predict, _ = load_servable(version_location(pub, last.version), device=DEVICE)
    parsed = [parse_example(r) for r in online_records(seed + 63, 0)[:8]]
    ids = np.stack([p["ids"] for p in parsed]).astype(np.int64)
    vals = np.stack([p["values"] for p in parsed]).astype(np.float32)
    served = predict(ids, vals)
    ref = predict_step(state.model, {"feat_ids": torch.from_numpy(ids).to(DEVICE),
                                     "feat_vals": torch.from_numpy(vals).to(DEVICE)})
    err = float(np.abs(served - ref.cpu().numpy()).max())
    if not err <= TOL_GRAPH:
        fail(f"families {name} online: the published version answers {err} from the state")
    out = {"steps": steps, "versions": versions, "launches": [fwd, bwd],
           "replay_bit_equal": True, "published_vs_state": err}
    print(f"families {name} online %s" % json.dumps(out))
    return out


def family_elastic_standby(seed: int, root: str) -> _ElasticJob:
    """The xDeepFM elastic drill's job: elastic_doc's config at phase 21's
    xDeepFM (model_zoo's MLP, the CIN 128/128, dropout off, lazy Adam),
    commits and publishes every FAM_ELASTIC[0] steps; all six rank
    processes started now as warm standbys (ranks 0-3 released by
    family_elastic, 4 and 5 at the grow)."""
    def doc_fn(url):
        doc = elastic_doc(seed, root, url, True, False)
        doc["model"].update(model_name="xdeepfm", deep_layers=list(FAM_MODEL["deep_layers"]),
                            cin_layers=list(FAM_MODEL["cin_layers"]),
                            dropout_keep=[1.0] * len(FAM_MODEL["deep_layers"]))
        doc["run"].update(checkpoint_every_steps=FAM_ELASTIC[0],
                          online_publish_every_steps=FAM_ELASTIC[0])
        return doc

    job = _ElasticJob(root, [0, 1, 2, 3], doc_fn)
    for i in ELASTIC_IDS:
        job.start(i, os.path.join(root, "grow" if i in ELASTIC_JOINERS else "release"))
    return job


def family_elastic(seed: int, job: _ElasticJob) -> dict:
    """The xDeepFM drill on its standby job: [2, 2] -> [1, 2] after
    FAM_ELASTIC[0] steps (devices 2 and 3 off the board) -> [2, 2] after
    FAM_ELASTIC[1] (4 and 5 join), FAM_ELASTIC[2] steps: the reshards'
    shapes (0 table bytes moved on the shrink, more on the grow; its CIN
    moves as a replicated parameter), no step replayed, a strictly
    increasing lineage, every manifest at the true vocabulary and of
    xDeepFM, B1 and B1' on each rank's first compact rows of each epoch
    against their plain versions, finite final weights.  Counts: the
    ranks' B1 and B1' runs (main path)."""
    from deepfm_tpu_torch.elastic.mpmd import read_payload_tree
    from deepfm_tpu_torch.online import list_versions, read_manifest

    shrink, grow, total = FAM_ELASTIC
    t0 = time.perf_counter()
    try:
        job.feed(seed, 0, shrink)
        open(os.path.join(job.root, "release"), "w").close()
        job.wait_until(f"commit of step {shrink}", job.committed(shrink))
        job.board.remove(2, 3)
        job.wait_until("the epoch of devices 0 and 1", job.epoch_of([0, 1]))
        for i in (2, 3):
            job.finish(i)
        job.feed(seed, shrink, grow)
        job.wait_until(f"commit of step {grow}", job.committed(grow))
        job.board.add(*ELASTIC_JOINERS)
        open(os.path.join(job.root, "grow"), "w").close()
        job.wait_until("the epoch of devices 0, 1, 4 and 5", job.epoch_of([0, 1, 4, 5]))
        job.feed(seed, grow, total)
        job.wait_until(f"commit of step {total}", job.committed(total))
        job.stop((0, 1, *ELASTIC_JOINERS))
    finally:
        job.close()
    seconds = time.perf_counter() - t0
    results = job.results()
    for i, r in zip(ELASTIC_IDS, results):
        if r is None or r["error"] is not None:
            fail(f"families elastic: device {i}: {r and r['error']}")
    r0, doc = results[0], job.doc
    shapes = [(r["from_mesh"], r["to_mesh"]) for r in r0["reshards"]]
    if shapes != [([2, 2], [1, 2]), ([1, 2], [2, 2])] \
            or not r0["reshards"][0]["moved_bytes"] == 0 < r0["reshards"][1]["moved_bytes"] \
            or any(r["steps_replayed"] for r in r0["reshards"]):
        fail("families elastic: reshards %s" % json.dumps(r0["reshards"]))
    lineage = r0["lineage"]
    if len(lineage) != total or not all(a < b for a, b in zip(lineage, lineage[1:])):
        fail(f"families elastic: cursor lineage of {len(lineage)}: {lineage}")
    if [r["left"] for r in results] != [i in (2, 3) for i in ELASTIC_IDS]:
        fail(f"families elastic: left {[r['left'] for r in results]}")
    pub = doc["run"]["servable_model_dir"]
    manifests = [read_manifest(pub, v) for v in list_versions(pub)]
    if len(manifests) < 2 or any((m.feature_size, m.model_name) != (LIFE_VOCAB, "xdeepfm")
                                 for m in manifests):
        fail(f"families elastic: manifests "
             f"{[(m.version, m.feature_size, m.model_name) for m in manifests]}")
    err, epochs = {"forward": 0.0, "backward": 0.0}, 0
    for r in results:
        for e in r["kernel_err"]:
            epochs += 1
            (emb, _), (y_w, sw), _ = e["forward"]
            if not (emb <= TOL_EMB and y_w <= TOL_YW_REL * (1.0 + sw)):
                fail(f"families elastic: fused_ctr_forward on a rank's compact rows: {e}")
            for b_err, scale in e["backward"]:
                if not b_err <= TOL_GRAD_REL * scale:
                    fail(f"families elastic: fused_ctr_backward on a rank's compact rows: {e}")
            err["forward"] = max(err["forward"], emb, y_w)
            err["backward"] = max(err["backward"], *(x for x, _ in e["backward"]))
    if DEVICE == "cuda" and any(r["launches"] < 1 or r["backward_launches"] < 1
                                for r in results):
        fail(f"families elastic: B1/B1' runs by rank "
             f"{[(r['launches'], r['backward_launches']) for r in results]}")
    final = read_payload_tree(doc["run"]["model_dir"], step=total)[1]["model"]
    if "cin.filter_0" not in final or not all(torch.isfinite(t).all() for t in final.values()):
        fail(f"families elastic: the final commit holds {sorted(final)[:8]}, not finite")
    out = {"reshards": [{k: r[k] for k in ("from_mesh", "to_mesh", "moved_bytes",
                                           "kept_bytes", "steps_replayed", "wall_secs")}
                        for r in r0["reshards"]],
           "steps": total, "versions": len(manifests), "epochs_kernel_checked": epochs,
           "kernel_vs_plain_max_abs_err": err, "step_host_ms": r0["step_ms"],
           "launches": [sum(r["launches"] for r in results),
                        sum(r["backward_launches"] for r in results)], "seconds": seconds}
    print("families elastic %s" % json.dumps(out))
    return out


def phase_families(seed: int, workdir: str, card: str, train_dir: str, val_dir: str,
                   funnel_servable: str) -> dict:
    """Phase 21 (ROADMAP A12): the other model families through the port's
    entry points at model_zoo's widths (module docstring)."""
    t0 = time.perf_counter()
    fam_train, fam_val = os.path.join(workdir, "train"), os.path.join(workdir, "val")
    os.makedirs(fam_train)
    os.makedirs(fam_val)
    for i in range(FAM_TRAIN_FILES):
        os.symlink(os.path.join(train_dir, f"train-{i}.tfrecords"),
                   os.path.join(fam_train, f"train-{i}.tfrecords"))
    os.symlink(os.path.join(val_dir, "val-0.tfrecords"), os.path.join(fam_val, "val-0.tfrecords"))
    out = {"launches": 0, "backward_launches": 0, "retrieval_launches": 0}
    line = {"card": card}
    out["kernels"] = family_kernels(seed, train_dir)
    fwd_errs, bwd_errs = [], []
    drill = start_two_tower_grid(seed, os.path.join(workdir, "two_tower_grid"))
    standby = None
    try:
        for name in FAM_FAMILIES:
            tasks = family_tasks(name, seed, fam_train, fam_val, os.path.join(workdir, name))
            os.remove(os.path.join(fam_val, "pred.txt"))
            out["launches"] += tasks.pop("launches")
            out["backward_launches"] += tasks.pop("backward_launches")
            tasks["buckets"] = family_buckets(
                name, seed, os.path.join(workdir, name, "dense", "servable"))
            out["launches"] += tasks["buckets"]["b1_runs"]
            tasks["graphed"] = family_graphed(name, seed)
            line[name] = tasks
        # the other CTR paths; the elastic drill's ranks boot meanwhile
        standby = family_elastic_standby(seed, os.path.join(workdir, "elastic"))
        path_s = {}
        for name in FAM_FAMILIES:
            tasks, t1 = line[name], time.perf_counter()
            servable = os.path.join(workdir, name, "dense", "servable")
            tasks["member"] = family_member(name, servable)
            out["launches"] += tasks["member"]["b1_runs"]
            tasks["online"] = family_online(name, seed, os.path.join(workdir, name, "online"))
            out["launches"] += tasks["online"]["launches"][0]
            out["backward_launches"] += tasks["online"]["launches"][1]
            path_s[f"{name} member+online"] = time.perf_counter() - t1
            if name == "xdeepfm":
                t1 = time.perf_counter()
                tiered = family_tiered(seed, os.path.join(workdir, name, "tiered"))
                out["launches"] += tiered["launches"][0]
                out["backward_launches"] += tiered["launches"][1]
                fwd_errs += tiered.pop("forward_errs")
                bwd_errs += tiered.pop("backward_errs")
                tasks["tiered"] = tiered
                path_s["xdeepfm tiered"] = t2 = time.perf_counter() - t1
                tasks["funnel"] = family_funnel(seed, os.path.join(workdir, name),
                                                funnel_servable, servable)
                out["retrieval_launches"] += tasks["funnel"]["launches"][0]
                out["launches"] += tasks["funnel"]["launches"][1]
                path_s["xdeepfm funnel"] = time.perf_counter() - t1 - t2
        elastic = family_elastic(seed, standby)
        path_s["xdeepfm elastic"] = elastic["seconds"]
        out["launches"] += elastic["launches"][0]
        out["backward_launches"] += elastic["launches"][1]
        fwd_errs.append(elastic["kernel_vs_plain_max_abs_err"]["forward"])
        bwd_errs.append(elastic["kernel_vs_plain_max_abs_err"]["backward"])
        line["xdeepfm"]["elastic"] = elastic
        line["paths_s"] = path_s
        tt = two_tower_tasks(seed, os.path.join(workdir, "two_tower"))
        tt["step_device_ms_8_4_fields"] = two_tower_step_ms(seed)
        tt["grid"] = finish_two_tower_grid(drill)
    finally:  # the drills' ranks end with the phase, whatever happened
        if standby is not None:
            standby.close()
        for p in drill["ctx"].processes:
            if p.is_alive():
                p.kill()
    line["two_tower"] = tt
    line["seconds"] = time.perf_counter() - t0
    print("families %s" % json.dumps(line))
    kernels = out["kernels"]
    return {**out, "max_abs_err": max(*kernels["forward_max_abs_err"], *fwd_errs),
            "backward_max_abs_err": max(*kernels["backward_max_abs_err"], *bwd_errs),
            "line": line}


# the fleet phase: tenants A and B split 50/50 over one [1, 1] member,
# challenger C shadowing A, FLEET_KEYS keyed requests of 1 to 4 rows,
# FLEET_CLIENTS clients across A's swap, two region routers over the member
FLEET_KEYS, FLEET_CLIENTS, FLEET_REGIONS = 400, 4, ("use1", "euw1")


def fleet_weights(seed: int, cfg) -> dict:
    """Host state dicts at the flagship width: A v1, B v1 and C v1 from
    their own seeds, A v2 = A v1 moved by 0.01·N(0, 1)."""
    from deepfm_tpu_torch.models import DeepFM

    out = {}
    for i, t in enumerate("ABC"):
        out[t, 1] = {k: v.numpy() for k, v in DeepFM(
            cfg, device="cpu",
            generator=torch.Generator().manual_seed(seed + 50 + i)).state_dict().items()}
    rng = np.random.default_rng(seed + 53)
    out["A", 2] = {k: (v + 0.01 * rng.standard_normal(v.shape)).astype(v.dtype)
                   for k, v in out["A", 1].items()}
    return out


def fleet_slot_bytes(cfg, servable: str) -> dict:
    """A member's predictor at one and at two tenants in this process, both
    alive at once: the card bytes each one's slots and captured bucket
    graphs hold (allocated, after capture) and its graph count."""
    import gc

    from deepfm_tpu_torch.serve.export import read_params
    from deepfm_tpu_torch.serve.pool.sharded import ShardedPredictor, make_serve_context

    out, kept = {}, []
    if DEVICE != "cuda":
        return out
    sd = read_params(servable)
    ctx = make_serve_context(cfg, 1, 1, device=DEVICE)
    for n in (1, 2):
        # earlier phases' garbage freed first, so no collection during the
        # build lowers the count under it
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        kept.append(ShardedPredictor(ctx, sd, buckets=POOL_BUCKETS, tenants=n))
        kept[-1].precompile()
        torch.cuda.synchronize()
        out[n] = {"allocated_bytes": torch.cuda.memory_allocated() - base,
                  "graphs": kept[-1].graph_count,
                  "build_and_capture_s": time.perf_counter() - t0}
    del kept
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _fleet_body(rng: np.random.Generator, cfg, key: str | None = None):
    n = int(rng.integers(1, 5))
    ids = make_ids(rng, n, cfg.field_size, cfg.feature_size)
    vals = rng.random((n, cfg.field_size)).astype(np.float32)
    doc = {"instances": [{"feat_ids": a.tolist(), "feat_vals": b.tolist()}
                         for a, b in zip(ids, vals)]}
    if key is not None:
        doc["key"] = key
    return ids, vals, json.dumps(doc).encode()


class _FleetPlain:
    """Each (tenant, version)'s plain answers on the card: the eager model
    of its weights through the plain B1, at the bucket a dispatch pads to."""

    def __init__(self, cfg, weights: dict):
        from deepfm_tpu_torch.serve.export import model_from_state

        self.models = {tv: model_from_state(cfg, w, DEVICE) for tv, w in weights.items()}
        self.worst = 0.0

    def check(self, tv, ids, vals, preds, what: str) -> None:
        from deepfm_tpu_torch.serve.batcher import pick_bucket

        want = plain_probs(self.models[tv], ids, vals, pick_bucket(POOL_BUCKETS, len(ids)))
        err = float(np.abs(np.asarray(preds, np.float32) - want).max())
        self.worst = max(self.worst, err)
        if not np.isfinite(preds).all() or err > TOL_PROB:
            fail(f"fleet: {what}: tenant {tv[0]} v{tv[1]} answered {err} off its plain forward")


def fleet_isolation(base: str, member: str, publish: dict, weights: dict, cfg, plain,
                    seed: int, cli) -> dict:
    """(c) A's v2 published under FLEET_CLIENTS clients, half on A, half on
    B: A's swapper converges; B's answers stay the same bytes (each
    labelled generation 1, version 1), A's are labelled (1, 1) or (2, 2)
    only and held to their version's plain answers; the member captures
    nothing."""
    from deepfm_tpu_torch.online.publisher import ModelPublisher

    rng = np.random.default_rng(seed + 54)
    bodies = {t: [_fleet_body(rng, cfg) for _ in range(8)] for t in "AB"}
    port = int(urllib.parse.urlsplit(base).port)
    conn = _Client(port)
    ref = {}
    try:
        for i, (_, _, body) in enumerate(bodies["B"]):
            code, _, raw = conn.post("/v1/models/deepfm:predict", body,
                                     {"Content-Type": "application/json", "X-Tenant": "B"})
            ref[i] = json.loads(raw)["predictions"] if code == 200 else fail(
                f"fleet: B's reference answered {code}")
    finally:
        conn.close()
    graphs = get(f"{member}/v1/metrics")["reload"]["graphs"]
    results, errors, stop = {"A": [], "B": []}, [], threading.Event()

    def client(t: str, k: int):
        c = _Client(port)
        try:
            j = k
            while not stop.is_set():
                j = (j + 1) % len(bodies[t])
                code, _, raw = c.post("/v1/models/deepfm:predict", bodies[t][j][2],
                                      {"Content-Type": "application/json", "X-Tenant": t})
                (results[t] if code == 200 else errors).append((j, code, json.loads(raw)))
        finally:
            c.close()

    threads = [threading.Thread(target=client, args=(t, k), daemon=True)
               for t in "AB" for k in range(FLEET_CLIENTS // 2)]
    for t in threads:
        t.start()
    time.sleep(0.5)
    t0 = time.perf_counter()
    ModelPublisher(publish["A"], keep=8).publish(cfg, weights["A", 2], step=2)
    _wait_ready(member, cli, timeout=120,
                want=lambda d: d["tenants"]["A"]["model_version"] == 2)
    converged = time.perf_counter() - t0
    time.sleep(0.5)
    stop.set()
    for t in threads:
        t.join(timeout=60)
    b_bad = [d for j, _, d in results["B"]
             if d["predictions"] != ref[j] or (d["group_generation"], d["model_version"],
                                               d["tenant"]) != (1, 1, "B")]
    pairs = {(d["group_generation"], d["model_version"]) for _, _, d in results["A"]}
    mixed = [d for _, _, d in results["A"]
             if (d["group_generation"], d["model_version"]) not in ((1, 1), (2, 2))]
    if errors or b_bad or mixed or (2, 2) not in pairs or len(results["B"]) < 20:
        fail(f"fleet: across A's swap {len(errors)} failed (first {errors[:2]}), "
             f"{len(b_bad)} of B's {len(results['B'])} answers moved, A's pairs {pairs} "
             f"({len(mixed)} mixed)")
    for j, _, d in results["A"][::max(1, len(results["A"]) // 100)]:
        ids, vals, _ = bodies["A"][j]
        plain.check(("A", d["model_version"]), ids, vals, d["predictions"], "across A's swap")
    metrics = get(f"{member}/v1/metrics")
    if metrics["reload"]["graphs"] != graphs:
        fail(f"fleet: the member's graphs went from {graphs} to {metrics['reload']['graphs']}")
    return {"converged_after_publish_s": converged, "answered_a": len(results["A"]),
            "answered_b": len(results["B"]), "b_moved": len(b_bad), "mixed": len(mixed),
            "failed": len(errors), "a_pairs": sorted(pairs), "graphs": graphs,
            "tenant_timings": metrics["reload"]["tenant_timings"]}


def fleet_region_start(member: str, cfg, weights: dict, workdir: str) -> dict:
    """(f)'s set-up, started while the pool boots: a home root with version
    1, two regions each an in-process router over the member (they eject it
    until it is ready) with its own store, and `--task_type region-front`
    over them, whose replicator fills the stores."""
    from deepfm_tpu_torch.online.publisher import ModelPublisher
    from deepfm_tpu_torch.serve.pool.router import start_router

    home = os.path.join(workdir, "region_home")
    ModelPublisher(home, keep=8).publish(cfg, weights["B", 1], step=1)
    routers = {name: start_router({"g0": [member]}, probe_interval_secs=0.2)
               for name in FLEET_REGIONS}
    stores = {name: os.path.join(workdir, f"region_store_{name}") for name in FLEET_REGIONS}
    fport = _free_port()
    regions = [{"name": n, "router_url": routers[n][1], "store_root": stores[n]}
               for n in FLEET_REGIONS]
    cli = _Cli("fleet region front", [
        "--task_type", "region-front", "--set", "regions.enabled=true",
        "--set", f"regions.home_root={home}", "--set", "regions.regions=" + json.dumps(regions),
        "--set", f"regions.front_port={fport}", "--set", "regions.replication_poll_secs=0.1",
        "--set", "regions.probe_interval_secs=0.2", "--set", "regions.failover_budget_pct=100",
        "--set", "run.keep_checkpoints=3"], workdir, env=_pool_env(workdir, "region_front"))
    return {"home": home, "routers": routers, "stores": stores, "cli": cli,
            "front": f"http://127.0.0.1:{fport}"}


def fleet_region_stop(region: dict) -> None:
    _stop_tree(region["cli"])
    for httpd, _, router in region["routers"].values():
        httpd.shutdown()
        httpd.server_close()
        router.close()
    region["routers"].clear()


def fleet_region(region: dict, cfg, weights: dict) -> dict:
    """(f) `--task_type region-front` over two regions, each a router over
    the member with its own store that the front's replicator fills from a
    home root: each key served by its rendezvous home; a version published
    at home appears marker-last in both stores; one router stopped, its
    keys fail over with X-Region, X-Region-Home and the client's trace
    id."""
    from deepfm_tpu_torch.fleet import rendezvous_ranking
    from deepfm_tpu_torch.online.publisher import ModelPublisher, list_versions

    home, routers, stores, cli = (region[k] for k in ("home", "routers", "stores", "cli"))
    front = region["front"]
    out = {}
    _wait_ready(front, cli, timeout=120)
    # every region back in (its router ejected the member until it was
    # ready) and version 1 in both stores
    deadline = time.monotonic() + 60
    while any(list_versions(s) != [1] for s in stores.values()) or not all(
            r["admitted"] for r in get(f"{front}/v1/metrics")["regions"].values()):
        if time.monotonic() > deadline or cli.proc.poll() is not None:
            cli.fail("the regions were not all admitted with version 1 in their stores")
        time.sleep(0.05)
    rng = np.random.default_rng(7)
    names = sorted(FLEET_REGIONS)
    for i in range(24):
        key = f"region-user-{i}"
        _, _, body = _fleet_body(rng, cfg, key)
        req = urllib.request.Request(f"{front}/v1/models/deepfm:predict", data=body,
                                     headers={"X-Tenant": "B"})
        with urllib.request.urlopen(req, timeout=60) as r:
            doc, hdrs = json.load(r), dict(r.headers)
        home_region = rendezvous_ranking(key, names)[0]
        if (doc["region"] != {"served": home_region, "home": home_region, "attempts": 1}
                or (hdrs["X-Region"], hdrs["X-Region-Home"]) != (home_region,
                                                                 home_region)):
            fail(f"fleet: {key} was not served by its home {home_region}: "
                 f"{doc['region']} {hdrs}")
    # a version published at home: in each store the manifest appears
    # only once its tree is whole
    ModelPublisher(home, keep=8).publish(cfg, weights["A", 2], step=2)
    home_tree = {f: os.path.getsize(os.path.join(home, "versions", "00000002", f))
                 for f in os.listdir(os.path.join(home, "versions", "00000002"))}
    t0, seen = time.perf_counter(), {}
    while len(seen) < len(stores):
        for name, store in stores.items():
            if name not in seen and os.path.exists(
                    os.path.join(store, "MANIFEST-00000002.json")):
                tree = os.path.join(store, "versions", "00000002")
                got = {f: os.path.getsize(os.path.join(tree, f)) for f in os.listdir(tree)}
                if got != home_tree:
                    fail(f"fleet: {name}'s manifest 2 is visible before its tree "
                         f"({got} != {home_tree})")
                seen[name] = time.perf_counter() - t0
        if time.perf_counter() - t0 > 60:
            fail(f"fleet: version 2 reached only {sorted(seen)}")
        time.sleep(0.005)
    out["replicated_s"] = seen
    # one region's router stopped: its keys fail over with the headers
    # and the client's trace id
    down = FLEET_REGIONS[1]
    up = next(n for n in FLEET_REGIONS if n != down)
    httpd, _, router = routers.pop(down)
    httpd.shutdown()
    httpd.server_close()
    router.close()
    keys = [k for k in (f"failover-user-{i}" for i in range(200))
            if rendezvous_ranking(k, names)[0] == down][:6]
    lat = []
    for i, key in enumerate(keys):
        _, _, body = _fleet_body(rng, cfg, key)
        trace = f"fleet-failover-{i:04d}"
        t1 = time.perf_counter()
        req = urllib.request.Request(f"{front}/v1/models/deepfm:predict", data=body,
                                     headers={"X-Tenant": "B", "X-Trace-Id": trace})
        with urllib.request.urlopen(req, timeout=60) as r:
            doc, hdrs = json.load(r), dict(r.headers)
        lat.append((time.perf_counter() - t1) * 1e3)
        if (doc["region"]["served"], doc["region"]["home"]) != (up, down) or (
                hdrs["X-Region"], hdrs["X-Region-Home"], hdrs["X-Trace-Id"]) != (
                up, down, trace):
            fail(f"fleet: {key} after {down} stopped: {doc['region']} {hdrs}")
    traced = {t["trace_id"] for t in routers[up][2].tracer.recent()}
    if not {f"fleet-failover-{i:04d}" for i in range(len(keys))} <= traced:
        fail("fleet: the surviving router did not see the failed-over trace ids")
    out.update(failover_ms=lat, failover_keys=len(keys),
               front=get(f"{front}/v1/metrics")["regions"])
    cli.proc.send_signal(signal.SIGTERM)
    if cli.finish(timeout=60) != 0:
        cli.fail("SIGTERM did not stop the region front with exit 0")
    return out


def phase_fleet(seed: int, workdir: str, card: str, one_tenant_bytes: list) -> dict:
    """Phase 22 (ROADMAP A18 and A19): the multi-tenant fleet and the
    cross-region front at the flagship width (module docstring)."""
    from deepfm_tpu_torch.fleet import TrafficSplit
    from deepfm_tpu_torch.online.publisher import ModelPublisher

    t_phase = time.perf_counter()
    os.makedirs(workdir, exist_ok=True)
    cfg, servable, _, _ = pool_servable(seed, workdir)
    weights = fleet_weights(seed, cfg)
    publish = {t: os.path.join(workdir, f"publish_{t}") for t in "ABC"}
    for t, root in publish.items():
        ModelPublisher(root, keep=8).publish(cfg, weights[t, 1], step=1)
    tenants = [{"name": "A", "source": publish["A"], "split_percent": 50},
               {"name": "B", "source": publish["B"], "split_percent": 50},
               {"name": "C", "source": publish["C"], "shadow_of": "A"}]
    # the serve task's member binds the supervisor's default port
    _check_ports_free([POOL_MEMBER_PORT_BASE], "fleet: the member's port")
    member = f"http://127.0.0.1:{POOL_MEMBER_PORT_BASE}"
    rport = _free_port()
    device_args = ["--device", "cpu"] if DEVICE == "cpu" else []
    t0 = time.perf_counter()
    cli = _Cli("fleet pool", [
        "--task_type", "serve", "--servable_model_dir", servable, "--serve_groups", "1",
        "--serve_tenants", json.dumps(tenants), "--set", f"run.serve_router_port={rport}",
        "--set", "run.serve_buckets=" + ",".join(map(str, POOL_BUCKETS)),
        "--set", "run.serve_reload_interval_secs=0.2",
        "--set", "run.serve_health_interval_secs=0.2",
        "--set", "fleet.shadow_sample_percent=100", *device_args],
        workdir, env=_pool_env(workdir, "fleet_pool"))
    base = f"http://127.0.0.1:{rport}"
    region = None
    try:
        # while the pool boots: the region front's processes, this
        # process's predictors at one and two tenants, the plain models
        region = fleet_region_start(member, cfg, weights, workdir)
        line = {"card": card, "slot_bytes_in_process": fleet_slot_bytes(cfg, servable)}
        plain = _FleetPlain(cfg, weights)
        if _router_member_urls(base, cli, n=1) != [member]:
            fail(f"fleet: the router lists {_router_member_urls(base, cli, n=1)}")
        _wait_ready(member, cli, want=lambda d: all(
            t["model_version"] == 1 for t in d.get("tenants", {}).values()))
        _wait_ready(base, cli)
        line["boot_s"] = time.perf_counter() - t0
        line["member_device_max_reserved_bytes"] = {
            "1 tenant (phase 18's group members)": one_tenant_bytes,
            "3 tenants": get(f"{member}/v1/metrics")["router"].get("device_max_reserved_bytes")}
        # (b) keyed requests on the split's arms, each tenant's answers
        # held to its plain forward
        split = TrafficSplit({"A": 50.0, "B": 50.0})
        rng = np.random.default_rng(seed + 55)
        keyed = [(f"user-{i}", *_fleet_body(rng, cfg, f"user-{i}")) for i in range(FLEET_KEYS)]
        conn = _Client(rport)
        try:
            arms = {}
            for key, ids, vals, body in keyed:
                code, _, raw = conn.post("/v1/models/deepfm:predict", body,
                                         {"Content-Type": "application/json"})
                doc = json.loads(raw)
                if code != 200 or doc["tenant"] != split.arm(key):
                    fail(f"fleet: {key} answered {code} by {doc.get('tenant')}, its arm is "
                         f"{split.arm(key)}")
                plain.check((doc["tenant"], 1), ids, vals, doc["predictions"], "split")
                arms[key] = doc["tenant"]
        finally:
            conn.close()
        line["split_counts"] = {t: list(arms.values()).count(t) for t in "AB"}
        line["max_abs_err"] = plain.worst
        # (c) A's swap under traffic leaves B's answers
        line["isolation"] = fleet_isolation(base, member, publish, weights, cfg, plain, seed,
                                            cli)
        # (d) re-split to 80/20: exactly the keys of the shifted window move
        code, doc = post(f"{base}/admin:split",
                         json.dumps({"percentages": {"A": 80.0, "B": 20.0}}).encode())
        if code != 200:
            fail(f"fleet: /admin:split answered {code}: {doc}")
        split.set_percentages({"A": 80.0, "B": 20.0})
        conn = _Client(rport)
        moved = []
        try:
            for key, ids, vals, body in keyed:
                code, _, raw = conn.post("/v1/models/deepfm:predict", body,
                                         {"Content-Type": "application/json"})
                doc = json.loads(raw)
                if code != 200 or doc["tenant"] != split.arm(key):
                    fail(f"fleet: after the re-split {key} went to {doc.get('tenant')}")
                if doc["tenant"] != arms[key]:
                    moved.append(key)
                plain.check((doc["tenant"], doc["model_version"]), ids, vals,
                            doc["predictions"], "re-split")
        finally:
            conn.close()
        want_moved = [k for k, _, _, _ in keyed if arms[k] == "B" and split.arm(k) == "A"]
        if moved != want_moved or not moved:
            fail(f"fleet: the re-split moved {len(moved)} keys, the window holds "
                 f"{len(want_moved)}")
        line["resplit_moved"] = len(moved)
        # (e) the challenger scored A's stream, and no answer came from it
        deadline = time.monotonic() + 30
        while True:
            shadow = get(f"{base}/v1/metrics")["tenants"]["C"]["shadow"]
            if shadow["scored_total"] + shadow["errors_total"] + shadow["shed_total"] \
                    >= shadow["offered_total"] or time.monotonic() > deadline:
                break
            time.sleep(0.1)
        if shadow["scored_total"] <= 0 or shadow["errors_total"]:
            fail(f"fleet: the shadow {shadow}")
        line["shadow"] = shadow
        line["region"] = fleet_region(region, cfg, weights)
        cli.proc.send_signal(signal.SIGTERM)
        if cli.finish(timeout=120) != 0:
            cli.fail("SIGTERM did not stop the fleet pool with exit 0")
    finally:
        if region is not None:
            fleet_region_stop(region)
        _stop_tree(cli)
    (member_line,) = cli.kind("kernel_runs")
    if DEVICE == "cuda" and member_line["forward"] <= 0:
        fail(f"fleet: the member launched no B1: {member_line}")
    line["member_kernel_runs"] = member_line
    line["seconds"] = time.perf_counter() - t_phase
    print("fleet %s" % json.dumps(line))
    return {"launches": member_line["forward"], "max_abs_err": plain.worst, "line": line}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="Smoke run of the port on one Hopper card.")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script runs "
              "the port on an NVIDIA Hopper card", file=sys.stderr)
        return 2
    try:
        from deepfm_tpu_torch import native
        from deepfm_tpu_torch.core.platform import resolve_device
        from deepfm_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the port's package is not beside this script: {e}",
              file=sys.stderr)
        return 2

    t_main = _phase["t0"] = time.perf_counter()
    start_watchdog(WATCHDOG_S)
    dev = resolve_device("cuda")
    card = card_line()
    print(f"card: {card} (torch {torch.__version__}, CUDA {torch.version.cuda})")

    t0 = time.perf_counter()
    begin("build")
    built = _build.build()
    print(f"build: {sorted(_build.sources())} in {time.perf_counter() - t0:.2f} s")
    native_s = native.build()
    print(f"build: the native record reader and Criteo encoder ({native.SOURCE}, "
          f"{native.ENCODER_SOURCE}, g++) in {native_s:.2f} s")
    for name, info in built.items():
        print(f"build {name}: {info['seconds']:.2f} s\n{info['log'].strip()}", file=sys.stderr)

    begin("kernel")
    kernel = phase_kernel(args.seed)
    begin("backward")
    backward = phase_backward(args.seed)
    begin("b2")
    b2 = phase_b2(args.seed)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        begin("serve")
        serve = phase_serve(args.seed, os.path.join(workdir, "serve"))
        train_dir, val_dir = (os.path.join(workdir, d) for d in ("train", "val"))
        os.makedirs(train_dir)
        os.makedirs(val_dir)
        write_synthetic(args.seed, train_dir, val_dir)
        begin("parity")
        phase_parity(args.seed, train_dir)
        begin("train")
        train = phase_train(args.seed, train_dir, val_dir,
                            os.path.join(workdir, "trained_servable"))
        begin("lazy")
        lazy = phase_lazy(args.seed, train_dir, val_dir,
                          os.path.join(workdir, "lazy_servable"),
                          train["breakdown"][TRAIN_BATCHES[0]])
        begin("graphed")
        phase_graphed(args.seed, train, lazy)
        begin("ddp")
        ddp = phase_ddp(args.seed, workdir)
        begin("sharded")
        sharded = phase_sharded(args.seed, os.path.join(workdir, "sharded"))
        begin("lifecycle")
        life = phase_lifecycle(args.seed, os.path.join(workdir, "lifecycle"), val_dir,
                               train_dir, os.path.join(workdir, "readers"))
        begin("tiered")
        tiered = phase_tiered(args.seed, os.path.join(workdir, "tiered"), train_dir,
                              os.path.join(workdir, "lifecycle", "life"))
        begin("online")
        online = phase_online(args.seed, os.path.join(workdir, "online"), card)
        begin("elastic")
        elastic = phase_elastic(args.seed, os.path.join(workdir, "elastic"), card,
                                os.path.join(workdir, "lifecycle", "life"))
        begin("funnel")
        funnel = phase_funnel(args.seed, os.path.join(workdir, "funnel"))
        begin("funnel_swap")
        swap = phase_funnel_swap(args.seed, os.path.join(workdir, "funnel_swap"), card,
                                 os.path.join(workdir, "funnel"))
        begin("pool")
        pool = phase_pool(args.seed, os.path.join(workdir, "pool"), card,
                          os.path.join(workdir, "funnel"), serve["ab"]["graphed"])
        begin("prep")
        prep = phase_prep(args.seed, os.path.join(workdir, "prep"), card)
        begin("stream")
        stream = phase_stream(args.seed, os.path.join(workdir, "stream"), card, train_dir,
                              val_dir, life["readers"])
        begin("families")
        fam = phase_families(args.seed, os.path.join(workdir, "families"), card, train_dir,
                             val_dir, os.path.join(workdir, "funnel"))
        begin("fleet")
        fleet = phase_fleet(args.seed, os.path.join(workdir, "fleet"), card,
                            pool["member_device_bytes"])

    fwd = kernel["per_bucket"][TRAIN_BATCHES[0]]
    bwd = backward["per_batch"][TRAIN_BATCHES[0]]
    # B2 at the served corpus and the smaller serving bucket
    b2_row = b2["per_shape"][(B2_CORPORA[0], B2_BATCHES[0])]
    line = {"kernels": [{
        "name": "fused_ctr_forward",
        "route": "cuda",
        "source": "deepfm_tpu_torch/csrc/fused_ctr.cu",
        "replaces": "deepfm_tpu/ops/pallas_ctr.py:133",
        "launches": (serve["launches"] + train["launches"] + lazy["launches"]
                     + ddp["launches"] + sharded["launches"] + life["launches"]
                     + online["launches"] + elastic["launches"] + funnel["forward_launches"]
                     + funnel["task_forward_launches"] + swap["forward_launches"]
                     + pool["forward_launches"] + prep["launches"] + tiered["launches"]
                     + stream["launches"] + fam["launches"] + fleet["launches"]),
        "max_abs_err": max(kernel["max_abs_err"], lazy["forward_max_abs_err"],
                           sharded["max_abs_err"], elastic["max_abs_err"],
                           stream["max_abs_err"], fam["max_abs_err"], fleet["max_abs_err"],
                           *tiered["hot_forward"]["max_abs_err"],
                           *tiered["compact"]["forward_max_abs_err"]),
        "ms": fwd["ms"],
        "plain_ms": fwd["plain_ms"],
        "bound_ms": fwd["bound_ms"],
        "bound_by": fwd["bound_by"],
        "library_ms": None,
    }, {
        "name": "fused_ctr_backward",
        "route": "cuda",
        "source": "deepfm_tpu_torch/csrc/fused_ctr.cu",
        "replaces": "deepfm_tpu/ops/pallas_ctr.py:317",
        "launches": (train["backward_launches"] + lazy["backward_launches"]
                     + ddp["backward_launches"] + sharded["backward_launches"]
                     + life["backward_launches"] + online["backward_launches"]
                     + elastic["backward_launches"]
                     + prep["backward_launches"] + tiered["backward_launches"]
                     + stream["backward_launches"] + fam["backward_launches"]),
        "max_abs_err": max(backward["max_abs_err"], lazy["backward_max_abs_err"],
                           sharded["backward_max_abs_err"], elastic["backward_max_abs_err"],
                           stream["backward_max_abs_err"], fam["backward_max_abs_err"],
                           *tiered["compact"]["backward_max_abs_err"]),
        "ms": bwd["ms"],
        "plain_ms": bwd["plain_ms"],
        "bound_ms": bwd["bound_ms"],
        "bound_by": bwd["bound_by"],
        "library_ms": None,
    }, {
        "name": "retrieval_topk",
        "route": "cuda",
        "source": "deepfm_tpu_torch/csrc/retrieval_topk.cu",
        "replaces": "deepfm_tpu/ops/pallas_retrieval.py:173",
        "launches": (funnel["retrieval_launches"] + funnel["task_retrieval_launches"]
                     + swap["retrieval_launches"] + pool["retrieval_launches"]
                     + fam["retrieval_launches"]),
        "max_abs_err": b2["max_abs_err"],
        "ms": b2_row["ms"],
        "plain_ms": b2_row["plain_ms"],
        "bound_ms": b2_row["bound_ms"],
        "bound_by": b2_row["bound_by"],
        "library_ms": b2_row["library_ms"],
    }]}
    print(f"chip_smoke: total {time.perf_counter() - t_main:.1f} s")
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(dev),
        "count": torch.cuda.device_count()}}))
    faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--elastic-rank"]:  # a rank process of the elastic phase
        sys.exit(elastic_cli_rank(sys.argv[2], sys.argv[3], sys.argv[4:]))
    sys.exit(main())
