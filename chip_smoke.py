#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dragonfly2_tpu_torch) on one GPU.

Run from the repository root on a machine with a CUDA device and nvcc:

    python3 chip_smoke.py

Phases, each of which must pass or the script exits non-zero without a
result line. Each ends with a line "<name> phase: <s> s (<card>)", and
the run with one line of every phase's seconds and the total, printed
before the kernels JSON line:

1. device: require CUDA; print the card's name and power limit.
2. build: compile every CUDA source of the path and the host launcher
   through which ops/flash.py makes every launch (ops/build.py; one nvcc
   per source and g++ for the launcher, all started together), and print
   the build time, the launcher's own seconds and the compiler's
   register/spill report.
3. kernels: each kernel against its plain PyTorch version on the same
   inputs, at the served shape and at long-context shapes, with the
   kernel's, the plain version's and a PyTorch library call's times
   (CUDA events) beside the bound the card allows. The training kernels
   (forward with lse, dK/dV, dQ) the same, at the trained shape
   [256, 4, 20, 32] and at the long shapes. At the ranker's D = 32 rows
   (served, trained, and phase 6's eval shard) the Hopper instance is
   forced too, held to the plain version at the row's shape and timed
   beside the picked one. Then the packed-sets kernels (slice 13's forward
   in three modes and dK/dV, slice 15's dQ, at L up to 32) at their edges: D = 32
   and 128, L = 1, 10, 15, 20, 21, 22 and 32 on 3 x 5 sets with batch row
   0 fully masked, causal or not, bf16 and float32, every launch counted,
   and the kernel names the profiler finds behind each entry.
4. serving path (slice 1): a full-width AttentionRanker (hidden 128, 4 heads, 2 layers)
   from a seeded generator, published to the port's bucket registry under
   a temporary fs:// location and activated, served by InferenceRPCServer
   on 127.0.0.1 with a ModelServer on cuda, and queried with
   InferenceClient (ServerLive, ModelReady, ModelInfer at N = 64, 256 and
   1024 tasks of 15 candidates). Launch counters are zeroed just before and
   read just after; every request must go through the kernel once per
   layer. The answers are checked against the in-process score_set (bit
   for bit) and against the same params on the CPU with the plain version.
5. training path (slice 2): a 20,000-record trace on 10,000 hosts from the
   port's synth (bench_trainer.py's trace; made in a thread while phase 2
   builds, and waited for before phase 3), train_attention on cuda at the
   trainer's defaults (batch 256, lr 1e-3, hidden 128) for 3 epochs, the
   trained version published and activated as parent-ranker-attention and
   served over ModelInfer on held-out rows. Counters are zeroed before the
   training and again before the serving; every step must launch each
   training kernel once per layer. Checks: finite losses, the first steps
   replayed on the CPU with the plain versions, one step's gradients cuda
   against cpu, wire scores equal to score_set bit for bit; prints the
   throughput, the step p50 and a profiler breakdown of a step.
6. sequence parallelism (slice 3): the partial kernel against its plain
   version at the ranker's eval shard and at two ring blocks of long
   sequences; sharded_ring_attention with the partial kernel at
   [2, 4, 16384, 32] on a 1 x 4 mesh of the one card (against
   flash_attention on the whole sequence and a chunked dense oracle, with
   exactly dp * sp^2 partial launches) and the causal zigzag ring; then
   train_attention on a dp 2 x sp 2 mesh of the card with ring attention
   over phase 5's trace, 1 epoch: finite losses, the first steps replayed
   on a CPU mesh, layers * dp * sp^2 partial launches in the eval, the
   mesh's eval scores against one device's; then train_attention with
   Ulysses from the same seed (every training kernel steps * layers * dp *
   sp times, the finished forward layers * dp * sp times in the eval, the
   first losses against the ring's), and each strategy's step p50.
7. the Hopper instances (slices 4 and 5): Ulysses at [2, 16, 4096, 32] on
   a 1 x 4 mesh of the card, whose shards run the forward, the forward with
   lse, dK/dV and dQ at long L: the finished forward without grad and one
   forward/backward with it, each sm90 instance exactly sp times, against
   the plain versions over the whole sequence.
8. the scheduler's rule-arm decision program (slice 6): a deployment at
   the scheduler's Config defaults (16,384 hosts, 65,536 peers, 4,096
   tasks; DAG capacity 256) recorded from the reference's replay as
   bench_loop.py runs it (10,000 hosts, 512 tasks, seed 0, to 1,000,000
   pieces, then one round of 1,024 downloads;
   dragonfly2_tpu_torch/data/tick_deployment.npz, written by
   tests/test_torch_tick_deployment.py), its tick of 1,024 waiting peers
   built as the reference's _tick_fused builds it (native DAG legality),
   TickMirror on the card and four fused chunks of 256, each dispatched
   under torch.cuda.set_sync_debug_mode("error"). Checks: CUDA == CPU
   (selections and int segments byte for byte, scores and ledger rows
   within 1e-6), the shadow transport, the dirty-row mirror against a
   fresh one, the DAG twins against the native answers. Prints the
   chunk's times at buckets 64/256/1024 (dispatch, dispatch + drain,
   device time and launches), the mirror sync's time,
   schedule_from_packed at 1024 x 15 and 1024 x 64, and the whole tick at
   bench_loop's 64 waiting peers and at 1,024.
9. the wide instances (slices 7-9, ROADMAP C3): every entry at head dims
   above 128, each taken as it is, against the plain version of what it
   computes at D = 160, 192, 256, 320 and 512, L = 40 and 2048, causal and
   not, float32 too at D = 192, 320 and 512; the wide mma.sync instances at
   every D (the forward's one-pass kernel above 256), the wide Hopper ones
   (TMA + wgmma: the forward in its three modes, dK/dV and dQ) for bf16 at
   D up to 256 above their thresholds, and forced at the wide ranker's
   batch; that batch is checked at D = 320 too; then slices 11-12's
   kernels at their edges on 3 x 5 sets (the packed short-set forward at
   D = 136, 192 and 256, L = 1 .. 32, float32 too; the one-pass dQ and
   dK/dV at D = 136 .. 512, L = 1, 20, 32, 33 and 1024, the Hopper
   instances forced off; the chunked backward at D = 640). Each instance timed at its
   main path's shape (its device time beside the other instance's; before
   any timing, both instances' outputs there held to the plain version
   with the row's tolerances; at the wide eval shape both forward
   instances also timed in turns) and each wide mma.sync one at D = 320.
   Then their main paths: the ranker at hidden 768 with 4
   heads (head dim 192) trained for an epoch on phase 5's trace, and at
   hidden 1280 (head dim 320); the ring over its eval batch on a 1 x 2
   mesh; the ring over
   [2, 4, 4096, 192] on a 1 x 4 mesh; Ulysses over [2, 16, 4096, 192] on a
   1 x 4 mesh, without grad and with.
10. the scheduler service (slices 7 and 16): SchedulerService on the card
   driven by the port's ClusterSimulator at bench_loop.py's default replay
   (10,000 hosts, 512 tasks, seed 0, 64 downloads a round, Config()
   defaults, a TraceStorage, and bench_loop's ProbeStore of 2^17 pairs
   with a probe round of 8 sources every 50 rounds), 100 rounds and one
   flash-crowd round of 1,024 downloads: the tick's p50 and p99, each
   phase's median, pieces per second, the probe rounds' median, the pairs
   stored, the probed-count total, the topology rows snapshot_topology
   writes, the launches and device busy share of 5 profiled rounds.
   Checks: 30 rounds (a probe round every 10) on the CPU and on the card
   give the same selections (parent ids exact, scores within 1e-6), the
   same pieces, completed and piece_cost_ns_total, and the same probe
   store (ring, cursor, count, probed_count, averages); fused_tick=False
   agrees with True on the card over 10 rounds at tests/test_fused_tick.py's
   size.
11. the nt arm on measured RTTs (slice 16): the same deployment with
   algorithm "nt", its store warmed from the simulator's link model
   (warm_from_link_model), probed every 50 rounds, 100 timed rounds, as
   phase 10 prints them. Checks: the tick ran unfused, candidates carried
   measured RTTs, 30 paired rounds give CUDA == CPU as in phase 10.
12. the graph models (slice 16): GraphSAGERanker (hidden 128, 2 layers,
   bf16) over phase 5's host graph on both aggregation paths (segment
   sums over graph_arrays with edges padded to edge_bucket; the dense
   adjacency of dense_graph_arrays), each against its CPU twin, the dense
   against the segment embeddings, embed_subset over gather_coo_subgraph
   frontiers of 64 and 1 dirty hosts against the full embed's rows (every
   other row unchanged bit for bit), score on one 256-row rank_batches
   batch, and ProbeRTTRegressor (hidden 128, 3 layers) over
   topology_to_pairs of phase 11's snapshot; each embed's p50 by CUDA
   events, device ms and launches. No flash kernel launches in phases
   10-12.
13. the ml arm (slice 17): GraphSAGERanker (hidden 128, 2 layers, bf16,
   seed-0 weights) published to the port's bucket registry and served by
   ModelServer("gnn") on the card behind MLEvaluator; a NaN-poisoned
   second version is rejected by the activation gate while v1 keeps
   serving. Then bench_loop.py phase 3's ml arm (algorithm "ml", peer TTL
   10 s, GC every 1 s, 1,024 peers a task; 10,000 hosts, 32 tasks, seed
   2, 64 downloads a round), its embeddings refreshed inline once and then
   on the worker every 10 rounds, 100 timed rounds: the tick's p50 and
   p99, the phases' medians, pieces per second and the mean piece cost,
   the refresh counts and seconds, launches and busy share of 5 profiled
   rounds; and the rule arm at the same seed with the evaluator attached,
   whose ml shadow re-scores each tick (shadow_compared, the shadow_score
   median). Checks: the ml scoring of the timed run's first chunks on the
   card against the CPU on the same table (selections equal on every row
   outside the bf16 margin), a float32 paired run of 30 rounds CPU
   against CUDA compared tick by tick (at the first tick that differs,
   each differing row's CPU margin under the float32 tolerance), the
   incremental refresh against the full embed (every other row unchanged
   bit for bit), shadow_compared > 0, no flash kernel launched.
14. the trainer (slice 18): the Announcer streams phase 10's traces (its
   timed rounds and the flash crowd) and the topology rows phases 10-11
   snapshot to TrainerService on the card at TrainerConfig's defaults
   (hidden 128, batch 256, lr 1e-3, 10 epochs) with the attention family
   on and a checkpoint directory: train_gnn on the dense path over the
   10,000-host graph, train_attention through the training kernels,
   train_mlp over topology_to_pairs, three versions published to a
   filesystem ModelRegistry and activated. Prints each model's steps,
   samples/s, epoch mean losses, eval metrics and flash launches, the
   GNN's analytic flops and achieved share of the bf16 peak beside
   gnn_roofline_bound's step bound and MFU ceiling, each model's step p50
   by CUDA events, a profiler breakdown of 5 GNN steps and the announce's
   wall. Checks: finite losses, the GNN's and the MLP's last epoch mean
   below their first, no flash launch by the GNN or the MLP, each training
   kernel once a layer a step in the attention training, the checkpoint
   directory empty after success, the first 3 GNN and MLP steps replayed
   on the CPU from the same weights and batches, one GNN step's gradients
   CUDA against CPU, the three versions active and loading against the
   serving modules' shapes; then the MLP resumed on the card (2 epochs,
   then 4: exactly 2 more epochs of steps, then 4: none, the params bit
   for bit); then the trained GNN served on phase 13's ml arm for 100
   rounds, its tick p50 and mean piece cost beside the rule arm's.
15. the processes (slice 19): the port's trainer and scheduler started as
   processes on the card through python -m dragonfly2_tpu_torch.cmd (the
   trainer with train_attention on and TrainerConfig's defaults otherwise,
   the scheduler on Config() defaults with the ml arm, the registry, the
   announce loop to the trainer and both metrics ports); daemons played
   over the wire from this process, one SchedulerClientPool (one
   connection) per daemon host as a dfdaemon holds it: 1,024 hosts
   announce, 64 report probe rounds, 4,096 downloads of 16 tasks (each
   task's first peer back-sources, the rest fetch their 4 pieces from the
   parents the tick picked, 128 in flight), then 80 finished peers of each
   task leave and a flash crowd of 1,024 registrations, one from each
   host, is sent in one burst. The scheduler's network topology collect
   ticker writes the probe graph the trainer's MLP trains on. Prints the
   time from each process's start to its READY line, RegisterPeer to
   answer p50 and p99 and the crowd's last answer, the peers each tick
   answered (grouped by the tick span id its answers carry) with the
   largest, the scheduler's tick
   and batch histograms and announce_peer totals from its /metrics, the
   wall from the first announce upload to three active versions (gnn,
   attention, mlp) in the registry, the ml arm's log line naming the
   trained GNN version, 256 more downloads on it, ModelInfer on the
   attention version over the INFER port (p50) against this process's
   ModelServer on the same card and inputs, and the exits on SIGTERM.
   Checks: every registration answered by the tick, one tick of the crowd
   holding more than 256 peers (the evaluator's 1,024 bucket), the three versions
   active, the ml arm serving the trained GNN, ModelInfer equal bit for bit
   to the in-process ModelServer (flash_fwd launched once a layer there),
   both processes exiting 0 within 10 s of SIGTERM, and at least one
   download trace row on disk for each finished download.
16. the data plane (slice 20): the port's scheduler started as a process
   on the card at Config()'s defaults (the rule arm, the fused tick, a
   metrics port), an origin in this script serving one image of 4 blobs
   (128, 64, 32 and 16 MiB of seeded random bytes: 60 pieces of 4 MiB),
   and 16 dfdaemon processes (python -m dragonfly2_tpu_torch.cmd
   dfdaemon, hostnames df-00 .. df-15, each with its proxy hijacking
   '/blobs/' and a metrics port), started together. Stage 1: df-00 pulls
   the image through its proxy and back-sources. Stage 2: df-01 .. df-15
   pull it at once through their proxies, 60 fetches in flight, as every
   node of a rollout pulls one image through its registry mirror. Stage
   3: two dfget processes (python -m dragonfly2_tpu_torch.client.cli
   dfget --no-back-source) fetch the 128 MiB blob. Prints the time to
   READY (the scheduler; the daemons' p50 and max), stage 1's wall and
   MiB/s, stage 2's per-blob completion p50 and p99 across the nodes,
   aggregate MiB/s and wall, the dfget wall, the scheduler's ticks and
   peers a tick for each stage from its /metrics, pieces from the origin
   and from parents, origin bytes over image bytes, the daemons'
   downloads by dominant tail phase (their /metrics), and the SIGTERM to
   exit times. Checks: every body and file has the origin's sha256; the
   origin serves no data GET after stage 1 (every later piece came from a
   peer the card's tick picked); at least one download trace row on disk
   for each finished download; every process exits 0 within 10 s of
   SIGTERM; no dfdaemon or dfget process holds a CUDA context (neither
   among nvidia-smi's compute pids nor mapping libcuda or libtorch).
17. the manager (slice 21): the port's manager started as a process
   (python -m dragonfly2_tpu_torch.cmd manager: a SQLite file, a model
   registry directory, its REST, RPC and metrics ports), a cluster created
   over REST with candidate_parent_limit 4, two schedulers on the card (the
   rule arm with --manager, a keepalive interval of 2 s and a dynconfig
   interval of 1 s; the ml arm on the manager's registry, not registered),
   a seed dfdaemon and 16 dfdaemons with --manager and no --scheduler, and
   an OCI registry stub in this script (a schema-2 manifest, a config blob
   and four layers of 128, 64, 32 and 16 MiB of seeded random bytes over
   127.0.0.1, as the reference's tests/test_image_preheat.py FakeRegistry
   serves them). (a) The scheduler registers itself and the script
   registers the seed process over the manager's RPC (the reference's
   dfdaemon has no such edge); the manager lists both active within one
   keepalive interval of their READY lines, the scheduler's dynconfig
   snapshot lists the seed, and every daemon took the scheduler from the
   manager. (b) One POST /api/v1/jobs of type preheat with the image's
   manifest URL: the job reaches SUCCESS; its task ids equal
   idgen.task_id_v1 of the blob URLs; the registry served each blob's
   bytes once; then the 16 daemons pull the image at once through their
   proxies and 2 dfget processes (python -m
   dragonfly2_tpu_torch.client.cli dfget --no-back-source; dfget takes no
   --manager in either package) pull the 128 MiB layer from the scheduler
   the manager lists; every body has the registry's sha256 and the
   registry serves no data GET after the preheat, while REST GETs are
   timed against the daemons' GetSchedulers polls. (c) Wire peers on the
   128 MiB layer's task ask the card's scheduler for parents (answers of 3
   or 4 candidates must occur), a REST PATCH lowers the cluster's
   candidate_parent_limit to 2, and every answer from the first obeying
   one on offers at most 2, the first within 3 dynconfig intervals. (d)
   Two seeded GraphSAGERanker versions (hidden 128, the flax msgpack
   layout) go in through the manager's CreateModel RPC; each REST
   activation (PATCH /api/v1/models/:id) makes the ml scheduler log
   "ml evaluator serving model version N". (e) SIGTERM to every process:
   each exits 0 within 10 s; the scheduler's download rows name the seed
   among the daemons' parents. Prints the READY and registration times,
   the job's create-to-SUCCESS time, the stage's wall, aggregate MiB/s and
   per-daemon p50 and p99, the dfget wall, origin bytes over image bytes,
   REST p50 and p99, the dynconfig apply time, the activation-to-serving
   times, the scheduler's tick count, mean and histogram p50 bound, and
   the exit times.
18. object storage and the flight recorder (slice 22): an S3 stub in this
   script (path-style, 127.0.0.1, in a thread; it recomputes every SigV4
   signature from the shared secret with its own code, answers 403 when
   it differs, and counts each key's GETs, ranged GETs and bytes served),
   the port's manager with --registry-dir s3://models/registry?endpoint=
   <stub>, one scheduler on the card (--manager, --algorithm ml, the same
   registry), a seed dfdaemon with --object-storage
   --object-storage-backend s3 --object-storage-endpoint <stub> (its
   credentials in DRAGONFLY_OBJ_ACCESS_KEY / _SECRET_KEY) and 16 dfdaemons
   whose proxies hijack ^s3://. (a) A seeded GraphSAGERanker version goes
   in through CreateModel into the S3 registry; params.sha256 equals the
   sha256 of the params the stub holds; a REST activation makes the
   scheduler log "ml evaluator serving model version N" after a GET of
   those params. (b) The stub holds one 240 MiB object; a preheat job of
   its s3:// URL with the credentials in x-df-* headers makes the seed
   back-source it in ranged GETs, then the 16 daemons pull it at once
   through their proxies: every body the object's sha256, stub bytes over
   object bytes 1.000, no signature refused, at least one ranged GET; it
   prints the scheduler's bad-node verdict on the seed, recomputed from
   the seed's piece journal (a seed judged bad sends every child back to
   source). (c)
   dfstore --endpoint on the seed's OBJSTORE port puts a 64 MiB object,
   the dfstore client checks it exists, dfstore gets it back with equal
   bytes, the client copies it and dfstore sum lists both keys; deleted in
   the stub behind the daemon's back, a GET still answers the same bytes
   from the imported task, and the client's delete removes the task too.
   (d) /debug/flight on the scheduler's metrics port, the wire
   FlightRecorderRequest and the manager's /api/v1/flight-recorder (with a
   JWT): every section of flight.DUMP_SECTIONS, ticks with phase p50s, the
   ml arm's entries with calls, a cost card for every (entry, signature)
   the jit section lists, each with bytes and flops, within
   DUMP_MAX_BYTES; ?section=ticks,jit&max_bytes=4096 returns only those
   sections within 4,096 bytes; the wire and HTTP dumps have the same
   sections; the manager's body has its own section and the scheduler's;
   the ledger's capture counter does not move across 20 ticks of 20 wire
   peers. (e) SIGTERM to every process: each exits 0 within 10 s. Prints
   the stage's wall, aggregate MiB/s and per-daemon p50 and p99, dfstore's
   put and get MiB/s, the activation-to-serving time, the dump's size and
   the table of cost cards beside the tick phase p50 that holds each
   entry. After phase 14, the in-process cost cards of phases 5-14 are
   printed the same way (the fused tick's at the recorded deployment, the
   trainer's with their hand kernels counted).
19. the scale labs (slice 23): the port's megascale lab and process
   planet driving its scheduler on the card, no hand kernel launched (the
   flash counts zeroed before and read zero after). (a) to (c) run in a
   process of their own beside phases 10 to 16, (b) first (their lines
   printed when it ends, after phase 16); (d) runs after phase 18. (a)
   The reference's 1,500-host soak day (soak, 32 tasks, seed 7, 24
   arrivals a round, retire after 24; 108 rounds) through run_megascale
   twice on the card
   and once on the CPU: the card's two runs identical (deterministic
   view, digests included, every selection); card against CPU, every
   selection's parent ids exactly and scores within 1e-6, the view's
   integers, strings and digests exactly but the ledger's and the tail
   plane's score digests, its floats within 1e-6; every fault family
   nonzero. (b) The 10^6-host planet slice (128 tasks, seed 11, 20
   rounds, 6 draining, 8,000 arrivals a round), three of its ticks under
   torch.profiler: more than 40,000 registered, every one completed; then
   the 50k-host soak smoke (64 tasks, seed 7, 8 rounds): more than 10,000
   pieces, 500 completed, 4 regions. (c) The fleet builtin at 2,000
   hosts, 24 tasks, seed 11, 40 rounds: the plain run, K = 1 (equal to
   it outside the fleet columns) and K = 4 (zero lost downloads, each
   announce page at a kill round and cleared). (d) run_procday over the
   procday spec's 12-round day (two scheduler processes on the card with
   --device cuda, three dfdaemons, the spec's three seed daemons, a
   manager): zero lost downloads, completions over P2P, kills at rounds 5
   and 10 with failover, at least 4 restarts, a page at each kill cleared
   the next round, every exit code set; each kill round's b, failovers
   and the inheriting scheduler's seed triggers printed; then tools/dfproc.py's simulator leg (300 hosts, 24 tasks,
   16 arrivals) on the card, every divergence metric within its band.
   Prints each run's setup and wall seconds, pieces/s, events/s, the
   engine's and the tick's phase p50s, peak RSS and
   torch.cuda.max_memory_allocated; the profiled ticks' launches, device
   ms and busy share; timing.fleet; the planet's wall, downloads/s and
   each divergence metric with its band.
20. tensor, pipeline and expert parallelism (slice 24), every mesh the
   one card repeated. (a) The bodies at the ranker's widths, float32 (F =
   128, hidden 512, 5,120 tokens, 4 experts): sharded_tp_ffn on tp 4 and
   on dp 2 x tp 2, sharded_pipeline_apply on pp 4 over 4 microbatches,
   sharded_moe_ffn on ep 4 with every token of a shard in capacity and
   with a capacity that drops, each within 1e-4 of its one-device oracle
   on the card and of the same call on a CPU mesh, the dropped set the
   same on both. (b) train_attention from TrainerConfig's defaults and the
   mesh alone, one epoch each over phase 5's trace: tp on dp 2 x tp 2, ep
   on dp 2 x ep 2 with 4 experts, pp on pp 2 over 4 microbatches, and the
   MoE on one device; each training kernel's launches equal to the path's
   formula, finite losses, the first steps replayed on a CPU mesh of the
   same shape, and the eval, the step p50 and a profiler split of a step.
   (c) embed_graph_sharded on dp 2 x graph 2 over phase 12's host graph
   against GraphSAGERanker.embed, both p50s by CUDA events. (d)
   make_hybrid_mesh(dcn_dp=2, dp=1, tp=2) in one process (folded to dp 2
   x tp 2) training (b)'s tp path; then two processes sharing the card
   over gloo (initialize_distributed, make_hybrid_mesh(dcn_dp=2, dp=1)),
   one epoch at batch 64, their losses against one process on a dp 2
   mesh (trained while they run), every exit code 0.
21. the workload drivers (slice 26), in a process of their own beside
   phase 20 (their lines printed when it ends): the in-process rigs of
   tools/torch_stress.py and tools/torch_llm_prefetch.py (the reference's
   tools/stress.py and tools/llm_prefetch.py on the port) with the
   scheduler on the card. Stress at the reference's defaults: an origin,
   the scheduler (tick every 0.01 s), one daemon and its proxy, one warm
   fetch, then 16 connections for 10 s of a 4 MiB blob. Prefetch at
   Llama-3-70B's 30 shards, each cut from ~4.6 GiB to 8 MiB for the time
   limit: a seed back-sources every shard, then 6 hosts pull every shard
   with back-to-source refused, in 1 MiB pieces. Checks: stress made
   requests and no error; every shard's sha256 on every host, the fleet's
   offload 100.0%, the origin's bytes one pass and at most 4 KiB of
   probes; each scheduler ticked on the card; no flash kernel launched.
   Prints each driver's JSON line and its scheduler's ticks and tick p50.
22. the kernels JSON line and, last, the result line.

Between phases 3 and 4, the host cost of the forward with lse's wrapper at
the ranker's two trained shapes, [256, 4, 20, 32] and [256, 4, 20, 192]:
each step of the wrapper through the launcher, and of the ctypes control
(this script's own copy of the wrapper as it stood before the launcher:
checks, output allocations and pointers in Python around a ctypes call),
then the wrapper, the control and the library call in four alternating
turns, by CUDA events and by the host clock, with the launcher's outputs
held to the control's bit for bit.

Phase 3's forward rows include a head dim no instance has (D = 24,
zero-padded to 32 and scored at D = 24's softmax scale).

At every long shape (the Hopper instances' shapes) the kernels are held
to the LONG tolerances, the kernel lines give both instances' device times
(the one ops/flash.py picks, and the other, forced through the same
wrappers, for comparison), and a long shape whose kernel the profiler does
not find fails the run.

    python3 chip_smoke.py --threshold

instead times both instances of the forward, of dK/dV and of dQ at
L = 16 .. 512 (device time), the readings ops/flash.py's SM90_MIN_L is set
from, and both wide instances of the forward with lse, of dK/dV and of dQ
at D = 192 and 256 over L = 16 .. 2048 (the WIDE_*SM90_MIN_L readings),
and prints no result line.

    python3 chip_smoke.py --rows [--tree DIR]

instead holds the kernels of the ranker's D = 32 rows (the trained
forward with lse, dK/dV and dQ at [256, 4, 20, 32], the served forward at
[1024, 4, 15, 32], the ring's eval-shard partials at [2000, 4, 10, 32]) to
their plain versions at those shapes and times them, with the package
from DIR (another commit's checkout, built there) or beside the script;
run it for two trees in turns to compare their kernels in one call. No
result line.

    python3 chip_smoke.py --dcn-worker RANK,PORT,DIR

is one process of phase 20's two-process leg, which phase 20 starts
itself; it prints no result line.

    python3 chip_smoke.py --side-worker LEG,DEVICE,CARD

is one of the two legs that the smoke run starts as a process of its own,
beside phases of the main process whose checks it does not touch, and
joins later (its lines, its phase line and its failure come at the
join): LEG scale is phase 19 (a) to (c), the megascale runs, started
after phase 9 and joined after phase 16; LEG drivers is phase 21,
started after phase 19 and joined after phase 20.
It prints no result line.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import asyncio
import collections
import contextlib
import ctypes
import functools
import json
import os
import pathlib
import re
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

SEED = 0
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 495e12}  # dense tensor core: bf16, TF32
# kernel vs plain version on the card: both round to bf16 where the kernel
# feeds the tensor cores (q, k, v, p), and the output is bf16 for bf16 inputs
KERNEL_ATOL, KERNEL_RTOL = 3e-2, 2e-2
# at long L a row of attention averages thousands of keys (~0.01-0.02 for
# N(0, 1) inputs at L = 4096, D = 32), where KERNEL_ATOL would pass a
# dropped key tile: every shape that takes the Hopper instances, the ring
# and the causal ring are held to LONG (rtol above one bf16 ulp, 2^-7 of
# the value)
LONG_ATOL, LONG_RTOL = 3e-3, 1e-2
# the partial kernel's row_max and row_sum, every shape, and the lse at the
# long shapes: float32 from the same float32 scores as the plain version's
# (bf16 inputs are exact in f32)
STATS_ATOL, STATS_RTOL = 1e-3, 1e-3
# full ranker, cuda (kernel, cuBLAS bf16) vs cpu (plain version): bf16
# rounding at every layer, the same family as tests/test_attention.py
MODEL_ATOL, MODEL_RTOL = 5e-2, 5e-2
# backward kernels vs their plain version: bf16 rounding of q, k, v, dO, P
# and dS before the tensor cores, summed over up to L keys or queries
GRAD_ATOL, GRAD_RTOL = 5e-2, 5e-2
# gradients at the long shapes: a dK/dV element sums thousands of small
# terms (typically 0.02-0.03 at L = 4096), where GRAD would pass a skipped
# query tile; rtol above one bf16 ulp
LONG_GRAD_ATOL, LONG_GRAD_RTOL = 5e-3, 1e-2
# the training path: bench_trainer.py's trace and the trainer's defaults
TRACE_HOSTS, TRACE_RECORDS, TRACE_TASKS, MAX_PARENTS = 10_000, 20_000, 512, 20
TRAIN_EPOCHS = 3
REPLAY_STEPS = 8
# cuda (kernels, bf16 cuBLAS) vs cpu (plain versions) over the first steps
# from the same weights and batches: bf16 rounding at every layer of a
# listwise loss of ~2.5
REPLAY_LOSS_ATOL = 2e-2
# one step's gradient per parameter, cuda vs cpu, relative to the
# parameter's largest gradient element
GRAD_REL = 5e-2
SHIFT_INVARIANT = ("score.bias", "LayerNorm_0.bias")
SERVE_ROWS, SERVE_REQUESTS = 256, 4  # ModelInfer requests of held-out rows
CANDIDATES = 15  # FILTER_PARENT_LIMIT
TASK_BUCKETS = (64, 256, 1024)  # the scheduler's eval buckets
REQUESTS_PER_BUCKET = 6
# slice 3: the ring at long L on a 1 x 4 mesh of the card, and the ranker
# on a dp 2 x sp 2 mesh of it
RING_SHAPE, RING_SP = (2, 4, 16384, 32), 4
CAUSAL_RING_L = 4096
ORACLE_ROWS = 256  # query rows a chunk of the dense oracle takes ([L, L] f32 is 8.6 GB)
MESH_DP, MESH_SP = 2, 2
MESH_EPOCHS = 1
MESH_STEPS = 12  # timed steps of each strategy from the same weights
# slice 4: Ulysses over a long sequence, whose shards run the Hopper
# instances: [2, 4, 4096, 32] each, the "long" rows of the kernel phases;
# and, with --threshold, where they overtake the mma.sync ones
THRESHOLD_LENGTHS = (16, 20, 32, 64, 96, 128, 256, 512)
# head dim -> (B, H): the ranker's trained batch, and the wide rows' heads
THRESHOLD_SHAPES = {32: (256, 4), 128: (16, 8)}
# the wide instances' readings (WIDE_SM90_MIN_L): the wide ranker's 4 heads
# at D = 192 and 256, B = WIDE_THRESHOLD_TOKENS // L sets (256 at L = 20,
# the ranker's training batch)
WIDE_THRESHOLD_DIMS = (192, 256)
WIDE_THRESHOLD_LENGTHS = (16, 20, 32, 48, 64, 96, 128, 256, 512, 1024, 2048)
WIDE_THRESHOLD_TOKENS = 5120
ULYSSES_SHAPE, ULYSSES_SP = (2, 16, 4096, 32), 4


def _fail(message: str) -> None:
    print(f"chip_smoke FAILED: {message}", file=sys.stderr, flush=True)
    sys.exit(1)


# each phase's seconds, in the order the phases ran, and the card's
# nvidia-smi line (phase_device sets it)
PHASE_SECONDS: dict[str, float] = {}
_CARD = {"line": "no card"}


def _phase(name: str):
    """A phase: its closing line "<name> phase: <s> s (<card>)" and its
    seconds in PHASE_SECONDS. A failure is not caught: it ends the run."""
    def wrap(fn):
        @functools.wraps(fn)
        def timed(*args, **kwargs):
            start = time.perf_counter()
            result = fn(*args, **kwargs)
            seconds = time.perf_counter() - start
            PHASE_SECONDS[name] = PHASE_SECONDS.get(name, 0.0) + seconds
            print(f"{name} phase: {seconds:.1f} s ({_CARD['line']})", flush=True)
            return result
        return timed
    return wrap


def _time_ms(fn, iters: int) -> float:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


KERNEL_CALLS = 20  # launches in one profiler window of _kernel_ms


def _fmt(row: dict, prefix: str = "kernel") -> str:
    """A row's ``{prefix}_ms`` device time with the launches the profiler
    recorded of the KERNEL_CALLS made."""
    ms = row.get(f"{prefix}_ms")
    if ms is None:
        return "not measured"
    return f"{ms:.4f}, {row[f'{prefix}_recorded']}/{KERNEL_CALLS} launches recorded"


def _kernel_rows(prof, calls: int):
    """(kernel name, device ms per call), the longest first, and the
    kernels launched per call, from one aggregation of a profiler window,
    user annotations (whose ranges overlap the kernels) left out."""
    import torch

    rows = [e for e in prof.key_averages()
            if e.self_device_time_total > 0 and e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]
    kernels = sorted(((e.key, e.self_device_time_total / calls / 1e3) for e in rows),
                     key=lambda kv: -kv[1])
    return kernels, sum(e.count for e in rows) / calls


def _kernels_of(prof, calls: int):
    """(kernel name, device ms per call) from a profiler window, the
    longest first."""
    return _kernel_rows(prof, calls)[0]


# profiler windows taken by _kernel_ms, those that recorded fewer or more
# of the kernel's launches than were made, and those whose launches' mean
# and median differ by more than a fifth
_WINDOWS = {"taken": 0, "short": 0, "over": 0, "uneven": 0}


def _kernel_ms(fn, symbol: str, calls: int = KERNEL_CALLS, windows: int = 6):
    """(device ms of one launch, launches recorded, the names matched) of
    the kernel whose name ``symbol`` (a regular expression, most often a
    plain name) finds under ``fn``, which launches it once a call
    (torch.profiler):
    the kernel's own execution, where ``_time_ms`` at a small shape
    measures the back-to-back call rate of its wrapper. A window may record
    fewer of the kernel's launches than were made (on the H100 machine,
    often 17 of 20, whichever kernel): the time is the median over the
    launches recorded, and a window that recorded none is taken again, up
    to ``windows`` times (on that machine three windows in a row once
    recorded none of a kernel, in a run whose other windows all found
    theirs);
    (None, 0, []) if none did."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        matched = [e for e in prof.events()
                   if re.search(symbol, e.name) and e.device_type == torch.autograd.DeviceType.CUDA]
        us = sorted(e.time_range.elapsed_us() for e in matched)
        _WINDOWS["taken"] += 1
        _WINDOWS["short"] += len(us) < calls
        _WINDOWS["over"] += len(us) > calls
        if us:
            median, mean = statistics.median(us), sum(us) / len(us)
            uneven = abs(mean - median) > 0.2 * median
            _WINDOWS["uneven"] += uneven
            if uneven or len(us) > calls:
                print(f"profiler window for {symbol}: {len(us)} of {calls} launches recorded, "
                      f"median {median:.1f} us, mean {mean:.1f} us, range "
                      f"{us[0]:.1f}-{us[-1]:.1f} us")
            found = re.compile(r"\w*(?:" + symbol + r")\w*")
            names = sorted({found.search(e.name).group(0) for e in matched})
            return median / 1e3, len(us), names
        print(f"profiler window for {symbol}: none of {calls} launches recorded; taking another")
        time.sleep(0.5)
    return None, 0, []


def _timed(fn, symbol: str, prefix: str = "kernel") -> dict:
    """_kernel_ms as a row's ``{prefix}_ms``, ``{prefix}_recorded`` and
    ``{prefix}_names``."""
    ms, recorded, names = _kernel_ms(fn, symbol)
    return {f"{prefix}_ms": ms, f"{prefix}_recorded": recorded, f"{prefix}_names": names}


@_phase("device")
def phase_device():
    import torch

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        _fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    _CARD["line"] = card
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"device 0: {torch.cuda.get_device_name(0)}")
    return card


@_phase("build")
def phase_build():
    from dragonfly2_tpu_torch.ops import build

    sources = build.kernel_sources()
    start = time.perf_counter()
    reports = build.build_all([*sources, build.LAUNCHER])
    seconds = time.perf_counter() - start
    for name, (log, own_seconds) in reports.items():
        if name not in (*sources, build.LAUNCHER):  # a part, printed with its source
            continue
        if name == build.LAUNCHER:
            print(f"build {name} (the host launcher, g++, PyTorch's per-operator headers): "
                  + (f"{own_seconds:.2f} s of compile and link" if own_seconds else "already built")
                  + (f"; compiler said: {log.strip()[:2000]}" if log.strip() else ""))
            continue
        if not log:
            print(f"build {name}: already built")
            continue
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
        spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores", log)]
        parts = [reports[build.part_name(name, i)][1] for i in range(build.source_parts(name))
                 if build.part_name(name, i) in reports]
        print(f"build {name}: {len(regs)} kernels in {own_seconds:.2f} s"
              + (f" ({len(parts)} parts compiled together, each "
                 + ", ".join(f"{t:.2f}" for t in parts) + " s, then one link)" if parts else "")
              + f", registers {min(regs, default=0)}-{max(regs, default=0)}, spill stores max "
              f"{max(spills, default=0)} bytes")
        # each instance of the Hopper sources, and the wide ones of the others
        entries = re.findall(r"Compiling entry function '(\w+)'", log)
        for entry, used, spill in zip(entries, regs, spills):
            if "sm90" in name or any(kind in entry for kind in ("wide", "onepass", "_sets_")):
                print(f"  {_instance_label(entry)}: {used} registers, {spill} bytes spilled")
            # wgmma issued one at a time: registers ran short
            for why, entry in re.findall(
                    r"wgmma.mma_async instructions are serialized due to (.*?) for the function "
                    r"'(\w+)'", log):
                print(f"  {_instance_label(entry)}: wgmma serialized ({why})")
    print(f"build: {len(sources)} sources in "
          f"{sum(build.source_parts(name) for name in sources)} compiles and the launcher in "
          f"{seconds:.2f} s")


def _instance_label(entry: str) -> str:
    """``kernel<template arguments>`` of a mangled kernel name (its element
    type, where it is the first, and its integers; ``kernel`` alone where it
    takes none)."""
    m = re.search(r"\d(flash_\w+?_kernel)I(13__nv_bfloat16|f)?((?:Li\d+E)+)E", entry)
    if m is None:
        plain = re.search(r"\d(flash_\w+?_kernel)", entry)
        return plain.group(1) if plain else entry[-40:]
    dtype = {"13__nv_bfloat16": ["bf16"], "f": ["float32"]}.get(m.group(2), [])
    return f"{m.group(1)}<{', '.join(dtype + re.findall(r'Li(\d+)E', m.group(3)))}>"


def _attention_inputs(gen, b, h, l, d, dtype, fully_masked_rows):
    """N(0, 1) q, k, v and a random key mask with a ragged tail on the last
    batch row, and fully masked batch rows at the front if asked."""
    import torch

    q, k, v = (
        torch.randn(b, h, l, d, generator=gen, device="cuda").to(dtype) for _ in range(3)
    )
    mask = torch.rand(b, l, generator=gen, device="cuda") < 0.85
    mask[:, 0] = True
    mask[-1, l - l // 8:] = False
    if fully_masked_rows:
        mask[: max(1, b // 16)] = False
    return q, k, v, mask


def _bound(q, mask, causal, matrices=4, row_stats=0, ops_per_pair=4):
    """Least time for the function on this card: each input read once and
    each output written once (``matrices`` [B, H, L, D] tensors of q's
    dtype, ``row_stats`` [B, H, L] float32 rows, the mask), or the products
    over the valid (query, key) pairs of this run's mask at the dtype's
    peak (``ops_per_pair`` * D operations per pair and head) — whichever is
    larger. The forward: 4 matrices (q, k, v, o), 4 D per pair."""
    import torch

    b, h, l, d = q.shape
    nbytes = matrices * q.numel() * q.element_size() + row_stats * b * h * l * 4 + mask.numel()
    m = mask.to(torch.int64)
    if causal:
        pairs = int(torch.cumsum(m, dim=1).sum().item())
    else:
        pairs = int((m.sum(dim=1) * l).sum().item())
    ops = ops_per_pair * d * h * pairs
    mem_s = nbytes / PEAK_BYTES_PER_S
    ops_s = ops / PEAK_OPS_PER_S[str(q.dtype).removeprefix("torch.")]
    return max(mem_s, ops_s) * 1e3, ("bytes" if mem_s >= ops_s else "operations")


def _is_long(shape, dtype) -> bool:
    """Whether ops/flash.py gives this shape the Hopper instances (at the
    head dim it pads to, for one outside the instances)."""
    from dragonfly2_tpu_torch.ops import flash

    d_pad = next((d for d in flash.HEAD_DIMS if d >= shape[3]), shape[3])
    return flash._sm90_path(shape[2], d_pad, dtype)


def _symbol(kernel: str, shape, dtype) -> str:
    """The profiler name of the instance ops/flash.py picks for ``kernel``
    ("fwd" for every forward mode, "dkv", "dq") at this shape."""
    if _is_long(shape, dtype):
        return _SM90_SYMBOLS[kernel]
    return _mma_sync_symbol(kernel, shape[2])


_SM90_SYMBOLS = {"fwd": "flash_fwd_sm90_kernel", "dkv": "flash_bwd_dkv_sm90_kernel",
                 "dq": "flash_bwd_dq_sm90_kernel"}


def _mma_sync_symbol(kernel: str, length: int) -> str:
    """The profiler name of the mma.sync instance's kernel of ``kernel``
    ("fwd", "dkv", "dq") at L: the forward's, dK/dV's and dQ's C sides
    launch their packed-sets kernels at L up to SETS_MAX_L."""
    from dragonfly2_tpu_torch.ops import flash

    sets = "sets_" if length <= flash.SETS_MAX_L else ""
    return {"fwd": f"flash_fwd_{sets}kernel", "dkv": f"flash_bwd_dkv_{sets}kernel",
            "dq": f"flash_bwd_dq_{sets}kernel"}[kernel]


def _need_time(label: str, shape, dtype, ms) -> None:
    if ms is None and _is_long(shape, dtype):
        _fail(f"{label} {list(shape)}: the profiler found no device time for the kernel")


@contextlib.contextmanager
def _instance(sm90: bool):
    """ops/flash.py's wrappers with the Hopper instances forced on or off
    whatever the shape: the other instance's device time beside the picked
    one's, through the same launch calls. Its launches are counted; every
    main path zeroes the counts just before its run."""
    from dragonfly2_tpu_torch.ops import flash

    picked = flash._sm90_path
    flash._sm90_path = lambda length, head_dim, dtype, kernel="fwd": sm90
    try:
        yield
    finally:
        flash._sm90_path = picked


# the D = 32 rows of the ranker's paths, whose picked instance is the
# mma.sync one (its packed-sets kernels): the Hopper instance is forced there
# too, held to the plain version at the row's shape first and timed beside
HOPPER_FORCED_ROWS = ("served", "trained", "eval-shard")


def _tolerances(shape, dtype):
    """(output, lse, gradient) (atol, rtol) at this shape: LONG, STATS and
    LONG_GRAD where ops/flash.py picks the Hopper instances, else KERNEL,
    STATS and GRAD (lse is a float32 sum of the same float32 scores at
    every shape)."""
    if _is_long(shape, dtype):
        return (LONG_ATOL, LONG_RTOL), (STATS_ATOL, STATS_RTOL), (LONG_GRAD_ATOL, LONG_GRAD_RTOL)
    return (KERNEL_ATOL, KERNEL_RTOL), (STATS_ATOL, STATS_RTOL), (GRAD_ATOL, GRAD_RTOL)


@_phase("kernels")
def phase_kernels():
    import torch
    import torch.nn.functional as F

    from dragonfly2_tpu_torch.ops import flash

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    shapes = [
        # name, (B, H, L, D), causal, dtype, fully masked rows, timing iters
        ("served", (1024, 4, 15, 32), False, torch.bfloat16, True, 200),
        ("long", (2, 4, 4096, 32), False, torch.bfloat16, False, 20),
        ("long-causal", (2, 4, 4096, 32), True, torch.bfloat16, False, 20),
        ("wide", (4, 8, 2048, 128), False, torch.bfloat16, False, 20),
        ("long-ragged", (2, 4, 4000, 64), True, torch.bfloat16, True, 20),
        ("test-width", (4, 2, 15, 16), False, torch.bfloat16, True, 50),
        ("float32", (3, 2, 130, 64), True, torch.float32, True, 50),
        # a head dim no instance has: zero-padded to 32, scored at D = 24's scale
        ("head-dim-24", (2, 4, 1000, 24), True, torch.bfloat16, True, 20),
    ]
    results = {}
    for name, (b, h, l, d), causal, dtype, fully, iters in shapes:
        q, k, v, mask = _attention_inputs(gen, b, h, l, d, dtype, fully)
        long = _is_long(q.shape, dtype)
        (atol, rtol), _, _ = _tolerances(q.shape, dtype)
        errs = {}
        for label, kv_mask in (("mask", mask), ("no mask", None)):
            out = flash.flash_attention(q, k, v, kv_mask, causal)
            torch.cuda.synchronize()
            ref = flash.flash_attention_plain(q, k, v, kv_mask, causal)
            errs[label] = float((out.float() - ref.float()).abs().max().item())
            if (not torch.allclose(out.float(), ref.float(), atol=atol, rtol=rtol)
                    or not torch.isfinite(out).all()):
                _fail(f"kernel {name} ({label}): max_abs_err {errs[label]} outside atol {atol} "
                      f"rtol {rtol}")
            if kv_mask is not None:
                dead = ~mask.any(dim=1)
                if dead.any() and out[dead].abs().max().item() != 0.0:
                    _fail(f"kernel {name}: fully masked rows are not 0")
        err, no_mask_err = errs["mask"], errs["no mask"]
        forced = not long and name in HOPPER_FORCED_ROWS
        if forced:
            with _instance(sm90=True):
                got = flash.flash_attention(q, k, v, mask, causal)
                torch.cuda.synchronize()
            ref = flash.flash_attention_plain(q, k, v, mask, causal)
            other_err = float((got.float() - ref.float()).abs().max().item())
            if not torch.allclose(got.float(), ref.float(), atol=atol, rtol=rtol):
                _fail(f"kernel {name}: the Hopper instance forced, max_abs_err {other_err} outside "
                      f"atol {atol} rtol {rtol}")
        ms = _time_ms(lambda: flash.flash_attention(q, k, v, mask, causal), iters)
        plain_ms = _time_ms(lambda: flash.flash_attention_plain(q, k, v, mask, causal),
                            max(3, iters // 4))
        sdpa_mask = mask[:, None, None, :]
        if causal:
            sdpa_mask = sdpa_mask & torch.ones(l, l, dtype=torch.bool, device="cuda").tril()
        library_ms = _time_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=sdpa_mask), iters
        )
        bound_ms, bound_by = _bound(q, mask, causal)
        row = dict(
            shape=[b, h, l, d], causal=causal, dtype=str(dtype).removeprefix("torch."),
            variant="sm90" if long else "mma.sync", max_abs_err=err, ms=ms,
            **_timed(lambda: flash.flash_attention(q, k, v, mask, causal),
                     _symbol("fwd", q.shape, dtype)),
            mma_sync_kernel_ms=None,
            plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
        )
        _need_time(f"kernel flash_fwd {name}", q.shape, dtype, row["kernel_ms"])
        if long:
            with _instance(sm90=False):
                row.update(_timed(lambda: flash.flash_attention(q, k, v, mask, causal),
                                  "flash_fwd_kernel", "mma_sync_kernel"))
        if forced:
            with _instance(sm90=True):
                row.update(_timed(lambda: flash.flash_attention(q, k, v, mask, causal),
                                  "flash_fwd_sm90_kernel", "other_kernel"))
            row.update(other_variant="flash_fwd_sm90", other_max_abs_err=other_err)
        results[name] = row
        print(f"kernel flash_fwd {name} {[b, h, l, d]} causal={causal} "
              f"{row['dtype']} ({row['variant']}): max_abs_err {err:.3g} "
              f"(no mask {no_mask_err:.3g}; atol {atol} rtol {rtol}) ms {ms:.4f} "
              f"(kernel {_fmt(row)}{_other(row)}) plain_ms {plain_ms:.4f} library_ms "
              f"{library_ms:.4f} bound_ms {bound_ms:.4f} ({bound_by})")
    return results


def _other(row: dict) -> str:
    """The forced other instance's device time, where a row took one: the
    mma.sync one at a long shape, the Hopper one at a D = 32 row of the
    ranker's paths."""
    if "mma_sync_kernel_recorded" in row:
        return f"; mma.sync instance {_fmt(row, 'mma_sync_kernel')}"
    if "other_kernel_recorded" in row:
        return (f"; Hopper instance forced {_fmt(row, 'other_kernel')}, max_abs_err "
                f"{row['other_max_abs_err']:.3g}")
    return ""


TRAINING_KERNELS = ("flash_fwd_lse", "flash_bwd_dkv", "flash_bwd_dq")
# each function's launches of either instance, then those of the Hopper
# instances (ops/flash.py's counters)
_COUNTERS = {
    "flash_fwd": "LAUNCHES",
    "flash_fwd_lse": "LSE_LAUNCHES",
    "flash_fwd_partial": "PARTIAL_LAUNCHES",
    "flash_bwd_dkv": "DKV_LAUNCHES",
    "flash_bwd_dq": "DQ_LAUNCHES",
    "flash_fwd_sm90": "FWD_SM90_LAUNCHES",
    "flash_fwd_lse_sm90": "LSE_SM90_LAUNCHES",
    "flash_fwd_partial_sm90": "PARTIAL_SM90_LAUNCHES",
    "flash_bwd_dkv_sm90": "DKV_SM90_LAUNCHES",
    "flash_bwd_dq_sm90": "DQ_SM90_LAUNCHES",
}
SM90_KERNELS = tuple(name for name in _COUNTERS if name.endswith("_sm90"))


def _zero_counts() -> None:
    from dragonfly2_tpu_torch.ops import flash

    for counter in _COUNTERS.values():
        setattr(flash, counter, 0)


def _counts() -> dict:
    from dragonfly2_tpu_torch.ops import flash

    return {name: getattr(flash, counter) for name, counter in _COUNTERS.items()}


def _library_fwd_lse(q, k, v, mask, causal):
    """PyTorch's memory-efficient attention asked for its logsumexp too,
    the one library call with the lse kernel's outputs, as a callable;
    None where it refuses these inputs."""
    import torch

    l = q.shape[2]
    # the library wants the bias rows 8-element aligned: pad, then slice
    bias = torch.zeros(q.shape[0], 1, l, l + (-l) % 8, device="cuda", dtype=q.dtype)[..., :l]
    valid = mask[:, None, None, :]
    if causal:
        valid = valid & torch.ones(q.shape[2], q.shape[2], dtype=torch.bool, device="cuda").tril()
    bias = bias.masked_fill_(~valid, float("-inf")).expand(-1, q.shape[1], -1, -1)
    call = torch.ops.aten._scaled_dot_product_efficient_attention
    try:
        call(q, k, v, bias, True)
        torch.cuda.synchronize()
    except RuntimeError as e:
        print(f"library forward with lse refused {list(q.shape)}: {str(e).splitlines()[0][:120]}")
        return None
    return lambda: call(q, k, v, bias, True)


def _library_fwd_lse_ms(q, k, v, mask, causal, iters):
    """_library_fwd_lse's CUDA-event time; None where it refuses."""
    call = _library_fwd_lse(q, k, v, mask, causal)
    return None if call is None else _time_ms(call, iters)


@_phase("training kernels")
def phase_training_kernels():
    """The training kernels against their plain versions: the forward with
    lse (o and lse), and from the same o and lse, the dK/dV and dQ kernels.
    Rows at the trained shape (with fully masked rows) and at slice 1's
    long shapes. plain_ms of both backward rows is the plain backward,
    which computes dq, dk and dv in one function; library_ms of both is
    the backward of scaled_dot_product_attention (all three gradients),
    to be set against the sum of the two kernels."""
    import torch
    import torch.nn.functional as F

    from dragonfly2_tpu_torch.ops import flash

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    shapes = [
        # name, (B, H, L, D), causal, dtype, fully masked rows, timing iters
        ("trained", (256, 4, 20, 32), False, torch.bfloat16, True, 200),
        ("long", (2, 4, 4096, 32), False, torch.bfloat16, False, 10),
        ("long-causal", (2, 4, 4096, 32), True, torch.bfloat16, False, 10),
        ("wide", (4, 8, 2048, 128), False, torch.bfloat16, False, 10),
        ("long-ragged", (2, 4, 4000, 64), True, torch.bfloat16, True, 10),
    ]
    results = {name: {} for name in TRAINING_KERNELS}
    for label, (b, h, l, d), causal, dtype, fully, iters in shapes:
        q, k, v, mask = _attention_inputs(gen, b, h, l, d, dtype, fully)
        do = torch.randn(b, h, l, d, generator=gen, device="cuda").to(dtype)
        dead = ~mask.any(dim=1)
        long = _is_long(q.shape, dtype)
        (o_atol, o_rtol), (lse_atol, lse_rtol), (g_atol, g_rtol) = _tolerances(q.shape, dtype)

        o, lse = flash.flash_attention_lse(q, k, v, mask, causal)
        torch.cuda.synchronize()
        ref_o, ref_lse = flash.flash_attention_lse_plain(q, k, v, mask, causal)
        seen = ref_lse > -1e20  # rows with a valid key
        o_err = float((o.float() - ref_o.float()).abs().max().item())
        lse_err = float((lse[seen] - ref_lse[seen]).abs().max().item())
        if not (torch.allclose(o.float(), ref_o.float(), atol=o_atol, rtol=o_rtol)
                and torch.allclose(lse[seen], ref_lse[seen], atol=lse_atol, rtol=lse_rtol)
                and torch.isfinite(lse).all()):
            _fail(f"flash_fwd_lse {label}: o err {o_err} (atol {o_atol} rtol {o_rtol}), lse err "
                  f"{lse_err} (atol {lse_atol} rtol {lse_rtol})")

        delta = (do.float() * o.float()).sum(-1)
        dk, dv = flash.flash_attention_bwd_dkv(q, k, v, mask, lse, delta, do, causal)
        dq = flash.flash_attention_bwd_dq(q, k, v, mask, lse, delta, do, causal)
        torch.cuda.synchronize()
        ref_dq, ref_dk, ref_dv = flash.flash_attention_bwd_plain(q, k, v, mask, o, lse, do, causal)
        errs = {}
        for name, got, want in (("dq", dq, ref_dq), ("dk", dk, ref_dk), ("dv", dv, ref_dv)):
            errs[name] = float((got.float() - want.float()).abs().max().item())
            if not torch.allclose(got.float(), want.float(), atol=g_atol, rtol=g_rtol):
                _fail(f"flash_bwd {label} {name}: max_abs_err {errs[name]} outside "
                      f"atol {g_atol} rtol {g_rtol}")
            if dead.any() and got[dead].abs().max().item() != 0.0:
                _fail(f"flash_bwd {label} {name}: fully masked batch rows are not 0")
        forced = not long and label in HOPPER_FORCED_ROWS
        if forced:  # the Hopper instances at the row's shape, from the same o and lse
            with _instance(sm90=True):
                f_o, f_lse = flash.flash_attention_lse(q, k, v, mask, causal)
                f_dk, f_dv = flash.flash_attention_bwd_dkv(q, k, v, mask, lse, delta, do, causal)
                f_dq = flash.flash_attention_bwd_dq(q, k, v, mask, lse, delta, do, causal)
                torch.cuda.synchronize()
            other_errs = {
                "flash_fwd_lse": max(float((f_o.float() - ref_o.float()).abs().max().item()),
                                     float((f_lse[seen] - ref_lse[seen]).abs().max().item())),
                "flash_bwd_dkv": max(float((f_dk.float() - ref_dk.float()).abs().max().item()),
                                     float((f_dv.float() - ref_dv.float()).abs().max().item())),
                "flash_bwd_dq": float((f_dq.float() - ref_dq.float()).abs().max().item()),
            }
            held = (torch.allclose(f_o.float(), ref_o.float(), atol=o_atol, rtol=o_rtol)
                    and torch.allclose(f_lse[seen], ref_lse[seen], atol=lse_atol, rtol=lse_rtol)
                    and all(torch.allclose(got.float(), want.float(), atol=g_atol, rtol=g_rtol)
                            for got, want in ((f_dk, ref_dk), (f_dv, ref_dv), (f_dq, ref_dq))))
            if not held:
                _fail(f"training kernels {label}: the Hopper instances forced, errors {other_errs}")
        tolerance = {"flash_fwd_lse": f"o atol {o_atol} rtol {o_rtol}, lse atol {lse_atol} rtol "
                                      f"{lse_rtol}",
                     "flash_bwd_dkv": f"atol {g_atol} rtol {g_rtol}",
                     "flash_bwd_dq": f"atol {g_atol} rtol {g_rtol}"}

        plain_fwd_ms = _time_ms(lambda: flash.flash_attention_lse_plain(q, k, v, mask, causal),
                                max(3, iters // 4))
        plain_bwd_ms = _time_ms(
            lambda: flash.flash_attention_bwd_plain(q, k, v, mask, o, lse, do, causal),
            max(3, iters // 4),
        )
        sdpa_mask = mask[:, None, None, :]
        if causal:
            sdpa_mask = sdpa_mask & torch.ones(l, l, dtype=torch.bool, device="cuda").tril()
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        sdpa_out = F.scaled_dot_product_attention(*leaves, attn_mask=sdpa_mask)
        library_bwd_ms = _time_ms(
            lambda: torch.autograd.grad(sdpa_out, leaves, do, retain_graph=True), iters
        )
        def fwd_lse():
            return flash.flash_attention_lse(q, k, v, mask, causal)

        def bwd_dkv():
            return flash.flash_attention_bwd_dkv(q, k, v, mask, lse, delta, do, causal)

        def bwd_dq():
            return flash.flash_attention_bwd_dq(q, k, v, mask, lse, delta, do, causal)

        rows = {
            "flash_fwd_lse": dict(
                max_abs_err=max(o_err, lse_err), ms=_time_ms(fwd_lse, iters),
                **_timed(fwd_lse, _symbol("fwd", q.shape, dtype)),
                plain_ms=plain_fwd_ms,
                library_ms=_library_fwd_lse_ms(q, k, v, mask, causal, iters),
                bound=_bound(q, mask, causal, matrices=4, row_stats=1, ops_per_pair=4),
            ),
            "flash_bwd_dkv": dict(
                max_abs_err=max(errs["dk"], errs["dv"]), ms=_time_ms(bwd_dkv, iters),
                **_timed(bwd_dkv, _symbol("dkv", q.shape, dtype)),
                plain_ms=plain_bwd_ms,
                library_ms=library_bwd_ms,
                bound=_bound(q, mask, causal, matrices=6, row_stats=2, ops_per_pair=8),
            ),
            "flash_bwd_dq": dict(
                max_abs_err=errs["dq"], ms=_time_ms(bwd_dq, iters),
                **_timed(bwd_dq, _symbol("dq", q.shape, dtype)),
                plain_ms=plain_bwd_ms,
                library_ms=library_bwd_ms,
                bound=_bound(q, mask, causal, matrices=5, row_stats=2, ops_per_pair=6),
            ),
        }
        for row in rows.values():
            row["mma_sync_kernel_ms"] = None
        if long:
            with _instance(sm90=False):
                rows["flash_fwd_lse"].update(_timed(fwd_lse, "flash_fwd_kernel", "mma_sync_kernel"))
                rows["flash_bwd_dkv"].update(
                    _timed(bwd_dkv, "flash_bwd_dkv_kernel", "mma_sync_kernel"))
                rows["flash_bwd_dq"].update(
                    _timed(bwd_dq, "flash_bwd_dq_kernel", "mma_sync_kernel"))
        if forced:
            with _instance(sm90=True):
                for name, fn, symbol in (("flash_fwd_lse", fwd_lse, "flash_fwd_sm90_kernel"),
                                         ("flash_bwd_dkv", bwd_dkv, "flash_bwd_dkv_sm90_kernel"),
                                         ("flash_bwd_dq", bwd_dq, "flash_bwd_dq_sm90_kernel")):
                    rows[name].update(_timed(fn, symbol, "other_kernel"),
                                      other_variant=name + "_sm90",
                                      other_max_abs_err=other_errs[name])
        for name, row in rows.items():
            bound_ms, bound_by = row.pop("bound")
            variant = "sm90" if long else "mma.sync"
            row.update(shape=[b, h, l, d], causal=causal, dtype=str(dtype).removeprefix("torch."),
                       variant=variant, bound_ms=bound_ms, bound_by=bound_by)
            _need_time(f"kernel {name} {label}", q.shape, dtype, row["kernel_ms"])
            results[name][label] = row
            lib = "n/a" if row["library_ms"] is None else f"{row['library_ms']:.4f}"
            print(f"kernel {name} {label} {[b, h, l, d]} causal={causal} {row['dtype']} "
                  f"({variant}): max_abs_err {row['max_abs_err']:.3g} ({tolerance[name]}) "
                  f"ms {row['ms']:.4f} (kernel {_fmt(row)}{_other(row)}) "
                  f"plain_ms {row['plain_ms']:.4f} library_ms {lib} "
                  f"bound_ms {bound_ms:.4f} ({bound_by})")
        del sdpa_out, leaves
    return results


# the packed-sets kernels (slices 13 and 15) at their edges: B x H = 3 x 5 sets, where
# a block holds 32 / L whole sets, so the last block is short at most L; L
# from 1 (32 sets a block) through 10 and 15 (three, two) to 20-32 (one);
# batch row 0 fully masked
SETS_EDGE_SETS = (3, 5)
SETS_EDGE_DIMS = (32, 128)
SETS_EDGE_LENGTHS = (1, 10, 15, 20, 21, 22, 32)


@_phase("sets kernels")
def phase_sets_kernels():
    """The packed-sets kernels of the forward (three modes), of dK/dV and
    of dQ against their plain versions at the edge shapes, causal or not,
    bf16 and float32: every output within KERNEL, lse and the partials' row
    statistics within STATS, gradients within GRAD (float32 is rounded to
    bf16 in shared memory, so both sides take the rounded values), batch
    row 0 (no valid key) exactly 0; one launch of each counted a call;
    then, at L = 22, the kernel names the profiler finds behind each
    entry."""
    import torch

    from dragonfly2_tpu_torch.ops import flash

    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    b, h = SETS_EDGE_SETS
    worst = collections.defaultdict(float)
    for d in SETS_EDGE_DIMS:
        for dtype in (torch.bfloat16, torch.float32):
            for l in SETS_EDGE_LENGTHS:
                for causal in (False, True):
                    q, k, v, mask = _attention_inputs(gen, b, h, l, d, dtype, True)
                    q, k, v = (t.to(torch.bfloat16).to(dtype) for t in (q, k, v))
                    do = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
                    do = do.to(dtype)
                    label = f"[{b}, {h}, {l}, {d}] causal={causal} {str(dtype)[6:]}"
                    before = _counts()
                    out = flash.flash_attention(q, k, v, mask, causal)
                    o, lse = flash.flash_attention_lse(q, k, v, mask, causal)
                    delta = (do.float() * o.float()).sum(-1)
                    dk, dv = flash.flash_attention_bwd_dkv(q, k, v, mask, lse, delta, do, causal)
                    dq = flash.flash_attention_bwd_dq(q, k, v, mask, lse, delta, do, causal)
                    partials = None if causal else flash.flash_attention_partials(q, k, v, mask)
                    torch.cuda.synchronize()
                    expected = dict(before, flash_fwd=before["flash_fwd"] + 1,
                                    flash_fwd_lse=before["flash_fwd_lse"] + 1,
                                    flash_bwd_dkv=before["flash_bwd_dkv"] + 1,
                                    flash_bwd_dq=before["flash_bwd_dq"] + 1,
                                    flash_fwd_partial=before["flash_fwd_partial"] + (not causal))
                    if _counts() != expected:
                        _fail(f"sets kernels {label}: launches {_counts()}, expected {expected}")
                    ref_o, ref_lse = flash.flash_attention_lse_plain(q, k, v, mask, causal)
                    seen = ref_lse > -1e20
                    errs = {"fwd": float((out.float() - ref_o.float()).abs().max().item()),
                            "lse": max(float((o.float() - ref_o.float()).abs().max().item()),
                                       float((lse[seen] - ref_lse[seen]).abs().max().item()))}
                    ok = (torch.allclose(out.float(), ref_o.float(), atol=KERNEL_ATOL,
                                         rtol=KERNEL_RTOL)
                          and torch.equal(o, out) and bool(torch.isfinite(lse).all())
                          and torch.allclose(lse[seen], ref_lse[seen], atol=STATS_ATOL,
                                             rtol=STATS_RTOL)
                          and bool((out[0] == 0).all()))
                    ref_dq, ref_dk, ref_dv = flash.flash_attention_bwd_plain(q, k, v, mask, o, lse,
                                                                             do, causal)
                    errs["dkv"] = max(float((dk.float() - ref_dk.float()).abs().max().item()),
                                      float((dv.float() - ref_dv.float()).abs().max().item()))
                    errs["dq"] = float((dq.float() - ref_dq.float()).abs().max().item())
                    ok = ok and all(
                        torch.allclose(got.float(), want.float(), atol=GRAD_ATOL, rtol=GRAD_RTOL)
                        and bool((got[0] == 0).all())
                        for got, want in ((dk, ref_dk), (dv, ref_dv), (dq, ref_dq)))
                    if partials is not None:
                        perr, pok = _partial_errors(
                            partials, flash.flash_attention_partials_plain(q, k, v, mask),
                            KERNEL_ATOL, KERNEL_RTOL)
                        errs["partial"] = max(perr["acc_over_row_sum"], perr["row_max"],
                                              perr["row_sum"])
                        ok = ok and pok
                    if not ok:
                        _fail(f"sets kernels {label} vs the plain versions: errors {errs} (outputs "
                              f"atol {KERNEL_ATOL} rtol {KERNEL_RTOL}, lse and row statistics "
                              f"{STATS_ATOL}, gradients {GRAD_ATOL}), or batch row 0 not 0")
                    for kind, err in errs.items():
                        worst[kind, d, dtype] = max(worst[kind, d, dtype], err)
            print(f"sets kernels D = {d} {str(dtype)[6:]} on {b} x {h} sets, L = "
                  f"{', '.join(map(str, SETS_EDGE_LENGTHS))}, causal and not: max_abs_err "
                  + ", ".join(f"{kind} {worst[kind, d, dtype]:.3g}"
                              for kind in ("fwd", "lse", "partial", "dkv", "dq"))
                  + f" (outputs atol {KERNEL_ATOL} rtol {KERNEL_RTOL}, lse and row statistics "
                  f"{STATS_ATOL}, gradients {GRAD_ATOL} rtol {GRAD_RTOL}); every launch counted")
        # the kernels behind each entry at the one-tile limit's far side
        q, k, v, mask = _attention_inputs(gen, b, h, 22, d, torch.bfloat16, True)
        o, lse = flash.flash_attention_lse(q, k, v, mask)
        delta = (o.float() * o.float()).sum(-1)
        reached = {}
        for name, call in (
                ("fwd", lambda: flash.flash_attention(q, k, v, mask)),
                ("lse", lambda: flash.flash_attention_lse(q, k, v, mask)),
                ("partial", lambda: flash.flash_attention_partials(q, k, v, mask)),
                ("dkv", lambda: flash.flash_attention_bwd_dkv(q, k, v, mask, lse, delta, o)),
                ("dq", lambda: flash.flash_attention_bwd_dq(q, k, v, mask, lse, delta, o))):
            _, _, names = _kernel_ms(call, r"flash_\w+_kernel", calls=5)
            reached[name] = names
            symbol = _mma_sync_symbol(name if name in ("dkv", "dq") else "fwd", 22)
            if names != [symbol]:
                _fail(f"sets kernels D = {d} L = 22: {name} reached {names}, not {symbol}")
        print(f"sets kernels D = {d} at [{b}, {h}, 22, {d}] bf16, the kernels the profiler found: "
              + "; ".join(f"{name} {', '.join(names)}" for name, names in reached.items()))


LAUNCH_COST_CALLS = 2000  # host-clock calls of each step of the wrapper
LAUNCH_TURNS = ("control", "launcher", "launcher", "control")  # who goes first in each turn
# a turn takes each side in LAUNCH_WINDOWS windows, interleaved with the
# other sides' so that all of them meet the same host, and reads each
# side's medians: LAUNCH_EVENT_CALLS calls by CUDA events and
# LAUNCH_HOST_CALLS by the host clock a window
LAUNCH_WINDOWS = 5
LAUNCH_EVENT_CALLS = 200
LAUNCH_HOST_CALLS = 500
# the ranker's trained batch at hidden 128 (the mma.sync instance) and at
# hidden 768 (head dim 192, the wide mma.sync instance)
LAUNCH_SHAPES = ((256, 4, 20, 32), (256, 4, 20, 192))


def _host_us(step, calls: int = LAUNCH_COST_CALLS) -> float:
    """Host microseconds a call of ``step`` (perf_counter over ``calls``
    calls after a warm-up; what it enqueues is drained outside the window)."""
    import torch

    for _ in range(50):
        step()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(calls):
        step()
    seconds = time.perf_counter() - start
    torch.cuda.synchronize()
    return seconds / calls * 1e6


class _CtypesControl:
    """The forward with lse as ops/flash.py made it before the launcher:
    its checks, routing, output allocations, pointers and stream lookup in
    Python around a ctypes call of dfly_flash_fwd_lse or
    dfly_flash_fwd_lse_wide, counted under a lock. The control of
    phase_launch_cost; nothing in the package uses it. Its steps are its
    methods, which that phase also times one by one."""

    def __init__(self):
        from dragonfly2_tpu_torch.ops import build

        self.lib = ctypes.CDLL(str(build._library_path("flash_fwd", build.nvcc_path())))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        self.fns = {}
        for name, ints in (("dfly_flash_fwd_lse", 7), ("dfly_flash_fwd_lse_wide", 6)):
            fn = getattr(self.lib, name)
            fn.argtypes, fn.restype = [p] * 6 + [i] * ints + [f, p], ctypes.c_int
            self.fns[name] = fn
        self.lib.dfly_cuda_error_string.argtypes = [i]
        self.lib.dfly_cuda_error_string.restype = ctypes.c_char_p
        self.lock, self.launches = threading.Lock(), 0

    @staticmethod
    def check(q, k, v, mask):
        from dragonfly2_tpu_torch.ops import flash

        flash._check(q, k, v, mask)

    @staticmethod
    def route(q):
        from dragonfly2_tpu_torch.ops import flash

        _, _, l, d = q.shape
        if flash._padded_route(q) or flash._sm90_path(l, d, q.dtype):
            raise ValueError("the control takes the mma.sync and wide instances alone")
        wide = flash._is_wide(d)
        return ("dfly_flash_fwd_lse_wide", ()) if wide else ("dfly_flash_fwd_lse",
                                                             (flash.warps_for(l),))

    @staticmethod
    def outputs(q):
        import torch

        b, h, l, _ = q.shape
        return torch.empty_like(q), torch.empty(b, h, l, dtype=torch.float32, device=q.device)

    @staticmethod
    def pointers(*tensors):
        if any(t is not None and t.dim() == 4 and t.data_ptr() % 16 for t in tensors):
            raise ValueError("flash attention operands must be 16-byte aligned")
        return [None if t is None else t.data_ptr() for t in tensors]

    def launch(self, name, device, *args):
        import torch

        stream = torch.cuda.current_stream(device).cuda_stream
        if device.index is None or device.index == torch.cuda.current_device():
            err = self.fns[name](*args, stream)
        else:
            with torch.cuda.device(device):
                err = self.fns[name](*args, stream)
        if err != 0:
            raise RuntimeError(f"{name} launch failed: "
                               f"{self.lib.dfly_cuda_error_string(err).decode()} ({err})")

    def count(self):
        with self.lock:
            self.launches += 1

    def __call__(self, q, k, v, mask, causal=False):
        import torch

        from dragonfly2_tpu_torch.ops import flash

        self.check(q, k, v, mask)
        name, warps = self.route(q)
        o, lse = self.outputs(q)
        b, h, l, d = q.shape
        dtype = 0 if q.dtype == torch.bfloat16 else 1
        self.launch(name, q.device, *self.pointers(q, k, v, mask, o, lse),
                    b, h, l, d, int(causal), dtype, *warps, flash._scale(q))
        self.count()
        return o, lse


@_phase("launch cost")
def phase_launch_cost(card: str):
    """The host cost of the forward with lse's wrapper at the ranker's two
    trained shapes (LAUNCH_SHAPES; at L = 20 a wrapper's CUDA-event time
    is its host call rate): each step of the wrapper through the launcher
    and of the ctypes control timed alone on the host clock, then the
    wrapper, the control and the library call in LAUNCH_TURNS, by CUDA
    events and by the host clock, the two sides first in turn, each turn
    the medians of LAUNCH_WINDOWS interleaved windows. The launcher's
    outputs must equal the control's bit for bit."""
    import torch

    from dragonfly2_tpu_torch.ops import build, flash

    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    control = _CtypesControl()
    counted = {name: getattr(flash, name) for name in ("LSE_LAUNCHES", "LSE_WIDE_LAUNCHES")}
    results = {}
    for shape in LAUNCH_SHAPES:
        q, k, v, mask = _attention_inputs(gen, *shape, torch.bfloat16, True)
        b, h, l, d = q.shape
        dev = q.device
        got, want = flash.flash_attention_lse(q, k, v, mask), control(q, k, v, mask)
        torch.cuda.synchronize()
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            _fail(f"launch cost {list(shape)}: the launcher's outputs differ from the ctypes "
                  "control's on the same inputs")
        print(f"launch bits {list(shape)}: the launcher's o and lse equal the ctypes control's "
              "bit for bit")
        name, warps = control.route(q)  # the entry the launcher's route takes too
        o, lse = control.outputs(q)
        args = control.pointers(q, k, v, mask, o, lse) + [b, h, l, d, 0, 0, *warps, flash._scale(q)]
        stream = torch.cuda.current_stream(dev).cuda_stream
        kind, instance = flash.ENTRIES[name]
        launch = getattr(build.launcher(), kind)
        scale = flash._scale(q)
        launcher_steps = {
            "_need_cuda (q.is_cuda)": lambda: flash._need_cuda(q),
            "q.is_cpu and _padded_route": lambda: (q.is_cpu, flash._padded_route(q)),
            "routing (_is_wide, _sm90_path, _ROUTES, warps_for)": lambda: (
                flash._is_wide(d), flash._sm90_path(l, d, q.dtype, "lse"),
                flash._ROUTES["lse", instance], flash.warps_for(l)),
            "_scale": lambda: flash._scale(q),
            "_launch's lookups (ENTRIES, build.launcher(), getattr)": lambda: getattr(
                build.launcher(), flash.ENTRIES[name][0]),
            "the launcher's call (checks, at::empty x2, device guard, stream, launch, wrap)":
                lambda: launch(instance, q, k, v, mask, False, scale, flash.warps_for(l)),
            "_count under its lock": lambda: flash._count("LSE_LAUNCHES"),
        }
        control_steps = {
            "_check": lambda: control.check(q, k, v, mask),
            "routing (_padded_route, _sm90_path, _is_wide, warps_for)": lambda: control.route(q),
            "torch.empty (o, lse)": lambda: control.outputs(q),
            "_pointers": lambda: control.pointers(q, k, v, mask, o, lse),
            "current_stream(device).cuda_stream":
                lambda: torch.cuda.current_stream(dev).cuda_stream,
            "torch.cuda.current_device()": torch.cuda.current_device,
            "ctypes call (the launch)": lambda: control.fns[name](*args, stream),
            "count under a lock": control.count,
        }
        wrapper = lambda: flash.flash_attention_lse(q, k, v, mask)  # noqa: E731
        controlled = lambda: control(q, k, v, mask)  # noqa: E731
        library = _library_fwd_lse(q, k, v, mask, False)
        for side, steps, whole in (("launcher", launcher_steps, wrapper),
                                   ("ctypes control", control_steps, controlled)):
            costs = {step: _host_us(fn) for step, fn in steps.items()}
            print(f"launch cost {list(shape)} bf16 ({card}), {side}, host us a call: "
                  + ", ".join(f"{step} {us:.2f}" for step, us in costs.items())
                  + f"; the whole wrapper {_host_us(whole):.2f} (the steps sum to "
                  f"{sum(costs.values()):.2f})")
        sides = {"launcher": wrapper, "control": controlled, "library": library}
        order = [side for side in sides if sides[side] is not None]
        turns = {side: [] for side in order}
        for first in LAUNCH_TURNS:
            order.sort(key=lambda side: (side != first, side == "library"))
            windows = {side: [] for side in order}
            for _ in range(LAUNCH_WINDOWS):
                for side in order:
                    windows[side].append((_host_us(sides[side], LAUNCH_HOST_CALLS),
                                          _time_ms(sides[side], LAUNCH_EVENT_CALLS)))
            for side, readings in windows.items():
                turns[side].append((statistics.median(us for us, _ in readings),
                                    statistics.median(ms for _, ms in readings)))
        for side, readings in turns.items():
            print(f"launch turns {list(shape)} ({card}), {side}: CUDA events "
                  + " / ".join(f"{ms:.4f}" for _, ms in readings) + " ms, host "
                  + " / ".join(f"{us:.2f}" for us, _ in readings) + " us (turns 1-4, each the "
                  f"median of {LAUNCH_WINDOWS} interleaved windows; control first in turns 1 "
                  "and 4, the launcher in 2 and 3)")
        if "library" in turns:
            under = sum(ms < lib_ms for (_, ms), (_, lib_ms)
                        in zip(turns["launcher"], turns["library"]))
            medians = {side: statistics.median(ms for _, ms in turns[side]) for side in turns}
            print(f"launch verdict {list(shape)} ({card}): the launcher's wrapper "
                  f"{medians['launcher']:.4f} ms median against the library's "
                  f"{medians['library']:.4f} and the control's {medians['control']:.4f}; under "
                  f"the library in {under} of {len(LAUNCH_TURNS)} turns")
        results[tuple(shape)] = turns
    for name, count in counted.items():
        setattr(flash, name, count)
    return results


def _requests(n: int, rng: np.random.Generator):
    from dragonfly2_tpu_torch.models.attention import NUM_HOST_FEATURES, NUM_PAIR_FEATURES

    child = rng.standard_normal((n, NUM_HOST_FEATURES)).astype(np.float32)
    parents = rng.standard_normal((n, CANDIDATES, NUM_HOST_FEATURES)).astype(np.float32)
    pair = (rng.random((n, CANDIDATES, NUM_PAIR_FEATURES)) < 0.5).astype(np.float32)
    # left-compacted candidate slots, 0..15 valid per task (0 = a task with
    # no eligible parent, whose row the kernel must return as zeros)
    counts = rng.integers(0, CANDIDATES + 1, size=n)
    counts[0] = 0
    mask = np.arange(CANDIDATES)[None, :] < counts[:, None]
    return {"child_feats": child, "parent_feats": parents, "pair_feats": pair, "mask": mask}


async def _serve_and_query(server, name):
    from dragonfly2_tpu_torch.ops import flash
    from dragonfly2_tpu_torch.rpc.inference import InferenceClient, InferenceRPCServer

    rng = np.random.default_rng(SEED)
    batches = {n: _requests(n, rng) for n in TASK_BUCKETS}
    rpc = InferenceRPCServer({name: server}, host="127.0.0.1", port=0)
    host, port = await rpc.start()
    client = await InferenceClient(host, port).connect()
    try:
        if not await client.server_live():
            _fail("ServerLive answered false")
        if not await client.model_ready(name):
            _fail("ModelReady answered false after activation")
        answers, latency_ms = {}, {}
        _zero_counts()
        requests = 0
        for n in TASK_BUCKETS:
            times = []
            for _ in range(REQUESTS_PER_BUCKET):
                start = time.perf_counter()
                out = await client.model_infer(name, batches[n], request_id=f"smoke-{n}")
                times.append((time.perf_counter() - start) * 1e3)
                requests += 1
                if n in answers and not np.array_equal(out["scores"], answers[n]):
                    _fail(f"N={n}: repeated request answered differently")
                answers[n] = out["scores"]
            latency_ms[n] = times
        launches = flash.LAUNCHES
        if any(_counts()[name] for name in SM90_KERNELS):
            _fail(f"serving launched a Hopper instance: {_counts()}")
    finally:
        await client.close()
        await rpc.stop()
    return batches, answers, latency_ms, requests, launches


@_phase("serving")
def phase_main_path():
    import torch

    from dragonfly2_tpu_torch.models.attention import AttentionRanker
    from dragonfly2_tpu_torch.models.convert import attention_params_to_flax
    from dragonfly2_tpu_torch.registry import ModelEvaluation, ModelServer, open_registry
    from dragonfly2_tpu_torch.registry.registry import MODEL_TYPE_ATTENTION

    name, host_id = "attention-ranker", "chip-smoke-scheduler"
    model = AttentionRanker().reset_parameters(torch.Generator().manual_seed(SEED))
    with tempfile.TemporaryDirectory(prefix="dfly-smoke-") as tmp:
        registry = open_registry(f"fs://models/smoke?base_dir={tmp}")
        version = registry.create_model_version(
            name, MODEL_TYPE_ATTENTION, host_id, attention_params_to_flax(model),
            ModelEvaluation(),
            metadata={"hidden_dim": model.hidden_dim, "num_heads": model.num_heads,
                      "num_layers": model.num_layers},
        )
        registry.activate(version.model_id, version.version)
        server = ModelServer(registry, name, host_id, MODEL_TYPE_ATTENTION, device="cuda")
        batches, answers, latency_ms, requests, launches = asyncio.run(
            _serve_and_query(server, name)
        )
        expected = requests * model.num_layers
        print(f"main path: {requests} ModelInfer requests, flash_fwd launches {launches} "
              f"(expected {expected} = requests x num_layers)")
        if launches != expected:
            _fail(f"flash_fwd launched {launches} times on the main path, expected {expected}")

        cpu_server = ModelServer(registry, name, host_id, MODEL_TYPE_ATTENTION, device="cpu")
        if not cpu_server.refresh():
            _fail("the CPU ModelServer could not load the active version")
        for n in TASK_BUCKETS:
            batch, wire = batches[n], answers[n]
            mask = batch["mask"]
            if wire.shape != (n, CANDIDATES) or wire.dtype != np.float32:
                _fail(f"N={n}: scores {wire.shape} {wire.dtype}")
            if not np.isfinite(wire[mask]).all():
                _fail(f"N={n}: non-finite score at a valid slot")
            if not (wire[~mask] == np.float32(-1e30)).all():
                _fail(f"N={n}: invalid slots are not -1e30")
            direct = server.score_set(
                batch["child_feats"], batch["parent_feats"], batch["pair_feats"], mask
            ).cpu().numpy()
            if not np.array_equal(wire, direct):
                _fail(f"N={n}: wire scores differ from the in-process score_set")
            cpu = cpu_server.score_set(
                batch["child_feats"], batch["parent_feats"], batch["pair_feats"], mask
            ).numpy()
            err = float(np.abs(wire[mask] - cpu[mask]).max())
            if not np.allclose(wire[mask], cpu[mask], atol=MODEL_ATOL, rtol=MODEL_RTOL):
                _fail(f"N={n}: cuda vs cpu max_abs_err {err}")
            warm = latency_ms[n][1:]
            print(f"ModelInfer N={n} x {CANDIDATES}: p50 {statistics.median(warm):.3f} ms "
                  f"over {len(warm)} warm requests (first {latency_ms[n][0]:.3f} ms); "
                  f"valid slots {int(mask.sum())}; cuda vs cpu max_abs_err {err:.3g} "
                  f"(atol {MODEL_ATOL} rtol {MODEL_RTOL}); wire == score_set bit for bit")
            _breakdown(server, batch, n, statistics.median(warm))
    return launches


def _breakdown(server, batch, n, wire_p50_ms):
    """Where one request's time goes: the in-process score_set (host clock,
    synchronised) against the wire round trip, and the device's kernel time
    per request from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    args = (batch["child_feats"], batch["parent_feats"], batch["pair_feats"], batch["mask"])
    times = []
    for _ in range(8):
        start = time.perf_counter()
        server.score_set(*args)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - start) * 1e3)
    direct_ms = statistics.median(times[2:])
    calls = 5
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            server.score_set(*args)
        torch.cuda.synchronize()
    kernels = _kernels_of(prof, calls)
    device_ms = sum(ms for _, ms in kernels)
    if device_ms == 0:
        print(f"breakdown N={n}: wire p50 {wire_p50_ms:.3f} ms, score_set p50 {direct_ms:.3f} ms; "
              "device time not measured (the profiler saw no device activity)")
        return
    flash_ms = sum(ms for name, ms in kernels if "flash_fwd" in name)
    top = "; ".join(f"{name[:60]} {ms:.4f}" for name, ms in kernels[:4])
    print(f"breakdown N={n}: wire p50 {wire_p50_ms:.3f} ms, score_set p50 {direct_ms:.3f} ms, "
          f"device kernels {device_ms:.4f} ms/request in {len(kernels)} kernels "
          f"(flash_fwd {flash_ms:.4f} ms), device busy {100 * device_ms / direct_ms:.1f}% "
          f"of score_set, {100 * device_ms / wire_p50_ms:.1f}% of the wire request; top: {top}")


async def _serve_rows(server, name, batches):
    """ModelInfer over the RPC for each batch; (answers, latency ms)."""
    from dragonfly2_tpu_torch.rpc.inference import InferenceClient, InferenceRPCServer

    rpc = InferenceRPCServer({name: server}, host="127.0.0.1", port=0)
    host, port = await rpc.start()
    client = await InferenceClient(host, port).connect()
    answers, latency_ms = [], []
    try:
        if not await client.model_ready(name):
            _fail(f"ModelReady answered false for {name} after activation")
        for i, batch in enumerate(batches):
            start = time.perf_counter()
            out = await client.model_infer(name, batch, request_id=f"smoke-trained-{i}")
            latency_ms.append((time.perf_counter() - start) * 1e3)
            answers.append(out["scores"])
    finally:
        await client.close()
        await rpc.stop()
    return answers, latency_ms


def _step_breakdown(trainer, idx, steps: int = 20):
    """A training step's time: p50 over synchronised steps (host clock),
    then a torch.profiler window for the device-busy share and the kernels
    that take the most device time per step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    times = []
    for i in range(steps):
        start = time.perf_counter()
        trainer.step(idx[i % len(idx)])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - start) * 1e3)
    p50 = statistics.median(times[3:])
    window = 10
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for i in range(window):
            trainer.step(idx[i % len(idx)])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3 / window
    kernels = _kernels_of(prof, window)
    device_ms = sum(ms for _, ms in kernels)
    if device_ms == 0:
        print(f"training step: p50 {p50:.3f} ms over {len(times) - 3} synchronised steps; "
              "device time not measured (the profiler saw no device activity)")
        return {"step_p50_ms": p50}
    shares = {
        label: sum(ms for key, ms in kernels if re.search(symbol, key))
        for label, symbol in (("forward with lse", r"flash_fwd_(?:sets_)?kernel"),
                              ("dK/dV", r"flash_bwd_dkv_(?:sets_)?kernel"),
                              ("dQ", r"flash_bwd_dq_(?:sets_)?kernel"))
    }
    top = "; ".join(f"{key[:60]} {ms:.4f}" for key, ms in kernels[:6])
    print(f"training step: p50 {p50:.3f} ms over {len(times) - 3} synchronised steps; "
          f"profiled {wall_ms:.3f} ms/step, device kernels {device_ms:.4f} ms/step in "
          f"{len(kernels)} kernels, device busy {100 * device_ms / wall_ms:.1f}%; "
          + ", ".join(f"{label} {ms:.4f} ms ({100 * ms / device_ms:.1f}%)"
                      for label, ms in shares.items())
          + f" of device time per step; top: {top}")
    return {"step_p50_ms": p50, "device_ms": device_ms, "profiled_step_ms": wall_ms}


def _first_epoch(ds, config):
    """(eval rows, train rows, the first epoch's batches of train rows):
    the split and the minibatch order as train_attention draws them from
    SEED."""
    from dragonfly2_tpu_torch.training import data, train

    rng = np.random.default_rng(SEED)
    eval_idx, train_idx = train._train_eval_split(rng.permutation(len(ds.mask)), 0.2)
    batch_size = min(config.batch_size, len(train_idx))
    return eval_idx, train_idx, np.stack(list(data.minibatches(len(train_idx), batch_size, rng)))


def _replay_on_cpu(ds, config, losses, train_idx, first_epoch, steps: int, label: str = "",
                   rounding=None):
    """A cuda train_attention run's first ``steps`` steps again on the
    CPU's plain versions, from the same weights and batches (losses within
    REPLAY_LOSS_ATOL); then one step's gradients, cuda against cpu, from
    the same weights: each parameter within GRAD_REL of its largest
    element. Given ``rounding``, an attention function one bf16 rounding
    of q away from the plain version, the CPU's gradients through it set
    the floor: the limit is then twice the difference that rounding makes,
    where that is above GRAD_REL. Returns (the train rows, in_features)."""
    import torch

    from dragonfly2_tpu_torch.training import train

    rows = train.take(ds, train_idx)
    in_features = sum(rows[key].shape[-1] for key in ("parents", "child", "pair"))
    cpu = train.AttentionTrainer(
        train.build_ranker(config, in_features, SEED, None, "cpu"), rows, config.learning_rate, "cpu"
    )
    replay = [cpu.step(torch.from_numpy(i)).item() for i in first_epoch[:steps]]
    replay_err = float(np.abs(np.array(replay) - np.array(losses[:len(replay)])).max())
    print(f"{label}cpu replay of the first {len(replay)} steps (plain versions): max loss "
          f"difference {replay_err:.3g} (atol {REPLAY_LOSS_ATOL})")
    if replay_err > REPLAY_LOSS_ATOL:
        _fail(f"{label}cpu replay loss differs by {replay_err}")

    def gradients(device, **kwargs):
        trainer = train.AttentionTrainer(
            train.build_ranker(config, in_features, SEED, None, device), rows,
            config.learning_rate, device, **kwargs,
        )
        trainer.loss(torch.from_numpy(first_epoch[0]).to(device)).backward()
        return {n: prm.grad.float().cpu() for n, prm in trainer.model.named_parameters()}

    def worst_of(got, want):
        return max((float((got[n] - g).abs().max()) / float(g.abs().max()), n)
                   for n, g in want.items() if n not in SHIFT_INVARIANT)

    grads = {device: gradients(device) for device in ("cuda", "cpu")}
    # the score head's and the last LayerNorm's biases shift a row's scores
    # alike, which the listwise loss ignores: their true gradient is 0
    largest = max(float(g.abs().max()) for g in grads["cpu"].values())
    worst = worst_of(grads["cuda"], grads["cpu"])
    zero = max(float(grads[d][n].abs().max()) for d in grads for n in SHIFT_INVARIANT) / largest
    limit, floor = GRAD_REL, ""
    if rounding is not None:
        moved = worst_of(gradients("cpu", attention_fn=rounding), grads["cpu"])
        limit = max(GRAD_REL, 2 * moved[0])
        floor = (f"; one bf16 rounding of q moves the CPU's gradients by {moved[0]:.3g} "
                 f"({moved[1]})")
    print(f"{label}one step's gradients, cuda vs cpu: worst parameter {worst[1]} at "
          f"{worst[0]:.3g} of its largest element (limit {limit:.3g}) over "
          f"{len(grads['cpu']) - len(SHIFT_INVARIANT)} parameters; the shift-invariant biases at "
          f"{zero:.3g} of the largest gradient (limit 1e-3){floor}")
    if worst[0] > limit or zero > 1e-3:
        _fail(f"{label}gradient of {worst[1]} differs by {worst[0]} of its scale "
              f"(shift-invariant {zero})")
    return rows, in_features


def _prescaled_attention(q, k, v, kv_mask=None, causal=False):
    """flash_attention one bf16 rounding of q away: q scaled by
    sqrt(256 / D) and rounded to its dtype once, zero-padded to 256 with k
    and v (whose 1/sqrt(256) undoes the scale), the output sliced back."""
    import torch.nn.functional as F

    from dragonfly2_tpu_torch.ops import flash

    d = q.shape[-1]
    pad = (0, 256 - d)
    out = flash.flash_attention(F.pad(q * (256 / d) ** 0.5, pad), F.pad(k, pad), F.pad(v, pad),
                                kv_mask, causal)
    return out[..., :d]


def trace(hosts: int = TRACE_HOSTS, n_records: int = TRACE_RECORDS, tasks: int = TRACE_TASKS):
    """Phase 5's trace (bench_trainer.py's) from the port's synth: (the
    ranking dataset, the host graph, the download records)."""
    from dragonfly2_tpu_torch.records import synth
    from dragonfly2_tpu_torch.records.features import downloads_to_ranking_dataset

    start = time.perf_counter()
    cluster = synth.make_cluster(hosts, seed=SEED)
    records = synth.gen_download_records(cluster, n_records, num_tasks=tasks,
                                         max_parents=MAX_PARENTS)
    ds, graph = downloads_to_ranking_dataset(records, max_parents=MAX_PARENTS)
    print(f"trace: {len(records)} download records on {len(graph.host_ids)} hosts "
          f"({hosts} in the cluster), {tasks} tasks, parents {list(ds.parents.shape)}, "
          f"valid candidates {int(ds.mask.sum())}; synth + features {time.perf_counter() - start:.1f} s "
          "(host)")
    return ds, graph, records


class _Background(threading.Thread):
    """``fn()`` in a thread of its own, started at once; ``result()`` waits
    for it and returns its value, or raises what it raised."""

    def __init__(self, fn):
        super().__init__(daemon=True)
        self._fn, self._value, self._error = fn, None, None
        self.start()

    def run(self) -> None:
        try:
            self._value = self._fn()
        except BaseException as e:  # noqa: BLE001 - raised again in result()
            self._error = e

    def result(self):
        self.join()
        if self._error is not None:
            raise self._error
        return self._value


@_phase("training")
def phase_training(traced: _Background | None = None):
    """Slice 2's main path: trace -> train_attention on cuda -> publish ->
    serve over ModelInfer. The trace is ``traced``'s, made while the kernels
    built, or made here. Returns the launch counts of the training run and
    of the serving run."""
    import torch

    from dragonfly2_tpu_torch.config.config import TrainerConfig
    from dragonfly2_tpu_torch.models import metrics
    from dragonfly2_tpu_torch.registry import ModelEvaluation, ModelServer, open_registry
    from dragonfly2_tpu_torch.registry.registry import MODEL_TYPE_ATTENTION
    from dragonfly2_tpu_torch.training import train

    ds, graph, records = traced.result() if traced is not None else trace()

    config = TrainerConfig(epochs=TRAIN_EPOCHS)
    layers = config.attention_num_layers
    _zero_counts()
    torch.cuda.synchronize()
    start = time.perf_counter()
    result = train.train_attention(ds, config, seed=SEED)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - start
    train_counts = _counts()
    expected = {"flash_fwd": layers, "flash_fwd_partial": 0,
                **{k: result.steps * layers for k in TRAINING_KERNELS},
                **{k: 0 for k in SM90_KERNELS}}
    print(f"training: {result.steps} steps of batch {config.batch_size} over {TRAIN_EPOCHS} epochs "
          f"in {train_s:.2f} s; launches {train_counts} (expected {expected}: steps x layers for "
          "each training kernel, one eval batch x layers for the finished forward)")
    if train_counts != expected:
        _fail(f"training launches {train_counts}, expected {expected}")
    if not np.isfinite(result.losses).all():
        _fail("non-finite training loss")

    eval_idx, train_idx, first_epoch = _first_epoch(ds, config)
    eb = train.take(ds, eval_idx)
    chance = metrics.top1_selection_stats(
        np.random.default_rng(SEED).random(eb["mask"].shape, dtype=np.float32),
        eb["throughput"], eb["mask"],
    )
    em = result.eval_metrics
    print(f"training throughput: {result.samples_per_sec:.1f} samples/s steady state (epochs after the first), "
          f"peak epoch {result.peak_samples_per_sec:.1f}; loss first {result.losses[0]:.4f} "
          f"last {result.losses[-1]:.4f}; eval on {len(eval_idx)} held-out rows: precision "
          f"{em['precision']:.4f} (random picks {float(chance['precision']):.4f}), recall "
          f"{em['recall']:.4f} of a ceiling {em['recall_ceiling']:.4f}, f1 {em['f1']:.4f}, "
          f"regret {em['regret']:.4f} (random picks {float(chance['regret']):.4f}); "
          f"analytic {result.analytic_flops_per_sample / 1e6:.2f} MFLOP/sample")

    rows, in_features = _replay_on_cpu(ds, config, result.losses, train_idx, first_epoch,
                                       REPLAY_STEPS)
    # a steady step's time and where it goes (outside the counted run)
    steady = train.AttentionTrainer(
        train.build_ranker(config, in_features, SEED, result.params, "cuda"), rows,
        config.learning_rate, "cuda",
    )
    breakdown = _step_breakdown(steady, torch.from_numpy(first_epoch).cuda())

    name, host_id = "parent-ranker-attention", "chip-smoke-trainer"
    with tempfile.TemporaryDirectory(prefix="dfly-smoke-train-") as tmp:
        registry = open_registry(f"fs://models/smoke?base_dir={tmp}")
        version = registry.create_model_version(
            name, MODEL_TYPE_ATTENTION, host_id, result.params,
            ModelEvaluation(recall=em["recall"], precision=em["precision"], f1_score=em["f1"]),
            metadata={
                "steps": result.steps,
                "final_loss": result.losses[-1],
                "samples_per_sec": result.samples_per_sec,
                "hidden_dim": config.hidden_dim,
                "recall_ceiling": em["recall_ceiling"],
                "num_downloads": len(records),
                "num_heads": 4,
                "num_layers": layers,
            },
        )
        registry.activate(version.model_id, version.version)
        server = ModelServer(registry, name, host_id, MODEL_TYPE_ATTENTION, device="cuda")
        batches = []
        for i in range(SERVE_REQUESTS):
            rows_i = train.take(ds, eval_idx[i * SERVE_ROWS:(i + 1) * SERVE_ROWS])
            batches.append({"child_feats": rows_i["child"], "parent_feats": rows_i["parents"],
                            "pair_feats": rows_i["pair"], "mask": rows_i["mask"]})
        _zero_counts()
        answers, latency_ms = asyncio.run(_serve_rows(server, name, batches))
        serve_counts = _counts()
        if server.version != version.version:
            _fail(f"served version {server.version}, published {version.version}")
        want = {"flash_fwd": SERVE_REQUESTS * layers, "flash_fwd_partial": 0,
                **{k: 0 for k in TRAINING_KERNELS}, **{k: 0 for k in SM90_KERNELS}}
        if serve_counts != want:
            _fail(f"serving the trained version launched {serve_counts}, expected {want}")
        for batch, wire in zip(batches, answers):
            mask = batch["mask"]
            direct = server.score_set(
                batch["child_feats"], batch["parent_feats"], batch["pair_feats"], mask
            ).cpu().numpy()
            if not np.array_equal(wire, direct):
                _fail("trained version: wire scores differ from the in-process score_set")
            if not np.isfinite(wire[mask]).all() or not (wire[~mask] == np.float32(-1e30)).all():
                _fail("trained version: bad scores at valid or invalid slots")
        print(f"served {name} v{version.version} over ModelInfer: {SERVE_REQUESTS} requests of "
              f"{SERVE_ROWS} held-out rows x {MAX_PARENTS} candidates, p50 "
              f"{statistics.median(latency_ms[1:]):.3f} ms (first {latency_ms[0]:.3f} ms), "
              f"flash_fwd launches {serve_counts['flash_fwd']} (= requests x layers); "
              "wire == score_set bit for bit")
    return train_counts, serve_counts, ds, graph, breakdown


def _partial_errors(got, want, atol, rtol, stats=(STATS_ATOL, STATS_RTOL)):
    """Max abs errors of (acc, row_max, row_sum), and whether they hold:
    row_max (on rows with a valid key) and row_sum to ``stats`` (STATS by
    default), acc relative to its row sum (a sum over up to L keys) to
    ``atol``/``rtol``, and rows with no valid key exactly at the filler, 0
    and 0."""
    import torch

    s_atol, s_rtol = stats
    acc, row_max, row_sum = got
    want_acc, want_max, want_sum = want
    live = want_sum > 0
    scale = want_sum.clamp_min(1.0)[..., None]
    errors = {
        "acc": float((acc - want_acc).abs().max().item()),
        "acc_over_row_sum": float(((acc - want_acc) / scale).abs().max().item()),
        "row_max": float((row_max[live] - want_max[live]).abs().max().item()),
        "row_sum": float((row_sum - want_sum).abs().max().item()),
    }
    ok = (
        torch.allclose(row_max[live], want_max[live], atol=s_atol, rtol=s_rtol)
        and torch.allclose(row_sum, want_sum, atol=s_atol, rtol=s_rtol)
        and torch.allclose(acc / scale, want_acc / scale, atol=atol, rtol=rtol)
        and bool(torch.isfinite(row_max).all() and torch.isfinite(acc).all())
        and bool((row_max[~live] == want_max[~live]).all())
        and bool((row_sum[~live] == 0).all() and (acc[~live] == 0).all())
    )
    return errors, ok


@_phase("partial kernel")
def phase_partial_kernel(ds):
    """The partial kernel against its plain version: at the ranker's eval
    shard on the dp x sp mesh (held-out rows / dp, P / sp candidates; see
    phase_mesh_training) and at ring blocks of L = 16384 and L = 8192 with
    sp = 4. library_ms is the memory-efficient attention asked for its
    logsumexp: the same information as (acc, row_max, row_sum) in its
    finished (o, lse) form."""
    import torch

    from dragonfly2_tpu_torch.ops import flash
    from dragonfly2_tpu_torch.training import train

    eval_rows = len(train._train_eval_split(np.arange(len(ds.mask)), 0.2)[0])
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    shapes = [
        # name, (B, H, L, D), fully masked rows, acc tolerance, timing iters
        ("eval-shard", (eval_rows // MESH_DP, 4, MAX_PARENTS // MESH_SP, 32), True,
         (KERNEL_ATOL, KERNEL_RTOL), 200),
        ("ring-block-16k", (2, 4, 4096, 32), False, (LONG_ATOL, LONG_RTOL), 20),
        ("ring-block-wide", (4, 8, 2048, 128), True, (LONG_ATOL, LONG_RTOL), 20),
    ]
    results = {}
    for name, (b, h, l, d), fully, (atol, rtol), iters in shapes:
        q, k, v, mask = _attention_inputs(gen, b, h, l, d, torch.bfloat16, fully)
        got = flash.flash_attention_partials(q, k, v, mask)
        torch.cuda.synchronize()
        errors, ok = _partial_errors(got, flash.flash_attention_partials_plain(q, k, v, mask),
                                     atol, rtol)
        if not ok:
            _fail(f"flash_fwd_partial {name}: errors {errors} outside atol {atol} rtol {rtol} "
                  f"(acc relative to its row sum; row stats atol {STATS_ATOL} rtol "
                  f"{STATS_RTOL}), or a fully masked row not at the filler")
        bound_ms, bound_by = _bound(q, mask, False, matrices=3 + 4 // q.element_size(),
                                    row_stats=2, ops_per_pair=4)
        long = _is_long(q.shape, torch.bfloat16)
        forced = not long and name in HOPPER_FORCED_ROWS
        if forced:
            with _instance(sm90=True):
                got = flash.flash_attention_partials(q, k, v, mask)
                torch.cuda.synchronize()
            other, ok = _partial_errors(got, flash.flash_attention_partials_plain(q, k, v, mask),
                                        atol, rtol)
            if not ok:
                _fail(f"flash_fwd_partial {name}: the Hopper instance forced, errors {other}")

        def partials():
            return flash.flash_attention_partials(q, k, v, mask)

        row = dict(
            shape=[b, h, l, d], causal=False, dtype="bfloat16", errors=errors,
            max_abs_err=max(errors["acc_over_row_sum"], errors["row_max"]),
            ms=_time_ms(partials, iters),
            **_timed(partials, _symbol("fwd", q.shape, torch.bfloat16)),
            mma_sync_kernel_ms=None,
            variant="sm90" if long else "mma.sync",
            plain_ms=_time_ms(lambda: flash.flash_attention_partials_plain(q, k, v, mask),
                              max(3, iters // 4)),
            library_ms=_library_fwd_lse_ms(q, k, v, mask, False, iters),
            bound_ms=bound_ms, bound_by=bound_by,
        )
        _need_time(f"kernel flash_fwd_partial {name}", q.shape, torch.bfloat16, row["kernel_ms"])
        if long:
            with _instance(sm90=False):
                row.update(_timed(partials, "flash_fwd_kernel", "mma_sync_kernel"))
        if forced:
            with _instance(sm90=True):
                row.update(_timed(partials, "flash_fwd_sm90_kernel", "other_kernel"))
            row.update(other_variant="flash_fwd_partial_sm90",
                       other_max_abs_err=max(other["acc_over_row_sum"], other["row_max"]))
        results[name] = row
        lib = "n/a" if row["library_ms"] is None else f"{row['library_ms']:.4f}"
        print(f"kernel flash_fwd_partial {name} {[b, h, l, d]} bfloat16 ({row['variant']}): "
              f"max_abs_err acc "
              f"{errors['acc']:.3g} (over its row sum {errors['acc_over_row_sum']:.3g}), row_max "
              f"{errors['row_max']:.3g}, row_sum {errors['row_sum']:.3g} (acc atol {atol} rtol "
              f"{rtol}, row stats atol {STATS_ATOL} rtol {STATS_RTOL}); fully masked rows at the "
              f"filler; ms {row['ms']:.4f} (kernel "
              f"{_fmt(row)}{_other(row)}) plain_ms {row['plain_ms']:.4f} library_ms {lib} "
              f"(efficient attention with lse) bound_ms {bound_ms:.4f} ({bound_by})")
    return results


@_phase("long ring")
def phase_long_ring():
    """sharded_ring_attention with the partial kernel at L = 16384 on a
    1 x 4 mesh of the one card, against flash_attention on the whole
    sequence and a chunked dense oracle; then the causal zigzag ring.
    Returns the partial kernel's launches in the counted call."""
    import torch

    from dragonfly2_tpu_torch.ops import flash
    from dragonfly2_tpu_torch.parallel.mesh import make_mesh
    from dragonfly2_tpu_torch.parallel.ring import (
        dense_attention,
        sharded_causal_ring_attention,
        sharded_ring_attention,
    )

    card = torch.device("cuda", 0)
    mesh = make_mesh(RING_SP, dp=1, sp=RING_SP, devices=[card] * RING_SP)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    b, h, l, d = RING_SHAPE
    q, k, v, mask = _attention_inputs(gen, b, h, l, d, torch.bfloat16, False)
    _zero_counts()
    torch.cuda.synchronize()
    out = sharded_ring_attention(mesh, q, k, v, mask, use_flash=True)
    torch.cuda.synchronize()
    counts = _counts()
    expected = {name: 0 for name in _COUNTERS}
    expected["flash_fwd_partial"] = RING_SP * RING_SP  # dp * sp^2
    expected["flash_fwd_partial_sm90"] = RING_SP * RING_SP  # blocks of L / sp = 4096
    if counts != expected:
        _fail(f"the ring at L = {l} launched {counts}, expected {expected}")
    whole = flash.flash_attention(q, k, v, mask)
    err = float((out.float() - whole.float()).abs().max().item())
    if not torch.allclose(out.float(), whole.float(), atol=LONG_ATOL, rtol=LONG_RTOL):
        _fail(f"ring vs flash_attention at L = {l}: max_abs_err {err}")
    oracle_err = 0.0
    for start in (0, l // 2, l - ORACLE_ROWS):
        rows = slice(start, start + ORACLE_ROWS)
        want = dense_attention(q[:, :, rows], k, v, mask).float()
        got = out[:, :, rows].float()
        oracle_err = max(oracle_err, float((got - want).abs().max().item()))
        if not torch.allclose(got, want, atol=LONG_ATOL, rtol=LONG_RTOL):
            _fail(f"ring vs dense_attention on query rows {start}+{ORACLE_ROWS}: {oracle_err}")
    ring_ms = _time_ms(lambda: sharded_ring_attention(mesh, q, k, v, mask, use_flash=True), 5)
    flash_ms = _time_ms(lambda: flash.flash_attention(q, k, v, mask), 5)
    split = _device_split(lambda: sharded_ring_attention(mesh, q, k, v, mask, use_flash=True),
                          _symbol("fwd", (b, h, l // RING_SP, d), torch.bfloat16))
    print(f"ring attention {list(RING_SHAPE)} bf16 on a 1 x {RING_SP} mesh of one card: partial "
          f"launches {counts['flash_fwd_partial']} (= dp x sp^2); vs flash_attention on the whole "
          f"sequence max_abs_err {err:.3g}, vs dense on {3 * ORACLE_ROWS} query rows "
          f"{oracle_err:.3g} (atol {LONG_ATOL} rtol {LONG_RTOL}); ring {ring_ms:.4f} ms, "
          f"flash_attention {flash_ms:.4f} ms (CUDA events)")
    _print_split(f"ring at L = {l}", split, "the partial kernel")
    if split[1] and not split[2]:
        _fail("the ring's profile shows no partial kernel")

    lc = CAUSAL_RING_L
    qc, kc, vc = (t[:, :, :lc].contiguous() for t in (q, k, v))
    mc = mask[:, :lc].contiguous()
    causal = sharded_causal_ring_attention(mesh, qc, kc, vc, mc)
    want = flash.flash_attention(qc, kc, vc, mc, causal=True)
    cerr = float((causal.float() - want.float()).abs().max().item())
    if not torch.allclose(causal.float(), want.float(), atol=LONG_ATOL, rtol=LONG_RTOL):
        _fail(f"causal zigzag ring vs causal flash_attention at L = {lc}: {cerr}")
    causal_ms = _time_ms(lambda: sharded_causal_ring_attention(mesh, qc, kc, vc, mc), 5)
    causal_flash_ms = _time_ms(lambda: flash.flash_attention(qc, kc, vc, mc, causal=True), 5)
    print(f"causal zigzag ring [{b}, {h}, {lc}, {d}] (einsum blocks) vs causal flash_attention: "
          f"max_abs_err {cerr:.3g} (atol {LONG_ATOL} rtol {LONG_RTOL}); ring {causal_ms:.4f} ms, "
          f"flash_attention {causal_flash_ms:.4f} ms")
    return counts["flash_fwd_partial_sm90"]


def _device_split(fn, symbol: str, calls: int = 3, kernels_out: list | None = None):
    """Where ``fn``'s time goes, from one torch.profiler window: (wall ms a
    call, host clock and synchronised; device kernel ms a call; the kernel
    named ``symbol``'s share of that, ms; kernels launched a call). The
    window's (kernel name, ms a call) rows go to ``kernels_out`` if given."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3 / calls
    kernels, launched = _kernel_rows(prof, calls)
    if kernels_out is not None:
        kernels_out.extend(kernels)
    return (wall_ms, sum(ms for _, ms in kernels),
            sum(ms for key, ms in kernels if symbol in key), launched)


def _print_split(label, split, named):
    wall_ms, device_ms, named_ms, launched = split
    if device_ms == 0:
        print(f"{label}: device time not measured (the profiler saw no device activity)")
        return
    print(f"{label}: profiled {wall_ms:.3f} ms a call, device kernels {device_ms:.4f} ms "
          f"({launched:.0f} launches), of which {named} {named_ms:.4f} ms "
          f"({100 * named_ms / device_ms:.1f}%); device busy {100 * device_ms / wall_ms:.1f}%")


def _step_p50(trainer, stack, steps: int):
    """p50 of synchronised steps (host clock) over the first batches of a
    stacked epoch, and their losses, read after each step."""
    import torch

    times, losses = [], []
    for s in range(steps):
        start = time.perf_counter()
        losses.append(trainer.step_batch({key: value[s] for key, value in stack.items()}).item())
        torch.cuda.synchronize()
        times.append((time.perf_counter() - start) * 1e3)
    return statistics.median(times[2:]), losses


@_phase("mesh training")
def phase_mesh_training(ds, single_step_p50):
    """Slice 3's main path: train_attention on a dp x sp mesh of the one
    card with ring attention (einsum blocks under autograd, the partial
    kernel in the eval), then the checks, then train_attention with Ulysses.
    Returns the partial launches of the ring's run, the launch counts of
    the Ulysses run, and each strategy's step p50."""
    import torch

    from dragonfly2_tpu_torch.config.config import TrainerConfig
    from dragonfly2_tpu_torch.parallel.mesh import make_mesh, shard_stacked_batches
    from dragonfly2_tpu_torch.training import train

    card = torch.device("cuda", 0)
    n_dev = MESH_DP * MESH_SP
    mesh = make_mesh(n_dev, dp=MESH_DP, sp=MESH_SP, devices=[card] * n_dev)
    config = TrainerConfig(epochs=MESH_EPOCHS)
    layers = config.attention_num_layers
    _zero_counts()
    torch.cuda.synchronize()
    start = time.perf_counter()
    result = train.train_attention(ds, config, mesh=mesh, seed=SEED, sp_strategy="ring")
    torch.cuda.synchronize()
    train_s = time.perf_counter() - start
    counts = _counts()
    expected = {name: 0 for name in _COUNTERS}
    expected["flash_fwd_partial"] = layers * MESH_DP * MESH_SP * MESH_SP
    print(f"mesh training: {result.steps} steps of batch {config.batch_size} on a dp {MESH_DP} x "
          f"sp {MESH_SP} mesh of one card (ring attention) in {train_s:.2f} s; launches {counts} "
          "(expected: the einsum ring under autograd, the partial kernel layers x dp x sp^2 "
          "times in the eval)")
    if counts != expected:
        _fail(f"mesh training launches {counts}, expected {expected}")
    if not np.isfinite(result.losses).all():
        _fail("non-finite loss on the mesh")

    # the split and the first epoch's batches, as train_attention drew them
    rng = np.random.default_rng(SEED)
    eval_idx, train_idx = train._train_eval_split(rng.permutation(len(ds.mask)), 0.2)
    batch_size = min(config.batch_size, len(train_idx))
    first = train.epoch_batches(ds, train_idx, batch_size, rng)
    if first["mask"].shape[0] != result.steps // MESH_EPOCHS:
        _fail(f"{result.steps} steps, {first['mask'].shape[0]} batches an epoch")
    in_features = sum(first[key].shape[-1] for key in ("parents", "child", "pair"))

    # the first steps again on a CPU mesh (plain versions) from the same weights
    cpu_mesh = make_mesh(n_dev, dp=MESH_DP, sp=MESH_SP, devices=["cpu"] * n_dev)
    cpu = train.AttentionTrainer(
        train.build_ranker(config, in_features, SEED, None, "cpu"), None, config.learning_rate,
        "cpu", attention_fn=train.attention_fns(cpu_mesh, "ring")[0],
    )
    stack_cpu = shard_stacked_batches(cpu_mesh, {k: v[:REPLAY_STEPS] for k, v in first.items()})
    replay = [cpu.step_batch({k: v[s] for k, v in stack_cpu.items()}).item()
              for s in range(REPLAY_STEPS)]
    replay_err = float(np.abs(np.array(replay) - np.array(result.losses[:REPLAY_STEPS])).max())
    print(f"cpu mesh replay of the first {REPLAY_STEPS} steps: max loss difference "
          f"{replay_err:.3g} (atol {REPLAY_LOSS_ATOL})")
    if replay_err > REPLAY_LOSS_ATOL:
        _fail(f"cpu mesh replay loss differs by {replay_err}")

    # the mesh's eval scores (the partial kernel) against one device's
    # (flash_attention), from the trained weights
    model = train.build_ranker(config, in_features, SEED, result.params, "cuda")
    model.eval()
    eb = train.take(ds, eval_idx)
    mesh_scores = train.eval_scores(model, eb, train.attention_fns(mesh, "ring")[1], mesh)
    one_scores = train.eval_scores(model, eb)
    valid = torch.from_numpy(eb["mask"]).cuda()
    err = float((mesh_scores[valid] - one_scores[valid]).abs().max().item())
    if not torch.allclose(mesh_scores[valid], one_scores[valid], atol=MODEL_ATOL, rtol=MODEL_RTOL):
        _fail(f"mesh eval scores vs one device: max_abs_err {err}")
    em = result.eval_metrics
    print(f"mesh eval on {len(eval_idx)} held-out rows: scores vs one device (flash_attention) "
          f"max_abs_err {err:.3g} (atol {MODEL_ATOL} rtol {MODEL_RTOL}); precision "
          f"{em['precision']:.4f}, recall {em['recall']:.4f} of {em['recall_ceiling']:.4f}, "
          f"regret {em['regret']:.4f}; loss first {result.losses[0]:.4f} last "
          f"{result.losses[-1]:.4f}; {result.samples_per_sec:.1f} samples/s")

    # the same entry point with Ulysses from the same seed (the same weights
    # and batches): flash_attention on each shard's head group, so each step
    # launches every training kernel layers x dp x sp times and the eval the
    # finished forward layers x dp x sp times
    _zero_counts()
    torch.cuda.synchronize()
    start = time.perf_counter()
    uly = train.train_attention(ds, config, mesh=mesh, seed=SEED, sp_strategy="ulysses")
    torch.cuda.synchronize()
    uly_s = time.perf_counter() - start
    uly_counts = _counts()
    shards = layers * MESH_DP * MESH_SP
    expected = {name: uly.steps * shards for name in TRAINING_KERNELS}
    expected.update(flash_fwd=shards, flash_fwd_partial=0, **{k: 0 for k in SM90_KERNELS})
    print(f"mesh training with Ulysses: {uly.steps} steps in {uly_s:.2f} s; launches "
          f"{uly_counts} (expected: each training kernel steps x layers x dp x sp times, the "
          "finished forward layers x dp x sp times in the eval)")
    if uly_counts != expected:
        _fail(f"Ulysses mesh training launches {uly_counts}, expected {expected}")
    if uly.steps != result.steps or not np.isfinite(uly.losses).all():
        _fail(f"Ulysses: {uly.steps} steps (ring {result.steps}), finite losses "
              f"{bool(np.isfinite(uly.losses).all())}")
    uly_err = float(np.abs(np.array(uly.losses[:REPLAY_STEPS])
                           - np.array(result.losses[:REPLAY_STEPS])).max())
    if uly_err > REPLAY_LOSS_ATOL:
        _fail(f"Ulysses' first {REPLAY_STEPS} losses differ from the ring's by {uly_err}")
    em = uly.eval_metrics
    print(f"Ulysses vs ring over the first {REPLAY_STEPS} steps: max loss difference "
          f"{uly_err:.3g} (atol {REPLAY_LOSS_ATOL}); precision {em['precision']:.4f}, recall "
          f"{em['recall']:.4f}; loss last {uly.losses[-1]:.4f}; {uly.samples_per_sec:.1f} samples/s")

    # each strategy's step time from the same initial weights over the same batches
    stack = shard_stacked_batches(mesh, {k: v[:MESH_STEPS] for k, v in first.items()})
    p50 = {}
    for strategy in ("ring", "ulysses"):
        trainer = train.AttentionTrainer(
            train.build_ranker(config, in_features, SEED, None, "cuda"), None,
            config.learning_rate, "cuda", attention_fn=train.attention_fns(mesh, strategy)[0],
        )
        p50[strategy], losses = _step_p50(trainer, stack, MESH_STEPS)
        batch = {key: value[0] for key, value in stack.items()}
        _print_split(f"{strategy} mesh step",
                     _device_split(lambda: trainer.step_batch(batch), "flash_"), "the flash kernels")
        if not np.isfinite(losses).all():
            _fail(f"{strategy}: non-finite loss in the timed steps")
    print(f"step p50 (synchronised, host clock, batch {config.batch_size}): ring "
          f"{p50['ring']:.3f} ms, ulysses {p50['ulysses']:.3f} ms on the dp {MESH_DP} x sp "
          f"{MESH_SP} mesh; one device {single_step_p50:.3f} ms (phase 5)")
    return counts["flash_fwd_partial"], uly_counts, p50


def phase_threshold():
    """Both instances of the forward, of dK/dV and of dQ at L = 16 .. 512
    (device time, each forced through the wrappers): where the Hopper
    instances overtake the mma.sync ones, the readings SM90_MIN_L is set
    from; then both wide instances of the forward, of dK/dV and of dQ at
    D = 192 and 256, L = 16 .. 2048, the readings the WIDE_*SM90_MIN_L
    thresholds are set from. Run with --threshold, not in the smoke
    run."""
    import torch

    from dragonfly2_tpu_torch.ops import flash

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    for d, (b, h) in THRESHOLD_SHAPES.items():
        for l in THRESHOLD_LENGTHS:
            q, k, v, mask = _attention_inputs(gen, b, h, l, d, torch.bfloat16, False)
            do = torch.randn(b, h, l, d, generator=gen, device="cuda").to(torch.bfloat16)
            picks = "sm90" if _is_long(q.shape, torch.bfloat16) else "mma.sync"
            o, lse = flash.flash_attention_lse(q, k, v, mask)
            delta = (do.float() * o.float()).sum(-1)
            row = {}
            for sm90, instance in ((True, "sm90"), (False, "mma_sync")):
                symbol = (_SM90_SYMBOLS if sm90 else
                          {kernel: _mma_sync_symbol(kernel, l) for kernel in _SM90_SYMBOLS})
                with _instance(sm90):
                    row.update(_timed(lambda: flash.flash_attention(q, k, v, mask),
                                      symbol["fwd"], f"fwd_{instance}"))
                    row.update(_timed(
                        lambda: flash.flash_attention_bwd_dkv(q, k, v, mask, lse, delta, do),
                        symbol["dkv"], f"dkv_{instance}"))
                    row.update(_timed(
                        lambda: flash.flash_attention_bwd_dq(q, k, v, mask, lse, delta, do),
                        symbol["dq"], f"dq_{instance}"))
            print(f"threshold [{b}, {h}, {l}, {d}] bf16 device ms: forward sm90 "
                  f"{_fmt(row, 'fwd_sm90')} vs mma.sync {_fmt(row, 'fwd_mma_sync')}; dK/dV sm90 "
                  f"{_fmt(row, 'dkv_sm90')} vs mma.sync {_fmt(row, 'dkv_mma_sync')}; dQ sm90 "
                  f"{_fmt(row, 'dq_sm90')} vs mma.sync {_fmt(row, 'dq_mma_sync')} (ops/flash.py "
                  f"picks {picks})")
    for d in WIDE_THRESHOLD_DIMS:
        for l in WIDE_THRESHOLD_LENGTHS:
            b, h = max(2, WIDE_THRESHOLD_TOKENS // l), 4
            q, k, v, mask = _attention_inputs(gen, b, h, l, d, torch.bfloat16, False)
            do = torch.randn(b, h, l, d, generator=gen, device="cuda").to(torch.bfloat16)
            o, lse = flash.flash_attention_lse(q, k, v, mask)
            delta = (do.float() * o.float()).sum(-1)
            row = {}
            for sm90, instance in ((True, "sm90"), (False, "mma_sync")):
                with _instance(sm90):
                    row.update(_timed(lambda: flash.flash_attention_lse(q, k, v, mask),
                                      _WIDE_SYMBOLS["flash_fwd_lse_wide" + ("_sm90" if sm90
                                                                            else "")],
                                      f"fwd_{instance}"))
                    row.update(_timed(
                        lambda: flash.flash_attention_bwd_dq(q, k, v, mask, lse, delta, do),
                        _WIDE_SYMBOLS["flash_bwd_dq_wide" + ("_sm90" if sm90 else "")],
                        f"dq_{instance}"))
            # dK/dV's two instances in turns (Hopper, mma.sync, mma.sync, Hopper):
            # the WIDE_DKV_SM90_MIN_L readings
            for turn, sm90 in enumerate((True, False, False, True)):
                instance = ("sm90" if sm90 else "mma_sync") + ("_2" if turn > 1 else "")
                with _instance(sm90):
                    row.update(_timed(
                        lambda: flash.flash_attention_bwd_dkv(q, k, v, mask, lse, delta, do),
                        _WIDE_SYMBOLS["flash_bwd_dkv_wide" + ("_sm90" if sm90 else "")],
                        f"dkv_{instance}"))
            picks = ", ".join(_wide_instance(fn, l, d, torch.bfloat16).removeprefix("flash_")
                              for fn in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"))
            print(f"threshold wide [{b}, {h}, {l}, {d}] bf16 device ms: forward with lse sm90 "
                  f"{_fmt(row, 'fwd_sm90')} vs mma.sync {_fmt(row, 'fwd_mma_sync')}; dK/dV in turns "
                  f"sm90 {_fmt(row, 'dkv_sm90')}, mma.sync {_fmt(row, 'dkv_mma_sync')}, mma.sync "
                  f"{_fmt(row, 'dkv_mma_sync_2')}, sm90 {_fmt(row, 'dkv_sm90_2')}; dQ sm90 "
                  f"{_fmt(row, 'dq_sm90')} vs mma.sync {_fmt(row, 'dq_mma_sync')} (ops/flash.py "
                  f"picks {picks})")


@_phase("long ulysses")
def phase_long_ulysses():
    """Slices 4 and 5's main path: Ulysses over [2, 16, 4096, 32] on a
    1 x 4 mesh of the card, whose shards attend [2, 4, 4096, 32] each, the
    Hopper instances' shapes: the finished forward without grad (serving a
    long sequence), then one forward and backward with it (a training
    step's attention: the forward with lse, dK/dV and dQ, all Hopper
    instances). Counters are zeroed just before and read just after; each
    Hopper instance must launch sp times. Checked against the plain
    versions over the whole sequence at the long tolerances. Returns the
    counts."""
    import torch

    from dragonfly2_tpu_torch.ops import flash
    from dragonfly2_tpu_torch.parallel.mesh import make_mesh
    from dragonfly2_tpu_torch.parallel.ulysses import sharded_ulysses_attention

    card = torch.device("cuda", 0)
    mesh = make_mesh(ULYSSES_SP, dp=1, sp=ULYSSES_SP, devices=[card] * ULYSSES_SP)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    b, h, l, d = ULYSSES_SHAPE
    q, k, v, mask = _attention_inputs(gen, b, h, l, d, torch.bfloat16, True)
    do = torch.randn(b, h, l, d, generator=gen, device="cuda").to(torch.bfloat16)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]

    def step():
        out = sharded_ulysses_attention(mesh, *leaves, mask)
        return out, torch.autograd.grad(out, leaves, do)

    _zero_counts()
    torch.cuda.synchronize()
    with torch.no_grad():
        served = sharded_ulysses_attention(mesh, q, k, v, mask)
    trained, grads = step()
    torch.cuda.synchronize()
    counts = _counts()
    expected = {name: ULYSSES_SP for name in _COUNTERS}
    expected.update(flash_fwd_partial=0, flash_fwd_partial_sm90=0)
    print(f"long-context Ulysses {list(ULYSSES_SHAPE)} bf16 on a 1 x {ULYSSES_SP} mesh of one "
          f"card: launches {counts} (expected sp = {ULYSSES_SP} of each Hopper instance, of the "
          "finished forward, the forward with lse, dK/dV and dQ; no partial)")
    if counts != expected:
        _fail(f"long-context Ulysses launched {counts}, expected {expected}")

    # the plain versions over the whole sequence: the output and lse, then
    # the gradients from them
    whole, whole_lse = flash.flash_attention_lse_plain(q, k, v, mask)
    want = flash.flash_attention_bwd_plain(q, k, v, mask, whole, whole_lse, do)
    del whole_lse
    errs = {"served": float((served.float() - whole.float()).abs().max().item()),
            "trained": float((trained.float() - whole.float()).abs().max().item())}
    for name, got in (("served", served), ("trained", trained)):
        if not torch.allclose(got.float(), whole.float(), atol=LONG_ATOL, rtol=LONG_RTOL):
            _fail(f"long Ulysses {name} output vs the plain version: {errs[name]}")
    dead = ~mask.any(dim=1)
    for name, got, ref in zip(("dq", "dk", "dv"), grads, want):
        errs[name] = float((got.float() - ref.float()).abs().max().item())
        if not torch.allclose(got.float(), ref.float(), atol=LONG_GRAD_ATOL, rtol=LONG_GRAD_RTOL):
            _fail(f"long Ulysses {name} vs the plain version's: {errs[name]}")
        if got[dead].abs().max().item() != 0.0:
            _fail(f"long Ulysses {name}: fully masked batch rows are not 0")
    if served[dead].abs().max().item() != 0.0:
        _fail("long Ulysses: fully masked batch rows are not 0")
    del want, whole
    with torch.no_grad():
        serve_ms = _time_ms(lambda: sharded_ulysses_attention(mesh, q, k, v, mask), 5)
    step_ms = _time_ms(step, 5)
    print(f"long-context Ulysses vs the plain versions over the whole sequence: max_abs_err "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
          + f" (outputs atol {LONG_ATOL} rtol {LONG_RTOL}, gradients atol {LONG_GRAD_ATOL} rtol "
          f"{LONG_GRAD_RTOL}); forward {serve_ms:.4f} ms, forward + backward {step_ms:.4f} ms "
          "(CUDA events)")
    _print_split("long Ulysses forward + backward", _device_split(step, "flash_"),
                 "the flash kernels")
    return counts



# slices 7-9 (C3): the wide instances, head dims above 128, each taken as
# it is (no pad copy; 130 -> 136 is the only padding left above 128).
# Checked at D = 160, 192 and 256 (the wide Hopper instances of the forward,
# dK/dV and dQ at long L, bf16) and 320 and 512 (above 256: the wide
# mma.sync instances, the forward's one-pass kernel and the backward's
# 256-column chunks), short and long L, causal and
# not, in bf16 and, at D = 320 and 512, float32; and at the wide ranker's
# own training batch with its key mask. The main paths: the ranker at hidden
# 768 with its 4 heads (D = 192) trained for an epoch (the mma.sync wide
# forward with lse, dK/dV and dQ) and evaluated (the finished forward); the
# ring over its eval batch on a 1 x 2 mesh (10 keys a shard: the mma.sync
# wide partials); the ring at WIDE_RING_SHAPE on a 1 x 4 mesh (the wide
# Hopper partials); and Ulysses over WIDE_ULYSSES_SHAPE on a 1 x 4 mesh (the
# wide Hopper forward, forward with lse, dK/dV and dQ). The kernels line's
# rows are timed at the shapes those runs give each kernel.
WIDE_CHECK_DIMS, WIDE_CHECK_LENGTHS = (160, 192, 256, 320, 512), (40, 2048)
WIDE_FLOAT32_DIMS = (192, 320, 512)  # float32 at L = 40
# slices 11-12's kernels at their edges, on B x H = 3 x 5 sets: the packed
# short-set forward (D up to 256, L up to 32; float32 too at L = 10) and the
# one-pass dQ and dK/dV (D in (128, 512]; at D up to 256 the wide Hopper
# instances forced off, so every L reaches them); and one D above 512 for
# the chunked backward kernels that remain there
WIDE_EDGE_SETS = (3, 5)
WIDE_SETS_DIMS, WIDE_SETS_LENGTHS = (136, 192, 256), (1, 7, 10, 16, 20, 31, 32)
WIDE_ONEPASS_DIMS = (136, 192, 256, 264, 320, 384, 512)
WIDE_ONEPASS_LENGTHS = (1, 20, 32, 33, 1024)
WIDE_CHUNKED_DIM = 640
WIDE_C3_DIM = 320  # each wide mma.sync instance also timed at this D
WIDE_HIDDEN = 768
WIDE_HEAD_DIM = WIDE_HIDDEN // 4
# the ranker above 256: hidden 1280, head dim 320 (C3's main path)
WIDE_C3_HIDDEN = 4 * WIDE_C3_DIM
WIDE_RING_SHAPE, WIDE_RING_SP = (2, 4, 4096, WIDE_HEAD_DIM), 4
WIDE_EVAL_RING_SP = 2
WIDE_ULYSSES_SHAPE, WIDE_ULYSSES_SP = (2, 16, 4096, WIDE_HEAD_DIM), 4
WIDE_REPLAY_STEPS = 2  # a step at hidden 768 takes seconds on the CPU
# each wide instance -> its ops/flash.py counter: the mma.sync instances
# ("_wide"), then the Hopper ones ("_wide_sm90")
_WIDE_COUNTERS = {
    "flash_fwd_wide": "FWD_WIDE_LAUNCHES",
    "flash_fwd_lse_wide": "LSE_WIDE_LAUNCHES",
    "flash_fwd_partial_wide": "PARTIAL_WIDE_LAUNCHES",
    "flash_bwd_dkv_wide": "DKV_WIDE_LAUNCHES",
    "flash_bwd_dq_wide": "DQ_WIDE_LAUNCHES",
    "flash_fwd_wide_sm90": "FWD_WIDE_SM90_LAUNCHES",
    "flash_fwd_lse_wide_sm90": "LSE_WIDE_SM90_LAUNCHES",
    "flash_fwd_partial_wide_sm90": "PARTIAL_WIDE_SM90_LAUNCHES",
    "flash_bwd_dkv_wide_sm90": "DKV_WIDE_SM90_LAUNCHES",
    "flash_bwd_dq_wide_sm90": "DQ_WIDE_SM90_LAUNCHES",
}
# profiler names (regular expressions) of the wide instances' kernels;
# "flash_fwd_wide" names the three kernels of the wide mma.sync forward (the
# packed-sets one its C side picks for D up to 256 at L up to 32, the
# one-pass one for D in (256, 512], the chunked one otherwise), and the
# dK/dV and dQ patterns their two kernels each (one pass for D in (128,
# 512], chunked otherwise) but not the wide Hopper ones'
# flash_bwd_{dkv,dq}_wide_sm90_kernel: a row prints the name the profiler
# found
_WIDE_SYMBOLS = {
    "flash_fwd_wide": "flash_fwd_wide", "flash_fwd_lse_wide": "flash_fwd_wide",
    "flash_fwd_partial_wide": "flash_fwd_wide",
    "flash_bwd_dkv_wide": r"flash_bwd_dkv_(?:wide|onepass)_kernel",
    "flash_bwd_dq_wide": r"flash_bwd_dq_(?:wide|onepass)_kernel",
    "flash_fwd_wide_sm90": "flash_fwd_sm90_kernel",
    "flash_fwd_lse_wide_sm90": "flash_fwd_sm90_kernel",
    "flash_fwd_partial_wide_sm90": "flash_fwd_sm90_kernel",
    "flash_bwd_dkv_wide_sm90": "flash_bwd_dkv_wide_sm90_kernel",
    "flash_bwd_dq_wide_sm90": "flash_bwd_dq_wide_sm90_kernel",
}


def _wide_counts() -> dict:
    from dragonfly2_tpu_torch.ops import flash

    return {name: getattr(flash, counter) for name, counter in _WIDE_COUNTERS.items()}


def _zero_wide_counts() -> None:
    from dragonfly2_tpu_torch.ops import flash

    for counter in _WIDE_COUNTERS.values():
        setattr(flash, counter, 0)


def _wide_instance(function: str, l: int, d: int, dtype) -> str:
    """The wide instance ops/flash.py picks for ``function`` ("flash_fwd",
    "flash_fwd_lse", "flash_fwd_partial", "flash_bwd_dkv", "flash_bwd_dq")
    at a wide (L, D, dtype)."""
    from dragonfly2_tpu_torch.ops import flash

    kernel = {"flash_bwd_dkv": "dkv", "flash_bwd_dq": "dq"}.get(function, "fwd")
    return function + ("_wide_sm90" if flash._sm90_path(l, d, dtype, kernel) else "_wide")


def _wide_config(hidden: int = WIDE_HIDDEN):
    from dragonfly2_tpu_torch.config.config import TrainerConfig

    return TrainerConfig(epochs=1, hidden_dim=hidden)


def _ranker_masks(ds):
    """The wide ranker's key masks on the card: its first training batch's
    and its eval rows', as train_attention draws them."""
    import torch

    eval_idx, train_idx, first_epoch = _first_epoch(ds, _wide_config())
    return (torch.from_numpy(ds.mask[train_idx][first_epoch[0]]).cuda(),
            torch.from_numpy(ds.mask[eval_idx]).cuda())


def _check_wide_case(gen, b, l, d, causal, dtype, given, worst, h=4):
    """Every entry at one wide shape [b, h, l, d] against the plain version
    of what it computes, each launch counted on the instance ops/flash.py
    picks; the errors folded into ``worst``, keyed by (instance, D,
    dtype)."""
    import torch

    from dragonfly2_tpu_torch.ops import flash

    q, k, v, mask = _attention_inputs(gen, b, h, l, d, dtype, given is None)
    if given is not None:
        mask = given
    do = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
    long = l > 1000
    atol, rtol = (LONG_ATOL, LONG_RTOL) if long else (KERNEL_ATOL, KERNEL_RTOL)
    g_atol, g_rtol = (LONG_GRAD_ATOL, LONG_GRAD_RTOL) if long else (GRAD_ATOL, GRAD_RTOL)
    # row statistics of bf16 operands are exact float32 sums; a float32
    # input is rounded to bf16 in shared memory, as phase 3's float32 rows
    s_atol, s_rtol = (STATS_ATOL, STATS_RTOL) if dtype == torch.bfloat16 else (atol, rtol)
    label = (f"B = {b}, H = {h}, D = {d}, L = {l}, causal={causal}, "
             f"{str(dtype).removeprefix('torch.')}")
    if given is not None:
        label += " (the wide ranker's first batch and its mask)"
    functions = ["flash_fwd", "flash_fwd_lse", "flash_bwd_dkv", "flash_bwd_dq"]
    if not causal:
        functions.append("flash_fwd_partial")
    picked = {fn: _wide_instance(fn, l, d, dtype) for fn in functions}
    before = _wide_counts()
    out = flash.flash_attention(q, k, v, mask, causal)
    o, lse = flash.flash_attention_lse(q, k, v, mask, causal)
    got_dq, got_dk, got_dv = flash.flash_attention_bwd(q, k, v, mask, o, lse, do, causal)
    partials = None if causal else flash.flash_attention_partials(q, k, v, mask)
    torch.cuda.synchronize()
    want = dict(before)
    for name in picked.values():
        want[name] += 1
    if _wide_counts() != want:
        _fail(f"wide {label}: launches {_wide_counts()}, expected {want}")
    ref_o, ref_lse = flash.flash_attention_lse_plain(q, k, v, mask, causal)
    seen = ref_lse > -1e20
    errs = {
        picked["flash_fwd"]: float((out.float() - ref_o.float()).abs().max().item()),
        picked["flash_fwd_lse"]: max(
            float((o.float() - ref_o.float()).abs().max().item()),
            float((lse[seen] - ref_lse[seen]).abs().max().item())),
    }
    if not (torch.allclose(out.float(), ref_o.float(), atol=atol, rtol=rtol)
            and torch.equal(o, out) and torch.isfinite(lse).all()
            and torch.allclose(lse[seen], ref_lse[seen], atol=s_atol, rtol=s_rtol)):
        _fail(f"wide forward {label}: errors {errs} (atol {atol} rtol {rtol}, lse atol {s_atol})")
    dead = ~mask.any(dim=1)
    if dead.any() and out[dead].abs().max().item() != 0.0:
        _fail(f"wide forward {label}: fully masked rows are not 0")
    if partials is not None:
        perr, ok = _partial_errors(partials, flash.flash_attention_partials_plain(q, k, v, mask),
                                   atol, rtol, (s_atol, s_rtol))
        errs[picked["flash_fwd_partial"]] = max(perr["acc_over_row_sum"], perr["row_max"],
                                                perr["row_sum"])
        if not ok:
            _fail(f"wide partials {label}: errors {perr}")
    want_dq, want_dk, want_dv = flash.flash_attention_bwd_plain(q, k, v, mask, o, lse, do, causal)
    for name, g, w in (("dq", got_dq, want_dq), ("dk", got_dk, want_dk), ("dv", got_dv, want_dv)):
        err = float((g.float() - w.float()).abs().max().item())
        kernel = picked["flash_bwd_dq" if name == "dq" else "flash_bwd_dkv"]
        errs[kernel] = max(errs.get(kernel, 0.0), err)
        if not torch.allclose(g.float(), w.float(), atol=g_atol, rtol=g_rtol):
            _fail(f"wide backward {label} {name}: max_abs_err {err} (atol {g_atol} rtol {g_rtol})")
        if dead.any() and g[dead].abs().max().item() != 0.0:
            _fail(f"wide backward {label} {name}: fully masked rows are not 0")
    for name, err in errs.items():
        worst[name, d, dtype] = max(worst[name, d, dtype], err)
    print(f"wide {label}: max_abs_err " + ", ".join(
        f"{name} {err:.3g}" for name, err in errs.items())
        + f" (outputs atol {atol} rtol {rtol}, gradients atol {g_atol} rtol {g_rtol})")


@_phase("wide kernels")
def phase_wide_kernels(ds):
    """Every wide instance against the plain version at the call's own D:
    at each checked D, L and causal flag with a mask holding fully masked
    batch rows, float32 above 256, and at the wide ranker's first training
    batch with its own key mask at D = 192 (on the instances ops/flash.py
    picks there, and on the wide Hopper ones forced) and at D =
    WIDE_C3_DIM, and slices 11-12's kernels at their edge shapes; then
    each instance's row at the shape its main path gives it (wrapper ms,
    device ms beside the other instance's, the plain version's ms, a
    library call's where there is one, and the bound), and each wide
    mma.sync instance's at D = WIDE_C3_DIM. Before any timing, a row holds
    its instance's outputs at that shape, and the other instance's forced
    through the same call, to the plain version with the row's own
    tolerances, and prints both errors; at the wide eval shape the two
    forward instances are also timed in turns. A row's max_abs_err is its
    instance's worst at its own D and dtype, over every kernel its C side
    picks at that D (the forward's packed-sets kernel at L up to 32, the
    chunked one above), and row_max_abs_err its error at the row's shape.
    Returns {kernel: {shape key: row}}."""
    import torch
    import torch.nn.functional as F

    from dragonfly2_tpu_torch.ops import flash

    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    train_mask, eval_mask = _ranker_masks(ds)
    worst = collections.defaultdict(float)  # (instance, D, dtype) -> max abs error
    for d in WIDE_CHECK_DIMS:
        for l in WIDE_CHECK_LENGTHS:
            for causal in (False, True):
                _check_wide_case(gen, 2, l, d, causal, torch.bfloat16, None, worst)
    for d in WIDE_FLOAT32_DIMS:
        _check_wide_case(gen, 2, 40, d, False, torch.float32, None, worst)
    ranker = (train_mask.shape[0], train_mask.shape[1], WIDE_HEAD_DIM, False, torch.bfloat16)
    _check_wide_case(gen, *ranker, train_mask, worst)
    with _instance(sm90=True):  # the wide Hopper instances at the ranker's own batch
        _check_wide_case(gen, *ranker, train_mask, worst)
    # the same batch at the hidden-WIDE_C3_HIDDEN ranker's head dim (the
    # forward's one-pass kernel, the wide mma.sync backward)
    _check_wide_case(gen, train_mask.shape[0], train_mask.shape[1], WIDE_C3_DIM, False,
                     torch.bfloat16, train_mask, worst)
    # the packed short-set forward at its edges: B H = 15 sets, so sets
    # straddle its 32-row blocks at every L but 1, 16 and 32, batch row 0
    # fully masked
    b, h = WIDE_EDGE_SETS
    for d in WIDE_SETS_DIMS:
        for l in WIDE_SETS_LENGTHS:
            for causal in (False, True):
                _check_wide_case(gen, b, l, d, causal, torch.bfloat16, None, worst, h)
        _check_wide_case(gen, b, 10, d, False, torch.float32, None, worst, h)
    # the one-pass dQ and dK/dV at one, a ragged, a whole and many swept
    # tiles (one stage up to L = 32, two from 33), on the mma.sync
    # instances at every L; then the chunked backward above 512
    with _instance(sm90=False):
        for d in WIDE_ONEPASS_DIMS:
            for l in WIDE_ONEPASS_LENGTHS:
                for causal in (False, True):
                    _check_wide_case(gen, b, l, d, causal, torch.bfloat16, None, worst, h)
    _check_wide_case(gen, b, 40, WIDE_CHUNKED_DIM, False, torch.bfloat16, None, worst, h)

    iters = 10
    results = {name: {} for name in _WIDE_COUNTERS}

    def row(function, key, q, call, plain_ms, library_ms, bound, check):
        """Hold ``call`` (one launch of the instance ops/flash.py picks for
        ``function`` at q's shape) to the plain version by ``check`` (the
        call's outputs -> (max abs error, whether within the row's own
        tolerances)), and the other wide instance forced through the same
        call too, before any timing; then time both and keep the row."""
        b, h, l, d = q.shape
        name = _wide_instance(function, l, d, q.dtype)
        if (name, d, q.dtype) not in worst:
            _fail(f"kernel {name} was not checked at D = {d} in {q.dtype}")
        err, ok = check(call())
        if not ok:
            _fail(f"kernel {name} {list(q.shape)} ({key}) vs the plain version: max_abs_err {err}")
        worst[name, d, q.dtype] = max(worst[name, d, q.dtype], err)
        other_name = None
        if d <= flash.WIDE_SM90_MAX_DIM:
            hopper = not name.endswith("_sm90")
            other_name = function + ("_wide_sm90" if hopper else "_wide")
            with _instance(sm90=hopper):
                other_err, ok = check(call())
            if not ok:
                _fail(f"kernel {other_name} forced at {list(q.shape)} ({key}) vs the plain "
                      f"version: max_abs_err {other_err}")
        bound_ms, bound_by = bound
        r = dict(shape=list(q.shape), causal=False, dtype="bfloat16",
                 variant="wide sm90" if name.endswith("_sm90") else "wide mma.sync",
                 max_abs_err=worst[name, d, q.dtype], row_max_abs_err=err,
                 ms=_time_ms(call, iters), **_timed(call, _WIDE_SYMBOLS[name]),
                 mma_sync_kernel_ms=None, plain_ms=plain_ms, library_ms=library_ms,
                 bound_ms=bound_ms, bound_by=bound_by)
        if r["kernel_ms"] is None:
            _fail(f"kernel {name} {list(q.shape)}: the profiler found no device time")
        other = ""
        if other_name is not None:
            with _instance(sm90=hopper):
                r.update(_timed(call, _WIDE_SYMBOLS[other_name], "other_kernel"))
            r.update(other_variant=other_name, other_max_abs_err=other_err)
            other = (f"; {other_name} forced {', '.join(r['other_kernel_names'])} "
                     f"{_fmt(r, 'other_kernel')}, max_abs_err {other_err:.3g} here")
        results[name][key] = r
        lib = "n/a" if library_ms is None else f"{library_ms:.4f}"
        print(f"kernel {name} {list(q.shape)} bf16 ({key}): max_abs_err {err:.3g} here, "
              f"{worst[name, d, q.dtype]:.3g} over the checked bf16 shapes at D = {d}; ms "
              f"{r['ms']:.4f} (kernel "
              f"{', '.join(r['kernel_names'])} {_fmt(r)}{other}) plain_ms "
              f"{plain_ms:.4f} library_ms {lib} bound_ms {bound_ms:.4f} ({bound_by})")

    def inputs(b, l, d, mask=None, h=4):
        q, k, v, m = _attention_inputs(gen, b, h, l, d, torch.bfloat16, False)
        return q, k, v, (m if mask is None else mask)

    def tolerance(q):
        return (LONG_ATOL, LONG_RTOL) if q.shape[2] > 1000 else (KERNEL_ATOL, KERNEL_RTOL)

    def grad_tolerance(q):
        return (LONG_GRAD_ATOL, LONG_GRAD_RTOL) if q.shape[2] > 1000 else (GRAD_ATOL, GRAD_RTOL)

    def held(pairs, tol, stats=None):
        """(max abs error, ok) of (got, want) pairs to ``tol``; ``stats``
        (lse against the plain lse on the rows with a valid key) to STATS."""
        err, ok = 0.0, True
        for got, want in pairs:
            err = max(err, float((got.float() - want.float()).abs().max().item()))
            ok = ok and bool(torch.allclose(got.float(), want.float(), atol=tol[0], rtol=tol[1]))
        if stats is not None:
            lse, want_lse = stats
            seen = want_lse > -1e20
            err = max(err, float((lse[seen] - want_lse[seen]).abs().max().item()))
            ok = ok and bool(torch.isfinite(lse).all()) and bool(
                torch.allclose(lse[seen], want_lse[seen], atol=STATS_ATOL, rtol=STATS_RTOL))
        return err, ok

    def forward_turns(key, q, k, v, mask):
        """Both wide instances of the finished forward at this shape, forced
        in turns (Hopper, mma.sync, mma.sync, Hopper), each already held to
        the plain version by its row: every turn's CUDA-event ms of the
        call and the profiler's device ms of its kernel."""
        call = lambda: flash.flash_attention(q, k, v, mask)  # noqa: E731
        turns = []
        for hopper in (True, False, False, True):
            name = "flash_fwd_wide" + ("_sm90" if hopper else "")
            with _instance(sm90=hopper):
                ms = _time_ms(call, iters)
                device, recorded, names = _kernel_ms(call, _WIDE_SYMBOLS[name])
            device = "not measured" if device is None else f"{device:.4f}"
            turns.append(f"{name} ({', '.join(names)}) {ms:.4f} ms, device {device}, "
                         f"{recorded}/{KERNEL_CALLS} recorded")
        print(f"wide forward {key} {list(q.shape)} bf16, both instances forced in turns: "
              + "; ".join(turns))

    def forward_row(key, q, k, v, mask):
        """The finished forward's row at this shape."""
        want = flash.flash_attention_plain(q, k, v, mask)
        sdpa_mask = mask[:, None, None, :]
        row("flash_fwd", key, q, lambda: flash.flash_attention(q, k, v, mask),
            _time_ms(lambda: flash.flash_attention_plain(q, k, v, mask), 3),
            _time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=sdpa_mask), iters),
            _bound(q, mask, False), lambda out: held([(out, want)], tolerance(q)))

    def training_rows(key, q, k, v, mask, dkv=True, dq=True):
        """The forward with lse, then the backward kernels as the backward
        launches them, from its o and lse."""
        want_o, want_lse = flash.flash_attention_lse_plain(q, k, v, mask)
        row("flash_fwd_lse", key, q, lambda: flash.flash_attention_lse(q, k, v, mask),
            _time_ms(lambda: flash.flash_attention_lse_plain(q, k, v, mask), 3),
            _library_fwd_lse_ms(q, k, v, mask, False, iters), _bound(q, mask, False, row_stats=1),
            lambda got: held([(got[0], want_o)], tolerance(q), (got[1], want_lse)))
        del want_o, want_lse
        do = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
        o, lse = flash.flash_attention_lse(q, k, v, mask)
        delta = (do.float() * o.float()).sum(-1)
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        sdpa_out = F.scaled_dot_product_attention(*leaves, attn_mask=mask[:, None, None, :])
        library_bwd_ms = _time_ms(
            lambda: torch.autograd.grad(sdpa_out, leaves, do, retain_graph=True), iters)
        plain_bwd_ms = _time_ms(
            lambda: flash.flash_attention_bwd_plain(q, k, v, mask, o, lse, do), 3)
        want_dq, want_dk, want_dv = flash.flash_attention_bwd_plain(q, k, v, mask, o, lse, do)
        if dkv:
            row("flash_bwd_dkv", key, q,
                lambda: flash.flash_attention_bwd_dkv(q, k, v, mask, lse, delta, do),
                plain_bwd_ms, library_bwd_ms,
                _bound(q, mask, False, matrices=6, row_stats=2, ops_per_pair=8),
                lambda got: held(zip(got, (want_dk, want_dv)), grad_tolerance(q)))
        if dq:
            row("flash_bwd_dq", key, q,
                lambda: flash.flash_attention_bwd_dq(q, k, v, mask, lse, delta, do),
                plain_bwd_ms, library_bwd_ms,
                _bound(q, mask, False, matrices=5, row_stats=2, ops_per_pair=6),
                lambda got: held([(got, want_dq)], grad_tolerance(q)))

    def partial_row(key, q, k, v, mask):
        """The partials' row at this shape."""
        want = flash.flash_attention_partials_plain(q, k, v, mask)

        def check(got):
            errs, ok = _partial_errors(got, want, *tolerance(q))
            return max(errs["acc_over_row_sum"], errs["row_max"], errs["row_sum"]), ok

        row("flash_fwd_partial", key, q, lambda: flash.flash_attention_partials(q, k, v, mask),
            _time_ms(lambda: flash.flash_attention_partials_plain(q, k, v, mask), 3),
            _library_fwd_lse_ms(q, k, v, mask, False, iters),
            _bound(q, mask, False, matrices=3 + 4 // q.element_size(), row_stats=2), check)

    # the ranker's eval (the finished forward over every eval row) and its
    # training step, at its head dim and at WIDE_C3_DIM
    for d, suffix in ((WIDE_HEAD_DIM, ""), (WIDE_C3_DIM, f"-d{WIDE_C3_DIM}")):
        eval_inputs = inputs(eval_mask.shape[0], eval_mask.shape[1], d, eval_mask)
        forward_row("ranker-eval" + suffix, *eval_inputs)
        if d <= flash.WIDE_SM90_MAX_DIM:
            forward_turns("ranker-eval" + suffix, *eval_inputs)
        del eval_inputs
        training_rows("ranker-train" + suffix, *inputs(train_mask.shape[0], train_mask.shape[1], d,
                                                       train_mask))
    # the ring over the eval rows on a 1 x WIDE_EVAL_RING_SP mesh: a shard's
    # queries against one shard's keys
    shard = eval_mask.shape[1] // WIDE_EVAL_RING_SP
    partial_row("eval-ring-shard", *inputs(eval_mask.shape[0], shard, WIDE_HEAD_DIM,
                                           eval_mask[:, :shard].contiguous()))
    # one block of the long ring, at its head dim and at WIDE_C3_DIM
    b, h, l, d = WIDE_RING_SHAPE
    partial_row("ring-block", *inputs(b, l // WIDE_RING_SP, d))
    partial_row(f"ring-block-d{WIDE_C3_DIM}", *inputs(b, l // WIDE_RING_SP, WIDE_C3_DIM))
    # a shard of the long Ulysses: the training step's kernels at [2, 4, 4096, 192]
    b, h, l, d = WIDE_ULYSSES_SHAPE
    shard = inputs(b, l, d, h=h // WIDE_ULYSSES_SP)
    forward_row("ulysses-shard", *shard)
    training_rows("ulysses-shard", *shard)
    return results


# the D = 32 rows of the ranker's paths at their shapes (random 85% key
# masks in place of the ranker's): the training step's forward with lse,
# dK/dV and dQ (slice 13 redesigned the first two, slice 15 dQ), the
# served forward and the ring's eval-shard partials
ROWS = (
    ("trained forward with lse", "lse", (256, 4, 20, 32)),
    ("trained dK/dV", "dkv", (256, 4, 20, 32)),
    ("trained dQ", "dq", (256, 4, 20, 32)),
    ("served forward", "fwd", (1024, 4, 15, 32)),
    ("eval-shard partials", "partial", (2000, 4, 10, 32)),
)
# profiler names of ROWS' kernels in this tree and the ones before it (the
# packed-sets kernels here; flash_fwd_kernel and flash_bwd_dkv_kernel before
# slice 13, flash_bwd_dq_kernel before slice 15)
_ROW_SYMBOLS = {"dkv": r"flash_bwd_dkv_(?:sets_)?kernel", "dq": r"flash_bwd_dq_(?:sets_)?kernel"}


def phase_rows(tree: str) -> None:
    """The kernels of ROWS through the public wrappers of the package
    imported (``--tree``), each held to its plain version, then timed:
    CUDA-event ms of the call and the profiler's device ms of its kernel,
    by a pattern that names the kernels of both this tree and the one
    before it. Run once per tree, in turns, to compare two commits' kernels
    in one call."""
    import torch

    from dragonfly2_tpu_torch.ops import flash

    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    for label, kind, shape in ROWS:
        b, h, l, d = shape
        q, k, v, mask = _attention_inputs(gen, b, h, l, d, torch.bfloat16, False)
        if kind in ("dkv", "dq"):
            do = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
            o, lse = flash.flash_attention_lse(q, k, v, mask)
            delta = (do.float() * o.float()).sum(-1)
            grads = flash.flash_attention_bwd_plain(q, k, v, mask, o, lse, do)
            if kind == "dkv":
                call = lambda: flash.flash_attention_bwd_dkv(q, k, v, mask, lse, delta, do)  # noqa: E731
                want = grads[1:]
            else:
                call = lambda: (flash.flash_attention_bwd_dq(q, k, v, mask, lse, delta, do),)  # noqa: E731
                want = grads[:1]
            del grads
            tol = (GRAD_ATOL, GRAD_RTOL)
        else:
            call = {"fwd": lambda: (flash.flash_attention(q, k, v, mask),),
                    "lse": lambda: flash.flash_attention_lse(q, k, v, mask)[:1],
                    "partial": lambda: flash.flash_attention_partials(q, k, v, mask)}[kind]
            want = {"fwd": lambda: (flash.flash_attention_plain(q, k, v, mask),),
                    "lse": lambda: flash.flash_attention_lse_plain(q, k, v, mask)[:1],
                    "partial": lambda: flash.flash_attention_partials_plain(q, k, v, mask)}[kind]()
            tol = (KERNEL_ATOL, KERNEL_RTOL)
        if kind == "partial":
            errs, ok = _partial_errors(call(), want, *tol)
            err = max(errs["acc_over_row_sum"], errs["row_max"], errs["row_sum"])
        else:
            got = call()
            err = max(float((g.float() - w.float()).abs().max().item()) for g, w in zip(got, want))
            ok = all(torch.allclose(g.float(), w.float(), atol=tol[0], rtol=tol[1])
                     for g, w in zip(got, want))
        if not ok:
            _fail(f"rows {tree}: {label} {list(shape)} vs the plain version: max_abs_err {err}")
        symbol = _ROW_SYMBOLS.get(kind, r"flash_fwd_(?:sets_)?kernel")
        ms = _time_ms(call, 20)
        device, recorded, names = _kernel_ms(call, symbol)
        if device is None:
            _fail(f"rows {tree}: {label}: the profiler found no device time")
        print(f"rows {tree}: {label} {list(shape)} bf16: max_abs_err {err:.3g}; ms {ms:.4f}, "
              f"device {device:.4f} ({', '.join(names)}, {recorded}/{KERNEL_CALLS} recorded)")
        del q, k, v, mask, want


@_phase("wide path")
def phase_wide_path(ds):
    """The wide instances' main paths. The ranker at hidden WIDE_HIDDEN
    with its 4 heads (head dim 192) trained for an epoch on phase 5's trace,
    whose steps run the forward with lse, dK/dV and dQ and whose eval runs
    the finished forward, its first steps replayed on the CPU's plain
    versions from the same weights and batches; the same at hidden
    WIDE_C3_HIDDEN (head dim 320, above 256: the wide mma.sync instances,
    the forward's one-pass kernel),
    its losses finite; the ring over its eval
    batch (the finished forward's shape) on a 1 x WIDE_EVAL_RING_SP mesh,
    whose blocks run the mma.sync wide partials; the ring at
    WIDE_RING_SHAPE on a 1 x WIDE_RING_SP mesh, whose blocks run the wide
    Hopper partials, against flash_attention on the whole sequence and the
    dense oracle on sampled query rows; and Ulysses over WIDE_ULYSSES_SHAPE
    on a 1 x WIDE_ULYSSES_SP mesh, without grad (the wide Hopper forward)
    and with (the wide Hopper forward with lse, dK/dV and dQ),
    against the plain versions over the whole sequence. Counters are zeroed
    just before each run and read just after. Returns the wide launches of
    all five runs."""
    import torch

    from dragonfly2_tpu_torch.ops import flash
    from dragonfly2_tpu_torch.parallel.mesh import make_mesh
    from dragonfly2_tpu_torch.parallel.ring import dense_attention, sharded_ring_attention
    from dragonfly2_tpu_torch.parallel.ulysses import sharded_ulysses_attention
    from dragonfly2_tpu_torch.training import train

    none = {name: 0 for name in _WIDE_COUNTERS}
    total = dict(none)
    for hidden in (WIDE_HIDDEN, WIDE_C3_HIDDEN):
        config = _wide_config(hidden)
        d, layers = hidden // 4, config.attention_num_layers
        _zero_counts()
        _zero_wide_counts()
        torch.cuda.synchronize()
        start = time.perf_counter()
        result = train.train_attention(ds, config, seed=SEED)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - start
        counts, wide = _counts(), _wide_counts()
        # the steps and the eval at the sets' L
        l = ds.mask.shape[1]
        expected = dict(none)
        for function, n in (("flash_fwd", layers), ("flash_fwd_lse", result.steps * layers),
                            ("flash_bwd_dkv", result.steps * layers),
                            ("flash_bwd_dq", result.steps * layers)):
            expected[_wide_instance(function, l, d, torch.bfloat16)] += n
        # every launch of the wrappers went to a wide instance
        expected_all = {"flash_fwd": layers, "flash_fwd_lse": result.steps * layers,
                        "flash_bwd_dkv": result.steps * layers,
                        "flash_bwd_dq": result.steps * layers}
        print(f"wide ranker (hidden {hidden}, 4 heads, head dim {d}, unpadded): "
              f"{result.steps} steps in {train_s:.2f} s, losses {result.losses[0]:.4f} -> "
              f"{result.losses[-1]:.4f}; wide launches "
              f"{({k: v for k, v in wide.items() if v})} (expected "
              f"{({k: v for k, v in expected.items() if v})})")
        if wide != expected or any(counts[k] != v for k, v in expected_all.items()):
            _fail(f"the wide ranker at hidden {hidden} launched {wide} / {counts}, expected "
                  f"{expected}")
        if not np.isfinite(result.losses).all():
            _fail(f"the wide ranker's loss at hidden {hidden} is not finite")
        if hidden == WIDE_HIDDEN:
            _, train_idx, first_epoch = _first_epoch(ds, config)
            _replay_on_cpu(ds, config, result.losses, train_idx, first_epoch, WIDE_REPLAY_STEPS,
                           label="wide ranker: ", rounding=_prescaled_attention)
        for name in total:
            total[name] += wide[name]

    card = torch.device("cuda", 0)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)

    def ring(shape, sp, mask=None):
        """sharded_ring_attention on a 1 x sp mesh of the card, its wide
        launches read just after, and flash_attention over the whole
        sequence."""
        mesh = make_mesh(sp, dp=1, sp=sp, devices=[card] * sp)
        b, h, l, d = shape
        q, k, v, m = _attention_inputs(gen, b, h, l, d, torch.bfloat16, False)
        m = m if mask is None else mask
        _zero_counts()
        _zero_wide_counts()
        torch.cuda.synchronize()
        out = sharded_ring_attention(mesh, q, k, v, m, use_flash=True)
        torch.cuda.synchronize()
        launched = _wide_counts()
        whole = flash.flash_attention(q, k, v, m)
        return q, k, v, m, out, whole, launched

    # the ring over the eval batch: 10 keys a shard, the mma.sync partials
    _, eval_mask = _ranker_masks(ds)
    b, l = eval_mask.shape
    shape = (b, 4, l, WIDE_HEAD_DIM)
    *_, out, whole, launched = ring(shape, WIDE_EVAL_RING_SP, eval_mask)
    want = {**none, "flash_fwd_partial_wide": WIDE_EVAL_RING_SP ** 2}
    if launched != want:
        _fail(f"the ring over the wide eval batch launched {launched}, expected {want}")
    err = float((out.float() - whole.float()).abs().max().item())
    if not torch.allclose(out.float(), whole.float(), atol=KERNEL_ATOL, rtol=KERNEL_RTOL):
        _fail(f"the ring over the wide eval batch vs flash_attention: max_abs_err {err}")
    print(f"wide eval ring {list(shape)} bf16 on a 1 x {WIDE_EVAL_RING_SP} mesh of one card: "
          f"partial launches {launched['flash_fwd_partial_wide']} (mma.sync wide, {l // 2} keys "
          f"a shard); vs flash_attention max_abs_err {err:.3g} (atol {KERNEL_ATOL} rtol "
          f"{KERNEL_RTOL})")
    for name in total:
        total[name] += launched[name]

    # the long ring: the wide Hopper partials
    q, k, v, mask, out, whole, launched = ring(WIDE_RING_SHAPE, WIDE_RING_SP)
    want = {**none, _wide_instance("flash_fwd_partial", WIDE_RING_SHAPE[2] // WIDE_RING_SP,
                                   WIDE_HEAD_DIM, torch.bfloat16): WIDE_RING_SP ** 2}
    if launched != want:
        _fail(f"the wide ring launched {launched}, expected {want}")
    b, h, l, d = WIDE_RING_SHAPE
    err = float((out.float() - whole.float()).abs().max().item())
    if not torch.allclose(out.float(), whole.float(), atol=LONG_ATOL, rtol=LONG_RTOL):
        _fail(f"the wide ring vs flash_attention at L = {l}: max_abs_err {err}")
    oracle_err = 0.0
    for start in (0, l // 2, l - ORACLE_ROWS):
        rows = slice(start, start + ORACLE_ROWS)
        want_rows = dense_attention(q[:, :, rows], k, v, mask).float()
        got = out[:, :, rows].float()
        oracle_err = max(oracle_err, float((got - want_rows).abs().max().item()))
        if not torch.allclose(got, want_rows, atol=LONG_ATOL, rtol=LONG_RTOL):
            _fail(f"the wide ring vs dense_attention on query rows {start}+{ORACLE_ROWS}: "
                  f"{oracle_err}")
    print(f"wide ring {list(WIDE_RING_SHAPE)} bf16 on a 1 x {WIDE_RING_SP} mesh of one card: "
          f"launches {({k: v for k, v in launched.items() if v})}; vs flash_attention on the "
          f"whole sequence max_abs_err {err:.3g}, vs dense on {3 * ORACLE_ROWS} query rows at "
          f"head dim {d} {oracle_err:.3g} (atol {LONG_ATOL} rtol {LONG_RTOL})")
    for name in total:
        total[name] += launched[name]
    del q, k, v, out, whole

    # the long Ulysses: the wide Hopper forward (no grad), then a training
    # step's attention (forward with lse, dK/dV, dQ)
    sp = WIDE_ULYSSES_SP
    mesh = make_mesh(sp, dp=1, sp=sp, devices=[card] * sp)
    b, h, l, d = WIDE_ULYSSES_SHAPE
    q, k, v, mask = _attention_inputs(gen, b, h, l, d, torch.bfloat16, True)
    do = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]

    def step():
        o = sharded_ulysses_attention(mesh, *leaves, mask)
        return o, torch.autograd.grad(o, leaves, do)

    _zero_counts()
    _zero_wide_counts()
    torch.cuda.synchronize()
    with torch.no_grad():
        served = sharded_ulysses_attention(mesh, q, k, v, mask)
    trained, grads = step()
    torch.cuda.synchronize()
    launched = _wide_counts()
    want = dict(none)
    for fn in ("flash_fwd", "flash_fwd_lse", "flash_bwd_dkv", "flash_bwd_dq"):
        want[_wide_instance(fn, l, d, torch.bfloat16)] = sp
    if launched != want:
        _fail(f"the wide Ulysses launched {launched}, expected {want}")
    whole, whole_lse = flash.flash_attention_lse_plain(q, k, v, mask)
    ref = flash.flash_attention_bwd_plain(q, k, v, mask, whole, whole_lse, do)
    del whole_lse
    errs = {}
    dead = ~mask.any(dim=1)
    for name, got, w, atol, rtol in (
            ("served", served, whole, LONG_ATOL, LONG_RTOL),
            ("trained", trained, whole, LONG_ATOL, LONG_RTOL),
            *((n, g, r, LONG_GRAD_ATOL, LONG_GRAD_RTOL)
              for n, g, r in zip(("dq", "dk", "dv"), grads, ref))):
        errs[name] = float((got.float() - w.float()).abs().max().item())
        if not torch.allclose(got.float(), w.float(), atol=atol, rtol=rtol):
            _fail(f"the wide Ulysses {name} vs the plain version: {errs[name]}")
        if got[dead].abs().max().item() != 0.0:
            _fail(f"the wide Ulysses {name}: fully masked batch rows are not 0")
    del ref, whole
    print(f"wide Ulysses {list(WIDE_ULYSSES_SHAPE)} bf16 on a 1 x {sp} mesh of one card: "
          f"launches {({k: v for k, v in launched.items() if v})}; vs the plain versions over "
          "the whole sequence max_abs_err " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
          + f" (outputs atol {LONG_ATOL} rtol {LONG_RTOL}, gradients atol {LONG_GRAD_ATOL} rtol "
          f"{LONG_GRAD_RTOL})")
    for name in total:
        total[name] += launched[name]
    _print_split("wide Ulysses forward + backward", _device_split(step, "flash_"),
                 "the flash kernels")
    return total


# slice 6: the scheduler's rule-arm decision program at the scheduler's
# Config defaults (state capacities 16,384 hosts, 65,536 peers, 4,096
# tasks; DAG capacity 256; cost ring 32; K = FILTER_PARENT_LIMIT = 15
# candidates, CANDIDATE_PARENT_LIMIT = 4 selected), over a deployment
# recorded from the reference's replay as bench_loop.py runs it (10,000
# hosts, 512 tasks, seed 0; tests/test_torch_tick_deployment.py records it)
TICK_RECORDING = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "dragonfly2_tpu_torch", "data", "tick_deployment.npz")
TICK_DAG_CAPACITY, TICK_K, TICK_LIMIT = 256, 15, 4
TICK_WAITING = 1024  # the recorded burst tick's size; bench_loop's ticks hold ~64
BENCH_LOOP_WAITING = 64
TICK_BUCKETS = (64, 256, 1024)
SERVING_K = 64  # ops/evaluator.py's 1k x 64 serving shape
# the tick on CUDA against the CPU: the same float32 operations in the
# same order on both, so scores and ledger rows agree to rounding
TICK_ATOL = 1e-6
TICK_TIMING_CALLS = 20
# ClusterState's constructor arguments, as the recording stores them
TICK_STATE_DIMS = ("max_hosts", "max_tasks", "max_peers", "piece_cost_capacity",
                   "piece_bitset_words")


def load_tick_deployment(path: str = TICK_RECORDING) -> dict:
    """The recorded deployment on the port's host-side state: the
    ClusterState (live rows, ids and free lists as recorded), a TaskDAG
    and slot map per task, the quarantine mask, and the recorded tick's
    waiting peer rows in order with their (task, DAG slot) and blocklists
    as peer rows."""
    from dragonfly2_tpu_torch.graph.dag import TaskDAG
    from dragonfly2_tpu_torch.state.cluster import ClusterState

    z = np.load(path)
    st = ClusterState(**dict(zip(TICK_STATE_DIMS, z["state.dims"].tolist())))
    rows = {kind: z[f"state.{kind}_rows"] for kind in ("host", "task", "peer")}
    for name, value in vars(st).items():
        if isinstance(value, np.ndarray):
            value[rows[name.split("_", 1)[0]]] = z[f"col.{name}"]
    for kind, kind_rows in rows.items():
        ids, by_id = getattr(st, f"_{kind}_id"), getattr(st, f"_{kind}_by_id")
        for row, ident in zip(kind_rows.tolist(), z[f"state.{kind}_ids"].tolist()):
            ids[row], by_id[ident] = ident, row
        getattr(st, f"_{kind}_free")._free = z[f"state.{kind}_free"].tolist()
    st.host_epoch = int(z["state.host_epoch"])
    st.peer_dirty[:] = True  # nothing of it is mirrored yet
    dags, slot_pidx = {}, {}
    for i, task_id in enumerate(z["dag.task_ids"].tolist()):
        dag = dags[task_id] = TaskDAG(TICK_DAG_CAPACITY)
        for name in ("adj", "present", "in_degree", "out_degree"):
            getattr(dag, name)[...] = z[f"dag.{name}"][i]
        slot_pidx[task_id] = z["dag.slot_pidx"][i].copy()
    waiting = np.array([st.peer_index(p) for p in z["waiting.peer_ids"].tolist()], np.int64)
    peer_slot = {int(r): (t, int(s)) for r, t, s in zip(
        waiting, z["waiting.task_ids"].tolist(), z["waiting.dag_slot"].tolist())}
    ptr, blocked = z["waiting.block_ptr"], z["waiting.block_rows"]
    blocklists = {int(r): set(blocked[ptr[i]:ptr[i + 1]].tolist())
                  for i, r in enumerate(waiting) if ptr[i + 1] > ptr[i]}
    return {"state": st, "dags": dags, "slot_pidx": slot_pidx, "peer_slot": peer_slot,
            "qmask": z["qmask"].copy(), "waiting": waiting, "blocklists": blocklists,
            "edges": sum(d.edge_count() for d in dags.values()), "meta": z["meta"].copy()}


def _tick_inputs(dep, waiting, k, rng):
    """The host half of a tick for ``waiting`` peer rows, as the
    reference's SchedulerService._tick_fused builds it
    (cluster/scheduler.py:1840-1903): per task group the shared
    _sample_rows draw and in-degrees from the DAG, the blocklists resolved
    to sample positions, and the DAG-legality superset from
    can_add_edges_pairs (the native library). Returns the grids and the
    host ms of the fill and of the legality prefilters."""
    from dragonfly2_tpu_torch.cluster.scheduler import _sample_rows

    st, slot_pidx = dep["state"], dep["slot_pidx"]
    b = waiting.size
    start = time.perf_counter()
    child_slot = np.array([dep["peer_slot"][int(p)][1] for p in waiting], np.int64)
    groups = {}
    for i, p in enumerate(waiting):
        groups.setdefault(dep["peer_slot"][int(p)][0], []).append(i)
    samples = np.full((b, k), -1, np.int64)
    ind = np.zeros((b, k), np.int32)
    task_row = np.full(b, -1, np.int64)
    for task_id, rows in groups.items():
        dag = dep["dags"][task_id]
        live = np.flatnonzero(dag.present)
        r = np.fromiter(rows, np.int64, len(rows))
        if live.size == 0 or task_id not in slot_pidx:
            continue
        trow = st.task_index(task_id)
        if trow is not None:
            task_row[r] = trow
        s = _sample_rows(rng, live, r.size, k)
        cols_r = np.arange(s.shape[1])
        samples[r[:, None], cols_r] = s
        ind[r[:, None], cols_r] = dag.in_degree[s]
    fill_ms = (time.perf_counter() - start) * 1e3
    start = time.perf_counter()
    bl0 = np.zeros((b, k), bool)
    for i, p in enumerate(waiting):
        blocked = dep["blocklists"].get(int(p))
        if blocked:
            spx = slot_pidx[dep["peer_slot"][int(p)][0]]
            srow = samples[i]
            prow = np.where(srow >= 0, spx[np.clip(srow, 0, None)], -1)
            bl0[i] = np.isin(prow, np.fromiter(blocked, np.int64, len(blocked)))
    ca0 = np.zeros((b, k), bool)
    for task_id, rows in groups.items():
        r = np.asarray(rows)
        sub = samples[r]
        rr, cc = np.nonzero(sub >= 0)
        if rr.size:
            ca0[r[rr], cc] = dep["dags"][task_id].can_add_edges_pairs(sub[rr, cc], child_slot[r][rr])
    legality_ms = (time.perf_counter() - start) * 1e3
    return {"samples": samples, "ind": ind, "task_row": task_row,
            "child": waiting.astype(np.int32), "bl0": bl0, "ca0": ca0,
            "child_slot": child_slot, "fill_ms": fill_ms, "legality_ms": legality_ms}


def _tick_inbuf(inp, s, e, bsz):
    from dragonfly2_tpu_torch.ops import tick

    return tick.build_inbuf(bsz, inp["samples"][s:e], inp["ind"][s:e], inp["task_row"][s:e],
                            inp["child"][s:e], inp["bl0"][s:e], inp["ca0"][s:e])


def _guarded(fn):
    """``fn()`` with any host synchronisation on the card an error: the
    proof that a chunk's call reads nothing back."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    except RuntimeError as e:
        _fail(f"the fused chunk synchronised with the host inside its call: {e}")
    finally:
        torch.cuda.set_sync_debug_mode("default")


def _check_tick_out(got, want, bsz, label):
    """CUDA output against the CPU's: the selection's indices and every int
    segment byte for byte, the scores and ledger rows within TICK_ATOL."""
    from dragonfly2_tpu_torch.ops import tick

    g = tick.decode_out(got, bsz, TICK_K, TICK_LIMIT, True)
    w = tick.decode_out(want, bsz, TICK_K, TICK_LIMIT, True)
    for name, value in w.items():
        if value.dtype == np.int32 and not np.array_equal(g[name], value):
            _fail(f"tick {label}: {name} differs between CUDA and the CPU")
    if not np.array_equal(g["selection"][..., 0], w["selection"][..., 0]):
        _fail(f"tick {label}: selected candidates differ between CUDA and the CPU")
    valid = w["selection"][..., 0] >= 0
    err = float(np.abs(g["selection"][..., 1][valid] - w["selection"][..., 1][valid]).max(
        initial=0.0))
    led_err = float(np.abs(g["led_feats"] - w["led_feats"]).max())
    if err > TICK_ATOL or led_err > TICK_ATOL or not np.isfinite(g["selection"][..., 1][valid]).all():
        _fail(f"tick {label}: scores differ by {err}, ledger rows by {led_err} (atol {TICK_ATOL})")
    return int(valid.sum()), err, led_err, g


def _event_ms(fn, calls: int):
    """Medians over ``calls`` synchronised calls of ``fn``: (host ms of the
    call alone, CUDA-event ms from before the call to after its last
    work, host ms of the call and its read-back). ``fn`` returns the
    device tensor the caller would read back."""
    import torch

    host, device, drained = [], [], []
    for i in range(calls + 3):
        torch.cuda.synchronize()
        a, z = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start = time.perf_counter()
        a.record()
        out = fn()
        z.record()
        mid = time.perf_counter()
        out.cpu()
        end = time.perf_counter()
        torch.cuda.synchronize()
        if i >= 3:
            host.append((mid - start) * 1e3)
            device.append(a.elapsed_time(z))
            drained.append((end - start) * 1e3)
    return statistics.median(host), statistics.median(device), statistics.median(drained)


def _host_ops(fn, launches: int, label: str, calls: int = 5) -> None:
    """Where a launch-bound call's host time goes: the host ops with the
    most self CPU time a call (torch.profiler), beside a control of as
    many tiny in-place adds as the call launches kernels (this machine's
    cost of one eager op)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ops = sorted(((e.key, e.self_cpu_time_total / calls / 1e3, e.count / calls)
                  for e in prof.key_averages() if e.self_cpu_time_total > 0),
                 key=lambda op: -op[1])
    x = torch.zeros(256, 15, device="cuda")
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(launches):
        x.add_(1)
    torch.cuda.synchronize()
    control_ms = (time.perf_counter() - start) * 1e3
    print(f"{label}, host ops by self CPU ms a call: "
          + "; ".join(f"{name} {ms:.3f} ({n:.0f}x)" for name, ms, n in ops[:10])
          + f". Control: {launches} tiny in-place adds take {control_ms:.3f} ms on the host")


@_phase("scheduler tick")
def phase_scheduler_tick(card: str):
    """Slice 6's main path: the recorded tick's waiting peers (about
    TICK_WAITING) through the fused decision program on the card, as the
    reference's _tick_fused runs it: the host fill and legality
    prefilters, the TickMirror sync, then the chunks of _chunk_stride(b)
    rows, each dispatched under the sync guard and drained with one
    read-back.
    Checks: the CUDA tick against the port's CPU run on the same inputs,
    the shadow transport (the fused chunk's device-built buffer through
    schedule_from_packed gives the fused selection), the dirty-row mirror
    against a fresh one, and the DAG twins against the native answers.
    Prints the chunk's times at three buckets, its device time and
    launches, the mirror sync's time, schedule_from_packed at 1024 x 15
    and 1024 x SERVING_K, and the whole tick on the host clock at
    bench_loop's 64 waiting peers and at the recorded b."""
    import copy

    import torch

    from dragonfly2_tpu_torch import native
    from dragonfly2_tpu_torch.cluster.scheduler import _bucket_rows, _chunk_stride
    from dragonfly2_tpu_torch.graph import dag as dag_mod
    from dragonfly2_tpu_torch.ops import evaluator as ev
    from dragonfly2_tpu_torch.ops import tick

    if not native.ensure_built() or native.get_lib() is None:
        _fail("the native library (native/dfnative.cpp) did not build or load")
    start = time.perf_counter()
    dep = load_tick_deployment()
    st, slot_pidx, qmask, waiting = dep["state"], dep["slot_pidx"], dep["qmask"], dep["waiting"]
    b = waiting.size
    if b < TICK_WAITING:
        _fail(f"the recorded tick holds {b} waiting peers, fewer than {TICK_WAITING}")
    hosts, tasks, seed, per_round, _, burst, _, rounds, pieces = dep["meta"][:9].tolist()
    groups = len({dep["peer_slot"][int(p)][0] for p in waiting})
    print(f"tick deployment recorded from the reference's replay ({hosts} hosts, {tasks} tasks, "
          f"seed {seed}, {per_round} downloads a round to {pieces} pieces, then {burst}; "
          f"{rounds} rounds): "
          f"{st.counts()} of capacity hosts {st.max_hosts}, tasks {st.max_tasks}, peers "
          f"{st.max_peers}; {len(dep['dags'])} task DAGs, {dep['edges']} edges; "
          f"{int(qmask.sum())} quarantined hosts; a tick of {b} waiting peers in {groups} task "
          f"groups, {len(dep['blocklists'])} with blocklists; loaded in "
          f"{time.perf_counter() - start:.1f} s (host)")
    cpu_state = copy.deepcopy(st)

    inp = _tick_inputs(dep, waiting, TICK_K, np.random.default_rng(SEED + 7))
    torch.cuda.synchronize()
    start = time.perf_counter()
    mirror = tick.TickMirror(st, TICK_DAG_CAPACITY)
    cols = mirror.sync(slot_pidx, st.task_index, set(slot_pidx), qmask)
    torch.cuda.synchronize()
    full_sync_ms = (time.perf_counter() - start) * 1e3
    cpu_cols = tick.TickMirror(cpu_state, TICK_DAG_CAPACITY, device="cpu").sync(
        slot_pidx, cpu_state.task_index, set(slot_pidx), qmask)
    for name, value in cpu_cols.items():
        if not torch.equal(cols[name].cpu(), value):
            _fail(f"mirror column {name} differs between CUDA and the CPU")

    # the tick: chunks pipelined as the reference's tick pipelines them
    stride = _chunk_stride(b)
    spans = [(s, min(s + stride, b)) for s in range(0, b, stride)]
    flash_before = _counts()
    outs = []
    for s, e in spans:
        bsz = _bucket_rows(e - s)
        inbuf = _tick_inbuf(inp, s, e, bsz)
        out = _guarded(lambda: tick.fused_tick_chunk(inbuf, cols, bsz, TICK_K, 32, 5, 12,
                                                     limit=TICK_LIMIT, emit_led=True))
        outs.append((s, e, bsz, inbuf, out))
    selected = 0
    errs = [0.0, 0.0]
    for s, e, bsz, inbuf, out in outs:
        got = out.cpu().numpy()  # the chunk's one read-back
        want = tick.fused_tick_chunk(inbuf, cpu_cols, bsz, TICK_K, 32, 5, 12, limit=TICK_LIMIT,
                                     emit_led=True).numpy()
        n, err, led_err, dec = _check_tick_out(got, want, bsz, f"rows {s}:{e}")
        selected += n
        errs = [max(errs[0], err), max(errs[1], led_err)]
        # the shadow transport, on the card and guarded as well
        flat, packed = _guarded(lambda: tick.fused_tick_chunk(
            inbuf, cols, bsz, TICK_K, 32, 5, 12, limit=TICK_LIMIT, emit_led=True,
            emit_packed=True))
        shadow = ev.schedule_from_packed(packed, bsz, TICK_K, 32, 5, 12, limit=TICK_LIMIT)
        # bit patterns: the int segments hold NaN patterns as float32 (-1 is one)
        if (not torch.equal(flat.view(torch.int32), out.view(torch.int32))
                or not np.array_equal(shadow.cpu().numpy(), dec["selection"])):
            _fail(f"tick rows {s}:{e}: the shadow transport does not give the fused selection")
        _, cpu_packed = tick.fused_tick_chunk(inbuf, cpu_cols, bsz, TICK_K, 32, 5, 12,
                                              limit=TICK_LIMIT, emit_packed=True)
        if not torch.equal(packed.cpu(), cpu_packed):
            _fail(f"tick rows {s}:{e}: the device-built shadow buffer differs from the CPU's")
    if _counts() != flash_before:
        _fail("the tick launched a flash kernel")
    if selected == 0:
        _fail("the tick selected no parent")
    print(f"tick of {b} waiting peers in {len(spans)} chunks of {stride} (K {TICK_K}, "
          f"limit {TICK_LIMIT}): CUDA == CPU (selections and int segments byte for byte, scores "
          f"max diff {errs[0]:.3g}, ledger rows {errs[1]:.3g}, atol {TICK_ATOL}); {selected} "
          "parents selected; each chunk's call ran under set_sync_debug_mode('error') with its "
          "staging copy; the shadow buffer through schedule_from_packed == the fused selection")

    # the DAG twins on the card against the native answers of the tick's pairs
    rows_dags = [dep["dags"][dep["peer_slot"][int(p)][0]] for p in waiting]
    adj, present = dag_mod.stacked_adjacency(rows_dags)
    parent = torch.from_numpy(inp["samples"]).cuda()
    child = torch.from_numpy(inp["child_slot"]).cuda()
    twin = dag_mod.batch_can_add_edge(adj, present, parent, child).cpu().numpy()
    asked = inp["samples"] >= 0
    if not np.array_equal(twin[asked], inp["ca0"][asked]):
        _fail("batch_can_add_edge on CUDA differs from the native legality answers")
    reach = dag_mod.batch_reachable(adj, child[:, None].expand_as(parent), parent).cpu().numpy()
    cycles = asked & reach & inp["ca0"]
    if cycles.any():
        _fail("batch_reachable on CUDA finds a cycle the native check allowed")
    twin_ms = _time_ms(lambda: dag_mod.batch_can_add_edge(adj, present, parent, child), 3)
    print(f"DAG twins on CUDA over the tick's {int(asked.sum())} pairs ({b} graphs of "
          f"{TICK_DAG_CAPACITY}): batch_can_add_edge == the native can_add_edges_pairs, "
          f"{int((asked & ~inp['ca0']).sum())} pairs refused; {twin_ms:.3f} ms (CUDA events)")
    del adj, present

    # the mirror after 1,024 dirty peer rows and 64 dirty tasks, against a fresh one
    rng = np.random.default_rng(SEED + 8)
    dirty_rows = rng.choice(np.flatnonzero(st.peer_alive), 1024, replace=False)
    live_costs = st.peer_piece_costs[st.peer_piece_cost_count > 0, 0]
    st.record_pieces_batch(dirty_rows, rng.integers(0, 4096, 1024),
                           rng.choice(live_costs, 1024), now=1.0)
    st.peer_state[dirty_rows[::2]] = 7  # SUCCEEDED
    dirty_tasks = set()
    open_tasks = sorted(t for t, spx in slot_pidx.items()
                        if (spx < 0).any() and st.task_index(t) is not None)
    host_rows = np.flatnonzero(st.host_alive)
    for task_id in rng.choice(open_tasks, min(64, len(open_tasks)), replace=False).tolist():
        dag, spx = dep["dags"][task_id], slot_pidx[task_id]
        slot = int(np.flatnonzero(spx < 0)[0])
        p = st.add_peer(f"{task_id}-late", st.task_index(task_id), int(rng.choice(host_rows)))
        dag.add_vertex(slot)
        spx[slot] = p
        dirty_tasks.add(task_id)
    st.host_upload_used[:64] += 1
    torch.cuda.synchronize()
    start = time.perf_counter()
    n_dirty_tasks = len(dirty_tasks)  # sync consumes the set
    synced = mirror.sync(slot_pidx, st.task_index, dirty_tasks, qmask)
    torch.cuda.synchronize()
    sync_ms = (time.perf_counter() - start) * 1e3
    st.peer_dirty[:] = True
    fresh = tick.TickMirror(st, TICK_DAG_CAPACITY).sync(slot_pidx, st.task_index,
                                                      set(slot_pidx), qmask)
    for name, value in fresh.items():
        if not torch.equal(synced[name], value):
            _fail(f"mirror column {name} after the incremental sync differs from a fresh mirror's")
    print(f"mirror sync: full {full_sync_ms:.3f} ms, incremental after 1024 dirty peer rows and "
          f"{n_dirty_tasks} dirty tasks {sync_ms:.3f} ms (host clock, synchronised; {card}); "
          "== a fresh mirror")

    # the chunk's times at the three buckets
    for bsz in TICK_BUCKETS:
        binp = _tick_inputs(dep, waiting[:bsz], TICK_K, np.random.default_rng(bsz))
        inbuf = _tick_inbuf(binp, 0, bsz, bsz)
        host_ms, device_ms, drained_ms = _event_ms(
            lambda: tick.fused_tick_chunk(inbuf, cols, bsz, TICK_K, 32, 5, 12, limit=TICK_LIMIT,
                                          emit_led=True), TICK_TIMING_CALLS)
        split = _device_split(lambda: tick.fused_tick_chunk(
            inbuf, cols, bsz, TICK_K, 32, 5, 12, limit=TICK_LIMIT, emit_led=True), "", calls=5)
        print(f"fused_tick_chunk bucket {bsz}: dispatch {host_ms:.3f} ms host, {device_ms:.3f} ms "
              f"CUDA events; dispatch + drain {drained_ms:.3f} ms host (medians of "
              f"{TICK_TIMING_CALLS}); profiled {split[0]:.3f} ms a call, device kernels "
              f"{split[1]:.4f} ms in {split[3]:.0f} launches, device busy "
              f"{100 * split[1] / split[0] if split[0] else 0:.1f}% ({card})")
        if bsz == stride:
            _host_ops(lambda: tick.fused_tick_chunk(inbuf, cols, bsz, TICK_K, 32, 5, 12,
                                                    limit=TICK_LIMIT, emit_led=True),
                      round(split[3]), f"fused_tick_chunk bucket {bsz}")

    # schedule_from_packed at 1024 x 15 and 1024 x SERVING_K
    rows = waiting[:TICK_WAITING]
    for kk in (TICK_K, SERVING_K):
        kinp = _tick_inputs(dep, rows, kk, np.random.default_rng(kk))
        samples = kinp["samples"]
        cand = np.zeros_like(samples)
        for i, p in enumerate(rows):
            spx = slot_pidx[dep["peer_slot"][int(p)][0]]
            cand[i] = np.where(samples[i] >= 0, spx[np.clip(samples[i], 0, None)], 0)
        feats = st.gather_candidates(rows, cand, samples >= 0).as_dict()
        buf = ev.pack_eval_batch(feats, kinp["bl0"], kinp["ind"], kinp["ca0"])
        args = (buf, TICK_WAITING, kk, 32, 5, 12)
        gpu = ev.schedule_from_packed(*args, limit=TICK_LIMIT).cpu().numpy()
        cpu = ev.schedule_from_packed(*args, limit=TICK_LIMIT, device="cpu").numpy()
        valid = cpu[..., 0] >= 0
        if (not np.array_equal(gpu[..., 0], cpu[..., 0])
                or np.abs(gpu[..., 1][valid] - cpu[..., 1][valid]).max(initial=0.0) > TICK_ATOL):
            _fail(f"schedule_from_packed {TICK_WAITING} x {kk}: CUDA differs from the CPU")
        host_ms, device_ms, drained_ms = _event_ms(
            lambda: ev.schedule_from_packed(*args, limit=TICK_LIMIT), TICK_TIMING_CALLS)
        print(f"schedule_from_packed {TICK_WAITING} x {kk} ({buf.nbytes} bytes in): CUDA == CPU "
              f"({int(valid.sum())} selected); call {host_ms:.3f} ms host, {device_ms:.3f} ms CUDA "
              f"events; call + read-back {drained_ms:.3f} ms host ({card})")

    # the whole tick on the host clock, as the scheduler runs it: at
    # bench_loop's size (the first 64 waiting rows, one chunk) and the
    # recorded burst's
    for n in (BENCH_LOOP_WAITING, b):
        n_spans = [(s, min(s + _chunk_stride(n), n)) for s in range(0, n, _chunk_stride(n))]
        runs = []
        for run in range(5):
            torch.cuda.synchronize()
            start = time.perf_counter()
            inp = _tick_inputs(dep, waiting[:n], TICK_K, np.random.default_rng(SEED + 9 + run))
            t0 = time.perf_counter()
            cols = mirror.sync(slot_pidx, st.task_index, set(), qmask)
            t1 = time.perf_counter()
            in_flight, drained = None, []
            for s, e in n_spans:  # chunk i+1 is dispatched before chunk i is read back
                bsz = _bucket_rows(e - s)
                out = tick.fused_tick_chunk(_tick_inbuf(inp, s, e, bsz), cols, bsz, TICK_K, 32, 5,
                                            12, limit=TICK_LIMIT, emit_led=True)
                if in_flight is not None:
                    drained.append(tick.decode_out(in_flight[0].cpu().numpy(), in_flight[1],
                                                   TICK_K, TICK_LIMIT, True))
                in_flight = (out, bsz)
            drained.append(tick.decode_out(in_flight[0].cpu().numpy(), in_flight[1], TICK_K,
                                           TICK_LIMIT, True))
            end = time.perf_counter()
            if sum(int((d["selection"][..., 0] >= 0).sum()) for d in drained) == 0:
                _fail(f"the timed tick of {n} selected no parent")
            runs.append(((end - start) * 1e3, inp["fill_ms"], inp["legality_ms"],
                         (t1 - t0) * 1e3, (end - t1) * 1e3))
        total, fill, legality, sync, chunks = min(runs, key=lambda r: abs(
            r[0] - statistics.median(x[0] for x in runs)))
        print(f"whole tick of {n} waiting peers (host clock, the run nearest the median of 5): "
              f"{total:.3f} ms = fill {fill:.3f} + legality {legality:.3f} + sync {sync:.3f} + "
              f"{len(n_spans)} chunks dispatched and drained {chunks:.3f} ms ({card})")



# slice 7: the scheduler service on the card, as an operator runs it, at
# bench_loop.py's default replay (10,000 hosts, 512 tasks, seed 0, 64
# downloads a round) under Config() defaults (16,384 hosts, 65,536 peers,
# 4,096 tasks, K = 15; the fused tick, the decision ledger and the SLO
# engine on), with a TraceStorage in a temporary directory and, since
# slice 16, bench_loop's probe store and probe rounds (bench_loop.py:91-92,
# 141-142). bench_loop runs ~960 rounds to 1,000,000 pieces; the timed run
# is cut to SERVICE_ROUNDS to stay in the time limit
SERVICE_HOSTS, SERVICE_TASKS, SERVICE_DOWNLOADS = 10_000, 512, 64
SERVICE_ROUNDS = 100  # 300 before the whole run was cut to fit its time limit
SERVICE_FLASH_CROWD = 1024
SERVICE_PARITY_ROUNDS = 30  # CUDA against the CPU at the same scale
SERVICE_PROFILED_TICKS = 5
SERVICE_WRAPPER_ROUNDS = 20  # rounds of each entry-wrapper mode, taken in turn
SERVICE_SCORE_ATOL = 1e-6
# bench_loop's ProbeStore(max_pairs=1 << 17) and run_probe_round(sources=8)
# every 50 rounds; every 10 in the paired rounds, so that 30 hold three
PROBE_PAIRS, PROBE_SOURCES, PROBE_EVERY, PARITY_PROBE_EVERY = 1 << 17, 8, 50, 10
# fused_tick=False against True on the card, at tests/test_fused_tick.py's size
ORACLE_HOSTS, ORACLE_TASKS, ORACLE_DOWNLOADS, ORACLE_ROUNDS = 40, 5, 5, 10


def _service(device, data_dir, hosts=SERVICE_HOSTS, tasks=SERVICE_TASKS, fused=True,
             algorithm="default", warm=False):
    """bench_loop's service with its probe store; ``warm`` seeds the store
    first from the simulator's link model (cluster/probes.warm_from_link_model)."""
    from dragonfly2_tpu_torch.cluster.probes import ProbeStore, warm_from_link_model
    from dragonfly2_tpu_torch.cluster.scheduler import SchedulerService
    from dragonfly2_tpu_torch.cluster.simulator import ClusterSimulator
    from dragonfly2_tpu_torch.config.config import Config
    from dragonfly2_tpu_torch.records.storage import TraceStorage

    cfg = Config()
    cfg.scheduler.fused_tick = fused
    cfg.evaluator.algorithm = algorithm
    probes = ProbeStore(max_pairs=PROBE_PAIRS, max_hosts=cfg.scheduler.max_hosts, device=device)
    svc = SchedulerService(config=cfg, storage=TraceStorage(data_dir), probes=probes, seed=SEED,
                           device=device)
    sim = ClusterSimulator(svc, num_hosts=hosts, num_tasks=tasks, seed=SEED,
                           deterministic_peer_ids=True)
    if warm:
        slotted = [(h, svc.state.host_index(h.id)) for h in sim.cluster.hosts
                   if svc.state.host_index(h.id) is not None]
        warm_from_link_model(probes, slotted, lambda src, dst, key: sim.cluster.rtt_ns(src, dst))
    return svc, sim


def _service_round(svc, sim, downloads: int, probe: bool = False):
    """One bench_loop round: new downloads, the seed triggers, the tick
    (host clock, ms), every response acted on, a probe round if asked
    (host clock, ms), the GC sweep. Returns the tick's ms, its selections
    [(peer, [(parent, score), ...])] and the probe round's ms (or None)."""
    for _ in range(downloads):
        sim.start_download()
    sim.consume_seed_triggers()
    start = time.perf_counter()
    responses = svc.tick()
    tick_ms = (time.perf_counter() - start) * 1e3
    for resp in responses:
        sim._act(resp)
    probe_ms = None
    if probe:
        start = time.perf_counter()
        sim.run_probe_round(sources=PROBE_SOURCES)
        probe_ms = (time.perf_counter() - start) * 1e3
    svc.run_gc()
    return tick_ms, [(r.peer_id, [(p.peer_id, p.score) for p in r.candidate_parents])
                     for r in responses if hasattr(r, "candidate_parents")], probe_ms


def _run_rounds(svc, sim, rounds: int, downloads: int, probe_every: int):
    """``rounds`` rounds with a probe round after every ``probe_every``-th,
    as bench_loop's replay takes them: (tick ms, selections, probe ms)."""
    ticks, selections, probes = [], [], []
    for i in range(1, rounds + 1):
        tick_ms, selected, probe_ms = _service_round(svc, sim, downloads,
                                                     probe=i % probe_every == 0)
        ticks.append(tick_ms)
        selections += selected
        if probe_ms is not None:
            probes.append(probe_ms)
    return ticks, selections, probes


def _same_selections(got, want, label: str) -> float:
    """Parent ids exactly, scores within SERVICE_SCORE_ATOL; the worst
    score difference."""
    if [p for p, _ in got] != [p for p, _ in want]:
        _fail(f"{label}: the responses' peers differ")
    err = 0.0
    for (peer, g), (_, w) in zip(got, want):
        if [pid for pid, _ in g] != [pid for pid, _ in w]:
            _fail(f"{label}: {peer}'s parents differ: {g} vs {w}")
        err = max([err] + [abs(a - b) for (_, a), (_, b) in zip(g, w)])
    if err > SERVICE_SCORE_ATOL:
        _fail(f"{label}: scores differ by {err} (atol {SERVICE_SCORE_ATOL})")
    return err


def _paired_runs(make, variants, rounds, downloads, label, probe_every=PARITY_PROBE_EVERY):
    """The same seeded service run twice, ``make(variant, data_dir)``
    building each of the two ``variants`` (a device, or a fused_tick
    flag), held equal: selections, the replay's stats and the probe
    store's ring, cursor, count, probed counts and averages."""
    import torch

    runs = []
    for variant in variants:
        with tempfile.TemporaryDirectory() as data_dir:
            svc, sim = make(variant, data_dir)
            selections = _run_rounds(svc, sim, rounds, downloads, probe_every)[1]
            store = svc.probes
            runs.append((selections, sim.stats, {
                name: getattr(store, name).cpu()
                for name in ("ring", "cursor", "count", "probed_count")
            } | {"average": torch.from_numpy(store.average)}, store._next))
    (want, want_stats, want_store, want_pairs), (got, got_stats, got_store, got_pairs) = runs
    err = _same_selections(got, want, label)
    for key in ("pieces", "completed", "piece_cost_ns_total"):
        if getattr(got_stats, key) != getattr(want_stats, key):
            _fail(f"{label}: {key} {getattr(got_stats, key)} vs {getattr(want_stats, key)}")
    for name, value in want_store.items():
        if not torch.equal(got_store[name], value):
            _fail(f"{label}: the probe stores' {name} differ")
    if got_pairs != want_pairs or got_pairs == 0:
        _fail(f"{label}: probe pairs {got_pairs} vs {want_pairs}")
    print(f"{label}: {len(got)} selections equal (parent ids exact, scores within "
          f"{err:.3g}); pieces {got_stats.pieces}, completed {got_stats.completed}, "
          f"piece_cost_ns_total {got_stats.piece_cost_ns_total} equal; probe stores "
          f"(a probe round every {probe_every} rounds, {got_pairs} pairs) ring, cursor, count, "
          "probed_count and averages equal")


def _wrapper_cost(svc, sim) -> None:
    """The entry wrappers' cost in the tick (telemetry/flight.py): rounds
    taken in turn with the device entries bare, wrapped as they ship
    (counting calls; the cost-card entries also look each call's
    signature up, the fused entry by its key) and wrapped with
    TRACK_SIGNATURES on; each mode's median
    fused_dispatch phase and tick, host clock."""
    from dragonfly2_tpu_torch.ops import evaluator as ev
    from dragonfly2_tpu_torch.ops import tick as tk
    from dragonfly2_tpu_torch.telemetry import flight

    wrapped = {(module, name): getattr(module, name) for module, name in (
        (ev, "schedule_from_packed"), (tk, "fused_tick_chunk"), (tk, "_scatter_rows"))}
    modes = ("bare", "counted", "signatures")
    dispatch, ticks = ({mode: [] for mode in modes} for _ in range(2))
    try:
        for _ in range(SERVICE_WRAPPER_ROUNDS):
            for mode in modes:
                for (module, name), wrapper in wrapped.items():
                    setattr(module, name, wrapper.__wrapped__ if mode == "bare" else wrapper)
                flight.TRACK_SIGNATURES = mode == "signatures"
                ticks[mode].append(_service_round(svc, sim, SERVICE_DOWNLOADS)[0])
                dispatch[mode].append(svc.recorder.snapshot(1)[0]["fused_dispatch"])
    finally:
        for (module, name), wrapper in wrapped.items():
            setattr(module, name, wrapper)
        flight.TRACK_SIGNATURES = False
    print(f"service entry wrappers, {SERVICE_WRAPPER_ROUNDS} rounds of each mode in turn: "
          + "; ".join(f"{mode} fused_dispatch p50 {statistics.median(dispatch[mode]):.4f} ms, "
                      f"tick p50 {statistics.median(ticks[mode]):.4f} ms" for mode in modes))


def _profile_rounds(svc, sim, label: str) -> None:
    """Launches a tick and the device's busy share over
    SERVICE_PROFILED_TICKS profiled rounds (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        tick_ms = sum(_service_round(svc, sim, SERVICE_DOWNLOADS)[0]
                      for _ in range(SERVICE_PROFILED_TICKS))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    kernels, launches = _kernel_rows(prof, SERVICE_PROFILED_TICKS)
    device_ms = sum(ms for _, ms in kernels)
    if device_ms == 0:
        print(f"{label} profiled rounds: device time not measured (the profiler saw no device "
              "activity)")
        return
    # the device works only inside the ticks: busy over the ticks' wall,
    # and over the whole rounds' (the simulator's host work too)
    busy_ticks = 100 * device_ms * SERVICE_PROFILED_TICKS / tick_ms
    busy_rounds = 100 * device_ms * SERVICE_PROFILED_TICKS / wall_ms
    print(f"{label} profiled rounds ({SERVICE_PROFILED_TICKS} of {SERVICE_DOWNLOADS} "
          f"downloads): {wall_ms / SERVICE_PROFILED_TICKS:.3f} ms a round, of it the tick "
          f"{tick_ms / SERVICE_PROFILED_TICKS:.3f} ms (host clock, profiled); device "
          f"kernels {device_ms:.4f} ms a tick over {launches:.0f} launches; device busy "
          f"{busy_ticks:.1f}% of the ticks, {busy_rounds:.1f}% of the rounds; top "
          "kernels: " + "; ".join(f"{k[:60]} {ms:.4f}" for k, ms in kernels[:6]))


def _timed_service(svc, sim, label: str, card: str):
    """Warmup, then SERVICE_ROUNDS timed rounds with bench_loop's probe
    rounds, no flash kernel launched: prints the tick's p50 and p99, the
    phases' medians, pieces a second and the probe rounds. Returns the
    probe rounds' ms."""
    import torch

    start = time.perf_counter()
    svc.warmup()
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - start
    _zero_counts()
    _zero_wide_counts()
    start = time.perf_counter()
    ticks, _, probe_ms = _run_rounds(svc, sim, SERVICE_ROUNDS, SERVICE_DOWNLOADS, PROBE_EVERY)
    wall = time.perf_counter() - start
    if any(_counts().values()) or any(_wide_counts().values()):
        _fail(f"{label}: the ticks launched a flash kernel: {_counts()}")
    pieces = sim.stats.pieces
    p50 = statistics.median(ticks)
    p99 = sorted(ticks)[int(0.99 * (len(ticks) - 1))]
    print(f"{label} on the card ({SERVICE_HOSTS} hosts, {SERVICE_TASKS} tasks, seed {SEED}, "
          f"{SERVICE_DOWNLOADS} downloads a round, algorithm {svc.algorithm}, fused tick "
          f"{svc._tick_mirror is not None}; warmup {warmup_s:.2f} s): {SERVICE_ROUNDS} rounds in "
          f"{wall:.2f} s, {pieces} pieces = {pieces / wall:.1f} pieces/s; tick p50 {p50:.3f} ms, "
          f"p99 {p99:.3f} ms (host clock); stats {sim.stats.completed} completed, "
          f"{sim.stats.back_to_source} back to source; counts {svc.counts()} ({card})")
    print(f"{label} tick phases, median ms over the timed rounds: "
          + ", ".join(f"{k} {v:.3f}" for k, v in svc.recorder.phase_p50s(SERVICE_ROUNDS).items()))
    return probe_ms


def _probe_summary(svc, label: str, probe_ms) -> int:
    """Prints the probe rounds and the store; writes the topology snapshot
    to trace storage (snapshot_topology) and returns its rows."""
    store = svc.probes
    rows = svc.snapshot_topology()
    svc.storage.flush()
    print(f"{label} probes (a ProbeStore of {PROBE_PAIRS} pairs, a round of {PROBE_SOURCES} "
          f"sources every {PROBE_EVERY} rounds): {len(probe_ms)} timed probe rounds, median "
          f"{statistics.median(probe_ms):.3f} ms (host clock); pairs stored {store._next}; "
          f"probed-count total {int(store.probed_count.sum())}; topology rows written {rows}")
    if not probe_ms or rows == 0 or store._next == 0:
        _fail(f"{label}: the probe rounds stored nothing or the snapshot wrote no row")
    return rows


@_phase("scheduler service")
def phase_scheduler_service(card: str, trace_dir: str):
    """Slice 7's main path: SchedulerService on the card driven by the
    port's ClusterSimulator through its entries (announce_host,
    register_peer, tick, piece and peer reports, run_gc, the probe rounds),
    as bench_loop.py replays: warmup, SERVICE_ROUNDS rounds of
    SERVICE_DOWNLOADS with a probe round every PROBE_EVERY, then one
    flash-crowd round of SERVICE_FLASH_CROWD and the topology snapshot.
    Prints the tick's p50 and p99 on the host clock, each PhaseRecorder
    phase's median, pieces per second, the probe rounds' median, the pairs
    stored, the probed-count total and the topology rows written, and the
    launches and device busy share of SERVICE_PROFILED_TICKS profiled
    ticks. Checks: the same seeded run of SERVICE_PARITY_ROUNDS (a probe
    round every PARITY_PROBE_EVERY) on the CPU and on the card gives the
    same selections, the same pieces, completed and piece_cost_ns_total,
    and the same probe store; fused_tick=False agrees with True on the
    card at tests/test_fused_tick.py's size; no tick launches a flash
    kernel. The timed service writes its traces under ``trace_dir``;
    returns its TraceStorage, which phase 14 trains on."""
    _paired_runs(lambda device, data_dir: _service(device, data_dir), ("cpu", "cuda"),
                 SERVICE_PARITY_ROUNDS, SERVICE_DOWNLOADS,
                 f"service CPU vs CUDA, {SERVICE_PARITY_ROUNDS} rounds at {SERVICE_HOSTS} hosts")
    _paired_runs(lambda fused, data_dir: _service("cuda", data_dir, ORACLE_HOSTS, ORACLE_TASKS,
                                                  fused=fused),
                 (True, False), ORACLE_ROUNDS, ORACLE_DOWNLOADS,
                 f"service on CUDA, fused_tick=False vs True, {ORACLE_ROUNDS} rounds at "
                 f"{ORACLE_HOSTS} hosts", probe_every=3)

    svc, sim = _service("cuda", trace_dir)
    probe_ms = _timed_service(svc, sim, "service", card)
    crowd_ms, crowd, _ = _service_round(svc, sim, SERVICE_FLASH_CROWD)
    if any(_counts().values()) or any(_wide_counts().values()):
        _fail(f"the scheduler's ticks launched a flash kernel: {_counts()}")
    if not any(sel for _, sel in crowd):
        _fail("the flash-crowd tick selected no parent")
    print(f"service flash-crowd tick of {SERVICE_FLASH_CROWD} downloads: {crowd_ms:.3f} ms "
          f"(host clock), {len(crowd)} selections; its phases: "
          + ", ".join(f"{k} {v:.3f}" for k, v in svc.recorder.snapshot(1)[0].items()))
    _probe_summary(svc, "service", probe_ms)
    led = svc.decisions.counters()
    slo = svc.slo.verdict()
    print(f"service decision ledger {led}; SLO verdict {slo['state']}; trace rows "
          f"{svc.storage.downloads.count()}")
    if led["decisions"] == 0 or svc.storage.downloads.count() == 0:
        _fail("the service recorded no decision or no download trace")
    _profile_rounds(svc, sim, "service")
    _wrapper_cost(svc, sim)
    return svc.storage


def _count_rtt_hits(store) -> list:
    """Wrap the store's RTT gather to count [candidates gathered, those
    with a measured RTT]."""
    hits = [0, 0]
    gather = store.gather_candidate_rtt

    def counted(child_host_slots, cand_host_slots):
        avg, has = gather(child_host_slots, cand_host_slots)
        hits[0] += has.size
        hits[1] += int(has.sum())
        return avg, has

    store.gather_candidate_rtt = counted
    return hits


@_phase("nt arm")
def phase_scheduler_nt(card: str):
    """Slice 16's main path: the nt arm on measured RTTs. The same
    deployment as phase 10 with ``algorithm="nt"``, its ProbeStore warmed
    from the simulator's link model (warm_from_link_model), a probe round
    every PROBE_EVERY rounds, SERVICE_ROUNDS timed rounds: the tick's p50
    and p99, the phases' medians, pieces per second, launches and busy
    share. Checks: the tick ran unfused (the host RTT gather), candidates
    carried measured RTTs, no flash kernel launched, and
    SERVICE_PARITY_ROUNDS on the CPU and on the card give equal
    selections, stats and probe stores. Returns the topology records the
    snapshot wrote to trace storage."""
    def make(device, data_dir):
        return _service(device, data_dir, algorithm="nt", warm=True)

    _paired_runs(make, ("cpu", "cuda"), SERVICE_PARITY_ROUNDS, SERVICE_DOWNLOADS,
                 f"nt service CPU vs CUDA, {SERVICE_PARITY_ROUNDS} rounds at {SERVICE_HOSTS} hosts")
    with tempfile.TemporaryDirectory() as data_dir:
        start = time.perf_counter()
        svc, sim = make("cuda", data_dir)
        warm_s = time.perf_counter() - start
        if svc._tick_mirror is not None:
            _fail("the probed nt arm took the fused tick")
        hits = _count_rtt_hits(svc.probes)
        print(f"nt service: set-up with the warm pass {warm_s:.2f} s, {svc.probes._next} pairs "
              "warmed from the link model")
        probe_ms = _timed_service(svc, sim, "nt service", card)
        if hits[1] == 0:
            _fail("the nt arm gathered no measured RTT")
        print(f"nt service RTT gather: {hits[1]} of {hits[0]} candidates carried a measured RTT "
              f"({100 * hits[1] / hits[0]:.1f}%)")
        _probe_summary(svc, "nt service", probe_ms)
        topology = svc.storage.list_network_topologies()
        _profile_rounds(svc, sim, "nt service")
    return topology


# slice 16: the graph models at full width (TrainerConfig's hidden 128,
# GraphSAGE's 2 layers) over phase 5's host graph (10,000 hosts, ~417,000
# directed edges), on both aggregation paths. bf16 compute: each side
# rounds its products and gelus to bf16 in its own order and the card's
# segment sums are atomics, a few bf16 ulps of embeddings up to ~4
GRAPH_LAYERS = 2
GRAPH_ATOL, GRAPH_RTOL = 5e-2, 5e-2
GRAPH_CALLS = 10  # timed embeds a path
GRAPH_FRONTIERS = (64, 1)  # dirty hosts of each embed_subset frontier
GRAPH_BATCH = 256  # rank_batches rows scored
MLP_HIDDEN, MLP_LAYERS = 128, 3


def _on(arrays: dict, device) -> dict:
    import torch

    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in arrays.items()}


def _embed(model, a: dict):
    return model.embed(a["node_feats"], a["edge_src"], a["edge_dst"], a["edge_feats"],
                       adj=a.get("adj"), edge_mean=a.get("edge_mean"))


def _hold(label: str, got, want, atol=GRAPH_ATOL, rtol=GRAPH_RTOL) -> float:
    """got (card) against want (CPU twin) within atol + rtol * |want|; the
    worst absolute difference."""
    import torch

    got, want = got.float().cpu(), want.float().cpu()
    if got.shape != want.shape or not torch.isfinite(got).all():
        _fail(f"{label}: shape {tuple(got.shape)} vs {tuple(want.shape)}, or non-finite values")
    err = (got - want).abs()
    if (err > atol + rtol * want.abs()).any():
        _fail(f"{label}: differs by up to {float(err.max()):.4g} (atol {atol}, rtol {rtol})")
    return float(err.max())


@_phase("graph models")
def phase_graph_models(ds, graph, topology, card: str):
    """Slice 16's models at full width on the card, each held to its CPU
    twin (the same module and weights on the CPU): GraphSAGERanker's embed
    on the segment path (graph_arrays with edges padded to edge_bucket) and
    the dense one (dense_graph_arrays), the dense against the segment
    embeddings, embed_subset over gather_coo_subgraph frontiers against the
    full embed's rows with every other table row unchanged, score on one
    rank_batches batch, and ProbeRTTRegressor over topology_to_pairs of the
    nt phase's snapshot. Prints each path's embed p50 (CUDA events), device
    ms and launches (profiler), and returns the p50s by path. No flash
    kernel may launch."""
    import copy

    import torch

    from dragonfly2_tpu_torch.config.config import TrainerConfig
    from dragonfly2_tpu_torch.models import GraphSAGERanker, ProbeRTTRegressor
    from dragonfly2_tpu_torch.ops.segment import gather_coo_subgraph
    from dragonfly2_tpu_torch.records.features import topology_to_pairs
    from dragonfly2_tpu_torch.training.data import (dense_graph_arrays, edge_bucket,
                                                     graph_arrays, rank_batches)

    hidden = TrainerConfig().hidden_dim
    twin = GraphSAGERanker(hidden, GRAPH_LAYERS).reset_parameters(
        torch.Generator().manual_seed(SEED))
    model = copy.deepcopy(twin).to("cuda")
    start = time.perf_counter()
    seg = graph_arrays(graph, pad_edges_to=edge_bucket(len(graph.edge_src)))
    dense = dense_graph_arrays(graph)
    print(f"graph models: GraphSAGERanker hidden {hidden}, {GRAPH_LAYERS} layers, bf16, over "
          f"{len(graph.host_ids)} hosts and {len(graph.edge_src)} edges (padded to "
          f"{len(seg['edge_src'])}, sink row {seg['node_feats'].shape[0] - 1}); graph arrays "
          f"{time.perf_counter() - start:.1f} s (host)")
    _zero_counts()
    _zero_wide_counts()
    emb, p50 = {}, {}
    with torch.no_grad():
        for path, arrays in (("segment", seg), ("dense", dense)):
            on_card, on_cpu = _on(arrays, "cuda"), _on(arrays, "cpu")
            emb[path] = _embed(model, on_card)
            err = _hold(f"{path} embed, CUDA vs CPU", emb[path], _embed(twin, on_cpu))
            _, event_ms, _ = _event_ms(lambda: _embed(model, on_card), GRAPH_CALLS)
            p50[path] = event_ms
            wall_ms, device_ms, _, launched = _device_split(lambda: _embed(model, on_card), "")
            print(f"graph embed, {path} path ({card}): CUDA vs CPU within {err:.4g} (atol "
                  f"{GRAPH_ATOL}, rtol {GRAPH_RTOL}); p50 {event_ms:.3f} ms (CUDA events, "
                  f"{GRAPH_CALLS} calls); profiled {wall_ms:.3f} ms a call, device "
                  f"{device_ms:.4f} ms over {launched:.0f} launches")
        n = len(graph.host_ids)
        err = _hold("dense vs segment embed on the card", emb["dense"], emb["segment"][:n])
        print(f"graph embed: dense path vs segment path on the card within {err:.4g}")

        full = emb["segment"].float()
        rows = seg["node_feats"].shape[0]
        if rows != n + 1:  # gather_coo_subgraph's padding aliases a sink row
            _fail("graph_arrays appended no sink row (the edges filled their bucket)")
        rng = np.random.default_rng(SEED)
        for dirty in GRAPH_FRONTIERS:
            frontier = rng.choice(n, dirty, replace=False)
            sub = gather_coo_subgraph(seg["edge_src"], seg["edge_dst"], frontier, rows,
                                      max_frac=1.0)
            feats = np.where(sub["edge_pad"][:, None], 0.0,
                             seg["edge_feats"][sub["edge_index"]]).astype(np.float32)
            table = torch.randn(full.shape, generator=torch.Generator().manual_seed(dirty)).cuda()
            fresh = model.embed_subset(
                *(_on({"n": seg["node_feats"][sub["nodes"]], "s": sub["edge_src"],
                       "d": sub["edge_dst"], "e": feats}, "cuda").values()),
                table, *(_on({"l": sub["target_local"], "g": sub["target_global"]},
                             "cuda").values()))
            targets = torch.from_numpy(sub["target_global"][sub["target_global"] < rows]).long()
            kept = torch.ones(rows, dtype=torch.bool)
            kept[targets] = False
            if not torch.equal(fresh.cpu()[kept], table.cpu()[kept]):
                _fail(f"embed_subset over {dirty} dirty hosts changed a row outside its targets")
            err = _hold(f"embed_subset over {dirty} dirty hosts vs the full embed",
                        fresh.cpu()[targets], full.cpu()[targets])
            print(f"graph embed_subset, a frontier of {dirty} dirty hosts: "
                  f"{len(sub['nodes'])} subgraph nodes, {int((~sub['edge_pad']).sum())} edges, "
                  f"{len(targets)} targets of {len(sub['target_global'])} (padding dropped): "
                  f"targets vs the full embed within {err:.4g}, the other {int(kept.sum())} "
                  "table rows unchanged bit for bit")

        batch = next(rank_batches(ds, GRAPH_BATCH, np.random.default_rng(SEED)))
        child = torch.from_numpy(batch.child_idx).long()
        parents = torch.from_numpy(batch.parent_idx).long()
        pair = torch.from_numpy(batch.pair_feats)
        cpu_emb = full.cpu()
        got = model.score(full[child.cuda()], full[parents.cuda()], pair.cuda())
        err = _hold("score, CUDA vs CPU", got, twin.score(cpu_emb[child], cpu_emb[parents], pair))
        print(f"graph score of a {GRAPH_BATCH}-row rank_batches batch ({list(pair.shape)}): "
              f"CUDA vs CPU within {err:.4g}")

        x, y = topology_to_pairs(topology)
        if len(x) == 0:
            _fail("the nt phase's snapshot held no probe pair")
        mlp_twin = ProbeRTTRegressor(MLP_HIDDEN, MLP_LAYERS).reset_parameters(
            torch.Generator().manual_seed(SEED))
        mlp = copy.deepcopy(mlp_twin).to("cuda")
        xt = torch.from_numpy(x)
        got = mlp(xt.cuda())
        err = _hold("ProbeRTTRegressor, CUDA vs CPU", got, mlp_twin(xt))
        _, event_ms, _ = _event_ms(lambda: mlp(xt.cuda()), GRAPH_CALLS)
        print(f"ProbeRTTRegressor (hidden {MLP_HIDDEN}, {MLP_LAYERS} layers, bf16) over "
              f"topology_to_pairs of the nt phase's {len(topology)} topology records: "
              f"{len(x)} pairs x {x.shape[1]} features, y log1p(ms) in [{y.min():.3f}, "
              f"{y.max():.3f}]; CUDA vs CPU within {err:.4g}; p50 {event_ms:.3f} ms (CUDA "
              "events, the upload included)")
    if any(_counts().values()) or any(_wide_counts().values()):
        _fail(f"the graph models launched a flash kernel: {_counts()}")
    return p50


# slice 17: the ml arm on the card, at bench_loop.py phase 3's arm settings
# (bench_loop.py:299-327: algorithm "ml", peer TTL 10 s, GC every 1 s, 1,024
# peers a task, piece timeout 30 s, Config()'s 16,384 hosts and 4,096 tasks;
# 10,000 hosts, 32 tasks, simulator seed 2, 64 downloads a round; the
# embedding refresh inline once, then on the worker every 10 rounds). The
# ranker is TrainerConfig's hidden 128, 2 layers, bf16, with random seed-0
# weights (phase 12's). bench_loop runs an arm to max(pieces // 4, 2000)
# pieces; the timed run is cut to ML_ROUNDS rounds, phase 10's cut
ML_HOSTS, ML_TASKS, ML_SEED, ML_DOWNLOADS = 10_000, 32, 2, 64
ML_ROUNDS = 100  # 300 before the whole run was cut to fit its time limit
ML_SHADOW_ROUNDS = 100  # the rule arm with the ml shadow: cut to keep the phase near 60 s
ML_REFRESH_EVERY = 10
ML_PARITY_ROUNDS = 30
ML_SCORED_CHUNKS = 4  # the timed run's first chunks, scored again on the CPU
ML_HOST_ID = "sched-host-1"
# bf16 ensemble scores on the card against the CPU on one table: the
# tests' port-vs-reference gap is at most 5.5e-3, and a row whose least gap
# down to the cut exceeds twice that cannot flip; float32: a flipped row's
# CPU margin lies under ML_F32_TOL (the scores' CPU-vs-card gap is ~1e-7)
ML_MARGIN_TOL = 1.2e-2
ML_F32_TOL = 1e-5


def _ml_service(device, evaluator, algorithm="ml", bench_gc=True):
    """bench_loop's arm: a fresh service and simulator. ``bench_gc=False``
    keeps Config()'s peer TTL, so that two runs of one seed at different
    speeds evict alike (the arm's 10 s TTL reads the wall clock)."""
    from dragonfly2_tpu_torch.cluster.scheduler import SchedulerService
    from dragonfly2_tpu_torch.cluster.simulator import ClusterSimulator
    from dragonfly2_tpu_torch.config.config import Config

    cfg = Config()
    cfg.evaluator.algorithm = algorithm
    if bench_gc:
        cfg.scheduler.peer_ttl_seconds = 10.0
        cfg.scheduler.peer_gc_interval_seconds = 1.0
    cfg.scheduler.max_peers_per_task = 1024
    cfg.scheduler.piece_download_timeout_seconds = 30.0
    svc = SchedulerService(config=cfg, ml_evaluator=evaluator, device=device)
    sim = ClusterSimulator(svc, num_hosts=ML_HOSTS, num_tasks=ML_TASKS, seed=ML_SEED,
                           deterministic_peer_ids=True)
    return svc, sim


def _ml_margins(model, table, buf, dims, limit):
    """Per row of a packed chunk, on the CPU: the least gap between
    consecutive valid ensemble scores, sorted down, from the first to the
    (limit + 1)-th (inf where the row has fewer than two)."""
    import torch

    from dragonfly2_tpu_torch.ops import evaluator as ev
    from dragonfly2_tpu_torch.registry import serving

    f = ev.unpack_eval_batch(torch.from_numpy(buf), *dims)
    scores = serving._ml_scores(model, table, f["child_host_slot"], f["cand_host_slot"], f,
                                "default")
    mask = ev.filter_candidates(f, f["blocklist"], f["in_degree"], f["can_add_edge"])
    s = torch.where(mask, scores, -torch.inf).sort(-1, descending=True).values[:, : limit + 1]
    both = torch.isfinite(s[:, :-1]) & torch.isfinite(s[:, 1:])
    return torch.where(both, s[:, :-1] - s[:, 1:], torch.inf).min(-1).values


def _record_ml_calls(evaluator, calls: list, keep):
    """Wrap the evaluator's schedule_from_packed to keep (buf, dims,
    snapshot, limit, read-back) of the calls that pinned a committed
    snapshot (the ticks), while ``keep(calls)`` allows."""
    inner = evaluator.schedule_from_packed

    def recorded(buf, b, k, c, l, n, **kw):
        out = inner(buf, b, k, c, l, n, **kw)
        snap = kw.get("snap")
        if getattr(snap, "host_emb", None) is not None and keep(calls):
            calls.append((np.array(buf, copy=True), (b, k, c, l, n), snap, kw["limit"],
                          out.cpu().numpy()))
        return out

    evaluator.schedule_from_packed = recorded


def _ml_paired_f32(reg, hidden: int) -> None:
    """The ml arm at float32, CPU against CUDA, ML_PARITY_ROUNDS rounds
    with an inline refresh every ML_REFRESH_EVERY, compared chunk by
    chunk: up to the first chunk that differs every input buffer must be
    equal; at that chunk each differing row's CPU margin must lie under
    ML_F32_TOL, and the comparison stops there."""
    import torch

    from dragonfly2_tpu_torch.models import GraphSAGERanker
    from dragonfly2_tpu_torch.registry import GNN_MODEL_NAME, MLEvaluator, ModelServer

    runs = {}
    for device in ("cpu", "cuda"):
        server = ModelServer(reg, GNN_MODEL_NAME, ML_HOST_ID, "gnn", device=device,
                             model=GraphSAGERanker(hidden, GRAPH_LAYERS, torch.float32))
        server.refresh()
        evaluator = MLEvaluator(server)
        svc, sim = _ml_service(device, evaluator, bench_gc=False)
        calls, rounds_of = [], []
        _record_ml_calls(evaluator, calls, lambda c: True)
        evaluator.refresh_embeddings(svc.serving_graph_arrays(), wait=True)
        for r in range(1, ML_PARITY_ROUNDS + 1):
            _service_round(svc, sim, ML_DOWNLOADS)
            rounds_of += [r] * (len(calls) - len(rounds_of))
            if r % ML_REFRESH_EVERY == 0:
                evaluator.refresh_embeddings(svc.serving_graph_arrays(), wait=True)
        evaluator.close()
        runs[device] = (calls, rounds_of, sim.stats)
    (want, rounds, want_stats), (got, _, got_stats) = runs["cpu"], runs["cuda"]
    if len(got) != len(want) and got_stats == want_stats:
        _fail(f"ml f32 paired: {len(got)} vs {len(want)} chunks with equal stats")
    for i, ((buf, dims, snap, limit, w), (gbuf, _, _, _, g)) in enumerate(zip(want, got)):
        if not np.array_equal(buf, gbuf):
            _fail(f"ml f32 paired: chunk {i} (round {rounds[i]}) got another input while every "
                  "earlier selection was equal")
        differ = ~(g[..., 0] == w[..., 0]).all(-1)
        if not differ.any():
            continue
        margins = _ml_margins(snap.model, snap.host_emb, buf, dims, limit).numpy()
        worst = float(margins[differ].max())
        print(f"ml f32 paired CPU vs CUDA: first difference at chunk {i} (round "
              f"{rounds[i]}): {int(differ.sum())} rows, their CPU margins at most {worst:.3g} "
              f"(tolerance {ML_F32_TOL})")
        if worst >= ML_F32_TOL:
            _fail(f"ml f32 paired: a row with CPU margin {worst} >= {ML_F32_TOL} differs")
        return
    if got_stats != want_stats:
        _fail(f"ml f32 paired: equal selections but stats {got_stats} vs {want_stats}")
    print(f"ml f32 paired CPU vs CUDA, {ML_PARITY_ROUNDS} rounds at {ML_HOSTS} hosts: all "
          f"{len(got)} chunks select alike; pieces {got_stats.pieces}, completed "
          f"{got_stats.completed}, piece_cost_ns_total {got_stats.piece_cost_ns_total} equal")


@_phase("ml arm")
def phase_ml_arm(card: str) -> dict:
    """Slice 17's main path: the ml arm served on the card (see the
    module docstring, phase 13). Returns the mean piece cost over the first
    ML_SHADOW_ROUNDS rounds of the rule arm and of the seed-0 ml arm."""
    import copy

    import torch

    from dragonfly2_tpu_torch.config.config import TrainerConfig
    from dragonfly2_tpu_torch.models import GraphSAGERanker
    from dragonfly2_tpu_torch.models.convert import graphsage_params_to_flax
    from dragonfly2_tpu_torch.objectstorage.backends import FilesystemBackend
    from dragonfly2_tpu_torch.ops.segment import gather_coo_subgraph
    from dragonfly2_tpu_torch.registry import (GNN_MODEL_NAME, BucketModelRegistry,
                                               MLEvaluator, ModelEvaluation, ModelServer,
                                               serving)

    hidden = TrainerConfig().hidden_dim
    model = GraphSAGERanker(hidden, GRAPH_LAYERS).reset_parameters(
        torch.Generator().manual_seed(SEED)).cuda()
    _zero_counts()
    _zero_wide_counts()
    with tempfile.TemporaryDirectory() as root:
        reg = BucketModelRegistry(FilesystemBackend(root), "models")
        tree = graphsage_params_to_flax(model)
        meta = {"hidden_dim": hidden, "num_layers": GRAPH_LAYERS}
        v1 = reg.create_model_version(GNN_MODEL_NAME, "gnn", ML_HOST_ID, tree, ModelEvaluation(),
                                      metadata=meta)
        reg.activate(v1.model_id, v1.version)
        server = ModelServer(reg, GNN_MODEL_NAME, ML_HOST_ID, "gnn")
        if not server.refresh() or server.device.type != "cuda":
            _fail("the gnn ModelServer served nothing on the card")
        if any(not torch.equal(server.params[k], v) for k, v in model.state_dict().items()):
            _fail("the served weights are not the published ones")
        evaluator = MLEvaluator(server)
        svc, sim = _ml_service("cuda", evaluator)
        start = time.perf_counter()
        evaluator.refresh_embeddings(svc.serving_graph_arrays(), wait=True)
        first_s = time.perf_counter() - start
        if evaluator.committed_versions[-1] != (v1.version, 1):
            _fail(f"the first refresh committed {list(evaluator.committed_versions)}")

        # the activation gate: a NaN-poisoned v2 never serves
        poisoned = copy.deepcopy(tree)
        poisoned["params"]["sage_0"]["self"]["kernel"][0, 0] = np.nan
        v2 = reg.create_model_version(GNN_MODEL_NAME, "gnn", ML_HOST_ID, poisoned,
                                      ModelEvaluation(), metadata=meta)
        reg.activate(v2.model_id, v2.version)
        if not server.refresh() or server.version != v2.version:
            _fail("the server did not load the poisoned version")
        evaluator.refresh_embeddings(svc.serving_graph_arrays(), wait=True)
        snap = evaluator.serving_snapshot()
        active = reg.active_version(v1.model_id).version
        rejected = evaluator._metrics.activation_rejected.value("nonfinite_params")
        if (evaluator.rejection_count != 1 or snap.params_version != v1.version
                or active != v1.version or rejected < 1):
            _fail(f"the gate let v2 through: rejections {evaluator.rejection_count}, serving "
                  f"v{snap.params_version}, registry active v{active}")
        if not server.refresh() or server.version != v1.version:
            _fail("the server did not fall back to v1")
        print(f"ml arm: GraphSAGERanker hidden {hidden}, {GRAPH_LAYERS} layers, bf16, published "
              f"as {v1.model_id} v1 and served on the card (first inline refresh {first_s:.3f} s, "
              f"table {tuple(snap.host_emb.shape)}); a NaN-poisoned v2 rejected by the gate "
              f"(nonfinite_params counted {rejected:.0f}), serving stayed on v{snap.params_version} "
              f"(emb v{snap.emb_version}), the registry fell back to v{active}, the server "
              f"reloaded v{server.version}")

        # the timed ml arm, as bench_loop's: the counters reset after the
        # warm refresh, every later refresh on the worker
        evaluator.refresh_blocking_s = evaluator.refresh_compute_s = 0.0
        evaluator.refresh_count = evaluator.incremental_refresh_count = 0
        chunks = []
        _record_ml_calls(evaluator, chunks, lambda c: len(c) < ML_SCORED_CHUNKS)
        start = time.perf_counter()
        svc.warmup()
        torch.cuda.synchronize()
        warmup_s = time.perf_counter() - start
        ticks, graph_ms, enqueue_ms = [], [], []
        start = time.perf_counter()
        for r in range(1, ML_ROUNDS + 1):
            ticks.append(_service_round(svc, sim, ML_DOWNLOADS)[0])
            if r == ML_SHADOW_ROUNDS:  # the rule arm's run ends here
                at_cut = sim.stats.piece_cost_ns_total / max(sim.stats.pieces, 1) / 1e6
            if r % ML_REFRESH_EVERY == 0:
                t0 = time.perf_counter()
                graph = svc.serving_graph_arrays()
                t1 = time.perf_counter()
                evaluator.refresh_embeddings(graph)
                graph_ms.append((t1 - t0) * 1e3)
                enqueue_ms.append((time.perf_counter() - t1) * 1e3)
        wall = time.perf_counter() - start
        evaluator.close(drain=True)
        st = sim.stats
        p50, p99 = statistics.median(ticks), sorted(ticks)[int(0.99 * (len(ticks) - 1))]
        ml_cost = st.piece_cost_ns_total / max(st.pieces, 1) / 1e6
        print(f"ml arm on the card ({ML_HOSTS} hosts, {ML_TASKS} tasks, seed {ML_SEED}, "
              f"{ML_DOWNLOADS} downloads a round, fused tick {svc._tick_mirror is not None}; "
              f"warmup {warmup_s:.2f} s): {ML_ROUNDS} rounds in {wall:.2f} s, {st.pieces} pieces "
              f"= {st.pieces / wall:.1f} pieces/s, mean piece cost {ml_cost:.4f} ms; tick p50 "
              f"{p50:.3f} ms, p99 {p99:.3f} ms (host clock); completed {st.completed}, back to "
              f"source {st.back_to_source}; served from {evaluator.last_used_versions} ({card})")
        print("ml arm tick phases, median ms over the timed rounds: "
              + ", ".join(f"{k} {v:.3f}" for k, v in svc.recorder.phase_p50s(ML_ROUNDS).items()))
        print(f"ml arm refreshes on the worker: {evaluator.refresh_count} "
              f"({evaluator.incremental_refresh_count} incremental), refresh_blocking_s "
              f"{evaluator.refresh_blocking_s:.4f}, refresh_compute_s "
              f"{evaluator.refresh_compute_s:.4f}; serving_graph_arrays {sum(graph_ms):.1f} ms "
              f"over {len(graph_ms)} calls (median {statistics.median(graph_ms):.3f}, "
              f"{graph['edge_src'].shape[0]} padded edges at the last), the enqueue "
              f"{sum(enqueue_ms):.3f} ms in all (host clock)")
        if evaluator.refresh_count == 0 or evaluator.last_used_versions[0] != v1.version:
            _fail("the ml arm refreshed nothing on the worker or did not serve v1")

        # the timed run's first chunks, again on the CPU on the same table
        inside, rows, worst = 0, 0, 0.0
        for buf, dims, snap, limit, got in chunks:
            cpu_model, cpu_table = copy.deepcopy(snap.model).cpu(), snap.host_emb.cpu()
            want = serving._ml_schedule_from_packed(cpu_model, cpu_table, buf, *dims,
                                                    limit).numpy()
            margins = _ml_margins(cpu_model, cpu_table, buf, dims, limit).numpy()
            wide = margins > ML_MARGIN_TOL
            same = (got[..., 0] == want[..., 0]).all(-1)
            if not same[wide].all():
                _fail(f"ml scoring: {int((~same[wide]).sum())} rows outside the margin "
                      f"{ML_MARGIN_TOL} select otherwise on the card")
            sel = got[..., 0] >= 0
            worst = max(worst, float(np.abs(got[..., 1][sel] - want[..., 1][sel]).max()))
            inside += int((~wide).sum())
            rows += dims[0]
        print(f"ml scoring of {len(chunks)} chunks ({rows} rows), card vs CPU on the same "
              f"table: selections equal on every row outside the margin {ML_MARGIN_TOL} "
              f"({inside} rows inside it), selected scores within {worst:.3g}")

        # the incremental refresh against the full embed
        for _ in range(2):
            _service_round(svc, sim, ML_DOWNLOADS)
        graph = svc.serving_graph_arrays()
        n = graph["node_feats"].shape[0]
        dirty = graph["dirty_slots"]
        old = evaluator.serving_snapshot().host_emb.clone()
        if len(dirty) == 0 or old.shape[0] != n:
            _fail(f"no frontier to refresh ({len(dirty)} dirty, table {old.shape[0]} vs {n})")
        evaluator.INCREMENTAL_MAX_FRAC = 1.0
        count = evaluator.incremental_refresh_count
        start = time.perf_counter()
        evaluator.refresh_embeddings(dict(graph, full_sync=False), wait=True)
        inc_s = time.perf_counter() - start
        if evaluator.incremental_refresh_count != count + 1:
            _fail("the frontier's refresh did not take the incremental path")
        fresh = evaluator.serving_snapshot().host_emb
        start = time.perf_counter()
        full = server.embed_hosts(graph)
        torch.cuda.synchronize()
        full_s = time.perf_counter() - start
        sub = gather_coo_subgraph(graph["edge_src"], graph["edge_dst"], dirty, n, max_frac=1.0)
        targets = torch.from_numpy(sub["target_global"][sub["target_global"] < n]).long()
        kept = torch.ones(n, dtype=torch.bool)
        kept[targets] = False
        if not torch.equal(fresh.cpu()[kept], old.cpu()[kept]):
            _fail("the incremental refresh changed a row outside its targets")
        err = _hold("incremental refresh vs the full embed", fresh.cpu()[targets],
                    full.cpu()[targets])
        print(f"ml incremental refresh of {len(dirty)} dirty hosts: {len(targets)} target rows "
              f"within {err:.4g} of the full embed (atol {GRAPH_ATOL}, rtol {GRAPH_RTOL}), the "
              f"other {int(kept.sum())} rows unchanged bit for bit; {inc_s * 1e3:.3f} ms inline "
              f"against {full_s * 1e3:.3f} ms for the full embed (host clock)")
        _profile_rounds(svc, sim, "ml arm")
        del svc, sim

        # the rule arm at the same seed with the evaluator attached: its ml
        # shadow re-scores every tick's batch from the fused program's buffer
        svc, sim = _ml_service("cuda", evaluator, algorithm="default")
        evaluator.refresh_embeddings(svc.serving_graph_arrays(), wait=True)
        svc.warmup()
        if not svc._shadow_ml_ready:
            _fail("warmup did not ready the ml shadow arm")
        ticks = []
        start = time.perf_counter()
        for _ in range(ML_SHADOW_ROUNDS):
            ticks.append(_service_round(svc, sim, ML_DOWNLOADS)[0])
        wall = time.perf_counter() - start
        st = sim.stats
        led = svc.decisions.counters()
        shadow = [ph["shadow_score"] for ph in svc.recorder.snapshot(ML_SHADOW_ROUNDS)
                  if "shadow_score" in ph]
        cost = st.piece_cost_ns_total / max(st.pieces, 1) / 1e6
        print(f"rule arm with the ml shadow ({ML_HOSTS} hosts, {ML_TASKS} tasks, seed {ML_SEED}, "
              f"fused tick {svc._tick_mirror is not None}): {ML_SHADOW_ROUNDS} rounds in "
              f"{wall:.2f} s, "
              f"{st.pieces} pieces = {st.pieces / wall:.1f} pieces/s (the shadow's work "
              f"included), mean piece cost {cost:.4f} ms (the ml arm's {at_cut:.4f} over its "
              f"first {ML_SHADOW_ROUNDS} rounds); tick p50 "
              f"{statistics.median(ticks):.3f} ms; shadow_compared {led['shadow_compared']}, "
              f"shadow_top1_disagree {led['shadow_top1_disagree']}, shadow_score median "
              f"{statistics.median(shadow) if shadow else float('nan'):.3f} ms a tick")
        if led["shadow_compared"] == 0:
            _fail("the ml shadow compared nothing")
        del svc, sim

        _ml_paired_f32(reg, hidden)
    if any(_counts().values()) or any(_wide_counts().values()):
        _fail(f"the ml arm launched a flash kernel: {_counts()}")
    return {"rule": cost, "ml": at_cut}


# slice 18: the trainer on the card, through TrainerService behind the
# Announcer, over phase 10's traces (its 100 rounds and flash crowd) and
# the topology rows phases 10-11 snapshot; TrainerConfig's defaults (hidden
# 128, batch 256, lr 1e-3, 10 epochs), the attention family on
TRAINER_HOST_ID = ML_HOST_ID
TRAINER_REPLAY_STEPS = 3
# the bf16 loss tolerances of tests/test_torch_trainer.py: the GNN's
# listwise loss, and the MLP's weighted MSE (which starts near 10, where
# bf16 carries ~0.04)
TRAINER_GNN_LOSS_ATOL, TRAINER_MLP_LOSS_ATOL = 2e-2, 5e-2
TRAINER_STEP_CALLS = 20  # steps timed by CUDA events, a model
TRAINER_PROFILED_STEPS = 5
TRAINER_SERVE_ROUNDS = 100  # the trained GNN on phase 13's ml arm
TRAINER_RESUME_EPOCHS = (2, 4, 4)


@contextlib.contextmanager
def _trainer_calls(service_module):
    """Wrap the trainer service's train_gnn, train_attention and train_mlp
    while the block runs: each call's flash launch counts (zeroed just
    before it, read just after), its wall, its inputs and its result, by
    family."""
    import torch

    calls, originals = {}, {}
    for family in ("gnn", "attention", "mlp"):
        inner = getattr(service_module, f"train_{family}")

        def wrapped(*args, inner=inner, family=family, **kwargs):
            _zero_counts()
            _zero_wide_counts()
            start = time.perf_counter()
            result = inner(*args, **kwargs)
            torch.cuda.synchronize()
            calls[family] = {"args": args, "kwargs": kwargs, "result": result,
                             "wall_s": time.perf_counter() - start,
                             "counts": _counts(), "wide": _wide_counts()}
            return result

        originals[family] = inner
        setattr(service_module, f"train_{family}", wrapped)
    try:
        yield calls
    finally:
        for family, inner in originals.items():
            setattr(service_module, f"train_{family}", inner)


def _epoch_means(result, epochs: int) -> list:
    per = result.steps // epochs
    return [float(np.mean(result.losses[e * per:(e + 1) * per])) for e in range(epochs)]


def _step_ms(trainer, idx) -> float:
    """A trainer's step p50 by CUDA events over TRAINER_STEP_CALLS steps on
    its device-resident rows (the trained weights go on moving)."""
    done = [0]

    def step():
        done[0] += 1
        return trainer.step(idx[done[0] % len(idx)])

    return _event_ms(step, TRAINER_STEP_CALLS)[1]


def _profile_steps(trainer, idx, label: str) -> None:
    """Launches, device ms and the busy share of TRAINER_PROFILED_STEPS steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    n = TRAINER_PROFILED_STEPS
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for i in range(n):
            trainer.step(idx[i % len(idx)])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3 / n
    kernels, launches = _kernel_rows(prof, n)
    device_ms = sum(ms for _, ms in kernels)
    if device_ms == 0:
        print(f"{label} profiled steps: device time not measured (the profiler saw no device "
              "activity)")
        return
    print(f"{label} profiled steps ({n}): {wall_ms:.3f} ms a step (host clock, profiled), "
          f"device kernels {device_ms:.4f} ms a step over {launches:.0f} launches, device busy "
          f"{100 * device_ms / wall_ms:.1f}%; top kernels: "
          + "; ".join(f"{k[:60]} {ms:.4f}" for k, ms in kernels[:5]))


def _first_batches(n_rows: int, batch_size: int, steps: int):
    """(train rows, the first ``steps`` batches) as the trainers draw them
    from SEED: the split, then each epoch's minibatches in turn (a small
    set has fewer batches an epoch than ``steps``)."""
    from dragonfly2_tpu_torch.training import data, train

    rng = np.random.default_rng(SEED)
    _, train_idx = train._train_eval_split(rng.permutation(n_rows), 0.2)
    batch = min(batch_size, len(train_idx))
    batches = []
    while len(batches) < steps:
        batches += list(data.minibatches(len(train_idx), batch, rng))
    return train_idx, np.stack(batches[:steps])


def _trainer_replays(calls, config, garrs) -> None:
    """The first GNN and MLP steps replayed on the CPU from the same initial
    weights and batches (losses within the CPU tests' bf16 tolerances), and
    one GNN step's gradients, CUDA against CPU, each parameter's within
    GRAD_REL of its largest element (the head's output bias, true gradient
    0, rounding-small)."""
    import torch

    from dragonfly2_tpu_torch.training import train

    ds, graph = calls["gnn"]["args"][:2]
    train_idx, first = _first_batches(len(ds.mask), config.batch_size, TRAINER_REPLAY_STEPS)
    rows = train._rank_rows(train._take_rank_batch(ds, train_idx))

    def gnn_trainer(device):
        model = train.build_graphsage(config, graph, SEED, None, device)
        return train.GNNTrainer(model, rows, garrs, config.learning_rate, device)

    cpu = gnn_trainer("cpu")
    replay = [cpu.step(torch.from_numpy(i)).item() for i in first]
    got = calls["gnn"]["result"].losses[:len(replay)]
    err = float(np.abs(np.array(replay) - np.array(got)).max())
    print(f"trainer: GNN's first {len(replay)} steps replayed on the CPU (dense path "
          f"{'adj' in garrs}): "
          f"max loss difference {err:.3g} (atol {TRAINER_GNN_LOSS_ATOL})")
    if err > TRAINER_GNN_LOSS_ATOL:
        _fail(f"the GNN's CPU replay differs by {err}")

    grads = {}
    for device in ("cuda", "cpu"):
        trainer = gnn_trainer(device)
        trainer.loss(torch.from_numpy(first[0]).to(device)).backward()
        grads[device] = {n: p.grad.float().cpu() for n, p in trainer.model.named_parameters()}
    largest = max(float(g.abs().max()) for g in grads["cpu"].values())
    worst = max((float((grads["cuda"][n] - g).abs().max()) / float(g.abs().max()), n)
                for n, g in grads["cpu"].items() if n != "head_out.bias")
    zero = max(float(grads[d]["head_out.bias"].abs().max()) for d in grads) / largest
    print(f"trainer: one GNN step's gradients, cuda vs cpu: worst parameter {worst[1]} at "
          f"{worst[0]:.3g} of its largest element (limit {GRAD_REL}); the head's output bias "
          f"(shift-invariant) at {zero:.3g} of the largest gradient (limit 1e-2)")
    if worst[0] > GRAD_REL or zero > 1e-2:
        _fail(f"the GNN gradient of {worst[1]} differs by {worst[0]} of its scale "
              f"(shift-invariant {zero})")

    x, y = calls["mlp"]["args"][:2]
    train_idx, first = _first_batches(len(y), config.batch_size, TRAINER_REPLAY_STEPS)
    mlp = train.MLPTrainer(train.build_regressor(config, x.shape[1], SEED, None, "cpu"),
                           {"x": x[train_idx], "y": y[train_idx],
                            "w": np.ones(len(train_idx), np.float32)},
                           config.learning_rate, "cpu")
    replay = [mlp.step(torch.from_numpy(i)).item() for i in first]
    got = calls["mlp"]["result"].losses[:len(replay)]
    err = float(np.abs(np.array(replay) - np.array(got)).max())
    print(f"trainer: MLP's first {len(replay)} steps replayed on the CPU: max loss difference "
          f"{err:.3g} (atol {TRAINER_MLP_LOSS_ATOL})")
    if err > TRAINER_MLP_LOSS_ATOL:
        _fail(f"the MLP's CPU replay differs by {err}")


def _trainer_timings(calls, config, garrs) -> None:
    """Each model's step p50 by CUDA events from its trained weights, and a
    profiler breakdown of the GNN's steps."""
    import torch

    from dragonfly2_tpu_torch.training import train

    ds, graph = calls["gnn"]["args"][:2]
    train_idx, first = _first_batches(len(ds.mask), config.batch_size, 8)
    idx = torch.from_numpy(first).cuda()
    gnn = train.GNNTrainer(
        train.build_graphsage(config, graph, SEED, calls["gnn"]["result"].params, "cuda"),
        train._rank_rows(train._take_rank_batch(ds, train_idx)), garrs, config.learning_rate,
        "cuda")
    rows = train.take(ds, train_idx)
    in_features = sum(rows[key].shape[-1] for key in ("parents", "child", "pair"))
    att = train.AttentionTrainer(
        train.build_ranker(config, in_features, SEED, calls["attention"]["result"].params,
                           "cuda"), rows, config.learning_rate, "cuda")
    x, y = calls["mlp"]["args"][:2]
    mlp_idx, mlp_first = _first_batches(len(y), config.batch_size, 8)
    mlp = train.MLPTrainer(
        train.build_regressor(config, x.shape[1], SEED, calls["mlp"]["result"].params, "cuda"),
        {"x": x[mlp_idx], "y": y[mlp_idx], "w": np.ones(len(mlp_idx), np.float32)},
        config.learning_rate, "cuda")
    p50 = {"gnn": _step_ms(gnn, idx), "attention": _step_ms(att, idx),
           "mlp": _step_ms(mlp, torch.from_numpy(mlp_first).cuda())}
    print("trainer: step p50 by CUDA events over "
          f"{TRAINER_STEP_CALLS} steps from the trained weights: "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in p50.items()))
    _profile_steps(gnn, idx, "trainer: GNN")


def _trainer_resume(x, y, config, root) -> None:
    """train_mlp on the card for 2 epochs with a TrainCheckpointer, then 4
    from it (exactly 2 more epochs of steps), then 4 again (0 steps, the
    checkpoint's params bit for bit)."""
    import dataclasses

    from dragonfly2_tpu_torch.training import train
    from dragonfly2_tpu_torch.training.checkpoint import TrainCheckpointer

    ck = TrainCheckpointer(os.path.join(root, "resume"))
    results = [train.train_mlp(x, y, dataclasses.replace(config, epochs=e), seed=SEED,
                               checkpointer=ck)
               for e in TRAINER_RESUME_EPOCHS]
    first, resumed, again = results
    per_epoch = first.steps // TRAINER_RESUME_EPOCHS[0]
    same = all((again.params["params"][layer][key] == value).all()
               for layer, leaves in resumed.params["params"].items()
               for key, value in leaves.items())
    print(f"trainer: MLP resume on the card: {first.steps} steps in {TRAINER_RESUME_EPOCHS[0]} "
          f"epochs, then {resumed.steps} resumed to {TRAINER_RESUME_EPOCHS[1]} epochs, then "
          f"{again.steps}; saved steps {ck.all_steps()}; the complete run's params are the "
          f"checkpoint's bit for bit: {same}")
    if resumed.steps != 2 * per_epoch or again.steps != 0 or not same:
        _fail("the MLP's resume on the card trained the wrong number of steps or changed params")


def _trainer_serve(registry, rule_cost) -> None:
    """Phase 13's ml arm for TRAINER_SERVE_ROUNDS rounds at its settings, on
    the trained GNN version from the registry: the tick p50 and the mean
    piece cost beside the rule arm's at the same seed (an observation)."""
    import torch

    from dragonfly2_tpu_torch.cluster.trainer_service import GNN_MODEL_NAME
    from dragonfly2_tpu_torch.registry import MLEvaluator, ModelServer

    server = ModelServer(registry, GNN_MODEL_NAME, TRAINER_HOST_ID, "gnn")
    if not server.refresh() or server.device.type != "cuda":
        _fail("the trained GNN did not load into a ModelServer on the card")
    evaluator = MLEvaluator(server)
    svc, sim = _ml_service("cuda", evaluator)
    evaluator.refresh_embeddings(svc.serving_graph_arrays(), wait=True)
    svc.warmup()
    torch.cuda.synchronize()
    ticks = []
    start = time.perf_counter()
    for r in range(1, TRAINER_SERVE_ROUNDS + 1):
        ticks.append(_service_round(svc, sim, ML_DOWNLOADS)[0])
        if r % ML_REFRESH_EVERY == 0:
            evaluator.refresh_embeddings(svc.serving_graph_arrays())
    wall = time.perf_counter() - start
    evaluator.close(drain=True)
    st = sim.stats
    cost = st.piece_cost_ns_total / max(st.pieces, 1) / 1e6
    print(f"trainer: the trained GNN (v{server.version}) on the ml arm ({ML_HOSTS} hosts, "
          f"{ML_TASKS} tasks, seed {ML_SEED}): {TRAINER_SERVE_ROUNDS} rounds in {wall:.2f} s, "
          f"{st.pieces} pieces, tick p50 {statistics.median(ticks):.3f} ms (host clock), mean "
          f"piece cost {cost:.4f} ms; the rule arm at the same seed and rounds (phase 13) "
          f"{rule_cost['rule']:.4f} ms, the seed-0 weights' ml arm {rule_cost['ml']:.4f} ms; "
          f"served {evaluator.last_used_versions} (an observation, no claim)")
    if evaluator.last_used_versions[0] != server.version or st.pieces == 0:
        _fail("the ml arm did not serve the trained version")


@_phase("trainer")
def phase_trainer(card: str, storage, topology, rule_cost) -> None:
    """Slice 18's main path: the Announcer streams phase 10's traces to
    TrainerService on the card (train_gnn on the dense path, train_attention
    through the training kernels, train_mlp over the topology pairs), which
    publishes three versions to a filesystem ModelRegistry; then the MLP's
    resume and the trained GNN served on the ml arm (the module docstring,
    phase 14)."""
    from dragonfly2_tpu_torch.cluster import trainer_service
    from dragonfly2_tpu_torch.cluster.announcer import Announcer
    from dragonfly2_tpu_torch.config.config import TrainerConfig
    from dragonfly2_tpu_torch.models import GraphSAGERanker, ProbeRTTRegressor
    from dragonfly2_tpu_torch.models.attention import AttentionRanker
    from dragonfly2_tpu_torch.models.convert import params_to_flax
    from dragonfly2_tpu_torch.records.storage import HostTraceStorage
    from dragonfly2_tpu_torch.registry import ModelRegistry
    from dragonfly2_tpu_torch.training import train

    for rec in topology:  # phase 11's snapshot beside phase 10's
        storage.create_network_topology(rec)
    storage.flush()
    with tempfile.TemporaryDirectory() as root, _trainer_calls(trainer_service) as calls:
        registry = ModelRegistry(os.path.join(root, "registry"))
        config = TrainerConfig(train_attention=True, checkpoint_dir=os.path.join(root, "ck"))
        service = trainer_service.TrainerService(
            HostTraceStorage(os.path.join(root, "trainer")), registry, config)
        announcer = Announcer(TRAINER_HOST_ID, storage, service, interval_seconds=0)
        start = time.perf_counter()
        if not announcer.maybe_announce():
            _fail("the announcer did not announce")
        announce_s = time.perf_counter() - start
        if set(calls) != {"gnn", "attention", "mlp"}:
            _fail(f"the service trained {sorted(calls)}, not the three families")
        ds, graph = calls["gnn"]["args"][:2]
        x = calls["mlp"]["args"][0]
        print(f"trainer: maybe_announce {announce_s:.2f} s (host clock) over "
              f"{storage.downloads.count()} download rows ({len(ds.mask)} ranking rows on "
              f"{graph.node_feats.shape[0]} hosts, {graph.edge_src.shape[0]} edges) and "
              f"{len(x)} topology pairs; TrainerConfig hidden {config.hidden_dim}, batch "
              f"{config.batch_size}, lr {config.learning_rate}, {config.epochs} epochs ({card})")
        for family in ("gnn", "attention", "mlp"):
            c = calls[family]
            res = c["result"]
            if not res.losses or not np.isfinite(res.losses).all():
                _fail(f"the {family} training's losses are not finite")
            means = _epoch_means(res, config.epochs)
            print(f"trainer: {family} {res.steps} steps in {c['wall_s']:.2f} s (eval and "
                  f"set-up included), {res.samples_per_sec:.1f} samples/s, peak "
                  f"{res.peak_samples_per_sec:.1f}; epoch mean loss {means[0]:.4f} -> "
                  f"{means[-1]:.4f}; eval {res.eval_metrics}; flash launches "
                  f"{ {k: v for k, v in c['counts'].items() if v} }")
            if family != "attention" and not means[-1] < means[0]:
                _fail(f"the {family}'s last epoch's mean loss is not below its first")
        for family in ("gnn", "mlp"):
            if any(calls[family]["counts"].values()) or any(calls[family]["wide"].values()):
                _fail(f"the {family} training launched a flash kernel: {calls[family]['counts']}")
        att = calls["attention"]
        steps, layers = att["result"].steps, config.attention_num_layers
        want = {name: steps * layers for name in TRAINING_KERNELS}
        got = {name: att["counts"][name] for name in TRAINING_KERNELS}
        if got != want:
            _fail(f"the attention training launched {got}, want {want} (once a layer a step)")
        print(f"trainer: the attention training launched each training kernel once a layer a "
              f"step: {got} over {steps} steps of {layers} layers")
        if any(p.is_file() for p in pathlib.Path(root, "ck").rglob("*")):
            _fail("the checkpoint directory is not empty after the service's success")

        gnn = calls["gnn"]["result"]
        garrs, dense = train.gnn_graph_arrays(graph)
        bound = train.gnn_roofline_bound(
            n_nodes=graph.node_feats.shape[0], node_feat_dim=graph.node_feats.shape[1],
            edge_feat_dim=graph.edge_feats.shape[1], hidden=config.hidden_dim,
            batch=min(config.batch_size, len(ds.mask)), parents=ds.parent_host_idx.shape[1],
            pair_feat_dim=2, dense_adj=dense)
        achieved = gnn.analytic_flops_per_sample * gnn.samples_per_sec
        print(f"trainer: GNN analytic_gnn_flops_per_sample {gnn.analytic_flops_per_sample:.4g} "
              f"(dense {dense}); achieved {achieved / 1e12:.4f} TFLOP/s = "
              f"{100 * achieved / PEAK_OPS_PER_S['bfloat16']:.3f}% of the card's bf16 peak; "
              f"gnn_roofline_bound at this shape: step_time_us_lb {bound['step_time_us_lb']}, "
              f"mfu_ceiling_pct {bound['mfu_ceiling_pct']} ({bound['statement']})")
        mlp = calls["mlp"]["result"]
        print(f"trainer: GNN precision {gnn.eval_metrics['precision']:.4f}, recall "
              f"{gnn.eval_metrics['recall']:.4f}, F1 {gnn.eval_metrics['f1']:.4f}, recall_ceiling "
              f"{gnn.eval_metrics['recall_ceiling']:.4f}; MLP MSE {mlp.eval_metrics['mse']:.4f}, "
              f"MAE {mlp.eval_metrics['mae']:.4f}")

        templates = {
            trainer_service.GNN_MODEL_NAME: GraphSAGERanker(config.hidden_dim),
            trainer_service.ATTENTION_MODEL_NAME: AttentionRanker(config.hidden_dim,
                                                                  in_features=26),
            trainer_service.MLP_MODEL_NAME: ProbeRTTRegressor(config.hidden_dim),
        }
        for name, module in templates.items():
            mid = registry.model_id(name, TRAINER_HOST_ID)
            active = registry.active_version(mid)
            if active is None or active.state != "active":
                _fail(f"{name} has no active version")
            registry.load_params(mid, active.version, template=params_to_flax(module))
        print(f"trainer: {len(templates)} versions active in the filesystem ModelRegistry, each "
              "loading against its serving module's shapes: "
              + ", ".join(f"{m['model_id']} v{m['active_version']}"
                          for m in registry.list_models()))

        _trainer_replays(calls, config, garrs)
        _trainer_timings(calls, config, garrs)
        _trainer_resume(calls["mlp"]["args"][0], calls["mlp"]["args"][1], config, root)
        _trainer_serve(registry, rule_cost)


# ------------------------------------------------------------------ phase 15

PROC_HOSTS = 1024
PROC_TASKS = 16
PROC_DOWNLOADS = 4096  # the tasks' first peers included
PROC_CROWD = 1024  # registrations of the flash crowd, sent in one burst
PROC_ML_DOWNLOADS = 256  # after the ml arm serves the trained GNN
# finished peers of each task that leave before the crowd: 4,096 downloads
# fill the 16 tasks' DAGs (Config's max_peers_per_task, 256)
PROC_CHURN = (PROC_CROWD + PROC_ML_DOWNLOADS) // PROC_TASKS
PROC_PIECE, PROC_PIECES = 4 << 20, 4
PROC_INFLIGHT = 128  # downloads in flight at once
PROC_DIALS = 64  # connections dialled at once (the server's listen backlog is 100)
PROC_FILES = 4 * PROC_HOSTS  # open files this process and the scheduler need
PROC_BUCKET = TASK_BUCKETS[-2]  # a tick above this many peers fills the largest bucket
PROC_PROBE_SOURCES, PROC_PROBE_COUNT = 64, 10
# seconds between the scheduler's uploads: the first comes at the wire
# play's end (its 4,096 downloads end 37-63 s after READY on the card; a
# slower play's last rows go in the next upload, which comes after the
# checks), the next this long after the first training answered, long
# after the checks: SIGTERM must not meet a training, which the trainer
# finishes before it exits. 60 s before the whole run was cut to fit its
# time limit (the phase waited up to 23 s for the first upload)
PROC_ANNOUNCE_S = 45.0
# the scheduler's network topology collect ticker (2 h in the Go
# scheduler): snapshots land after the probe rounds and before the upload
PROC_TOPOLOGY_S = 15.0
PROC_REFRESH_S = 1.0  # the ml arm's refresh loop
PROC_READY_S = 180.0
PROC_VERSIONS_S = 300.0  # from the scheduler's start to three active versions
PROC_STOP_S = 10.0
PROC_INFER_N, PROC_INFER_CALLS = 256, 20
PROC_SCHED_ID = "chip-smoke-scheduler"


class _Process:
    """One launcher process: its READY line and the seconds it took, its
    stderr in a file, and a SIGTERM stop that must exit 0 in time."""

    def __init__(self, name: str, args: list, tree: str, log_path: str, env=None):
        self.name, self.log_path = name, log_path
        env = dict(os.environ, PYTHONPATH=tree, **(env or {}))
        start = time.perf_counter()
        with open(log_path, "w") as log:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "dragonfly2_tpu_torch.cmd", *args], cwd=tree, env=env,
                stdout=subprocess.PIPE, stderr=log, text=True)
        line: list = []
        reader = threading.Thread(target=lambda: line.append(self.proc.stdout.readline()),
                                  daemon=True)
        reader.start()
        reader.join(PROC_READY_S)
        self.ready_at = time.perf_counter()
        self.ready_s = self.ready_at - start
        if not line or not line[0].startswith("READY"):
            self.kill()
            _fail(f"the {name} process printed no READY line in {self.ready_s:.1f} s "
                  f"(rc {self.proc.returncode}): {line}; its log ends: {self.log()[-3000:]}")
        self.ready = line[0].split()

    def log(self) -> str:
        with open(self.log_path) as f:
            return f.read()

    def alive(self) -> bool:
        return self.proc.poll() is None

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()

    def stop(self) -> float:
        if not self.alive():
            _fail(f"the {self.name} process died (rc {self.proc.returncode}): "
                  f"{self.log()[-3000:]}")
        start = time.perf_counter()
        self.proc.send_signal(signal.SIGTERM)
        try:
            rc = self.proc.wait(timeout=PROC_STOP_S)
        except subprocess.TimeoutExpired:
            self.kill()
            _fail(f"the {self.name} process did not exit within {PROC_STOP_S} s of SIGTERM")
        seconds = time.perf_counter() - start
        if rc != 0:
            _fail(f"the {self.name} process exited {rc} on SIGTERM: {self.log()[-3000:]}")
        return seconds


def _proc_hosts(msg):
    return [msg.HostInfo(host_id=f"proc-host-{i}", hostname=f"proc-node-{i}",
                         ip=f"10.{64 + i // 256}.{i % 256}.1", idc=f"idc-{i % 4}",
                         location=f"region-{i % 2}|zone-{i % 8}", port=8002, download_port=8001)
            for i in range(PROC_HOSTS)]


def _raise_open_files() -> None:
    """Room for one connection a daemon host on both ends: this process's
    soft limit of open files, which the launchers inherit, raised to the
    hard limit where it is below PROC_FILES."""
    import resource

    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    if soft != resource.RLIM_INFINITY and soft < PROC_FILES:
        if hard != resource.RLIM_INFINITY and hard < PROC_FILES:
            _fail(f"the hard limit of open files is {hard}; {PROC_HOSTS} daemon connections "
                  f"need {PROC_FILES}")
        resource.setrlimit(resource.RLIMIT_NOFILE, (PROC_FILES, hard))


class _WirePeers:
    """Daemons over the wire, as a dfdaemon's conductor plays them: each
    daemon host a SchedulerClientPool with its own connection to the
    scheduler; register, wait for the answer, then back-source or fetch
    the pieces from the parents the tick picked, and finish. Each answer's
    tick is known by the tick span id the server sends with it."""

    def __init__(self, host: str, port: int):
        from dragonfly2_tpu_torch.cluster import messages as msg

        self.msg, self.host, self.port = msg, host, port
        self.hosts = _proc_hosts(msg)
        self.latency_ms: list = []
        self.arrived: list = []
        self.ticks: list = []  # the tick span id of each answer, in arrival order
        self.answers = collections.Counter()
        self.pools, self.conns = [], []
        self.dirty: set = set()  # hosts whose frames no barrier has covered

    async def open(self) -> None:
        from dragonfly2_tpu_torch.rpc.client import SchedulerClientPool

        self.pools = [SchedulerClientPool([(self.host, self.port)]) for _ in self.hosts]
        gate = asyncio.Semaphore(PROC_DIALS)

        async def dial(h):
            async with gate:
                return await self.pools[h].for_task(self.hosts[h].host_id)

        self.conns = await asyncio.gather(*(dial(h) for h in range(len(self.hosts))))

    async def close(self) -> None:
        await asyncio.gather(*(pool.close() for pool in self.pools))

    def conn(self, h: int):
        self.dirty.add(h)
        return self.conns[h]

    async def barrier(self) -> None:
        """Every frame sent so far has been applied: one round trip on
        each connection that sent since the last barrier (the server reads
        a connection's frames in order)."""
        hosts, self.dirty = sorted(self.dirty), set()
        await asyncio.gather(*(self.conns[h].stat_task("barrier", timeout=120) for h in hosts))

    async def announce(self) -> None:
        for i, h in enumerate(self.hosts):
            await self.conn(i).send(self.msg.AnnounceHostRequest(host=h))
        await self.barrier()

    async def probe(self) -> int:
        pairs = 0
        for s in range(PROC_PROBE_SOURCES):
            src = self.hosts[s * (PROC_HOSTS // PROC_PROBE_SOURCES)]
            targets = await self.conn(s).sync_probes(src.host_id, count=PROC_PROBE_COUNT,
                                                     timeout=120)
            await self.conn(s).send(self.msg.ProbeFinishedRequest(host_id=src.host_id, results=[
                self.msg.ProbeResult(host_id=t.host_id, rtt_ns=(200 + 37 * ((s + j) % 23)) * 1000)
                for j, t in enumerate(targets)]))
            pairs += len(targets)
        await self.barrier()
        return pairs

    async def leave(self, items) -> None:
        for peer_id, _, h in items:
            await self.conn(h).send(self.msg.LeavePeerRequest(peer_id=peer_id))
        await self.barrier()

    async def register(self, peer_id: str, task_id: str, h: int):
        """Send one registration; returns its response queue and send time."""
        conn = self.conn(h)
        queue = conn.subscribe(peer_id)
        start = time.perf_counter()
        await conn.send(self.msg.RegisterPeerRequest(
            peer_id=peer_id, task_id=task_id, host=self.hosts[h],
            url=f"https://origin.example/{task_id}.bin",
            content_length=PROC_PIECE * PROC_PIECES, piece_length=PROC_PIECE))
        return queue, start

    async def answer(self, peer_id: str, h: int, queue, start: float):
        """The tick's answer to a registration, its latency recorded."""
        answer = await asyncio.wait_for(queue.get(), 300)
        self.arrived.append(time.perf_counter())
        self.latency_ms.append((self.arrived[-1] - start) * 1e3)
        self.ticks.append((getattr(answer, "trace_context", None) or {}).get("span_id"))
        self.conn(h).unsubscribe(peer_id)
        self.answers[type(answer).__name__] += 1
        return answer

    async def finish(self, peer_id: str, h: int, answer) -> None:
        """Back-source, or fetch the pieces from the tick's parents; finish."""
        m, conn = self.msg, self.conn(h)
        kind = type(answer).__name__
        cost = (2 + h % 8) * 1_000_000
        if kind == "NeedBackToSourceResponse":
            await conn.send(m.DownloadPeerBackToSourceStartedRequest(peer_id=peer_id))
            for n in range(PROC_PIECES):
                await conn.send(m.DownloadPieceFinishedRequest(
                    peer_id=peer_id, piece_number=n, length=PROC_PIECE, cost_ns=cost))
            await conn.send(m.DownloadPeerBackToSourceFinishedRequest(
                peer_id=peer_id, content_length=PROC_PIECE * PROC_PIECES,
                piece_count=PROC_PIECES))
        elif kind == "NormalTaskResponse" and answer.candidate_parents:
            parents = answer.candidate_parents
            for n in range(PROC_PIECES):
                await conn.send(m.DownloadPieceFinishedRequest(
                    peer_id=peer_id, piece_number=n, length=PROC_PIECE, cost_ns=cost,
                    parent_peer_id=parents[n % len(parents)].peer_id))
            await conn.send(m.DownloadPeerFinishedRequest(
                peer_id=peer_id, content_length=PROC_PIECE * PROC_PIECES,
                piece_count=PROC_PIECES))
        else:
            _fail(f"peer {peer_id}: the scheduler answered {answer}")

    async def downloads(self, items, limit: int = PROC_INFLIGHT) -> None:
        gate = asyncio.Semaphore(limit)

        async def one(peer_id, task_id, h):
            async with gate:
                queue, start = await self.register(peer_id, task_id, h)
                await self.finish(peer_id, h, await self.answer(peer_id, h, queue, start))

        await asyncio.gather(*(one(*item) for item in items))
        await self.barrier()

    async def crowd(self, items) -> float:
        """Every registration sent in one burst, then every answer awaited;
        returns the ms from the first send to the last answer."""
        start = time.perf_counter()
        sent = [(peer_id, h, *(await self.register(peer_id, task_id, h)))
                for peer_id, task_id, h in items]
        self.crowd_sent_ms = (time.perf_counter() - start) * 1e3
        gate = asyncio.Semaphore(PROC_INFLIGHT)
        first = len(self.arrived)

        async def one(peer_id, h, queue, t0):
            answer = await self.answer(peer_id, h, queue, t0)
            async with gate:
                await self.finish(peer_id, h, answer)

        await asyncio.gather(*(one(*s) for s in sent))
        await self.barrier()
        return (max(self.arrived[first:]) - start) * 1e3

    def tick_sizes(self, first: int = 0, last: int | None = None) -> list:
        """Peers answered by each tick, for the answers first:last, largest first."""
        ticks = self.ticks[first:last]
        if None in ticks:
            _fail("an answer came without its tick's span id")
        return sorted(collections.Counter(ticks).values(), reverse=True)


class _Watcher(threading.Thread):
    """Polls the trainer's /metrics and the registry every 0.1 s from the
    processes' start: the first announce upload's time (the trainer's
    first dataset chunk) and the time all three versions are active."""

    def __init__(self, metrics_port: int, registry, names):
        super().__init__(name="proc-watcher", daemon=True)
        self.metrics_port, self.registry, self.names = metrics_port, registry, names
        self.upload_at = self.active_at = None
        self.versions = None
        self.halt = threading.Event()

    def run(self) -> None:
        reg = self.registry
        while not self.halt.is_set() and self.active_at is None:
            now = time.perf_counter()
            if self.upload_at is None:
                try:
                    got = _scrape(self.metrics_port)
                except OSError:
                    got = {}
                if any(k.startswith("dragonfly_trainer_train_chunks_total") for k in got):
                    self.upload_at = now
            else:
                try:
                    versions = {n: reg.active_version(reg.model_id(n, PROC_SCHED_ID))
                                for n in self.names}
                except (OSError, ValueError):
                    versions = {}
                if versions and all(v is not None for v in versions.values()):
                    self.versions, self.active_at = versions, now
            self.halt.wait(0.1)


def _dispatch_ms(device, requests) -> float:
    """Host ms of one RegisterPeer dispatch on the card without the wire:
    SchedulerRPCServer._dispatch under svc.mu, as its pool threads run it,
    on a service at Config()'s defaults, its hosts announced first."""
    from dragonfly2_tpu_torch.cluster import messages as msg
    from dragonfly2_tpu_torch.cluster.probes import ProbeStore
    from dragonfly2_tpu_torch.cluster.scheduler import SchedulerService
    from dragonfly2_tpu_torch.config.config import Config
    from dragonfly2_tpu_torch.rpc.server import SchedulerRPCServer

    cfg = Config()
    svc = SchedulerService(config=cfg, device=device, probes=ProbeStore(
        max_hosts=cfg.scheduler.max_hosts, device=device))
    server, owned = SchedulerRPCServer(svc), set()
    for h in _proc_hosts(msg):
        with svc.mu:
            server._dispatch(msg.AnnounceHostRequest(host=h), owned)
    start = time.perf_counter()
    for request in requests:
        with svc.mu:
            server._dispatch(request, owned)
    return (time.perf_counter() - start) * 1e3 / len(requests)


def _scrape(port: int) -> dict:
    """The monitor's /metrics as {name{labels}: value}."""
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=30) as r:
        text = r.read().decode()
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            key, _, value = line.rpartition(" ")
            out[key] = float(value)
    return out


def _wait_for(predicate, timeout: float, what: str, procs=()):
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        value = predicate()
        if value:
            return value
        for p in procs:
            if not p.alive():
                _fail(f"the {p.name} process died while waiting for {what} (rc "
                      f"{p.proc.returncode}): {p.log()[-3000:]}")
        time.sleep(0.1)
    _fail(f"timed out after {timeout:.0f} s waiting for {what}")


def _pct(values, q: float) -> float:
    return float(np.percentile(np.asarray(values, np.float64), q))


@_phase("processes")
def phase_processes(card: str, tree: str, device=None, trainer_config=None) -> None:
    """Slice 19's main path: the port's trainer and scheduler as processes
    on the card through python -m dragonfly2_tpu_torch.cmd, with daemons
    played over the wire from this process (the module docstring, phase
    15). ``device`` and ``trainer_config`` are for a rehearsal on the CPU."""
    import torch

    from dragonfly2_tpu_torch.cluster.trainer_service import (
        ATTENTION_MODEL_NAME, GNN_MODEL_NAME, MLP_MODEL_NAME,
    )
    from dragonfly2_tpu_torch.ops import flash
    from dragonfly2_tpu_torch.registry import ModelRegistry, ModelServer
    from dragonfly2_tpu_torch.rpc.inference import InferenceClient

    if torch.cuda.is_available():
        torch.cuda.empty_cache()  # the earlier phases' cached blocks, for the two processes
    dev_args = ["--device", device] if device else []
    _raise_open_files()
    procs: list = []
    watcher = None
    with tempfile.TemporaryDirectory(prefix="dfly-procs-") as root:
        registry_dir = os.path.join(root, "registry")
        sched_dir = os.path.join(root, "scheduler")
        config_path = os.path.join(root, "trainer.json")
        with open(config_path, "w") as f:
            json.dump({"trainer": {"train_attention": True, **(trainer_config or {})}}, f)
        try:
            trainer = _Process("trainer", [
                "trainer", *dev_args, "--data-dir", os.path.join(root, "trainer"),
                "--registry-dir", registry_dir, "--config", config_path, "--metrics-port", "0"],
                tree, os.path.join(root, "trainer.log"))
            procs.append(trainer)
            t_host, t_port, t_metrics = trainer.ready[1], trainer.ready[2], int(trainer.ready[4])
            sched = _Process("scheduler", [
                "scheduler", *dev_args, "--data-dir", sched_dir, "--registry-dir", registry_dir,
                "--algorithm", "ml", "--trainer", f"{t_host}:{t_port}",
                "--announce-interval", str(PROC_ANNOUNCE_S),
                "--network-topology-collect-interval", str(PROC_TOPOLOGY_S),
                "--ml-refresh-interval", str(PROC_REFRESH_S),
                "--scheduler-host-id", PROC_SCHED_ID, "--metrics-port", "0"],
                tree, os.path.join(root, "scheduler.log"))
            procs.append(sched)
            sched_start = time.perf_counter() - sched.ready_s
            registry = ModelRegistry(registry_dir)
            watcher = _Watcher(t_metrics, registry,
                               (GNN_MODEL_NAME, ATTENTION_MODEL_NAME, MLP_MODEL_NAME))
            watcher.start()
            r = sched.ready
            if r[3] != "INFER" or r[6] != "METRICS":
                _fail(f"the scheduler's READY line lacks INFER or METRICS: {' '.join(r)}")
            s_host, s_port, i_port, s_metrics = r[1], int(r[2]), int(r[5]), int(r[7])
            print(f"processes: READY after {trainer.ready_s:.2f} s (trainer: "
                  f"{' '.join(trainer.ready)}) and {sched.ready_s:.2f} s (scheduler: "
                  f"{' '.join(r)}), from process start, host clock ({card})")

            # -- the daemons over the wire
            peers = _WirePeers(s_host, s_port)
            rng = np.random.default_rng(SEED)

            async def play():
                t_dial = time.perf_counter()
                await peers.open()
                try:
                    t0 = time.perf_counter()
                    await peers.announce()
                    pairs = await peers.probe()
                    t1 = time.perf_counter()
                    await peers.downloads([(f"proc-t{t}-p0", f"proc-task-{t}", t * 61 % PROC_HOSTS)
                                           for t in range(PROC_TASKS)])
                    rest = [(f"proc-t{t}-p{i}", f"proc-task-{t}", int(h))
                            for i in range(1, PROC_DOWNLOADS // PROC_TASKS)
                            for t, h in zip(range(PROC_TASKS),
                                            rng.integers(0, PROC_HOSTS, PROC_TASKS))]
                    await peers.downloads(rest)
                    t2 = time.perf_counter()
                    downloads_ms = list(peers.latency_ms)
                    await peers.leave(rest[:PROC_CHURN * PROC_TASKS])
                    # one registration from each of the crowd's hosts
                    crowd = [(f"proc-crowd-{i}", f"proc-task-{i % PROC_TASKS}", int(h))
                             for i, h in enumerate(rng.permutation(PROC_HOSTS)[:PROC_CROWD])]
                    before = await asyncio.to_thread(_scrape, s_metrics)
                    crowd_ms = await peers.crowd(crowd)
                    return (pairs, downloads_ms, crowd_ms, before, t0 - t_dial, t1 - t0, t2 - t1,
                            time.perf_counter() - t2)
                finally:
                    await peers.close()

            (pairs, downloads_ms, crowd_ms, before, dial_s, setup_s, play_s,
             crowd_s) = asyncio.run(play())
            play_done = time.perf_counter()
            n_down = len(downloads_ms)
            if n_down != PROC_DOWNLOADS or sum(peers.answers.values()) != PROC_DOWNLOADS + PROC_CROWD:
                _fail(f"answers {dict(peers.answers)} for {PROC_DOWNLOADS} downloads and "
                      f"{PROC_CROWD} in the crowd")
            crowd_lat = peers.latency_ms[n_down:]
            down_ticks, crowd_ticks = peers.tick_sizes(0, n_down), peers.tick_sizes(n_down)
            print(f"processes: {PROC_HOSTS} connections dialled, one a daemon host, in "
                  f"{dial_s:.2f} s; {PROC_HOSTS} hosts announced and {pairs} probe pairs reported "
                  f"in {setup_s:.2f} s; {PROC_DOWNLOADS} downloads of {PROC_TASKS} tasks "
                  f"({PROC_PIECES} pieces each, {PROC_INFLIGHT} in flight) in "
                  f"{play_s:.2f} s, every one answered by the tick "
                  f"({dict(peers.answers)} with the crowd); RegisterPeer to answer p50 "
                  f"{_pct(downloads_ms, 50):.3f} ms p99 {_pct(downloads_ms, 99):.3f} ms (host "
                  f"clock of this process, which plays the daemons and sets the pace); "
                  f"{PROC_CHURN * PROC_TASKS} finished peers left, then a flash crowd of "
                  f"{PROC_CROWD} sent in one burst: last answer {crowd_ms:.1f} ms after the "
                  f"first send (answers p50 {_pct(crowd_lat, 50):.1f} ms p99 "
                  f"{_pct(crowd_lat, 99):.1f} ms), finished in {crowd_s:.2f} s ({card})")
            m = _scrape(s_metrics)
            crowd_hist = {k.split('le="')[1].rstrip('"}'): m[k] - before.get(k, 0.0) for k in m
                          if k.startswith("dragonfly_scheduler_tick_batch_size_bucket")}
            crowd_phases = {k.split('phase="')[1].rstrip('"}'): 1e3 * (m[k] - before.get(k, 0.0))
                            for k in m if k.startswith("dragonfly_scheduler_tick_phase_seconds_sum")}
            tick_key = "dragonfly_scheduler_tick_seconds_sum"
            crowd_tick_ms = 1e3 * (m.get(tick_key, 0.0) - before.get(tick_key, 0.0))
            print(f"processes: peers each tick answered (by the tick span id on each answer): "
                  f"the downloads {len(down_ticks)} ticks, largest {down_ticks[:5]}, median "
                  f"{statistics.median(down_ticks)}; the crowd {len(crowd_ticks)} ticks, sizes "
                  f"{crowd_ticks[:8]}{' ...' if len(crowd_ticks) > 8 else ''}; the crowd's ticks "
                  f"in /metrics' peers-a-tick buckets, cumulative {crowd_hist}")
            print(f"processes: the crowd's time: its {PROC_CROWD} frames sent in "
                  f"{peers.crowd_sent_ms:.1f} ms (this process); first answer "
                  f"{min(crowd_lat):.1f} ms, last {crowd_ms:.1f} ms after the first send; its "
                  f"ticks {crowd_tick_ms:.1f} ms in all (the server's clock from a tick's start "
                  f"to its thread's return, its wait for a pool thread and svc.mu included), "
                  f"phases inside svc.tick() (ms, summed) "
                  f"{ {k: round(v, 3) for k, v in crowd_phases.items() if v} } ({card})")
            if crowd_ticks[0] <= PROC_BUCKET:
                _fail(f"no tick of the crowd held more than {PROC_BUCKET} peers (largest "
                      f"{crowd_ticks[0]}): the largest bucket was never filled")
            ticks = m.get("dragonfly_scheduler_tick_seconds_count", 0.0)
            tick_sum = m.get("dragonfly_scheduler_tick_seconds_sum", 0.0)
            batches = {k.split('le="')[1].rstrip('"}'): v for k, v in m.items()
                       if k.startswith("dragonfly_scheduler_tick_batch_size_bucket")}
            tick_buckets = {k.split('le="')[1].rstrip('"}'): v for k, v in m.items()
                            if k.startswith("dragonfly_scheduler_tick_seconds_bucket")}
            announce = {k.split('type="')[1].rstrip('"}'): v for k, v in m.items()
                        if k.startswith("dragonfly_scheduler_announce_peer_total{")}
            registered = announce.get("RegisterPeerRequest", 0.0)
            print(f"processes: scheduler /metrics: {ticks:.0f} ticks, mean "
                  f"{1e3 * tick_sum / max(ticks, 1):.3f} ms (the server's clock around the tick "
                  f"thread); tick_seconds buckets {tick_buckets}; peers a tick, cumulative "
                  f"buckets {batches}; announce_peer totals {announce}")
            if registered != PROC_DOWNLOADS + PROC_CROWD:
                _fail(f"the scheduler counted {registered} RegisterPeer frames")
            if ticks <= 0:
                _fail("the scheduler's /metrics shows no tick")

            # -- the trainer: three active versions in the registry
            _wait_for(lambda: watcher.active_at, PROC_VERSIONS_S,
                      "the first upload and three active versions", procs)
            versions = watcher.versions
            print(f"processes: first announce upload seen {watcher.upload_at - sched_start:.1f} s "
                  f"after the scheduler started (the play took {play_done - sched_start:.1f} s); "
                  f"three versions active {watcher.active_at - watcher.upload_at:.2f} s after the "
                  f"upload (host clock, polled every 0.1 s): "
                  + ", ".join(f"{n} v{v.version}" for n, v in versions.items()))
            gnn_version = versions[GNN_MODEL_NAME].version
            line = f"ml evaluator serving model version {gnn_version}"
            _wait_for(lambda: line in sched.log(), 120, f"the scheduler's log line '{line}'",
                      procs)

            # -- the ml arm scores ticks with the trained GNN
            peers2 = _WirePeers(s_host, s_port)

            async def ml_play():
                await peers2.open()
                try:
                    await peers2.downloads([(f"proc-ml-{i}", f"proc-task-{i % PROC_TASKS}",
                                             int(rng.integers(0, PROC_HOSTS)))
                                            for i in range(PROC_ML_DOWNLOADS)])
                finally:
                    await peers2.close()

            asyncio.run(ml_play())
            m = _scrape(s_metrics)
            accepted = m.get("dragonfly_serving_activation_accepted_total", 0.0)
            rejected = sum(v for k, v in m.items()
                           if k.startswith("dragonfly_serving_activation_rejected_total"))
            print(f"processes: the scheduler's ml arm serves the trained GNN v{gnn_version} (its "
                  f"log: '{line}'; activation gate accepted {accepted:.0f}, rejected "
                  f"{rejected:.0f}); {PROC_ML_DOWNLOADS} more downloads on it, answers "
                  f"{dict(peers2.answers)}, p50 {_pct(peers2.latency_ms, 50):.3f} ms")
            if accepted < 1 or rejected or sum(peers2.answers.values()) != PROC_ML_DOWNLOADS:
                _fail("the ml arm did not serve the trained GNN")

            # -- ModelInfer on the attention version, against this process
            batch = _requests(PROC_INFER_N, rng)

            async def infer():
                client = await InferenceClient(s_host, i_port).connect()
                try:
                    if not await client.model_ready(ATTENTION_MODEL_NAME):
                        _fail("ModelReady answered false for the attention version")
                    meta = await client.model_metadata(ATTENTION_MODEL_NAME)
                    times, outs = [], []
                    for i in range(PROC_INFER_CALLS + 1):
                        start = time.perf_counter()
                        out = await client.model_infer(ATTENTION_MODEL_NAME, batch,
                                                       request_id=f"proc-{i}")
                        times.append((time.perf_counter() - start) * 1e3)
                        outs.append(out["scores"])
                    return meta, times, outs
                finally:
                    await client.close()

            meta, times, outs = asyncio.run(infer())
            want_version = str(versions[ATTENTION_MODEL_NAME].version)
            if meta.versions != [want_version]:
                _fail(f"the INFER port serves {meta.versions}, the registry has {want_version}")
            if any(not np.array_equal(o, outs[0]) for o in outs):
                _fail("repeated ModelInfer requests answered differently")
            local = ModelServer(registry, ATTENTION_MODEL_NAME, PROC_SCHED_ID, "attention",
                                device=device)
            if not local.refresh() or str(local.version) != want_version:
                _fail("this process's ModelServer did not load the attention version")
            _zero_counts()
            direct = local.score_set(batch["child_feats"], batch["parent_feats"],
                                     batch["pair_feats"], batch["mask"]).cpu().numpy()
            launched = flash.LAUNCHES
            mask = batch["mask"]
            if not np.isfinite(outs[0][mask]).all():
                _fail("ModelInfer: non-finite score at a valid slot")
            equal = np.array_equal(outs[0], direct)
            print(f"processes: ModelInfer {ATTENTION_MODEL_NAME} v{want_version} at N = "
                  f"{PROC_INFER_N} x {CANDIDATES} over the INFER port: p50 "
                  f"{statistics.median(times[1:]):.3f} ms over {PROC_INFER_CALLS} warm calls "
                  f"(first {times[0]:.3f} ms; host clock); this process's ModelServer on the same "
                  f"card and inputs: {'equal bit for bit' if equal else 'DIFFERENT'} (bf16 "
                  f"ranker, float32 scores), flash_fwd launches {launched} in that call "
                  f"(once a layer)")
            if not equal:
                _fail(f"ModelInfer over the wire differs from this process's ModelServer by "
                      f"{float(np.abs(outs[0][mask] - direct[mask]).max())}")
            if device is None and launched != local.model.num_layers:
                _fail(f"the in-process ModelServer launched flash_fwd {launched} times")

            # -- shutdown: the scheduler flushes its trace rows, both exit 0;
            # the scheduler first, before its next upload can start a training
            since = time.perf_counter() - watcher.active_at
            if since > PROC_ANNOUNCE_S - 5:
                _fail(f"the checks took {since:.0f} s after the versions went active: the "
                      f"scheduler's next upload ({PROC_ANNOUNCE_S:.0f} s) may have begun")
            stop_s = {p.name: p.stop() for p in (sched, trainer)}
            rows = 0
            for path in pathlib.Path(sched_dir).glob("download*.csv"):
                with open(path) as f:
                    rows += sum(1 for _ in f) - 1
            done = PROC_DOWNLOADS + PROC_CROWD + PROC_ML_DOWNLOADS
            print(f"processes: SIGTERM -> exit 0 in {stop_s['scheduler']:.2f} s (scheduler) and "
                  f"{stop_s['trainer']:.2f} s (trainer); {rows} download rows on disk for "
                  f"{done} finished downloads")
            if rows < done:
                _fail(f"{rows} download trace rows on disk, fewer than the {done} downloads")

            # -- what one RegisterPeer dispatch costs the server, without the wire
            reqs = [peers.msg.RegisterPeerRequest(
                peer_id=f"proc-cost-{i}", task_id=f"proc-task-{i % PROC_TASKS}",
                host=peers.hosts[i], url=f"https://origin.example/proc-task-{i % PROC_TASKS}.bin",
                content_length=PROC_PIECE * PROC_PIECES, piece_length=PROC_PIECE)
                for i in range(PROC_CROWD)]
            per = _dispatch_ms(device or "cuda", reqs)
            print(f"processes: one RegisterPeer dispatch in this process (SchedulerRPCServer."
                  f"_dispatch under svc.mu on a Config() service on {device or 'the card'}, no "
                  f"wire, no thread hop): {per:.3f} ms, host clock, the mean of {PROC_CROWD}; "
                  f"the crowd's {PROC_CROWD} would take {per * PROC_CROWD:.1f} ms in a row "
                  f"({card})")
        finally:
            if watcher is not None:
                watcher.halt.set()
                watcher.join(5)
            for p in procs:
                p.kill()


# ------------------------------------------------------------------ phase 16

DATA_DAEMONS = 16
DATA_BLOBS_MIB = (128, 64, 32, 16)  # one image's layers: 60 pieces of 4 MiB, 240 MiB
DATA_DFGETS = 2  # dfget processes pulling the first blob with --no-back-source
DATA_FETCH_S = 300.0  # a proxy answers after the whole download: its socket timeout
DATA_STOP_S = 10.0


class _DataOrigin:
    """The image's registry: its blobs over HTTP with Range support,
    counting HEADs, data GETs (the range probe included), piece GETs and
    the bytes sent."""

    def __init__(self, blobs: dict):
        import http.server

        self.blobs = blobs
        self.heads = self.gets = self.piece_gets = self.bytes = 0
        self.mu = threading.Lock()
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):
                pass

            def do_HEAD(self):
                with outer.mu:
                    outer.heads += 1
                self.send_response(200)
                self.send_header("Content-Length", str(len(outer.blobs[self.path])))
                self.end_headers()

            def do_GET(self):
                data, status = memoryview(outer.blobs[self.path]), 200
                rng = self.headers.get("Range")
                if rng and rng.startswith("bytes="):
                    start, _, end = rng[len("bytes="):].partition("-")
                    data = data[int(start or 0):int(end) + 1 if end else len(data)]
                    status = 206
                with outer.mu:
                    outer.gets += 1
                    outer.piece_gets += len(data) > 1  # not the bytes=0-0 range probe
                    outer.bytes += len(data)
                self.send_response(status)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.server.daemon_threads = True
        threading.Thread(target=self.server.serve_forever, daemon=True).start()
        self.base = f"http://127.0.0.1:{self.server.server_address[1]}"

    def counts(self) -> tuple:
        with self.mu:
            return self.heads, self.gets, self.piece_gets, self.bytes

    def stop(self) -> None:
        self.server.shutdown()
        self.server.server_close()


def _proxy_fetch(proxy_port: int, url: str) -> tuple:
    """One GET through a daemon's proxy: (sha256 of the body, bytes, the
    X-Dragonfly-Via header, seconds)."""
    import hashlib
    import urllib.request

    start = time.perf_counter()
    req = urllib.request.Request(url)
    req.set_proxy(f"127.0.0.1:{proxy_port}", "http")
    h, n = hashlib.sha256(), 0
    with urllib.request.urlopen(req, timeout=DATA_FETCH_S) as resp:
        via = resp.headers.get("X-Dragonfly-Via")
        while True:
            chunk = resp.read(1 << 20)
            if not chunk:
                break
            h.update(chunk)
            n += len(chunk)
    return h.hexdigest(), n, via, time.perf_counter() - start


def _cuda_pids() -> set | None:
    """PIDs holding a CUDA context, as nvidia-smi lists them (None where
    nvidia-smi does not answer)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if out.returncode != 0:
        return None
    return {int(w) for w in out.stdout.split() if w.strip().isdigit()}


def _maps_cuda(pid: int) -> bool:
    """Whether a process has the CUDA driver or torch mapped."""
    try:
        with open(f"/proc/{pid}/maps") as f:
            maps = f.read()
    except OSError:
        return False
    return "libcuda" in maps or "libtorch" in maps


def _no_cuda_context(procs: dict, listed: set | None) -> None:
    for name, pid in procs.items():
        if (listed is not None and pid in listed) or _maps_cuda(pid):
            _fail(f"the {name} process (pid {pid}) holds a CUDA context or maps torch")


def _tail_dominant(ports) -> dict:
    """Downloads by their dominant tail phase, summed over the daemons'
    /metrics (dragonfly_tail_dominant_total of their dfdaemon.tail)."""
    out: collections.Counter = collections.Counter()
    for port in ports:
        for key, value in _scrape(port).items():
            if key.startswith("dragonfly_tail_dominant_total{"):
                out[key.split('phase="')[1].split('"')[0]] += int(value)
    return dict(out)


def _tick_stats(m: dict) -> tuple:
    return (m.get("dragonfly_scheduler_tick_seconds_count", 0.0),
            m.get("dragonfly_scheduler_tick_batch_size_sum", 0.0),
            m.get("dragonfly_scheduler_tick_seconds_sum", 0.0),
            {k.split('le="')[1].rstrip('"}'): v for k, v in m.items()
             if k.startswith("dragonfly_scheduler_tick_batch_size_bucket")})


def _traffic(m: dict) -> dict:
    out: collections.Counter = collections.Counter()
    for key, value in m.items():
        if key.startswith("dragonfly_scheduler_traffic{"):
            out[key.split('type="')[1].split('"')[0]] += value
    return dict(out)


@_phase("data plane")
def phase_data_plane(card: str, tree: str, device=None, daemons=DATA_DAEMONS,
                     blobs_mib=DATA_BLOBS_MIB) -> None:
    """Slice 20's main path: 16 dfdaemon processes and 2 dfget processes
    move one image's blobs between peers the scheduler's tick on the card
    picks (the module docstring, phase 16). ``device``, ``daemons`` and
    ``blobs_mib`` are for a rehearsal on the CPU."""
    import concurrent.futures
    import hashlib

    _raise_open_files()
    rng = np.random.default_rng(SEED)
    blobs = {f"/v2/library/app/blobs/sha256-{i}": rng.integers(0, 256, mib << 20, dtype=np.uint8)
             .tobytes() for i, mib in enumerate(blobs_mib)}
    shas = {path: hashlib.sha256(b).hexdigest() for path, b in blobs.items()}
    image = sum(len(b) for b in blobs.values())
    origin = _DataOrigin(blobs)
    urls = [origin.base + path for path in blobs]
    dev_args = ["--device", device] if device else []
    procs: list = []
    with tempfile.TemporaryDirectory(prefix="dfly-data-") as root:
        try:
            sched = _Process("scheduler", [
                "scheduler", *dev_args, "--data-dir", os.path.join(root, "traces"),
                "--metrics-port", "0"], tree, os.path.join(root, "scheduler.log"))
            procs.append(sched)
            s_addr, s_metrics = f"{sched.ready[1]}:{sched.ready[2]}", int(sched.ready[4])

            def start(i):
                name = f"df-{i:02d}"
                return _Process(name, [
                    "dfdaemon", "--data-dir", os.path.join(root, name), "--scheduler", s_addr,
                    "--hostname", name, "--proxy", "--proxy-rule", "/blobs/",
                    "--metrics-port", "0"], tree, os.path.join(root, f"{name}.log"))

            with concurrent.futures.ThreadPoolExecutor(daemons) as pool:
                dfs = list(pool.map(start, range(daemons)))
            procs.extend(dfs)
            for d in dfs:
                if d.ready[3] != "PROXY" or d.ready[5] != "METRICS":
                    _fail(f"{d.name}'s READY line lacks PROXY or METRICS: {' '.join(d.ready)}")
            proxy = {d.name: int(d.ready[4]) for d in dfs}
            metrics = {d.name: int(d.ready[6]) for d in dfs}
            ready = sorted(d.ready_s for d in dfs)
            print(f"data plane: READY after {sched.ready_s:.2f} s (scheduler, {' '.join(sched.ready)}); "
                  f"{daemons} dfdaemons started together, READY p50 {statistics.median(ready):.2f} s "
                  f"max {ready[-1]:.2f} s (df-00: {' '.join(dfs[0].ready)}), host clock ({card})")
            m0 = _scrape(s_metrics)

            def fetch(name, url):
                digest, n, via, seconds = _proxy_fetch(proxy[name], url)
                path = url[len(origin.base):]
                if digest != shas[path] or n != len(blobs[path]) or via != "p2p":
                    _fail(f"{name} {path} through its proxy: sha256 {digest} ({n} bytes, via "
                          f"{via}), the origin's {shas[path]} ({len(blobs[path])} bytes)")
                return name, path, seconds

            # -- stage 1: the first node pulls the image and back-sources
            start_s = time.perf_counter()
            with concurrent.futures.ThreadPoolExecutor(len(urls)) as pool:
                list(pool.map(lambda u: fetch("df-00", u), urls))
            wall1 = time.perf_counter() - start_s
            heads1, gets1, pieces1, bytes1 = origin.counts()
            print(f"data plane: stage 1, df-00 pulls the image ({len(urls)} blobs, "
                  f"{image / 2**20:.0f} MiB) through its proxy: {wall1:.2f} s, "
                  f"{image / 2**20 / wall1:.1f} MiB/s; the origin served {gets1} data GETs "
                  f"({pieces1} pieces, {bytes1 / image:.3f} image) and {heads1} HEADs")
            m1 = _scrape(s_metrics)

            # -- stage 2: every other node pulls the image at once
            jobs = [(d.name, u) for d in dfs[1:] for u in urls]
            done_at = collections.defaultdict(list)
            start_s = time.perf_counter()
            listed = None
            with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
                futures = [pool.submit(fetch, name, u) for name, u in jobs]
                time.sleep(min(1.0, DATA_FETCH_S))
                listed = _cuda_pids()  # mid-stage, while every daemon downloads
                for f in concurrent.futures.as_completed(futures):
                    name, path, seconds = f.result()
                    done_at[path].append(time.perf_counter() - start_s)
            wall2 = time.perf_counter() - start_s
            heads2, gets2, pieces2, bytes2 = origin.counts()
            moved = (daemons - 1) * image
            per_blob = "; ".join(
                f"{len(blobs[p]) >> 20} MiB p50 {_pct(done_at[p], 50):.2f} s p99 "
                f"{_pct(done_at[p], 99):.2f} s" for p in blobs)
            print(f"data plane: stage 2, {daemons - 1} nodes pull the image at once ({len(jobs)} "
                  f"fetches in flight): wall {wall2:.2f} s, {moved / 2**20 / wall2:.1f} MiB/s "
                  f"aggregate; per-blob completion across nodes: {per_blob}")
            _no_cuda_context({d.name: d.proc.pid for d in dfs}, listed)
            if listed is not None:
                print(f"data plane: nvidia-smi lists compute pids {sorted(listed)} (scheduler "
                      f"{sched.proc.pid}); no dfdaemon among them or mapping libcuda/libtorch")
            m2 = _scrape(s_metrics)

            # -- stage 3: dfget processes, no back-source
            first = urls[0]
            dfget_env = dict(os.environ, PYTHONPATH=tree)
            outs = [os.path.join(root, f"dfget-{i}.bin") for i in range(DATA_DFGETS)]
            start_s = time.perf_counter()
            getters = [subprocess.Popen(
                [sys.executable, "-m", "dragonfly2_tpu_torch.client.cli", "dfget", first,
                 "-o", outs[i], "--scheduler", s_addr, "--data-dir",
                 os.path.join(root, f"dfget-{i}"), "--no-back-source", "--ip", f"127.0.0.{2 + i}"],
                cwd=tree, env=dfget_env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for i in range(DATA_DFGETS)]
            time.sleep(0.5)
            listed3 = _cuda_pids()
            _no_cuda_context({f"dfget-{i}": g.pid for i, g in enumerate(getters)
                              if g.poll() is None}, listed3)
            for i, g in enumerate(getters):
                try:
                    out, _ = g.communicate(timeout=DATA_FETCH_S)
                except subprocess.TimeoutExpired:
                    g.kill()
                    g.wait()
                    _fail(f"dfget-{i} did not finish in {DATA_FETCH_S:.0f} s")
                if g.returncode != 0:
                    _fail(f"dfget-{i} exited {g.returncode}: {out[-3000:]}")
            wall3 = time.perf_counter() - start_s
            for path in outs:
                with open(path, "rb") as f:
                    digest = hashlib.file_digest(f, "sha256").hexdigest()
                if digest != shas[first[len(origin.base):]]:
                    _fail(f"{path}: sha256 {digest}, not the origin's")
            heads3, gets3, pieces3, bytes3 = origin.counts()
            print(f"data plane: stage 3, {DATA_DFGETS} dfget processes fetch the "
                  f"{blobs_mib[0]} MiB blob with --no-back-source: {wall3:.2f} s")
            if (gets3, pieces3) != (gets1, pieces1):
                _fail(f"the origin served {gets3 - gets1} data GETs after stage 1 "
                      f"({gets2 - gets1} in stage 2): a later piece did not come from a peer")

            # -- the scheduler and the daemons' own accounts
            m3 = _scrape(s_metrics)
            ticks, peers, tick_s, buckets = _tick_stats(m3)
            deltas = []
            for label, a, b in (("stage 1", m0, m1), ("stage 2", m1, m2), ("stage 3", m2, m3)):
                ta, pa, sa, _ = _tick_stats(a)
                tb, pb, sb, _ = _tick_stats(b)
                deltas.append(f"{label} {tb - ta:.0f} ticks, {pb - pa:.0f} peers "
                              f"({(pb - pa) / max(tb - ta, 1):.2f} a tick), tick mean "
                              f"{(sb - sa) / max(tb - ta, 1) * 1e3:.3f} ms")
            print(f"data plane: the scheduler's /metrics (its tick on {device or 'the card'}): "
                  f"{'; '.join(deltas)}; in all {ticks:.0f} ticks, {peers:.0f} peers, "
                  f"peers a tick cumulative buckets {buckets}")
            traffic = _traffic(m3)
            piece_tasks = sum(v for port in metrics.values() for k, v in _scrape(port).items()
                              if k.startswith("dragonfly_dfdaemon_piece_task_total"))
            from_parents = piece_tasks - pieces3
            print(f"data plane: pieces: {pieces3} from the origin, {from_parents:.0f} from parents "
                  f"by the dfdaemons' piece counters (+ {DATA_DFGETS} x "
                  f"{-(-(blobs_mib[0] << 20) // (4 << 20))} by the dfgets); the scheduler's "
                  f"traffic bytes {traffic}; origin bytes / image bytes "
                  f"{bytes3 / image:.3f}")
            if from_parents < (daemons - 1) * len(blobs) or traffic.get("p2p", 0) <= 0:
                _fail(f"{from_parents} pieces from parents and p2p traffic {traffic}")
            dominant = _tail_dominant(metrics.values())
            print(f"data plane: the dfdaemons' tail attribution, downloads by dominant phase: "
                  f"{dominant}")
            finished = daemons * len(blobs) + DATA_DFGETS
            if sum(dominant.values()) < daemons * len(blobs):
                _fail(f"the daemons' tail planes observed {sum(dominant.values())} downloads")

            # -- shutdown: every process exits 0 on SIGTERM within 10 s
            stop_s = {}
            for p in [*dfs, sched]:
                stop_s[p.name] = p.stop()
            df_stops = sorted(stop_s[d.name] for d in dfs)
            rows = 0
            for path in pathlib.Path(root, "traces").glob("download*.csv"):
                with open(path) as f:
                    rows += sum(1 for _ in f) - 1
            print(f"data plane: SIGTERM -> exit 0 in p50 {statistics.median(df_stops):.2f} s max "
                  f"{df_stops[-1]:.2f} s (dfdaemons), {stop_s['scheduler']:.2f} s (scheduler); "
                  f"{rows} download rows on disk for {finished} finished downloads")
            if rows < finished:
                _fail(f"{rows} download trace rows on disk, fewer than the {finished} downloads")
        finally:
            for p in procs:
                p.kill()
            origin.stop()


MGR_KEEPALIVE_S = 2.0  # the scheduler's keepalive interval: registered to active within one
MGR_DYNCONFIG_S = 1.0  # the scheduler's and the daemons' dynconfig interval
MGR_LIMITS = (4, 2)  # the cluster's candidate_parent_limit before and after the PATCH
MGR_APPLY_S = 3 * MGR_DYNCONFIG_S  # a loop's sleep plus the snapshot's expiry, and the RPC
MGR_PROBE_HOSTS = 64  # wire peers asking the card's scheduler for parents around the PATCH
MGR_PROBES_BEFORE = 8
MGR_PROBES_AFTER = 12  # answers held to the new limit after the first that obeys it
MGR_JOB_S = 180.0  # the preheat job from create to SUCCESS
MGR_SERVE_S = 60.0  # an activation to the ml arm's log line
MGR_REST_GAP_S = 0.05  # REST GETs timed while the daemons poll the manager
MGR_SCHED_ID = "chip-smoke-ml-scheduler"
MGR_REPO = "smoke/app"


class _OCIRegistry:
    """The image's registry, as the reference's tests/test_image_preheat.py
    FakeRegistry serves one: a manifest (schema 2: a config blob and the
    layers) and the blobs over HTTP with Range support on 127.0.0.1,
    counting manifest GETs, the bytes=0-0 range probes, HEADs and each
    blob's piece bytes."""

    MANIFEST = "application/vnd.docker.distribution.manifest.v2+json"

    def __init__(self, layers: list):
        import hashlib
        import http.server

        config = json.dumps({"architecture": "amd64", "os": "linux",
                             "rootfs": {"type": "layers"}}).encode()
        self.order = [config, *layers]  # the manifest's References(): config first
        self.digests = ["sha256:" + hashlib.sha256(b).hexdigest() for b in self.order]
        self.blobs = dict(zip(self.digests, self.order))
        layer_type = "application/vnd.docker.image.rootfs.diff.tar.gzip"
        self.manifest = json.dumps({
            "schemaVersion": 2, "mediaType": self.MANIFEST,
            "config": {"mediaType": "application/vnd.docker.container.image.v1+json",
                       "digest": self.digests[0], "size": len(config)},
            "layers": [{"mediaType": layer_type, "digest": d, "size": len(self.blobs[d])}
                       for d in self.digests[1:]],
        }).encode()
        self.manifest_gets = self.probes = self.heads = 0
        self.piece_bytes = collections.Counter()
        self.mu = threading.Lock()
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):
                pass

            def _blob(self):
                return outer.blobs.get(self.path.rsplit("/", 1)[-1])

            def do_HEAD(self):
                blob = self._blob()
                with outer.mu:
                    outer.heads += 1
                self.send_response(200 if blob is not None else 404)
                self.send_header("Content-Length", str(len(blob or b"")))
                self.end_headers()

            def do_GET(self):
                if self.path == f"/v2/{MGR_REPO}/manifests/latest":
                    with outer.mu:
                        outer.manifest_gets += 1
                    self.send_response(200)
                    self.send_header("Content-Type", outer.MANIFEST)
                    self.send_header("Content-Length", str(len(outer.manifest)))
                    self.end_headers()
                    self.wfile.write(outer.manifest)
                    return
                blob = self._blob()
                if blob is None:
                    self.send_error(404)
                    return
                data, status = memoryview(blob), 200
                rng = self.headers.get("Range")
                if rng and rng.startswith("bytes="):
                    start, _, end = rng[len("bytes="):].partition("-")
                    data = data[int(start or 0):int(end) + 1 if end else len(data)]
                    status = 206
                with outer.mu:
                    if rng == "bytes=0-0":
                        outer.probes += 1
                    else:
                        outer.piece_bytes[self.path.rsplit("/", 1)[-1]] += len(data)
                self.send_response(status)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.server.daemon_threads = True
        threading.Thread(target=self.server.serve_forever, daemon=True).start()
        self.base = f"http://127.0.0.1:{self.server.server_address[1]}"
        self.manifest_url = f"{self.base}/v2/{MGR_REPO}/manifests/latest"
        self.urls = [f"{self.base}/v2/{MGR_REPO}/blobs/{d}" for d in self.digests]

    def counts(self) -> tuple:
        with self.mu:
            return self.manifest_gets, self.probes, self.heads, dict(self.piece_bytes)

    def stop(self) -> None:
        self.server.shutdown()
        self.server.server_close()


class _Rest:
    """The manager's REST API, every call timed by the host clock."""

    def __init__(self, base: str):
        self.base, self.token, self.ms = base, None, []

    def __call__(self, method: str, path: str, body=None, timed: bool = True):
        import urllib.error
        import urllib.request

        req = urllib.request.Request(self.base + path, method=method,
                                     data=None if body is None else json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        if self.token:
            req.add_header("Authorization", f"Bearer {self.token}")
        start = time.perf_counter()
        try:
            with urllib.request.urlopen(req, timeout=60) as resp:
                out = json.loads(resp.read())
        except urllib.error.HTTPError as e:
            _fail(f"manager REST {method} {path}: {e.code} {e.read()[:500]!r}")
        if timed:
            self.ms.append((time.perf_counter() - start) * 1e3)
        return out


def _hist_p50_ms(m: dict, name: str) -> tuple:
    """(count, mean ms, the upper bound in ms of the bucket that holds the
    median) of a Prometheus histogram in a /metrics scrape."""
    count = m.get(f"{name}_count", 0.0)
    buckets = sorted((float(k.split('le="')[1].rstrip('"}')), v) for k, v in m.items()
                     if k.startswith(f"{name}_bucket"))
    bound = next((le for le, v in buckets if v >= count / 2), float("inf"))
    return count, m.get(f"{name}_sum", 0.0) / max(count, 1) * 1e3, bound * 1e3


async def _manager_call(rpc: str, request):
    from dragonfly2_tpu_torch.manager.rpc import ManagerClient

    host, _, port = rpc.rpartition(":")
    client = await ManagerClient(host, int(port)).connect()
    try:
        return await client.call(request)
    finally:
        await client.close()


async def _limit_probes(host: str, port: int, task_id: str, url: str, size: int,
                        patch) -> tuple:
    """Wire peers on one of the image's tasks ask the card's scheduler for
    parents: MGR_PROBES_BEFORE answers, then ``patch()`` (the REST PATCH
    of the cluster's limit), then answers until the first that offers at
    most the new limit and MGR_PROBES_AFTER more. Each peer leaves once
    answered. Returns (before counts, [(seconds after the PATCH, count)])."""
    from dragonfly2_tpu_torch.cluster import messages as msg
    from dragonfly2_tpu_torch.rpc.client import SchedulerConnection

    conn = await SchedulerConnection(host, port).connect()
    hosts = [msg.HostInfo(host_id=f"limit-host-{i}", hostname=f"limit-node-{i}",
                          ip=f"10.96.{i // 256}.{i % 256 + 1}", port=8002, download_port=8001)
             for i in range(MGR_PROBE_HOSTS)]
    asked = 0

    async def ask() -> int:
        nonlocal asked
        peer_id, h = f"limit-peer-{asked}", hosts[asked % MGR_PROBE_HOSTS]
        asked += 1
        queue = conn.subscribe(peer_id)
        await conn.send(msg.RegisterPeerRequest(peer_id=peer_id, task_id=task_id, host=h,
                                                url=url, content_length=size,
                                                piece_length=4 << 20))
        answer = await asyncio.wait_for(queue.get(), 30)
        await conn.send(msg.LeavePeerRequest(peer_id=peer_id))
        if type(answer).__name__ != "NormalTaskResponse":
            _fail(f"the card's scheduler answered a peer of {task_id} with {answer}")
        return len(answer.candidate_parents)

    try:
        for h in hosts:
            await conn.send(msg.AnnounceHostRequest(host=h))
        before = [await ask() for _ in range(MGR_PROBES_BEFORE)]
        t_patch = time.perf_counter()
        await asyncio.to_thread(patch)
        after, obeyed = [], 0
        while obeyed <= MGR_PROBES_AFTER:
            n = await ask()
            after.append((time.perf_counter() - t_patch, n))
            if obeyed or n <= MGR_LIMITS[1]:
                obeyed += 1
            if not obeyed and after[-1][0] > 10 * MGR_APPLY_S:
                break
        return before, after
    finally:
        await conn.close()


@_phase("manager")
def phase_manager(card: str, tree: str, device=None, daemons=DATA_DAEMONS,
                  blobs_mib=DATA_BLOBS_MIB) -> None:
    """Slice 21's main path: the manager over the port's cluster on the
    card (the module docstring, phase 17). ``device``, ``daemons`` and
    ``blobs_mib`` are for a rehearsal on the CPU."""
    import concurrent.futures
    import hashlib

    import torch

    from dragonfly2_tpu_torch.cluster.trainer_service import GNN_MODEL_NAME
    from dragonfly2_tpu_torch.config.config import TrainerConfig
    from dragonfly2_tpu_torch.manager import rpc as mrpc
    from dragonfly2_tpu_torch.models.convert import graphsage_params_to_flax
    from dragonfly2_tpu_torch.models.graphsage import GraphSAGERanker
    from dragonfly2_tpu_torch.records.storage import TraceStorage
    from dragonfly2_tpu_torch.training.checkpoint import params_to_bytes
    from dragonfly2_tpu_torch.utils import idgen

    _raise_open_files()
    rng = np.random.default_rng(SEED + 17)
    oci = _OCIRegistry([rng.integers(0, 256, mib << 20, dtype=np.uint8).tobytes()
                        for mib in blobs_mib])
    image = sum(len(b) for b in oci.order)
    shas = {url: hashlib.sha256(b).hexdigest() for url, b in zip(oci.urls, oci.order)}
    dev_args = ["--device", device] if device else []
    where = device or "the card"
    procs: list = []
    with tempfile.TemporaryDirectory(prefix="dfly-mgr-") as root:
        def log(name):
            return os.path.join(root, f"{name}.log")

        try:
            # -- the manager, its cluster, the schedulers (a) registration
            mgr = _Process("manager", [
                "manager", "--db", os.path.join(root, "manager.db"), "--registry-dir",
                os.path.join(root, "registry"), "--metrics-port", "0"], tree, log("manager"))
            procs.append(mgr)
            if mgr.ready[3] != "RPC" or mgr.ready[5] != "METRICS":
                _fail(f"the manager's READY line lacks RPC or METRICS: {' '.join(mgr.ready)}")
            rest, rpc = _Rest(f"http://{mgr.ready[1]}:{mgr.ready[2]}"), f"{mgr.ready[1]}:{mgr.ready[4]}"
            rest.token = rest("POST", "/api/v1/users/signin",
                              {"name": "root", "password": "dragonfly"})["token"]
            cluster = rest("POST", "/api/v1/clusters", {
                "name": "smoke", "is_default": True,
                "scheduler_cluster_config": {"candidate_parent_limit": MGR_LIMITS[0]}})
            sc_id, spc_id = cluster["scheduler_cluster_id"], cluster["seed_peer_cluster_id"]
            with concurrent.futures.ThreadPoolExecutor(2) as pool:
                fa = pool.submit(_Process, "scheduler", [
                    "scheduler", *dev_args, "--data-dir", os.path.join(root, "traces"),
                    "--manager", rpc, "--cluster-id", str(sc_id), "--hostname", "sched-a",
                    "--keepalive-interval", str(MGR_KEEPALIVE_S),
                    "--dynconfig-interval", str(MGR_DYNCONFIG_S), "--metrics-port", "0"],
                    tree, log("scheduler"))
                fb = pool.submit(_Process, "ml-scheduler", [
                    "scheduler", *dev_args, "--data-dir", os.path.join(root, "traces-ml"),
                    "--registry-dir", os.path.join(root, "registry"), "--algorithm", "ml",
                    "--scheduler-host-id", MGR_SCHED_ID, "--hostname", "sched-ml",
                    "--ml-refresh-interval", "0.5"], tree, log("ml-scheduler"))
                sched, ml_sched = fa.result(), fb.result()
            procs += [sched, ml_sched]
            s_port, s_metrics = int(sched.ready[2]), int(sched.ready[4])
            _wait_for(lambda: [r for r in rest("GET", "/api/v1/schedulers", timed=False)
                               if r["state"] == "active" and r["port"] == s_port],
                      2 * PROC_READY_S, "the manager to list the scheduler active", procs)
            sched_active_s = time.perf_counter() - sched.ready_at
            seed = _Process("seed", [
                "dfdaemon", "--data-dir", os.path.join(root, "seed"), "--manager", rpc,
                "--hostname", "seed", "--host-type", "super",
                "--dynconfig-interval", str(MGR_DYNCONFIG_S), "--metrics-port", "0"],
                tree, log("seed"))
            procs.append(seed)
            # the reference's dfdaemon registers no seed peer with the
            # manager (its keepalive edge is the scheduler's): this script
            # registers the seed process over the manager's RPC, as the
            # reference's tests do, and sends its first keepalive
            for request in (mrpc.RegisterInstanceRequest(
                    source_type="seed_peer", host_name="seed", ip=seed.ready[1],
                    port=int(seed.ready[2]), cluster_id=spc_id),
                    mrpc.KeepAliveRequest(source_type="seed_peer", host_name="seed",
                                          ip=seed.ready[1], cluster_id=spc_id)):
                asyncio.run(_manager_call(rpc, request))
            _wait_for(lambda: [r for r in rest("GET", "/api/v1/seed-peers", timed=False)
                               if r["state"] == "active"], MGR_KEEPALIVE_S,
                      "the manager to list the seed peer active", procs)
            seed_active_s = time.perf_counter() - seed.ready_at
            if sched_active_s > MGR_KEEPALIVE_S:
                _fail(f"the scheduler went active {sched_active_s:.2f} s after its READY, more "
                      f"than one keepalive interval ({MGR_KEEPALIVE_S} s)")
            snapshot = pathlib.Path(root, "traces", f"dynconfig-cluster{sc_id}.json")
            _wait_for(lambda: snapshot.exists() and json.loads(snapshot.read_text())["seed_peers"],
                      3 * MGR_APPLY_S, "the scheduler's dynconfig to list the seed", procs)

            def start(i):
                name = f"df-{i:02d}"
                return _Process(name, [
                    "dfdaemon", "--data-dir", os.path.join(root, name), "--manager", rpc,
                    "--hostname", name, "--proxy", "--proxy-rule", "/blobs/",
                    "--dynconfig-interval", str(MGR_DYNCONFIG_S), "--metrics-port", "0"],
                    tree, log(name))

            with concurrent.futures.ThreadPoolExecutor(daemons) as pool:
                dfs = list(pool.map(start, range(daemons)))
            procs.extend(dfs)
            for d in [seed, *dfs]:
                with open(os.path.join(root, d.name, "dynconfig.json")) as f:
                    listed = [(e["ip"], e["port"]) for e in json.load(f)["schedulers"]]
                if listed != [(sched.ready[1], s_port)]:
                    _fail(f"{d.name} took the scheduler list {listed} from the manager")
            ready = sorted(d.ready_s for d in dfs)
            print(f"manager: READY after {mgr.ready_s:.2f} s ({' '.join(mgr.ready)}); schedulers "
                  f"{sched.ready_s:.2f} s (rule arm, --manager) and {ml_sched.ready_s:.2f} s (ml "
                  f"arm) on {where}; the scheduler active {sched_active_s:.3f} s and the seed peer "
                  f"{seed_active_s:.3f} s after their READY (keepalive interval "
                  f"{MGR_KEEPALIVE_S} s); {daemons} dfdaemons with --manager and no --scheduler "
                  f"READY p50 {statistics.median(ready):.2f} s max {ready[-1]:.2f} s, each "
                  f"listing the scheduler the manager gave it, host clock ({card})")

            # -- (b) image preheat through the manager's job, then the pulls
            start_s = time.perf_counter()
            job = rest("POST", "/api/v1/jobs", {"type": "preheat", "args": {
                "type": "image", "url": oci.manifest_url, "platform": "linux/amd64"}})
            want_ids = [idgen.task_id_v1(u) for u in oci.urls]
            if job["state"] != "PENDING" or job["result"]["task_ids"] != want_ids:
                _fail(f"the preheat job {job} does not hold the daemons' task ids {want_ids}")
            done = _wait_for(lambda: (lambda j: j if j["state"] != "PENDING" else None)(
                rest("GET", f"/api/v1/jobs/{job['id']}")), MGR_JOB_S, "the preheat job", procs)
            job_s = time.perf_counter() - start_s
            if done["state"] != "SUCCESS":
                _fail(f"the preheat job ended {done['state']}: {done['result']}")
            manifests, probes, heads, pieces = oci.counts()
            unequal = {d: n for d, n in pieces.items() if n != len(oci.blobs[d])}
            if unequal or len(pieces) != len(oci.blobs):
                _fail(f"the registry served blob bytes {pieces}, not each blob once")
            print(f"manager: image preheat ({len(oci.urls)} blobs, config and "
                  f"{len(blobs_mib)} layers, {image / 2**20:.1f} MiB) from POST /api/v1/jobs to "
                  f"SUCCESS {job_s:.2f} s; the registry served {manifests} manifest GETs, "
                  f"{probes} range probes, {heads} HEADs and each blob's bytes once; task ids "
                  f"equal idgen.task_id_v1 of the blob URLs, host clock ({card})")

            polls = {"stop": False}

            def poll_rest():
                while not polls["stop"]:
                    rest("GET", "/api/v1/schedulers")
                    time.sleep(MGR_REST_GAP_S)

            rest.ms.clear()
            poller = threading.Thread(target=poll_rest, daemon=True)
            poller.start()
            proxy = {d.name: int(d.ready[4]) for d in dfs}
            jobs = [(d.name, u) for d in dfs for u in oci.urls]
            node_done = collections.defaultdict(float)
            start_s = time.perf_counter()

            def fetch(name, url):
                digest, n, via, _ = _proxy_fetch(proxy[name], url)
                if digest != shas[url] or via != "p2p":
                    _fail(f"{name} {url} through its proxy: sha256 {digest} ({n} bytes, via {via})")
                return name, time.perf_counter() - start_s

            with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
                for name, at in pool.map(lambda j: fetch(*j), jobs):
                    node_done[name] = max(node_done[name], at)
            wall = time.perf_counter() - start_s
            polls["stop"] = True
            poller.join()
            rest_ms = list(rest.ms)
            dfget_sched = asyncio.run(_manager_call(rpc, mrpc.GetSchedulersRequest(
                ip="127.0.0.2", hostname="dfget"))).schedulers
            addr = f"{dfget_sched[0].ip}:{dfget_sched[0].port}"
            big = oci.urls[1 + int(np.argmax(blobs_mib))]
            dfget_s = time.perf_counter()
            for i in range(DATA_DFGETS):
                out = os.path.join(root, f"dfget-{i}.bin")
                got = subprocess.run(
                    [sys.executable, "-m", "dragonfly2_tpu_torch.client.cli", "dfget", big,
                     "-o", out, "--scheduler", addr, "--data-dir", os.path.join(root, f"dfget-{i}"),
                     "--no-back-source", "--ip", f"127.0.0.{2 + i}"],
                    cwd=tree, env=dict(os.environ, PYTHONPATH=tree), capture_output=True,
                    text=True, timeout=DATA_FETCH_S)
                if got.returncode != 0:
                    _fail(f"dfget-{i} exited {got.returncode}: {got.stderr[-3000:]}")
                with open(out, "rb") as f:
                    if hashlib.file_digest(f, "sha256").hexdigest() != shas[big]:
                        _fail(f"dfget-{i}: sha256 differs from the registry's")
            dfget_s = time.perf_counter() - dfget_s
            pulled = oci.counts()
            if (pulled[1], pulled[3]) != (probes, pieces):  # HEADs carry no data
                _fail(f"the registry served {pulled} after the preheat: a pull back-sourced")
            per_node = list(node_done.values())
            origin_bytes = sum(pieces.values()) + probes
            print(f"manager: {daemons} dfdaemons pull the preheated image at once through their "
                  f"proxies ({len(jobs)} fetches): wall {wall:.2f} s, "
                  f"{daemons * image / 2**20 / wall:.1f} MiB/s aggregate, per daemon p50 "
                  f"{_pct(per_node, 50):.2f} s p99 {_pct(per_node, 99):.2f} s; "
                  f"{DATA_DFGETS} dfget --no-back-source of the {max(blobs_mib)} MiB layer from "
                  f"the scheduler the manager lists ({addr}): {dfget_s:.2f} s; no data GET at "
                  f"the registry after the preheat ({pulled[2] - heads} HEADs); origin bytes / "
                  f"image bytes {origin_bytes / image:.3f}; REST GET p50 "
                  f"{_pct(rest_ms, 50):.3f} ms p99 {_pct(rest_ms, 99):.3f} ms over "
                  f"{len(rest_ms)} calls while {daemons + 1} daemons poll GetSchedulers every "
                  f"{MGR_DYNCONFIG_S} s, host clock ({card})")

            # -- (c) dynconfig on the card's tick
            def patch():
                rest("PATCH", f"/api/v1/scheduler-clusters/{sc_id}",
                     {"config": {"candidate_parent_limit": MGR_LIMITS[1]}})

            before, after = asyncio.run(_limit_probes(
                sched.ready[1], s_port, want_ids[1], oci.urls[1], len(oci.order[1]), patch))
            if max(before) <= MGR_LIMITS[1]:
                _fail(f"before the PATCH the answers offered {before} candidates: none above "
                      f"{MGR_LIMITS[1]}, so the limit's change would prove nothing")
            first = next((i for i, (_, n) in enumerate(after) if n <= MGR_LIMITS[1]), None)
            if first is None:
                _fail(f"no answer obeyed the limit {MGR_LIMITS[1]} after the PATCH: {after}")
            apply_s = after[first][0]
            late = [n for _, n in after[first:] if n > MGR_LIMITS[1]]
            if late or apply_s > MGR_APPLY_S:
                _fail(f"after the PATCH: first obeying answer at {apply_s:.2f} s (bound "
                      f"{MGR_APPLY_S} s), later answers above the limit {late}")
            print(f"manager: dynconfig: answers offered {before} candidate parents at limit "
                  f"{MGR_LIMITS[0]}; PATCH candidate_parent_limit {MGR_LIMITS[1]} -> first "
                  f"answer obeying it {apply_s * 1e3:.1f} ms later (interval "
                  f"{MGR_DYNCONFIG_S} s), then {len(after) - first - 1} more, all at most "
                  f"{MGR_LIMITS[1]}, host clock ({card})")

            # -- (d) model activation through the manager to the ml arm
            hidden = TrainerConfig().hidden_dim
            versions = []
            for k in range(2):
                model = GraphSAGERanker(hidden, GRAPH_LAYERS).reset_parameters(
                    torch.Generator().manual_seed(SEED + k))
                created = asyncio.run(_manager_call(rpc, mrpc.CreateModelRequest(
                    name=GNN_MODEL_NAME, type="gnn", scheduler_host_id=MGR_SCHED_ID,
                    params_blob=params_to_bytes(graphsage_params_to_flax(model)),
                    evaluation={})))
                versions.append(created.version)
            rows = {r["version"]: r for r in rest("GET", f"/api/v1/models?model_id="
                                                       f"{created.model_id}")}
            served = []
            for v in versions:
                start_s = time.perf_counter()
                row = rest("PATCH", f"/api/v1/models/{rows[v]['id']}", {"state": "active"})
                if row["state"] != "active":
                    _fail(f"PATCH /api/v1/models/{rows[v]['id']} left it {row['state']}")
                _wait_for(lambda: f"ml evaluator serving model version {v}" in ml_sched.log(),
                          MGR_SERVE_S, f"the ml arm to serve version {v}", procs)
                served.append(time.perf_counter() - start_s)
            print(f"manager: CreateModel published GNN versions {versions} (hidden {hidden}, "
                  f"seeded, flax msgpack) to the manager's registry; each REST activation to the "
                  f"ml arm's 'serving model version' line: "
                  f"{', '.join(f'v{v} {s:.2f} s' for v, s in zip(versions, served))} (refresh "
                  f"every 0.5 s), host clock ({card})")

            # -- (e) shutdown, then the scheduler's own account
            m = _scrape(s_metrics)
            ticks, tick_mean, tick_p50 = _hist_p50_ms(m, "dragonfly_scheduler_tick_seconds")
            stop_s = {p.name: p.stop() for p in [*dfs, seed, ml_sched, sched, mgr]}
            storage = TraceStorage(os.path.join(root, "traces"))
            parents = collections.Counter(
                p.host.hostname for r in storage.list_downloads()
                if r.host.hostname.startswith("df-") for p in r.parents)
            storage.close()
            if not parents.get("seed"):
                _fail(f"the daemons' downloads name no seed among their parents: {parents}")
            df_stops = sorted(stop_s[d.name] for d in dfs)
            print(f"manager: the scheduler on {where}: {ticks:.0f} ticks, mean {tick_mean:.3f} ms, "
                  f"p50 at most {tick_p50:.3f} ms by its histogram's buckets; the daemons' "
                  f"download rows name {parents['seed']} parent entries on the seed of "
                  f"{sum(parents.values())}; SIGTERM -> exit 0 in p50 "
                  f"{statistics.median(df_stops):.2f} s max {df_stops[-1]:.2f} s (dfdaemons), "
                  + ", ".join(f"{n} {stop_s[n]:.2f} s" for n in ("seed", "ml-scheduler",
                                                                   "scheduler", "manager"))
                  + f", host clock ({card})")
        finally:
            for p in procs:
                p.kill()
            oci.stop()


@_phase("cost cards")
def phase_cost_cards(card: str) -> None:
    """The cost cards of the in-process phases 5-14 (telemetry/costcard.py):
    a flight-recorder dump of the cost-card section drains the notes the
    serving entries queued, by replays on zeros on the card; the trainer's
    cards were counted on their first real steps. Prints each entry's cards
    (at most four, the largest first) with flops, bytes, the roofline side
    and the lower-bound time at the H100's peaks; fails on a capture error,
    a card without bytes, or a trainer card of the attention ranker that
    counted no hand kernel."""
    from dragonfly2_tpu_torch.telemetry import costcard, flight

    doc = flight.dump(sections=("costcards",), max_bytes=None)["costcards"]
    if doc["capture_errors"]:
        _fail(f"cost-card captures failed: {doc['capture_errors']}")
    cards = doc["cards"]
    by_entry = collections.defaultdict(list)
    for c in cards:
        by_entry[c["entry"]].append(c)
    if any(c["bytes_accessed"] <= 0 for c in cards) or "scheduler.tick.fused_tick_chunk" \
            not in by_entry:
        _fail(f"cost cards without bytes, or none of the fused tick: {sorted(by_entry)}")
    kernels = {name for c in cards if c["entry"].startswith("trainer.") for name, _ in c["kernels"]}
    if not {"dfly_flash_fwd_lse", "dfly_flash_bwd_dkv", "dfly_flash_bwd_dq"} <= kernels:
        _fail(f"the trainer's cards counted the hand kernels {sorted(kernels)}")
    print(f"cost cards of phases 5-14 on the card: {len(cards)} cards of {len(by_entry)} entries "
          f"(telemetry/costcard.py counting rules; bound at the H100's bf16 peak "
          f"{costcard.H100_PEAK_FLOPS_BF16:.4g} FLOP/s and {costcard.H100_HBM_BYTES_PER_S:.4g} "
          f"B/s), ({card}):")
    for entry, group in sorted(by_entry.items()):
        for c in sorted(group, key=lambda c: -c["flops"])[:4]:
            lower_us = max(c["flops"] / costcard.H100_PEAK_FLOPS_BF16,
                           c["bytes_accessed"] / costcard.H100_HBM_BYTES_PER_S) * 1e6
            print(f"  {entry} [{len(group)} cards] {c['signature_repr'][:96]}: {c['flops']:.6g} "
                  f"flops, {c['bytes_accessed']:.6g} bytes, {c['transcendentals']:.4g} "
                  f"transcendentals, {c['bound']}-bound, lower bound {lower_us:.3f} us; "
                  f"hand kernels {c['kernels'] or 'none'}; data-dependent "
                  f"{c['data_dependent'] or 'none'}")


OBJ_ACCESS, OBJ_SECRET, OBJ_REGION = "AKIDchipsmoke", "chip-smoke-secret", "us-test-1"
OBJ_BUCKET, OBJ_KEY = "rollout", "images/layer.bin"  # the object the daemons pull
OBJ_REGISTRY = "models"  # the S3 bucket of the model registry
OBJ_STORE_BUCKET = "objects"  # the bucket of the daemon's object-storage service
OBJ_PUT_MIB = 64  # the object dfstore puts through the seed daemon's service
OBJ_SCHED_ID = "chip-smoke-objstore-scheduler"
OBJ_TICK_ASKS = 20  # ticks, each with no new signature, across which no capture may run
OBJ_SMALL_DUMP = 4096  # max_bytes of the bounded /debug/flight query
# the tick phase that holds each scheduler entry's call (telemetry/flight.py
# PhaseRecorder marks in cluster/scheduler.py); the refresh entries run on
# the ml arm's worker, outside any tick
OBJ_ENTRY_PHASE = {
    "scheduler.tick.fused_tick_chunk": "fused_dispatch",
    "scheduler.evaluator.schedule_from_packed": "shadow_score",
    "scheduler.ml.schedule_from_packed": "dispatch",
}
_V4_SAFE = "-_.~"
_OSS_SUBRESOURCES = ("acl", "uploads", "location", "tagging", "versioning", "versions")


class _S3Stub:
    """Phase 18's object store: path-style S3 (or, with ``scheme`` "oss" /
    "obs", the vendors' header-signed dialect) over 127.0.0.1 in a thread.
    It recomputes every request's signature from the shared secret with its
    own code (SigV4: the canonical request, the scope and the HMAC chain;
    OSS/OBS: HMAC-SHA1 over the string to sign), answers 403 when the
    signature differs, and counts each key's GETs, ranged GETs and the body
    bytes it served. Buckets, objects, ranged GETs, HEAD, list-type 2 pages
    with continuation tokens, copies, conditional creates and deletes."""

    def __init__(self, scheme: str = "s3", access: str = OBJ_ACCESS, secret: str = OBJ_SECRET,
                 region: str = OBJ_REGION):
        import http.server

        self.scheme, self.access, self.secret, self.region = scheme, access, secret, region
        self.buckets: dict = {}
        self.etags: dict = {}  # (bucket, key) -> md5, computed once per write
        self.lock = threading.Lock()
        self.gets, self.served = collections.Counter(), collections.Counter()
        self.ranged = self.refused = 0
        stub = self

        class Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):
                pass

            def handle_one(self):
                n = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(n) if n else b""
                code, data, headers = stub._serve(self, body)
                self.send_response(code)
                for k, v in headers.items():
                    self.send_header(k, v)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                if self.command != "HEAD":
                    self.wfile.write(data)

            do_GET = do_PUT = do_DELETE = do_HEAD = do_POST = handle_one

        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.httpd.daemon_threads = True
        self.endpoint = f"127.0.0.1:{self.httpd.server_address[1]}"
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(5)

    # -- signatures, recomputed here ----------------------------------------
    def _sigv4_ok(self, h, body: bytes) -> bool:
        import hashlib
        import hmac
        import urllib.parse

        auth = h.headers.get("Authorization", "")
        if not auth.startswith("AWS4-HMAC-SHA256 "):
            return False
        fields = dict(kv.strip().split("=", 1) for kv in auth.split(" ", 1)[1].split(","))
        access, date, region, service, _ = fields["Credential"].split("/")
        payload = h.headers.get("x-amz-content-sha256", "")
        if access != self.access or hashlib.sha256(body).hexdigest() != payload:
            return False
        names = fields["SignedHeaders"].split(";")
        canonical_headers = "".join(f"{n}:{' '.join(h.headers.get(n, '').split())}\n"
                                    for n in names)
        path, _, query = h.path.partition("?")
        pairs = sorted((urllib.parse.quote(k, safe=_V4_SAFE), urllib.parse.quote(v, safe=_V4_SAFE))
                       for k, v in urllib.parse.parse_qsl(query, keep_blank_values=True))
        request = "\n".join((h.command, path or "/", "&".join(f"{k}={v}" for k, v in pairs),
                             canonical_headers, fields["SignedHeaders"], payload))
        to_sign = "\n".join(("AWS4-HMAC-SHA256", h.headers.get("x-amz-date", ""),
                             f"{date}/{region}/{service}/aws4_request",
                             hashlib.sha256(request.encode()).hexdigest()))
        key = ("AWS4" + self.secret).encode()
        for part in (date, region, service, "aws4_request"):
            key = hmac.new(key, part.encode(), hashlib.sha256).digest()
        want = hmac.new(key, to_sign.encode(), hashlib.sha256).hexdigest()
        return hmac.compare_digest(want, fields["Signature"])

    def _headerstyle_ok(self, h, body: bytes, bucket: str, key: str, query: str) -> bool:
        import base64
        import hashlib
        import hmac
        import urllib.parse

        prefix = self.scheme.upper()
        auth = h.headers.get("Authorization", "")
        if not auth.startswith(prefix + " "):
            return False
        access, _, got = auth[len(prefix) + 1:].partition(":")
        lowered = {k.lower(): v.strip() for k, v in h.headers.items()}
        if access != self.access or (body and lowered.get("content-md5") != base64.b64encode(
                hashlib.md5(body).digest()).decode()):
            return False
        vendor = f"x-{self.scheme}-"
        canonical = "".join(f"{k}:{lowered[k]}\n" for k in sorted(lowered) if k.startswith(vendor))
        resource = f"/{bucket}/{key}" if key else (f"/{bucket}/" if bucket else "/")
        sub = sorted((k, v) for k, v in urllib.parse.parse_qsl(query, keep_blank_values=True)
                     if k in _OSS_SUBRESOURCES)
        if sub:
            resource += "?" + "&".join(k if not v else f"{k}={v}" for k, v in sub)
        to_sign = "\n".join((h.command, lowered.get("content-md5", ""),
                             lowered.get("content-type", ""), lowered.get("date", ""),
                             canonical + resource))
        want = base64.b64encode(hmac.new(self.secret.encode(), to_sign.encode(),
                                         hashlib.sha1).digest()).decode()
        return hmac.compare_digest(want, got)

    # -- the store -----------------------------------------------------------
    def _serve(self, h, body: bytes):
        import hashlib
        import urllib.parse

        parts = urllib.parse.urlsplit(h.path)
        bucket, _, key = parts.path.lstrip("/").partition("/")
        key, query = urllib.parse.unquote(key), parts.query
        ok = (self._sigv4_ok(h, body) if self.scheme == "s3"
              else self._headerstyle_ok(h, body, bucket, key, query))
        if not ok:
            with self.lock:
                self.refused += 1
            return 403, b"<Error><Code>SignatureDoesNotMatch</Code></Error>", {}
        q = dict(urllib.parse.parse_qsl(query, keep_blank_values=True))
        with self.lock:
            store = self.buckets.get(bucket)
            if h.command == "PUT" and not key:
                self.buckets.setdefault(bucket, {})
                return 200, b"", {}
            if h.command in ("GET", "HEAD") and not bucket:
                xml = "".join(f"<Bucket><Name>{b}</Name><CreationDate>2026-01-01T00:00:00Z"
                              "</CreationDate></Bucket>" for b in sorted(self.buckets))
                return 200, f"<ListAllMyBucketsResult><Buckets>{xml}</Buckets>" \
                            "</ListAllMyBucketsResult>".encode(), {}
            if store is None:
                if h.command == "DELETE":
                    return 204, b"", {}
                return 404, b"<Error><Code>NoSuchBucket</Code></Error>", {}
            if h.command == "DELETE":
                if key:
                    store.pop(key, None)
                else:
                    self.buckets.pop(bucket, None)
                return 204, b"", {}
            if h.command == "PUT":
                source = next((v for k, v in h.headers.items()
                               if k.lower() == f"x-{'amz' if self.scheme == 's3' else self.scheme}"
                                               "-copy-source"), None)
                if source:
                    sb, _, sk = urllib.parse.unquote(source).lstrip("/").partition("/")
                    data = self.buckets.get(sb, {}).get(sk)
                    if data is None:
                        return 404, b"<Error><Code>NoSuchKey</Code></Error>", {}
                    store[key] = data
                    self.etags[bucket, key] = self.etags[sb, sk]
                    return 200, b"<CopyObjectResult/>", {}
                exists = key in store
                if exists and h.headers.get("If-None-Match") == "*":
                    return 412, b"<Error><Code>PreconditionFailed</Code></Error>", {}
                if exists and h.headers.get(f"x-{self.scheme}-forbid-overwrite") == "true":
                    return 409, b"<Error><Code>FileAlreadyExists</Code></Error>", {}
                store[key] = body
                self.etags[bucket, key] = hashlib.md5(body).hexdigest()
                return 200, b"", {"ETag": f'"{self.etags[bucket, key]}"'}
            if not key:
                if h.command == "HEAD":
                    return 200, b"", {}
                prefix, after = q.get("prefix", ""), q.get("continuation-token", "")
                keys = sorted(k for k in store if k.startswith(prefix) and k > after)
                page = keys[:int(q.get("max-keys", "1000"))]
                more = len(keys) > len(page)
                xml = "".join(f"<Contents><Key>{k}</Key><Size>{len(store[k])}</Size>"
                              f"<ETag>\"{self.etags[bucket, k]}\"</ETag>"
                              "<LastModified>2026-01-02T03:04:05Z</LastModified></Contents>"
                              for k in page)
                tail = (f"<IsTruncated>true</IsTruncated><NextContinuationToken>{page[-1]}"
                        "</NextContinuationToken>" if more else "<IsTruncated>false</IsTruncated>")
                return 200, f"<ListBucketResult>{xml}{tail}</ListBucketResult>".encode(), {}
            data = store.get(key)
            if data is None:
                return 404, b"<Error><Code>NoSuchKey</Code></Error>", {}
            headers = {"ETag": f'"{self.etags[bucket, key]}"',
                       "Last-Modified": "Fri, 02 Jan 2026 03:04:05 GMT",
                       "Content-Type": "application/octet-stream"}
            if h.command == "HEAD":
                return 200, data, headers  # the handler sends the length, not the body
            code, rng = 200, h.headers.get("Range")
            if rng:
                lo, _, hi = rng.split("=", 1)[1].partition("-")
                data, code = memoryview(data)[int(lo): int(hi) + 1], 206
                self.ranged += 1
            self.gets[bucket, key] += 1
            self.served[bucket, key] += len(data)
            return code, data, headers

    def put(self, bucket: str, key: str, data: bytes) -> None:
        """Store an object behind the clients' backs (no signature)."""
        import hashlib

        etag = hashlib.md5(data).hexdigest()
        with self.lock:
            self.buckets.setdefault(bucket, {})[key] = data
            self.etags[bucket, key] = etag

    def delete(self, bucket: str, key: str) -> None:
        with self.lock:
            self.buckets.get(bucket, {}).pop(key, None)

    def object(self, bucket: str, key: str) -> bytes | None:
        with self.lock:
            return self.buckets.get(bucket, {}).get(key)

    def keys(self, bucket: str) -> list:
        with self.lock:
            return sorted(self.buckets.get(bucket, {}))


def _s3_proxy_fetch(proxy_port: int, url: str) -> tuple:
    """GET an s3:// URL through a daemon's proxy (its rule hijacks the
    scheme into the swarm): (status, sha256 of the body, bytes,
    X-Dragonfly-Via, the body's first KiB)."""
    import hashlib
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", proxy_port, timeout=DATA_FETCH_S)
    try:
        conn.request("GET", url)
        resp = conn.getresponse()
        h, n, head = hashlib.sha256(), 0, b""
        while True:
            chunk = resp.read(1 << 20)
            if not chunk:
                break
            h.update(chunk)
            head = head or chunk[:1024]
            n += len(chunk)
        return resp.status, h.hexdigest(), n, resp.getheader("X-Dragonfly-Via"), head
    finally:
        conn.close()


def _seed_cost_verdict(seed_dir: str, task_id: str) -> tuple:
    """The scheduler's bad-node verdict on a seed's peer of ``task_id``,
    recomputed from the seed's piece journal: the origin piece costs in
    the order the seed wrote and reported them, the newest
    ``PIECE_COST_CAPACITY`` as the scheduler's cost ring holds them,
    judged by ``ops/evaluator.is_bad_node`` (IsBadNode, evaluator.go:93-129:
    the newest cost above 20x the mean of the rest, or above their mean +
    3 sigma from 30 costs on). A seed judged bad is no candidate parent;
    with no other rooted peer every child of the task goes back to
    source. Returns (bad, the newest cost in ms, the rule's bound in ms,
    the costs in the ring)."""
    import torch

    from dragonfly2_tpu_torch.config.constants import CONSTANTS
    from dragonfly2_tpu_torch.ops import evaluator as ev
    from dragonfly2_tpu_torch.state.fsm import PeerState

    journal = pathlib.Path(seed_dir, task_id, "pieces.jsonl").read_text().splitlines()
    ring = np.asarray([json.loads(line)["cost_ns"] for line in journal if line],
                      np.float32)[-CONSTANTS.PIECE_COST_CAPACITY:]
    if len(ring) < CONSTANTS.MIN_AVAILABLE_COST_LEN:
        return False, float(ring[-1] / 1e6) if len(ring) else float("nan"), float("nan"), len(ring)
    costs = np.zeros((1, 1, CONSTANTS.PIECE_COST_CAPACITY), np.float32)
    costs[0, 0, :len(ring)] = ring
    bad = bool(ev.is_bad_node(torch.from_numpy(costs), torch.tensor([[len(ring)]]),
                              torch.tensor([[int(PeerState.SUCCEEDED)]]))[0, 0])
    rest = ring[:-1].astype(np.float64)
    bound = (rest.mean() * CONSTANTS.BAD_NODE_MEAN_MULTIPLIER
             if len(ring) < CONSTANTS.NORMAL_DISTRIBUTION_LEN
             else rest.mean() + CONSTANTS.BAD_NODE_SIGMA * rest.std())
    return bad, float(ring[-1] / 1e6), float(bound / 1e6), len(ring)


def _log_tails(procs, chars: int = 4000) -> str:
    """The ends of the named processes' logs, for a failure message."""
    return "".join(f"\n--- the {p.name}'s log ends:\n{p.log()[-chars:]}" for p in procs)


async def _tick_asks(host: str, port: int, task_id: str, url: str, size: int, n: int) -> None:
    """``n`` wire peers of one task, one after another, each asking the
    scheduler for parents and leaving once answered: ``n`` ticks of the
    bucket the warmup already ran."""
    from dragonfly2_tpu_torch.cluster import messages as msg
    from dragonfly2_tpu_torch.rpc.client import SchedulerConnection

    conn = await SchedulerConnection(host, port).connect()
    try:
        for i in range(n):
            h = msg.HostInfo(host_id=f"obj-host-{i}", hostname=f"obj-node-{i}",
                             ip=f"10.97.0.{i + 1}", port=8002, download_port=8001)
            await conn.send(msg.AnnounceHostRequest(host=h))
            peer_id = f"obj-peer-{i}"
            queue = conn.subscribe(peer_id)
            await conn.send(msg.RegisterPeerRequest(peer_id=peer_id, task_id=task_id, host=h,
                                                    url=url, content_length=size,
                                                    piece_length=4 << 20))
            answer = await asyncio.wait_for(queue.get(), 30)
            await conn.send(msg.LeavePeerRequest(peer_id=peer_id))
            if type(answer).__name__ not in ("NormalTaskResponse", "EmptyTaskResponse"):
                _fail(f"the card's scheduler answered a peer of {task_id} with {answer}")
    finally:
        await conn.close()


def _flight_get(port: int, query: str = "") -> tuple:
    """GET /debug/flight on a scheduler's metrics port: (body bytes, doc)."""
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}/debug/flight{query}",
                                timeout=120) as resp:
        body = resp.read()
    return body, json.loads(body)


def _cost_table(dump: dict, card: str) -> list:
    """The dump's cost cards as printed rows, each beside the tick phase
    p50 that holds its entry."""
    from dragonfly2_tpu_torch.telemetry import costcard

    p50 = dump["ticks"]["p50_ms"]
    rows = []
    for c in dump["costcards"]["cards"]:
        phase = OBJ_ENTRY_PHASE.get(c["entry"])
        lower_us = max(c["flops"] / costcard.H100_PEAK_FLOPS_BF16,
                       c["bytes_accessed"] / costcard.H100_HBM_BYTES_PER_S) * 1e6
        held = (f"{phase} p50 {p50[phase]:.3f} ms" if phase in p50
                else "outside the tick (the ml arm's refresh worker)")
        rows.append(f"  {c['entry']} {c['signature']} {c['signature_repr'][:72]}: "
                    f"{c['flops']:.6g} flops, {c['bytes_accessed']:.6g} bytes, {c['bound']}-bound, "
                    f"lower bound {lower_us:.3f} us at the H100's bf16 peak and HBM rate; {held} "
                    f"({card})")
    return rows


@_phase("objects")
def phase_objects(card: str, tree: str, device=None, daemons=DATA_DAEMONS,
                  object_mib=sum(DATA_BLOBS_MIB), put_mib=OBJ_PUT_MIB) -> None:
    """Slice 22's main path: object storage and the flight recorder over
    the port's cluster on the card (the module docstring, phase 18).
    ``device``, ``daemons``, ``object_mib`` and ``put_mib`` are for a
    rehearsal on the CPU."""
    import concurrent.futures
    import hashlib
    import urllib.parse

    import torch

    from dragonfly2_tpu_torch.cluster.jobs import RemoteScheduler
    from dragonfly2_tpu_torch.cluster.trainer_service import GNN_MODEL_NAME
    from dragonfly2_tpu_torch.config.config import TrainerConfig
    from dragonfly2_tpu_torch.manager import rpc as mrpc
    from dragonfly2_tpu_torch.models.convert import graphsage_params_to_flax
    from dragonfly2_tpu_torch.models.graphsage import GraphSAGERanker
    from dragonfly2_tpu_torch.objectstorage.service import DfstoreClient
    from dragonfly2_tpu_torch.telemetry import flight
    from dragonfly2_tpu_torch.training.checkpoint import params_to_bytes
    from dragonfly2_tpu_torch.utils import dferrors, idgen

    _raise_open_files()
    rng = np.random.default_rng(SEED + 18)
    stub = _S3Stub()
    blob = rng.integers(0, 256, object_mib << 20, dtype=np.uint8).tobytes()
    stub.put(OBJ_BUCKET, OBJ_KEY, blob)
    blob_sha = hashlib.sha256(blob).hexdigest()
    url = f"s3://{OBJ_BUCKET}/{OBJ_KEY}"
    creds = {"x-df-endpoint": stub.endpoint, "x-df-access-key": OBJ_ACCESS,
             "x-df-secret-key": OBJ_SECRET, "x-df-region": OBJ_REGION}
    registry_url = f"s3://{OBJ_REGISTRY}/registry?" + urllib.parse.urlencode({
        "endpoint": stub.endpoint, "access_key": OBJ_ACCESS, "secret_key": OBJ_SECRET,
        "region": OBJ_REGION})
    dev_args = ["--device", device] if device else []
    where = device or "the card"
    procs: list = []
    with tempfile.TemporaryDirectory(prefix="dfly-obj-") as root:
        def log(name):
            return os.path.join(root, f"{name}.log")

        try:
            # -- the manager on the S3 registry, its cluster, the scheduler
            mgr = _Process("manager", [
                "manager", "--db", os.path.join(root, "manager.db"), "--registry-dir",
                registry_url, "--metrics-port", "0"], tree, log("manager"))
            procs.append(mgr)
            rest, rpc = _Rest(f"http://{mgr.ready[1]}:{mgr.ready[2]}"), f"{mgr.ready[1]}:{mgr.ready[4]}"
            rest.token = rest("POST", "/api/v1/users/signin",
                              {"name": "root", "password": "dragonfly"})["token"]
            cluster = rest("POST", "/api/v1/clusters", {
                "name": "objects", "is_default": True,
                "scheduler_cluster_config": {"candidate_parent_limit": MGR_LIMITS[0]}})
            sc_id, spc_id = cluster["scheduler_cluster_id"], cluster["seed_peer_cluster_id"]
            sched = _Process("scheduler", [
                "scheduler", *dev_args, "--data-dir", os.path.join(root, "traces"),
                "--manager", rpc, "--cluster-id", str(sc_id), "--hostname", "sched-obj",
                "--keepalive-interval", str(MGR_KEEPALIVE_S),
                "--dynconfig-interval", str(MGR_DYNCONFIG_S), "--registry-dir", registry_url,
                "--algorithm", "ml", "--scheduler-host-id", OBJ_SCHED_ID,
                "--ml-refresh-interval", "0.5", "--metrics-port", "0"], tree, log("scheduler"))
            procs.append(sched)
            s_host, s_port = sched.ready[1], int(sched.ready[2])
            s_metrics = int(sched.ready[sched.ready.index("METRICS") + 1])  # after INFER h p
            _wait_for(lambda: [r for r in rest("GET", "/api/v1/schedulers", timed=False)
                               if r["state"] == "active" and r["port"] == s_port],
                      2 * PROC_READY_S, "the manager to list the scheduler active", procs)
            seed = _Process("seed", [
                "dfdaemon", "--data-dir", os.path.join(root, "seed"), "--manager", rpc,
                "--hostname", "seed", "--host-type", "super", "--object-storage",
                "--object-storage-backend", "s3", "--object-storage-endpoint", stub.endpoint,
                "--object-storage-region", OBJ_REGION,
                "--dynconfig-interval", str(MGR_DYNCONFIG_S), "--metrics-port", "0"],
                tree, log("seed"), env={"DRAGONFLY_OBJ_ACCESS_KEY": OBJ_ACCESS,
                                        "DRAGONFLY_OBJ_SECRET_KEY": OBJ_SECRET})
            procs.append(seed)
            if "OBJSTORE" not in seed.ready:
                _fail(f"the seed's READY line lacks OBJSTORE: {' '.join(seed.ready)}")
            objstore = f"http://{seed.ready[1]}:{seed.ready[seed.ready.index('OBJSTORE') + 1]}"
            for request in (mrpc.RegisterInstanceRequest(
                    source_type="seed_peer", host_name="seed", ip=seed.ready[1],
                    port=int(seed.ready[2]), cluster_id=spc_id),
                    mrpc.KeepAliveRequest(source_type="seed_peer", host_name="seed",
                                          ip=seed.ready[1], cluster_id=spc_id)):
                asyncio.run(_manager_call(rpc, request))
            snapshot = pathlib.Path(root, "traces", f"dynconfig-cluster{sc_id}.json")
            _wait_for(lambda: snapshot.exists() and json.loads(snapshot.read_text())["seed_peers"],
                      3 * MGR_APPLY_S, "the scheduler's dynconfig to list the seed", procs)

            def start(i):
                name = f"df-{i:02d}"
                return _Process(name, [
                    "dfdaemon", "--data-dir", os.path.join(root, name), "--manager", rpc,
                    "--hostname", name, "--proxy", "--proxy-rule", "^s3://",
                    "--dynconfig-interval", str(MGR_DYNCONFIG_S), "--metrics-port", "0"],
                    tree, log(name))

            with concurrent.futures.ThreadPoolExecutor(daemons) as pool:
                dfs = list(pool.map(start, range(daemons)))
            procs.extend(dfs)
            ready = sorted(d.ready_s for d in dfs)
            print(f"objects: READY: the manager {mgr.ready_s:.2f} s (registry on the S3 stub), "
                  f"the scheduler {sched.ready_s:.2f} s (ml arm, --manager, the same registry) on "
                  f"{where}, the seed {seed.ready_s:.2f} s (OBJSTORE over the stub), {daemons} "
                  f"dfdaemons p50 {statistics.median(ready):.2f} s max {ready[-1]:.2f} s, host "
                  f"clock ({card})")

            # -- (a) a model registry on S3: publish, activate, serve
            model = GraphSAGERanker(TrainerConfig().hidden_dim, GRAPH_LAYERS).reset_parameters(
                torch.Generator().manual_seed(SEED + 18))
            created = asyncio.run(_manager_call(rpc, mrpc.CreateModelRequest(
                name=GNN_MODEL_NAME, type="gnn", scheduler_host_id=OBJ_SCHED_ID,
                params_blob=params_to_bytes(graphsage_params_to_flax(model)), evaluation={})))
            prefix = f"registry/{created.model_id}/{created.version}/"
            params = stub.object(OBJ_REGISTRY, prefix + "params.msgpack")
            manifest = stub.object(OBJ_REGISTRY, prefix + "params.sha256")
            if params is None or manifest is None:
                _fail(f"CreateModel left no params under {prefix} in the stub: "
                      f"{stub.keys(OBJ_REGISTRY)}")
            if json.loads(manifest)["sha256"] != hashlib.sha256(params).hexdigest():
                _fail("the registry's params.sha256 differs from the sha256 of the params the "
                      "stub holds")
            reads = stub.gets[OBJ_REGISTRY, prefix + "params.msgpack"]
            row = next(r for r in rest("GET", f"/api/v1/models?model_id={created.model_id}")
                       if r["version"] == created.version)
            start_s = time.perf_counter()
            if rest("PATCH", f"/api/v1/models/{row['id']}", {"state": "active"})["state"] != "active":
                _fail(f"PATCH /api/v1/models/{row['id']} did not activate it")
            _wait_for(lambda: f"ml evaluator serving model version {created.version}"
                      in sched.log(), MGR_SERVE_S, "the ml arm to serve the S3 version", procs)
            serve_s = time.perf_counter() - start_s
            if stub.gets[OBJ_REGISTRY, prefix + "params.msgpack"] <= reads:
                _fail("the scheduler serves the version without a GET of its params from S3")
            print(f"objects: CreateModel published GNN version {created.version} (hidden "
                  f"{TrainerConfig().hidden_dim}, seeded) into the S3 registry; params.sha256 "
                  f"{json.loads(manifest)['sha256'][:16]}.. equals the sha256 of the "
                  f"{len(params)} bytes the stub holds; REST activation to 'serving model "
                  f"version {created.version}' {serve_s:.2f} s, host clock ({card})")

            # -- (b) back-source from S3 through the swarm
            task_id = idgen.task_id_v1(url)
            start_s = time.perf_counter()
            job = rest("POST", "/api/v1/jobs", {"type": "preheat", "args": {
                "type": "file", "url": url, "headers": creds}})
            if job["result"]["task_ids"] != [task_id]:
                _fail(f"the preheat job {job} does not hold the daemons' task id {task_id}")
            done = _wait_for(lambda: (lambda j: j if j["state"] != "PENDING" else None)(
                rest("GET", f"/api/v1/jobs/{job['id']}")), MGR_JOB_S, "the preheat job", procs)
            job_s = time.perf_counter() - start_s
            if done["state"] != "SUCCESS":
                _fail(f"the preheat job ended {done['state']}: {done['result']}")
            bad, newest_ms, bound_ms, ring_n = _seed_cost_verdict(os.path.join(root, "seed"), task_id)
            seed_costs = (f"the seed's newest origin piece cost {newest_ms:.3f} ms against the "
                          f"bad-node bound {bound_ms:.3f} ms of its {ring_n}-cost ring: "
                          f"{'judged BAD' if bad else 'not judged bad'}")
            proxy = {d.name: int(d.ready[4]) for d in dfs}
            start_s = time.perf_counter()

            def fetch(name):
                return name, _s3_proxy_fetch(proxy[name], url), time.perf_counter() - start_s

            with concurrent.futures.ThreadPoolExecutor(daemons) as pool:
                fetched = list(pool.map(fetch, proxy))
            wall = time.perf_counter() - start_s
            refused = [(name, got[0], got[4]) for name, got, _ in fetched if got[0] != 200]
            if refused:
                name = refused[0][0]
                _fail(f"{len(refused)} of {daemons} proxies answered {url} with an error, "
                      f"{refused[0][0]} with {refused[0][1]}: {refused[0][2]!r}; {seed_costs}"
                      + _log_tails(
                          [d for d in dfs if d.name == name] + [seed, sched]))
            for name, (_, digest, n, via, _), _ in fetched:
                if digest != blob_sha or via != "p2p":
                    _fail(f"{name} {url} through its proxy: sha256 {digest} ({n} bytes, via {via})")
            node_s = {name: s for name, _, s in fetched}
            served = stub.served[OBJ_BUCKET, OBJ_KEY] / len(blob)
            if f"{served:.3f}" != "1.000" or stub.refused or not stub.ranged:
                _fail(f"the stub served {served:.3f} of the object's bytes, refused "
                      f"{stub.refused} signatures and served {stub.ranged} ranged GETs")
            per_node = list(node_s.values())
            print(f"objects: preheat of {url} ({len(blob) / 2**20:.0f} MiB, credentials in "
                  f"x-df-* headers) from POST /api/v1/jobs to SUCCESS {job_s:.2f} s; {daemons} "
                  f"dfdaemons pull it at once through their proxies: wall {wall:.2f} s, "
                  f"{daemons * len(blob) / 2**20 / wall:.1f} MiB/s aggregate, per daemon p50 "
                  f"{_pct(per_node, 50):.2f} s p99 {_pct(per_node, 99):.2f} s; every body the "
                  f"object's sha256; stub bytes served / object bytes {served:.3f} over "
                  f"{stub.gets[OBJ_BUCKET, OBJ_KEY]} GETs ({stub.ranged} ranged), "
                  f"{stub.refused} signatures refused; {seed_costs}, host clock ({card})")

            # -- (c) the daemon's object-storage service, through dfstore
            data = rng.integers(0, 256, put_mib << 20, dtype=np.uint8).tobytes()
            src = os.path.join(root, "put.bin")
            with open(src, "wb") as f:
                f.write(data)
            client = DfstoreClient(objstore)
            client.create_bucket(OBJ_STORE_BUCKET)

            def dfstore(*args):
                start = time.perf_counter()
                got = subprocess.run(
                    [sys.executable, "-m", "dragonfly2_tpu_torch.client.cli", "dfstore", *args,
                     "--endpoint", objstore, "--bucket", OBJ_STORE_BUCKET],
                    cwd=tree, env=dict(os.environ, PYTHONPATH=tree), capture_output=True,
                    timeout=DATA_FETCH_S)
                if got.returncode != 0:
                    _fail(f"dfstore {' '.join(args)} exited {got.returncode}: {got.stderr[-2000:]}")
                return got.stdout, time.perf_counter() - start

            _, put_s = dfstore("put", "--key", "weights/a.bin", "--path", src)
            if not client.is_object_exist(OBJ_STORE_BUCKET, "weights/a.bin"):
                _fail("dfstore put left no object the service reports")
            got, get_s = dfstore("get", "--key", "weights/a.bin")
            if got != data:
                _fail(f"dfstore get returned {len(got)} bytes unequal to the {len(data)} put")
            client.copy_object(OBJ_STORE_BUCKET, "weights/a.bin", "weights/b.bin")
            listed, _ = dfstore("sum", "--key", "weights/")
            names = sorted(line.split()[-1] for line in listed.decode().splitlines())
            if names != ["weights/a.bin", "weights/b.bin"] or stub.object(
                    OBJ_STORE_BUCKET, "weights/b.bin") != data:
                _fail(f"after the copy dfstore sum lists {names}")
            stub.delete(OBJ_STORE_BUCKET, "weights/a.bin")  # behind the daemon's back
            if client.get_object(OBJ_STORE_BUCKET, "weights/a.bin") != data:
                _fail("the GET fell back to the imported task with other bytes")
            client.delete_object(OBJ_STORE_BUCKET, "weights/a.bin")
            try:
                client.get_object(OBJ_STORE_BUCKET, "weights/a.bin")
                _fail("a GET after dfstore's delete still answered: the task was kept")
            except dferrors.NotFound:
                pass
            print(f"objects: dfstore --endpoint on the seed's OBJSTORE ({put_mib} MiB): put "
                  f"{put_mib / put_s:.1f} MiB/s ({put_s:.2f} s), get {put_mib / get_s:.1f} MiB/s "
                  f"({get_s:.2f} s), each a CLI process; exists, copy and sum listing held; "
                  f"deleted in the stub, the GET answered from the imported task with equal "
                  f"bytes; dfstore's delete removed the task, host clock ({card})")

            # -- (d) the flight recorder
            _flight_get(s_metrics)  # drains the notes of every signature so far
            before = _scrape(s_metrics)
            asyncio.run(_tick_asks(s_host, s_port, task_id, url, len(blob), OBJ_TICK_ASKS))
            after = _scrape(s_metrics)
            ticks = (after["dragonfly_scheduler_tick_seconds_count"]
                     - before["dragonfly_scheduler_tick_seconds_count"])
            captures = [m.get("dragonfly_costcard_captures_total", 0.0) for m in (before, after)]
            if ticks < OBJ_TICK_ASKS or captures[1] != captures[0]:
                _fail(f"across {ticks:.0f} ticks (at least {OBJ_TICK_ASKS}) the ledger's captures "
                      f"went {captures[0]:.0f} -> {captures[1]:.0f}: a capture ran in a tick")
            body, dump = _flight_get(s_metrics)
            missing = [s for s in flight.DUMP_SECTIONS if s not in dump]
            if missing or len(body) > flight.DUMP_MAX_BYTES:
                _fail(f"/debug/flight lacks {missing} or is {len(body)} bytes "
                      f"(cap {flight.DUMP_MAX_BYTES})")
            if dump["ticks"]["ticks_total"] <= 0 or not dump["ticks"]["p50_ms"]:
                _fail(f"the dump's ticks section is empty: {dump['ticks']}")
            ran = {name: s for name, s in dump["jit"].items() if s["calls"] > 0}
            need = ("scheduler.ml.schedule_from_packed", "scheduler.ml.embed_hosts")
            if any(n not in ran for n in need):
                _fail(f"the dump's jit section lacks a served entry: {dump['jit']}")
            cards = collections.Counter(c["entry"] for c in dump["costcards"]["cards"])
            # every (entry, signature) the jit section saw has its card (a
            # refresh may note one more between the two sections)
            short = {n: (s["signatures"], cards[n]) for n, s in ran.items()
                     if cards[n] < s["signatures"]}
            bad = [c["entry"] for c in dump["costcards"]["cards"]
                   if c["bytes_accessed"] <= 0 or c["flops"] <= 0]
            if short or bad or dump["costcards"]["capture_errors"]:
                _fail(f"cost cards: (signatures, cards) {short}, without flops or bytes {bad}, "
                      f"errors {dump['costcards']['capture_errors']}")
            small, sdoc = _flight_get(s_metrics, f"?section=ticks,jit&max_bytes={OBJ_SMALL_DUMP}")
            if set(sdoc) - {"generated_at_ns", "truncated"} != {"ticks", "jit"} \
                    or len(small) > OBJ_SMALL_DUMP:
                _fail(f"?section=ticks,jit&max_bytes={OBJ_SMALL_DUMP} gave {sorted(sdoc)} in "
                      f"{len(small)} bytes")
            remote = RemoteScheduler(s_host, s_port)
            try:
                wire = remote.flight_recorder(64)
            finally:
                remote.close()
            if set(wire) != set(dump):
                _fail(f"the wire dump's sections {sorted(wire)} differ from the HTTP dump's "
                      f"{sorted(dump)}")
            mgr_doc = rest("GET", "/api/v1/flight-recorder")
            mine = [name for name, d in mgr_doc["schedulers"].items()
                    if "error" not in d and "ticks" in d]
            if "manager" not in mgr_doc or not mine:
                _fail(f"the manager's flight recorder lacks its own or the scheduler's section: "
                      f"{ {k: sorted(v) for k, v in mgr_doc['schedulers'].items()} }")
            print(f"objects: /debug/flight {len(body)} bytes (cap {flight.DUMP_MAX_BYTES}), "
                  f"{dump['ticks']['ticks_total']} ticks, sections {sorted(dump)}; "
                  f"?section=ticks,jit&max_bytes={OBJ_SMALL_DUMP}: {len(small)} bytes; the wire "
                  f"FlightRecorderRequest and the manager's /api/v1/flight-recorder (sections "
                  f"manager and {mine}) agree; entries that ran: "
                  + ", ".join(f"{n} {s['calls']:.0f} calls {s['signatures']} signatures"
                              for n, s in sorted(ran.items()))
                  + f"; captures {captures[0]:.0f} before and after {ticks:.0f} ticks, host "
                  f"clock ({card})")
            print(f"objects: cost cards on {where} (telemetry/costcard.py counting rules):")
            for line in _cost_table(dump, card):
                print(line)

            # -- (e) shutdown
            stop_s = {p.name: p.stop() for p in [*dfs, seed, sched, mgr]}
            df_stops = sorted(stop_s[d.name] for d in dfs)
            print(f"objects: SIGTERM -> exit 0 in p50 {statistics.median(df_stops):.2f} s max "
                  f"{df_stops[-1]:.2f} s (dfdaemons), seed {stop_s['seed']:.2f} s, scheduler "
                  f"{stop_s['scheduler']:.2f} s, manager {stop_s['manager']:.2f} s, host clock "
                  f"({card})")
        finally:
            for p in procs:
                p.kill()
            stub.stop()


# slice 23: the scale labs. (a) the reference's 1,500-host soak day
# (tests/test_megascale.py _mega_run); (b) its 10^6-host planet slice and
# its 50k-host soak smoke; (c) the fleet builtin at
# tests/test_wire_contract.py's size; (d) the planet of processes over
# tools/dfproc.py's default day (the procday spec's 12 rounds: a 6-round
# day leaves the divergence's pieces-per-download ratio at 0.236, below
# its 0.25 band, in both packages alike; tests/test_torch_procworld.py
# holds the 6-round day) and dfproc's simulator leg
SCALE_SOAK = dict(scenario="soak", num_hosts=1500, num_tasks=32, seed=7,
                  arrivals_per_round=24, retire_after_rounds=24)
SCALE_PLANET = dict(scenario="planet", num_hosts=1_000_000, num_tasks=128, seed=11,
                    rounds=20, drain_rounds=6, arrivals_per_round=8_000)
SCALE_SMOKE = dict(scenario="soak", num_hosts=50_000, num_tasks=64, seed=7, rounds=8,
                   drain_rounds=2, arrivals_per_round=600)
SCALE_PLANET_REGISTERED = 40_000  # the 10^6 slice's registrations must exceed this
SCALE_FLEET = dict(scenario="fleet", num_hosts=2000, num_tasks=24, seed=11, rounds=40)
SCALE_FLEET_K = 4
SCALE_PROFILED_TICKS = (8, 9, 10)  # ticks of the 10^6-host slice under torch.profiler
SCALE_PROC = dict(rounds=12, schedulers=2, daemons=3, tasks_per_round=4, with_manager=True)
SCALE_PROC_SIM = dict(num_hosts=300, num_tasks=24, arrivals_per_round=16)
SCALE_ATOL = 1e-6
# digests over score-bearing columns: equal between two runs of one
# device, not across devices (scores agree to rounding there)
_SCALE_SCORE_DIGESTS = {("decisions", "columns_digest"), ("tail", "digest")}


def _scale_close(got, want, path: str = "") -> float:
    """Structure, integers and strings exactly, floats within SCALE_ATOL,
    the score-bearing digests skipped; returns the worst float gap."""
    worst = 0.0
    if isinstance(want, dict):
        if not isinstance(got, dict) or sorted(got, key=str) != sorted(want, key=str):
            _fail(f"scale labs: {path} keys differ")
        for key in want:
            if (path.rsplit("/", 1)[-1], key) not in _SCALE_SCORE_DIGESTS:
                worst = max(worst, _scale_close(got[key], want[key], f"{path}/{key}"))
    elif isinstance(want, (list, tuple)):
        if not isinstance(got, (list, tuple)) or len(got) != len(want):
            _fail(f"scale labs: {path} lengths differ")
        for i, (g, w) in enumerate(zip(got, want)):
            worst = max(worst, _scale_close(g, w, f"{path}[{i}]"))
    elif isinstance(want, float):
        gap = abs(got - want) if isinstance(got, float) else float("inf")
        if not (gap <= SCALE_ATOL or (got != got and want != want)):
            _fail(f"scale labs: {path} {got!r} vs {want!r}")
        worst = max(worst, gap if gap == gap else 0.0)
    elif type(got) is not type(want) or got != want:
        _fail(f"scale labs: {path} {got!r} vs {want!r}")
    return worst


def _scale_run(device, profiled=(), **kw):
    """One run_megascale with its service captured, its selections
    recorded and the ticks in ``profiled`` under torch.profiler:
    (report, selections, {"ticks", "launches", "device_ms"})."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dragonfly2_tpu_torch.megascale import engine, soak

    made, selections, prof = {}, [], {"ticks": 0, "launches": 0.0, "device_ms": 0.0,
                                      "tick_ms": 0.0}
    factory = engine.megascale_service

    def capture(*args, **kwargs):
        svc = made["svc"] = factory(*args, **kwargs)
        tick, count = svc.tick, [0]

        def recorded():
            count[0] += 1
            if count[0] not in profiled:
                out = tick()
            else:
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
                    start = time.perf_counter()
                    out = tick()
                    torch.cuda.synchronize()
                    prof["tick_ms"] += (time.perf_counter() - start) * 1e3
                prof["ticks"] += 1
                kernels, launches = _kernel_rows(p, 1)
                prof["device_ms"] += sum(ms for _, ms in kernels)
                prof["launches"] += launches
            selections.extend(
                (r.peer_id, [(p.peer_id, float(p.score)) for p in r.candidate_parents])
                for r in out if hasattr(r, "candidate_parents"))
            return out

        svc.tick = recorded
        return svc

    engine.megascale_service = capture
    try:
        if device != "cpu":
            torch.cuda.reset_peak_memory_stats()
        report = soak.run_megascale(device=device, **kw)
    finally:
        engine.megascale_service = factory
    # device-dependent like the rest of `timing`, which deterministic_view drops
    report["timing"]["max_memory_allocated_mib"] = (
        None if device == "cpu" else torch.cuda.max_memory_allocated() / 2**20)
    return report, selections, prof


def _scale_line(label: str, r: dict, card: str) -> None:
    t = r["timing"]
    mem = t.get("max_memory_allocated_mib")
    print(f"{label}: {r['hosts']} hosts, {r['tasks']} tasks, seed {r['seed']}, {r['rounds']} "
          f"rounds of {r['arrivals_per_round']} arrivals: setup {t['setup_s']} s, wall "
          f"{t['wall_s']} s, {r['stats']['pieces']} pieces = {t['pieces_per_sec']} pieces/s, "
          f"{t['events_per_sec']} events/s; registered {r['stats']['registered']}, completed "
          f"{r['stats']['completed']}; peak RSS {t['peak_rss_mb']} MiB, max memory allocated "
          f"{'n/a' if mem is None else f'{mem:.1f} MiB'} (host clock after a device sync; "
          f"{card})")
    print(f"{label} engine step phases p50 ms: "
          + ", ".join(f"{k} {v}" for k, v in t["step_phases_p50_ms"].items()))
    print(f"{label} tick phases p50 ms: "
          + ", ".join(f"{k} {v}" for k, v in t["tick_phases_p50_ms"].items()))


def _scale_soak_pair(card: str, device: str) -> None:
    """(a) the 1,500-host soak day twice on ``device`` (the card) and once
    on the CPU: the card's two runs identical, digests included; card
    against CPU, selections (ids exactly, scores within SCALE_ATOL) and
    the deterministic view (exact but for floats within SCALE_ATOL and the
    score-bearing digests)."""
    from dragonfly2_tpu_torch.megascale.soak import deterministic_view

    first, first_sel, _ = _scale_run(device, **SCALE_SOAK)
    again, again_sel, _ = _scale_run(device, **SCALE_SOAK)
    cpu, cpu_sel, _ = _scale_run("cpu", **SCALE_SOAK)
    if deterministic_view(first) != deterministic_view(again) or first_sel != again_sel:
        _fail("scale labs: two runs of the soak day on the card differ")
    if [p for p, _ in first_sel] != [p for p, _ in cpu_sel]:
        _fail("scale labs: the soak day's selections differ on the card and the CPU")
    score_gap = 0.0
    for (peer, g), (_, w) in zip(first_sel, cpu_sel):
        if [pid for pid, _ in g] != [pid for pid, _ in w]:
            _fail(f"scale labs: {peer}'s parents differ on the card and the CPU")
        score_gap = max([score_gap] + [abs(a - b) for (_, a), (_, b) in zip(g, w)])
    if score_gap > SCALE_ATOL:
        _fail(f"scale labs: soak-day scores differ by {score_gap:.3g} on the card and the CPU")
    view_gap = _scale_close(deterministic_view(first), deterministic_view(cpu))
    fam = first["fault_families"]
    if not all(fam.values()) or first["stats"]["pieces"] == 0:
        _fail(f"scale labs: the soak day left a fault family at zero: {fam}")
    print(f"scale soak day: two card runs identical (deterministic view, digests included, "
          f"{len(first_sel)} selections); card vs CPU: selections equal (scores within "
          f"{score_gap:.3g}), every integer, string and digest of the view equal but the "
          f"ledger's and the tail's score digests, floats within {view_gap:.3g}; fault "
          f"families {fam}")
    for label, r in (("scale soak day, card run 1", first), ("scale soak day, card run 2", again),
                     ("scale soak day, CPU run", cpu)):
        _scale_line(label, r, card)


def _scale_planet(card: str, device: str) -> None:
    """(b) the 10^6-host planet slice (ticks SCALE_PROFILED_TICKS profiled)
    and the 50k-host soak smoke, on the card."""
    planet, _, prof = _scale_run(device, profiled=SCALE_PROFILED_TICKS, **SCALE_PLANET)
    st = planet["stats"]
    if st["completed"] != st["registered"] or st["registered"] <= SCALE_PLANET_REGISTERED:
        _fail(f"scale labs: the 10^6-host slice registered {st['registered']} and completed "
              f"{st['completed']}")
    _scale_line("scale planet 10^6", planet, card)
    if prof["ticks"]:
        print(f"scale planet 10^6 profiled ticks {list(SCALE_PROFILED_TICKS)}: "
              f"{prof['tick_ms'] / prof['ticks']:.3f} ms a tick (host clock, profiled), "
              f"{prof['launches'] / prof['ticks']:.0f} launches and "
              f"{prof['device_ms'] / prof['ticks']:.4f} ms of device kernels a tick, device busy "
              f"{100 * prof['device_ms'] / max(prof['tick_ms'], 1e-9):.1f}% of the ticks ({card})")
    smoke, _, _ = _scale_run(device, **SCALE_SMOKE)
    st = smoke["stats"]
    if st["pieces"] <= 10_000 or st["completed"] <= 500 or len(smoke["regions"]) != 4:
        _fail(f"scale labs: the 50k soak smoke gave {st['pieces']} pieces, {st['completed']} "
              f"completed, {len(smoke['regions'])} regions")
    _scale_line("scale soak smoke 50k", smoke, card)
    print(f"scale soak smoke 50k fault families {smoke['fault_families']}")


def _scale_fleet(card: str, device: str) -> None:
    """(c) the fleet builtin: the plain run, K = 1 (equal outside the
    fleet columns) and K = SCALE_FLEET_K (a kill loses zero downloads, the
    announce page fires at the kill round and clears)."""
    from dragonfly2_tpu_torch.megascale.soak import run_megascale

    plain = run_megascale(device=device, **SCALE_FLEET)
    one = run_megascale(device=device, fleet_replicas=1, **SCALE_FLEET)
    for key in ("stats", "fault_schedule_digest", "decisions", "slo", "scheduler_counts",
                "regions", "mega", "failover", "recovery"):
        if one[key] != plain[key]:
            _fail(f"scale labs: the K = 1 fleet's {key} differs from the plain run's")
    cols = {"fleet_pieces", "fleet_handoffs", "shards_in_ring", "shards_down"}
    if one["tail"]["digest"] != plain["tail"]["digest"] or [
            {k: v for k, v in s.items() if k not in cols} for s in one["timeline"]] \
            != plain["timeline"]:
        _fail("scale labs: the K = 1 fleet's tail or timeline differs from the plain run's")
    many = run_megascale(device=device, fleet_replicas=SCALE_FLEET_K, **SCALE_FLEET)
    st, fl = many["stats"], many["fleet"]
    kills = [v["round"] for v in fl["crash_victims"]]
    pages = [e for e in many["slo"]["alert_log"]
             if e["slo"] == "announce_stability" and e["severity"] == "page"]
    fired = [e["t"] for e in pages if e["event"] == "fired"]
    cleared = [e["t"] for e in pages if e["event"] == "cleared"]
    if st["failed"] or not kills or not fired or any(
            t not in kills or not any(c > t for c in cleared) for t in fired):
        _fail(f"scale labs: K = {SCALE_FLEET_K}: failed {st['failed']}, kills {kills}, pages "
              f"fired {fired}, cleared {cleared}")
    print(f"scale fleet: K = 1 equals the plain run outside the fleet columns; K = "
          f"{SCALE_FLEET_K}: {st['injected_scheduler_crashes']} kills at rounds {kills}, 0 lost "
          f"downloads, pages fired {fired} cleared {cleared}, handoffs {fl['handoffs']}")
    for label, r in (("plain", plain), ("K = 1", one), (f"K = {SCALE_FLEET_K}", many)):
        timing = r["timing"]
        f = timing.get("fleet", {})
        print(f"scale fleet {label}: wall {timing['wall_s']} s, {r['stats']['pieces']} pieces = "
              f"{timing['pieces_per_sec']} pieces/s; tick p50s "
              + ", ".join(f"{k} {v}" for k, v in timing["tick_phases_p50_ms"].items()
                          if k in ("fused_device_call", "control_dispatch"))
              + (f"; timing.fleet: aggregate {f['aggregate_pieces_per_sec']} pieces/s, serial "
                 f"{f['sched_serial_s']} s, critical {f['sched_critical_s']} s, by shard "
                 f"{f['sched_seconds_by_shard']}, modeled parallel wall "
                 f"{f['modeled_parallel_wall_s']} s" if f else "")
              + f" ({card})")


def _scale_procday(card: str, device: str) -> None:
    """(d) the planet of processes (2 schedulers on the card, 3 dfdaemons,
    the spec's seed daemons and a manager) over the procday spec's day: zero lost downloads, P2P
    completions, the kills at the spec's rounds with failover, the
    restart waves, each page at its kill round and cleared the round
    after, every exit code set; then the simulator leg on the card, every
    divergence metric within its band."""
    from dragonfly2_tpu_torch.megascale.soak import run_megascale
    from dragonfly2_tpu_torch.procworld import compute_divergence, real_facts, run_procday

    with tempfile.TemporaryDirectory() as work:
        run = run_procday(os.path.join(work, "planet"), device=device, **SCALE_PROC)
    st = run["stats"]
    cleared = [e["t"] for e in run["slo"]["alert_log"]
               if e["slo"] == "announce_stability" and e["severity"] == "page"
               and e["event"] == "cleared"]
    kills = [5.0, 10.0]  # the procday spec's certain kill every 5th round
    problems = []
    if st["lost_downloads"] or not st["completed"] or not st["via_p2p"]:
        problems.append(f"stats {st}")
    if run["kill_rounds"] != kills or st["kills"] != len(kills) or st["failovers"] < 1:
        problems.append(f"kills {run['kill_rounds']}, failovers {st['failovers']}")
    if st["restarts"] < 4 or run["page_rounds"] != kills or cleared != [k + 1 for k in kills]:
        problems.append(f"restarts {st['restarts']}, pages {run['page_rounds']}, cleared "
                        f"{cleared}")
    if any(code is None for code in run["proc"]["exit_codes"].values()):
        problems.append(f"exit codes {run['proc']['exit_codes']}")
    print(f"scale procday: {SCALE_PROC['schedulers']} schedulers on the card, "
          f"{SCALE_PROC['daemons']} dfdaemons, {run['seeds']} seed daemons and a manager, "
          f"{run['rounds']} rounds: wall "
          f"{run['timing']['wall_s']} s, {st['completed']} downloads = "
          f"{run['timing']['downloads_per_sec']} downloads/s; stats {st}; kills at "
          f"{run['kill_rounds']}, pages at {run['page_rounds']}, cleared at {cleared}; exit "
          f"codes {run['proc']['exit_codes']} (host clock; {card})")
    for k in run["kill_log"]:
        print(f"scale procday kill round {k['round']}: {k['victim']} killed with {k['backlog']} "
              f"downloads waiting on it; b = {k['b']} origin copies beyond the round's "
              f"seeders; {k['failovers']} failovers; the scheduler that inherited its tasks "
              f"{'sent' if k['seed_downloads'] + k['reannounces'] else 'sent no'} seed "
              f"triggers ({k['seed_downloads']} seed downloads, {k['reannounces']} seed "
              f"re-announces); {run['seeds']} seed daemons (host clock; {card})")
    if problems:
        _fail("scale labs: the planet day: " + "; ".join(problems))
    sim = run_megascale("procday", seed=run["seed"], rounds=run["rounds"], device=device,
                        **SCALE_PROC_SIM)
    div = compute_divergence(real_facts(run), sim)
    for name, m in sorted(div["metrics"].items()):
        print(f"scale divergence {name}: real {m['real']} sim {m['sim']} value {m['value']} "
              f"band {m['band']} {'within' if m['within'] else 'OUT OF BAND'}")
    print(f"scale procday simulator leg: {sim['hosts']} hosts, wall {sim['timing']['wall_s']} s "
          f"({card})")
    if not div["all_within"]:
        _fail("scale labs: a sim-vs-real divergence metric is out of its band")


@_phase("scale labs (d)")
def phase_scale_labs(card: str, tree: str, device: str = "cuda") -> None:
    """Slice 23's main path: the scale labs driving the port's scheduler
    on the card (megascale/, procworld/): (d) here, the planet's processes
    running the package of ``tree``; (a) to (c) in a process of their own
    (``_scale_megascale``). No hand kernel is on this path: the flash counts
    are zeroed before it and must read zero after."""
    from dragonfly2_tpu_torch.procworld import supervisor

    if supervisor.REPO != pathlib.Path(tree).resolve():
        _fail(f"the planet would start {supervisor.REPO}'s package, not {tree}'s")
    _zero_counts()
    _zero_wide_counts()
    _scale_procday(card, device)
    if any(_counts().values()) or any(_wide_counts().values()):
        _fail(f"the scale labs launched a flash kernel: {_counts()} {_wide_counts()}")


def _scale_megascale(card: str, device: str) -> None:
    """Phase 19 (a) to (c), the megascale runs: the 10^6-host slice first
    (its setup is host work alone), then the soak day and the fleet. No
    hand kernel is on this path."""
    _zero_counts()
    _zero_wide_counts()
    _scale_planet(card, device)
    _scale_soak_pair(card, device)
    _scale_fleet(card, device)
    if any(_counts().values()) or any(_wide_counts().values()):
        _fail(f"the scale labs launched a flash kernel: {_counts()} {_wide_counts()}")


# Two legs run in a process of their own (chip_smoke.py --side-worker),
# each beside phases of the main process whose checks it does not touch,
# so that its host work (a core of the card's machine) adds little to the
# run's wall: phase 19 (a) to (c), the megascale runs (the largest serial
# host cost of the run, the 10^6 hosts' announce first), beside phases 10
# to 16, and phase 21, the workload drivers, beside phase 20. Neither runs
# beside a phase that times kernels (3 to 9): another process's work on
# the card, or a busy core, moves those times. A leg's lines are printed
# when it is joined, with its phase line (its seconds from its process's
# start to its exit), and its failure fails the run there.
SIDE_TIMEOUT_S = {"scale": 900, "drivers": 600}
SIDE_PHASES = {"scale": "scale labs (a)-(c)", "drivers": "workload drivers"}


def _side_worker(spec: str) -> None:
    """A side process: ``LEG,DEVICE,CARD`` (CARD, the card's nvidia-smi
    line, for the labels); LEG ``scale`` is phase 19 (a) to (c),
    ``drivers`` phase 21."""
    leg, device, card = spec.split(",", 2)
    {"scale": _scale_megascale, "drivers": phase_workload_drivers}[leg](card, device)


class _SideProcess:
    """One leg in a process of its own, its output to a file."""

    def __init__(self, leg: str, tree: str, card: str, device: str = "cuda"):
        self.leg, self.log = leg, tempfile.TemporaryFile("w+")
        self.start = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--tree", tree, "--side-worker",
             f"{leg},{device},{card}"], cwd=tree, stdout=self.log, stderr=subprocess.STDOUT)

    def join(self, card: str, beside: str) -> None:
        """Wait for the process, print its lines and its phase line; fail
        the run unless it exited 0."""
        try:
            code = self.proc.wait(timeout=max(1.0, SIDE_TIMEOUT_S[self.leg]
                                              - (time.perf_counter() - self.start)))
        except subprocess.TimeoutExpired:
            code = None
        finally:
            self.stop()
        seconds = time.perf_counter() - self.start
        self.log.seek(0)
        out = self.log.read()
        self.log.close()
        print(out, end="" if out.endswith("\n") or not out else "\n")
        name = SIDE_PHASES[self.leg]
        PHASE_SECONDS[name] = seconds
        print(f"{name}: in a process of its own beside {beside}, its seconds from the "
              "process's start to its exit")
        print(f"{name} phase: {seconds:.1f} s ({card})", flush=True)
        if code != 0:
            _fail(f"the {name} process exited {code} after {seconds:.1f} s: {out[-3000:]}")

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


# slice 24: tensor, pipeline and expert parallelism on meshes of the one
# card (phase 20; every mesh is the card repeated). The bodies at the
# ranker's widths, float32: F = 128, hidden 512, T = 5,120 tokens (one
# batch of 256 rows x 20 candidates), E = 4 experts
PAR_F, PAR_HIDDEN, PAR_TOKENS, PAR_EXPERTS = 128, 512, 5120, 4
PAR_MICRO = 4  # the pipeline's microbatches, the bodies' and the pp training's
# the bodies against their single-device oracle and against the CPU mesh,
# float32 (the reference's dryrun holds 1e-4, __graft_entry__.py:243-290)
PAR_ATOL = 1e-4
# the dropping capacity: this share of a shard's even split of its tokens
PAR_DROP_SHARE = 0.9
PAR_CALLS = 10  # CUDA-event calls of each body and its oracle
# the config-driven trainings on phase 5's trace: TrainerConfig's defaults,
# one epoch; (label, mesh axes or None, config overrides)
PAR_TRAININGS = (
    ("tp", {"dp": 2, "tp": 2}, {"attention_tp": True}),
    ("ep", {"dp": 2, "ep": 2}, {"attention_moe_experts": 4}),
    ("pp", {"dp": 1, "pp": 2}, {"attention_pp": True, "attention_pp_microbatches": PAR_MICRO}),
    ("moe", None, {"attention_moe_experts": 4}),
)
PAR_EMBED_MESH = {"dp": 2, "graph": 2}
# the hybrid mesh's two-process leg: rows a batch, and each process's
# (and the wait's) limit in seconds
PAR_DCN_BATCH = 64
PAR_DCN_TIMEOUT_S = 300


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _par_mesh(axes: dict, device):
    """A mesh of ``axes`` over ``device`` repeated (the card, or the CPU)."""
    from dragonfly2_tpu_torch.parallel.mesh import make_mesh

    n = int(np.prod(list(axes.values())))
    return make_mesh(n, devices=[device] * n, **axes)


def _par_hold(label: str, got, oracle, cpu) -> str:
    """got (the mesh of ``device``) within PAR_ATOL of its one-device
    oracle and of the same call on a CPU mesh; the errors, as text."""
    errs = [float((got.float().cpu() - other.float().cpu()).abs().max()) for other in (oracle, cpu)]
    if not np.isfinite(got.float().cpu().numpy()).all() or max(errs) > PAR_ATOL:
        _fail(f"{label}: max error {errs[0]:.3g} against the oracle, {errs[1]:.3g} against the "
              f"CPU mesh (atol {PAR_ATOL})")
    return (f"max error {errs[0]:.3g} against the one-device oracle, {errs[1]:.3g} against the "
            f"CPU mesh (atol {PAR_ATOL})")


def _par_ms(fn, device) -> str:
    """p50 of PAR_CALLS calls by CUDA events, as text (not measured on
    the CPU)."""
    import torch

    if torch.device(device).type != "cuda":
        return "not measured (CPU)"
    return f"{_event_ms(fn, PAR_CALLS)[1]:.3f} ms"


def _par_bodies(card: str, device) -> None:
    """(a) sharded_tp_ffn on tp 4 and dp 2 x tp 2, sharded_pipeline_apply
    on pp 4 over PAR_MICRO microbatches, sharded_moe_ffn on ep 4 with a
    shard's every token in capacity and with a capacity that drops, each
    against its one-device oracle on ``device`` and against the same call
    on a CPU mesh."""
    import torch
    import torch.nn.functional as F

    from dragonfly2_tpu_torch.parallel import moe, pipeline, tensor

    gen = torch.Generator().manual_seed(SEED)

    def normal(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen) * scale

    f, h, t, e = PAR_F, PAR_HIDDEN, PAR_TOKENS, PAR_EXPERTS
    x = normal(t, f)
    ffn = (normal(f, h, scale=f ** -0.5), normal(h, scale=0.1), normal(h, f, scale=h ** -0.5),
           normal(f, scale=0.1))

    def oracle_ffn(a, w1, b1, w2, b2):
        return torch.matmul(F.gelu(torch.matmul(a, w1) + b1, approximate="tanh"), w2) + b2

    on = [v.to(device) for v in (x, *ffn)]
    with torch.no_grad():
        for axes in ({"dp": 1, "tp": 4}, {"dp": 2, "tp": 2}):
            m = _par_mesh(axes, device)
            got = tensor.sharded_tp_ffn(m, *on)
            held = _par_hold(f"sharded_tp_ffn {axes}", got, oracle_ffn(*on),
                             tensor.sharded_tp_ffn(_par_mesh(axes, "cpu"), x, *ffn))
            print(f"sharded_tp_ffn on dp {axes['dp']} x tp {axes['tp']} of the card, x [{t}, {f}], "
                  f"hidden {h}: {held}; p50 {_par_ms(lambda: tensor.sharded_tp_ffn(m, *on), device)}"
                  f", the oracle {_par_ms(lambda: oracle_ffn(*on), device)} ({card})")

        pp = 4
        stages = tuple(torch.stack([normal(*v.shape, scale=float(v.std())) for _ in range(pp)])
                       for v in ffn)
        micro = x.reshape(PAR_MICRO, t // PAR_MICRO, f)

        def stage_fn(params, a):
            return oracle_ffn(a, *params)

        def sequential(params, a):
            for i in range(pp):
                a = stage_fn(tuple(p[i] for p in params), a)
            return a

        m = _par_mesh({"dp": 1, "pp": pp}, device)
        st, mi = tuple(s.to(device) for s in stages), micro.to(device)
        got = pipeline.sharded_pipeline_apply(m, stage_fn, st, mi)
        held = _par_hold("sharded_pipeline_apply", got, sequential(st, mi),
                         pipeline.sharded_pipeline_apply(_par_mesh({"dp": 1, "pp": pp}, "cpu"),
                                                         stage_fn, stages, micro))
        print(f"sharded_pipeline_apply on pp {pp} of the card, {PAR_MICRO} microbatches of "
              f"[{t // PAR_MICRO}, {f}], each stage an FFN of hidden {h}: {held}; p50 "
              f"{_par_ms(lambda: pipeline.sharded_pipeline_apply(m, stage_fn, st, mi), device)}, "
              f"the stages in sequence {_par_ms(lambda: sequential(st, mi), device)} ({card})")

        # tokens and gate on a 1/16 and 1/64 grid: the gate logits are exact
        # in float32 on either device, so routing and drops are integer facts
        ep = 4
        xq = torch.round(x * 16) / 16
        experts = (torch.round(normal(f, e, scale=0.1) * 64) / 64,
                   normal(e, f, h, scale=f ** -0.5), normal(e, h, scale=0.1),
                   normal(e, h, f, scale=h ** -0.5), normal(e, f, scale=0.1))
        on = [v.to(device) for v in (xq, *experts)]
        local = t // ep
        oracle = moe.moe_reference(*on)
        m, cpu_m = _par_mesh({"dp": 1, "ep": ep}, device), _par_mesh({"dp": 1, "ep": ep}, "cpu")
        for capacity in (local, int(local / e * PAR_DROP_SHARE)):
            got = moe.sharded_moe_ffn(m, *on, capacity=capacity)
            cpu = moe.sharded_moe_ffn(cpu_m, xq, *experts, capacity=capacity)
            keep = {}
            for where, a, gate in (("card", on[0], on[1]), ("cpu", xq, experts[0])):
                keep[where] = torch.cat([
                    moe._top1_dispatch(s, s @ gate, e, capacity)[2]["keep"].cpu()
                    for s in a.split(local)])
            if not torch.equal(keep["card"], keep["cpu"]):
                _fail(f"sharded_moe_ffn capacity {capacity}: the dropped sets differ, card "
                      f"{int((~keep['card']).sum())} tokens, CPU {int((~keep['cpu']).sum())}")
            kept = keep["card"].to(got.device)
            dropped = int((~kept).sum())
            if dropped and (got[~kept] != 0).any():
                _fail(f"sharded_moe_ffn capacity {capacity}: a dropped token is not zero")
            # Switch semantics: a dropped token comes out as zeros
            held = _par_hold(f"sharded_moe_ffn capacity {capacity}", got,
                             torch.where(kept[:, None], oracle, 0.0), cpu)
            if (capacity == local) == bool(dropped):
                _fail(f"sharded_moe_ffn capacity {capacity}: {dropped} tokens dropped")
            print(f"sharded_moe_ffn on ep {ep} of the card, x [{t}, {f}], {e} experts of hidden "
                  f"{h}, capacity {capacity} ({dropped} tokens dropped, the same set on the card "
                  f"and the CPU; the oracle's dropped rows zeroed): {held}; p50 "
                  f"{_par_ms(lambda: moe.sharded_moe_ffn(m, *on, capacity=capacity), device)}, "
                  f"moe_reference {_par_ms(lambda: moe.moe_reference(*on), device)} ({card})")


def _par_trainer(config, in_features: int, path: str, mesh, rows, device):
    """A trainer of ``train_attention``'s ``path`` from SEED's weights."""
    from dragonfly2_tpu_torch.training import train

    if path == "pp":
        model = train.build_pp_ranker(config, mesh.shape["pp"], in_features, SEED, None, device)
    else:
        model = train.build_ranker(config, in_features, SEED, None, device)
    tp_fns = train.tp_attention_fns(mesh, "ring")[0] if path == "tp" else None
    return train.AttentionTrainer(model, rows, config.learning_rate, device, mesh=mesh,
                                  tp_attention_fns=tp_fns)


def _par_expected(path: str, steps: int, layers: int, axes: dict) -> tuple[dict, str]:
    """Each counter's launches on ``path``, and the formula, as text."""
    tp, pp = axes.get("tp", 1), axes.get("pp", 1)
    per_step, per_eval, formula = {
        "tp": (layers * tp, layers * tp, "each training kernel steps x layers x tp (one launch "
               "a head group), the finished forward layers x tp in the eval"),
        "pp": (pp * PAR_MICRO, pp * PAR_MICRO, "each training kernel steps x pp x microbatches "
               "(no bubble slot runs), the finished forward pp x microbatches in the eval"),
    }.get(path, (layers, layers, "each training kernel steps x layers, the finished forward "
                 "layers in the eval (the MoE is no flash kernel)"))
    expected = {name: 0 for name in _COUNTERS}
    expected.update({name: steps * per_step for name in TRAINING_KERNELS}, flash_fwd=per_eval)
    return expected, formula


def _par_train(card: str, ds, device, single_p50, mesh_p50) -> None:
    """(b) train_attention's tp, ep, pp and MoE paths from TrainerConfig and
    the mesh alone, one epoch each on phase 5's trace: the launches against
    their formula, finite losses, the first REPLAY_STEPS steps replayed on a
    CPU mesh of the same shape, the eval, and the step p50."""
    import dataclasses

    import torch

    from dragonfly2_tpu_torch.config.config import TrainerConfig
    from dragonfly2_tpu_torch.parallel.mesh import shard_stacked_batches
    from dragonfly2_tpu_torch.training import data, train

    base = TrainerConfig(epochs=1)
    layers = base.attention_num_layers
    for path, axes, overrides in PAR_TRAININGS:
        config = dataclasses.replace(base, **overrides)
        mesh = None if axes is None else _par_mesh(axes, device)
        _zero_counts()
        _sync(device)
        start = time.perf_counter()
        result = train.train_attention(ds, config, mesh=mesh, seed=SEED,
                                       device=device if mesh is None else None)
        _sync(device)
        train_s = time.perf_counter() - start
        counts = _counts()
        expected, formula = _par_expected(path, result.steps, layers, axes or {})
        where = "one device" if axes is None else " x ".join(f"{k} {v}" for k, v in axes.items())
        print(f"{path} training on {where} of the card: {result.steps} steps of batch "
              f"{config.batch_size} in {train_s:.2f} s; launches {counts} (expected {formula})")
        # the CPU takes the kernels' plain versions, which count nothing
        if counts != (expected if device.type == "cuda" else {k: 0 for k in expected}):
            _fail(f"{path} training launches {counts}, expected {expected}")
        if not np.isfinite(result.losses).all():
            _fail(f"{path} training: non-finite loss")

        # the first steps again on the CPU from the same weights and batches
        rng = np.random.default_rng(SEED)
        eval_idx, train_idx = train._train_eval_split(rng.permutation(len(ds.mask)), 0.2)
        batch_size = min(config.batch_size, len(train_idx))
        rows = train.take(ds, train_idx)
        in_features = sum(rows[key].shape[-1] for key in ("parents", "child", "pair"))
        if mesh is None:
            idx = np.stack(list(data.minibatches(len(train_idx), batch_size, rng)))
            cpu = _par_trainer(config, in_features, path, None, rows, "cpu")
            replay = [cpu.step(torch.from_numpy(i)).item() for i in idx[:REPLAY_STEPS]]
            timed = _par_trainer(config, in_features, path, None, rows, device)
            batches = torch.from_numpy(idx).to(device)

            def step(s, trainer=timed, batches=batches):
                return trainer.step(batches[s])
        else:
            first = train.epoch_batches(ds, train_idx, batch_size, rng)
            cpu_mesh = _par_mesh(axes, "cpu")
            cpu = _par_trainer(config, in_features, path, cpu_mesh, None, "cpu")
            stack = shard_stacked_batches(cpu_mesh, {k: v[:REPLAY_STEPS] for k, v in first.items()})
            replay = [cpu.step_batch({k: v[s] for k, v in stack.items()}).item()
                      for s in range(REPLAY_STEPS)]
            timed = _par_trainer(config, in_features, path, mesh, None, device)
            stack = shard_stacked_batches(mesh, {k: v[:MESH_STEPS] for k, v in first.items()})

            def step(s, trainer=timed, stack=stack):
                return trainer.step_batch({k: v[s] for k, v in stack.items()})
        err = float(np.abs(np.array(replay) - np.array(result.losses[:REPLAY_STEPS])).max())
        em = result.eval_metrics
        print(f"{path}: CPU replay of the first {REPLAY_STEPS} steps max loss difference "
              f"{err:.3g} (atol {REPLAY_LOSS_ATOL}); loss first {result.losses[0]:.4f} last "
              f"{result.losses[-1]:.4f}; eval on {len(eval_idx)} held-out rows: precision "
              f"{em['precision']:.4f}, recall {em['recall']:.4f} of {em['recall_ceiling']:.4f}, "
              f"f1 {em['f1']:.4f}, regret {em['regret']:.4f}; {result.samples_per_sec:.1f} "
              "samples/s")
        if err > REPLAY_LOSS_ATOL:
            _fail(f"{path}: CPU replay loss differs by {err}")

        if device.type != "cuda":
            continue
        times = []
        for s in range(MESH_STEPS):
            _sync(device)
            t0 = time.perf_counter()
            loss = step(s).item()
            _sync(device)
            times.append((time.perf_counter() - t0) * 1e3)
            if not np.isfinite(loss):
                _fail(f"{path}: non-finite loss in the timed steps")
        # the MoE's routing and dispatch: the cumsum (a scan), the queue
        # scatter (index_add), the combine's gather, and their backward
        pattern = r"index|gather|scatter|scan" if config.attention_moe_experts else "flash_"
        kernels = []
        split = _device_split(lambda: step(0), "", kernels_out=kernels)
        prof = _moe_split(kernels, pattern)
        print(f"{path} step p50 {statistics.median(times[2:]):.3f} ms (synchronised, host clock, "
              f"batch {config.batch_size}, {MESH_STEPS - 2} steps); one device "
              + (f"{single_p50:.3f} ms (phase 5)" if single_p50 else "not measured in this run")
              + ", the dp x sp mesh "
              + (f"{mesh_p50:.3f} ms (phase 6, ring)" if mesh_p50 else "not measured in this run")
              + f"; profiled {split[0]:.3f} ms a step, device kernels {split[1]:.4f} ms over "
              f"{split[3]:.0f} launches, busy {100 * split[1] / max(split[0], 1e-9):.1f}%; "
              f"{prof} ({card})")


def _moe_split(kernels, pattern: str) -> str:
    """The device ms a call of the kernels whose name matches ``pattern``,
    and their share of the call's kernel time, from a profiler window's
    (kernel name, ms a call) rows."""
    total = sum(ms for _, ms in kernels)
    matched = [(key, ms) for key, ms in kernels if re.search(pattern, key)]
    named = sum(ms for _, ms in matched)
    if total == 0:
        return "device split not measured (the profiler saw no device activity)"
    top = "; ".join(f"{key[:60]} {ms:.4f}" for key, ms in matched[:3])
    return (f"kernels matching /{pattern}/ {named:.4f} ms a step, {100 * named / total:.1f}% of "
            f"its kernel time (top: {top})")


def _par_embed(card: str, graph, device, segment_p50) -> None:
    """(c) embed_graph_sharded on a dp 2 x graph 2 mesh over phase 12's host
    graph against GraphSAGERanker.embed on the same device, within phase
    12's tolerance; both p50s by CUDA events."""
    import torch

    from dragonfly2_tpu_torch.config.config import TrainerConfig
    from dragonfly2_tpu_torch.models import GraphSAGERanker
    from dragonfly2_tpu_torch.training import embed_graph_sharded
    from dragonfly2_tpu_torch.training.data import edge_bucket, graph_arrays

    model = GraphSAGERanker(TrainerConfig().hidden_dim, GRAPH_LAYERS).reset_parameters(
        torch.Generator().manual_seed(SEED)).to(device)
    seg = graph_arrays(graph, pad_edges_to=edge_bucket(len(graph.edge_src)))
    arrays = _on(seg, device)
    mesh = _par_mesh(PAR_EMBED_MESH, device)
    _zero_counts()
    with torch.no_grad():
        got = embed_graph_sharded(model, None, arrays, mesh)
        want = _embed(model, arrays)
        err = _hold("embed_graph_sharded vs GraphSAGERanker.embed", got, want)
        sharded_ms = _par_ms(lambda: embed_graph_sharded(model, None, arrays, mesh), device)
        plain_ms = _par_ms(lambda: _embed(model, arrays), device)
    if any(_counts().values()):
        _fail(f"the sharded embed launched a flash kernel: {_counts()}")
    print(f"embed_graph_sharded on dp {PAR_EMBED_MESH['dp']} x graph {PAR_EMBED_MESH['graph']} "
          f"of the card over {len(graph.host_ids)} hosts and {len(graph.edge_src)} edges (padded "
          f"to {len(seg['edge_src'])}): vs GraphSAGERanker.embed within {err:.4g} (atol "
          f"{GRAPH_ATOL}, rtol {GRAPH_RTOL}); p50 {sharded_ms}, the segment path {plain_ms} in this "
          "phase, " + (f"{segment_p50:.3f} ms in phase 12" if segment_p50 else
                       "phase 12 not run") + f" (CUDA events, {PAR_CALLS} calls; {card})")


def _dcn_worker(spec: str) -> None:
    """One process of phase 20's two-process leg (``--dcn-worker
    RANK,PORT,DIR``): the dataset, the device and the batch size from DIR,
    gloo over localhost:PORT, a hybrid mesh of dcn 2 x dp 1 on the device,
    one epoch of train_attention; the losses and the eval to
    DIR/RANK.json."""
    import torch

    from dragonfly2_tpu_torch.config.config import TrainerConfig
    from dragonfly2_tpu_torch.parallel.mesh import initialize_distributed, make_hybrid_mesh
    from dragonfly2_tpu_torch.records.features import RankingDataset
    from dragonfly2_tpu_torch.training import train

    rank, port, root = spec.split(",", 2)
    with np.load(os.path.join(root, "ds.npz")) as f:
        ds = RankingDataset(**{key: f[key] for key in f.files})
    leg = json.loads(pathlib.Path(root, "leg.json").read_text())
    initialize_distributed(f"localhost:{port}", 2, int(rank), backend="gloo")
    try:
        mesh = make_hybrid_mesh(dcn_dp=2, dp=1, devices=[leg["device"]])
        result = train.train_attention(ds, TrainerConfig(epochs=1, batch_size=leg["batch"]),
                                       mesh=mesh, seed=SEED)
        pathlib.Path(root, f"{rank}.json").write_text(json.dumps(
            {"losses": result.losses, "eval": result.eval_metrics, "dcn": mesh.dcn}))
    finally:
        torch.distributed.destroy_process_group()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _par_hybrid(card: str, ds, tree: str, device) -> None:
    """(d) make_hybrid_mesh in one process (the dcn replicas fold into dp)
    training (b)'s tp path; then two processes sharing the device over
    gloo, a dcn 2 x dp 1 mesh each, against one process on a dp 2 mesh
    from the same weights."""
    import dataclasses

    from dragonfly2_tpu_torch.config.config import TrainerConfig
    from dragonfly2_tpu_torch.parallel.mesh import make_hybrid_mesh
    from dragonfly2_tpu_torch.training import train

    mesh = make_hybrid_mesh(dcn_dp=2, dp=1, tp=2, devices=[device] * 4)
    if mesh.shape["dp"] != 2 or mesh.shape["tp"] != 2 or mesh.dcn != 1:
        _fail(f"make_hybrid_mesh(dcn_dp=2, dp=1, tp=2) in one process: {mesh.shape}")
    config = TrainerConfig(epochs=1, attention_tp=True)
    _zero_counts()
    result = train.train_attention(ds, config, mesh=mesh, seed=SEED)
    expected, _ = _par_expected("tp", result.steps, config.attention_num_layers, mesh.shape)
    if device.type != "cuda":
        expected = {k: 0 for k in expected}
    if _counts() != expected or not np.isfinite(result.losses).all():
        _fail(f"the hybrid mesh's tp training: launches {_counts()} (expected {expected}), finite "
              f"losses {bool(np.isfinite(result.losses).all())}")
    print(f"make_hybrid_mesh(dcn_dp=2, dp=1, tp=2) in one process: folded to {mesh.shape}; "
          f"{result.steps} tp steps, loss first {result.losses[0]:.4f} last "
          f"{result.losses[-1]:.4f}, launches as (b)'s tp path")

    config = TrainerConfig(epochs=1, batch_size=PAR_DCN_BATCH)
    with tempfile.TemporaryDirectory(prefix="dfly-smoke-dcn-") as root:
        np.savez(os.path.join(root, "ds.npz"), **dataclasses.asdict(ds))
        pathlib.Path(root, "leg.json").write_text(json.dumps(
            {"device": str(device), "batch": config.batch_size}))
        port = _free_port()
        start = time.perf_counter()
        logs = [open(os.path.join(root, f"{rank}.log"), "w+") for rank in range(2)]
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--tree", tree, "--dcn-worker",
             f"{rank},{port},{root}"], cwd=tree, stdout=logs[rank], stderr=subprocess.STDOUT)
            for rank in range(2)]
        try:
            # the one-process run it is held to, while the two processes start and train
            one = train.train_attention(ds, config, mesh=_par_mesh({"dp": 2}, device), seed=SEED)
            codes = [p.wait(timeout=PAR_DCN_TIMEOUT_S) for p in procs]
        except subprocess.TimeoutExpired:
            codes = None
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - start
        if codes != [0, 0]:
            tails = []
            for log in logs:
                log.seek(0)
                tails.append(log.read()[-2000:])
            _fail(f"the two-process leg exited {codes} in {wall:.1f} s: {tails}")
        for log in logs:
            log.close()
        runs = [json.loads(pathlib.Path(root, f"{rank}.json").read_text()) for rank in range(2)]
    if runs[0]["losses"] != runs[1]["losses"] or runs[0]["dcn"] != 2:
        _fail("the two processes' losses differ, or their mesh spans no two processes")
    got = np.array(runs[0]["losses"])
    if got.shape != (one.steps,):
        _fail(f"two processes took {got.shape[0]} steps, one process {one.steps}")
    err = np.abs(got - np.array(one.losses))
    print(f"two processes on the card over gloo (make_hybrid_mesh(dcn_dp=2, dp=1), "
          f"{PAR_DCN_BATCH // 2} of {PAR_DCN_BATCH} rows a batch each, exit codes {codes}, "
          f"{wall:.1f} s with their start, the one-process run beside them): {one.steps} "
          f"steps, max loss difference {err.max():.3g} from one process on a dp 2 mesh "
          f"(first {REPLAY_STEPS} steps "
          f"{err[:REPLAY_STEPS].max():.3g}; atol {REPLAY_LOSS_ATOL}); precision "
          f"{runs[0]['eval']['precision']:.4f} vs {one.eval_metrics['precision']:.4f} ({card})")
    if err.max() > REPLAY_LOSS_ATOL:
        _fail(f"the two-process losses differ from one process's by {err.max()}")


@_phase("parallel")
def phase_parallel(ds, graph, card: str, tree: str, device: str = "cuda", single_p50=None,
                   mesh_p50=None, segment_p50=None) -> None:
    """Slice 24's main path: tensor, pipeline and expert parallelism on
    meshes of the one card (every mesh the card repeated). (a) the three
    bodies against their oracles; (b) train_attention's tp, ep, pp and MoE
    paths, each training kernel's launches against the path's formula;
    (c) the edge-sharded graph embed; (d) the hybrid mesh, folded in one
    process and across two processes over gloo. ``device="cpu"``
    rehearses it on the CPU (no timing)."""
    import torch

    dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    _par_bodies(card, dev)
    _par_train(card, ds, dev, single_p50, mesh_p50)
    _par_embed(card, graph, dev, segment_p50)
    _par_hybrid(card, ds, tree, dev)


# slice 26: the reference's two workload drivers on the port, their
# in-process rigs with the scheduler on the card: tools/torch_stress.py at
# the reference's defaults (16 connections, 10 s, a 4 MiB blob) and
# tools/torch_llm_prefetch.py at Llama-3-70B's 30 shards, each cut from
# ~4.6 GiB to 8 MiB for the time limit, 6 hosts, 1 MiB pieces
DRIVER_STRESS = dict(connections=16, duration=10.0, size=4 << 20)
DRIVER_PREFETCH = dict(shards=30, shard_bytes=8 << 20, hosts=6, piece_length=1 << 20)
DRIVER_PROBE_BYTES = 4096  # origin bytes beyond the seed's one pass (HEAD probes)


def phase_workload_drivers(card: str, device: str = "cuda") -> None:
    """Slice 26's main path: the two drivers' rigs on the card (see the
    module docstring, phase 21; the smoke run runs it in a process of its
    own beside phase 20). No hand kernel is on this path: the flash counts
    are zeroed before it and must read zero after."""
    from tools import torch_llm_prefetch, torch_stress

    _zero_counts()
    _zero_wide_counts()
    stress, clock = asyncio.run(torch_stress.run_inproc(device=device, **DRIVER_STRESS))
    print(f"workload drivers: stress, {clock.line()}; {json.dumps(stress)} ({card})")
    if stress["errors"] or not stress["requests"]:
        _fail(f"the stress driver made {stress['requests']} requests with "
              f"{stress['errors']} errors")
    if not clock.ms or clock.svc.device.type != device:
        _fail(f"the stress driver's scheduler ticked {len(clock.ms)} times on {clock.svc.device}")
    with tempfile.TemporaryDirectory() as workdir:
        prefetch, clock = asyncio.run(torch_llm_prefetch.run(workdir=workdir, device=device,
                                                             **DRIVER_PREFETCH))
    one_pass = DRIVER_PREFETCH["shards"] * DRIVER_PREFETCH["shard_bytes"]
    print(f"workload drivers: prefetch of {DRIVER_PREFETCH['shards']} shards of "
          f"{DRIVER_PREFETCH['shard_bytes'] / (1 << 20):g} MiB (Llama-3-70B's ~4.6 GiB cut for "
          f"the time limit) to {DRIVER_PREFETCH['hosts']} hosts, every shard's sha256 on every "
          "host; "
          f"origin bytes {prefetch['origin_bytes']} for a pass of {one_pass}; {clock.line()}; "
          f"{json.dumps(prefetch)} ({card})")
    if prefetch["fleet_offload_pct"] != 100.0:
        _fail(f"the fleet took {100.0 - prefetch['fleet_offload_pct']:.2f}% of its bytes from "
              "the origin")
    if prefetch["origin_bytes"] > one_pass + DRIVER_PROBE_BYTES:
        _fail(f"the origin served {prefetch['origin_bytes']} bytes, more than one pass "
              f"({one_pass}) and {DRIVER_PROBE_BYTES} of probes")
    if not clock.ms or clock.svc.device.type != device:
        _fail(f"the prefetch's scheduler ticked {len(clock.ms)} times on {clock.svc.device}")
    if any(_counts().values()) or any(_wide_counts().values()):
        _fail(f"the workload drivers launched a flash kernel: {_counts()} {_wide_counts()}")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--threshold", action="store_true",
                        help="time both instances at L = 16 .. 512, and both wide ones of the "
                             "forward, dK/dV and dQ at D = 192 and 256 over L = 16 .. 2048, "
                             "instead of the smoke run")
    parser.add_argument("--rows", action="store_true",
                        help="time only the kernels of the ranker's D = 32 rows, at their main "
                             "paths' shapes, instead of the smoke run")
    parser.add_argument("--tree", default=None,
                        help="import dragonfly2_tpu_torch from this checkout instead of the one "
                             "beside the script (with --rows: another commit's kernels, built "
                             "there, timed by the same code)")
    parser.add_argument("--dcn-worker", default=None, metavar="RANK,PORT,DIR",
                        help="run one process of phase 20's two-process leg (phase 20 starts "
                             "two), and nothing else")
    parser.add_argument("--side-worker", default=None, metavar="LEG,DEVICE,CARD",
                        help="run one leg that the smoke run starts as a process of its own "
                             "(planet: phase 19 (b); drivers: phase 21), and nothing else")
    args = parser.parse_args()
    run_start = time.perf_counter()
    try:
        import torch
    except ImportError:
        _fail("torch is not installed")
    tree = os.path.abspath(args.tree) if args.tree else os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, tree)
    try:
        import dragonfly2_tpu_torch  # noqa: F401
    except ImportError as e:
        _fail(f"the dragonfly2_tpu_torch package is not in {tree} ({e})")
    if args.dcn_worker:
        _dcn_worker(args.dcn_worker)
        return
    if args.side_worker:
        _side_worker(args.side_worker)
        return

    card = phase_device()
    # phase 5's trace is host work alone (the port's synth and features):
    # made in a thread while the build's processes compile
    traced = None if args.threshold or args.rows else _Background(trace)
    phase_build()
    if args.threshold:
        phase_threshold()
        return
    if args.rows:
        phase_rows(args.tree or ".")
        return
    if traced is not None:  # done before any timing: it holds the interpreter's lock
        traced.join()
    kernels = phase_kernels()
    training_kernels = phase_training_kernels()
    phase_sets_kernels()
    phase_launch_cost(card)
    launches = phase_main_path()
    train_counts, serve_counts, ds, graph, breakdown = phase_training(traced)
    partial = phase_partial_kernel(ds)
    ring_launches = phase_long_ring()
    mesh_launches, uly_counts, mesh_p50 = phase_mesh_training(ds, breakdown["step_p50_ms"])
    long_counts = phase_long_ulysses()
    phase_scheduler_tick(card)
    wide = phase_wide_kernels(ds)
    wide_launches = phase_wide_path(ds)
    scale = _SideProcess("scale", tree, card)  # phase 19 (a)-(c), beside phases 10 to 16
    try:
        with tempfile.TemporaryDirectory() as trace_dir:  # phase 10's traces, kept for 14
            storage = phase_scheduler_service(card, trace_dir)
            topology = phase_scheduler_nt(card)
            graph_p50 = phase_graph_models(ds, graph, topology, card)
            rule_cost = phase_ml_arm(card)
            phase_trainer(card, storage, topology, rule_cost)
        phase_cost_cards(card)
        phase_processes(card, tree)
        phase_data_plane(card, tree)
        scale.join(card, "phases 10 to 16")
    finally:
        scale.stop()
    phase_manager(card, tree)
    phase_objects(card, tree)
    phase_scale_labs(card, tree)
    drivers = _SideProcess("drivers", tree, card)  # phase 21, beside phase 20
    try:
        phase_parallel(ds, graph, card, tree, single_p50=breakdown["step_p50_ms"],
                       mesh_p50=mesh_p50["ring"], segment_p50=graph_p50["segment"])
        drivers.join(card, "phase 20")
    finally:
        drivers.stop()

    def entry(name, source, replaces, count, rows, main_shape):
        row = rows[main_shape]
        return {
            "name": name,
            "route": "cuda",
            "source": source,
            "variant": row.get("variant", "mma.sync"),
            "replaces": replaces,
            "launches": count,
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"],
            "kernel_ms": row["kernel_ms"],
            "kernel_recorded": row["kernel_recorded"],
            "mma_sync_kernel_ms": row["mma_sync_kernel_ms"],
            "mma_sync_kernel_recorded": row.get("mma_sync_kernel_recorded"),
            "other_variant": row.get("other_variant"),
            "other_kernel_ms": row.get("other_kernel_ms"),
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "shape": row["shape"],
            # the kernels the profiler found behind the entry at every row's shape
            "kernels_reached": sorted({n for r in rows.values() for n in r.get("kernel_names") or ()}),
            "other_shapes": {k: v for k, v in rows.items() if k != main_shape},
        }

    # launches: every main path's count, each read just after its run
    # (slice 1's serving; slice 2's training, then its serving; slice 3's
    # ring, its ring mesh training, then its Ulysses mesh training, all on
    # the mma.sync instances but the ring's partials; slices 4 and 5's long
    # Ulysses, all on the Hopper instances)
    fwd_launches = (launches + train_counts["flash_fwd"] + serve_counts["flash_fwd"]
                    + uly_counts["flash_fwd"])
    trained = {name: train_counts[name] + uly_counts[name] for name in TRAINING_KERNELS}
    src = "dragonfly2_tpu_torch/csrc/"
    fwd_src, bwd_src = src + "flash_fwd.cu", src + "flash_bwd.cu"
    fwd_sm90_src, dkv_sm90_src = src + "flash_fwd_sm90.cu", src + "flash_bwd_dkv_sm90.cu"
    dq_sm90_src = src + "flash_bwd_dq_sm90.cu"
    line = {"kernels": [
        entry("flash_fwd", fwd_src, "dragonfly2_tpu/ops/flash.py:71", fwd_launches, kernels, "served"),
        entry("flash_fwd_lse", fwd_src, "dragonfly2_tpu/ops/flash.py:186",
              trained["flash_fwd_lse"], training_kernels["flash_fwd_lse"], "trained"),
        entry("flash_bwd_dkv", bwd_src, "dragonfly2_tpu/ops/flash.py:418",
              trained["flash_bwd_dkv"], training_kernels["flash_bwd_dkv"], "trained"),
        entry("flash_bwd_dq", bwd_src, "dragonfly2_tpu/ops/flash.py:474",
              trained["flash_bwd_dq"], training_kernels["flash_bwd_dq"], "trained"),
        # slice 3's main path: the mesh training's eval
        entry("flash_fwd_partial", fwd_src, "dragonfly2_tpu/ops/flash.py:177",
              mesh_launches, partial, "eval-shard"),
        # slices 4 and 5's Hopper instances: the long Ulysses' shards, and the ring's blocks
        entry("flash_fwd_sm90", fwd_sm90_src, "dragonfly2_tpu/ops/flash.py:71",
              long_counts["flash_fwd_sm90"], kernels, "long"),
        entry("flash_fwd_lse_sm90", fwd_sm90_src, "dragonfly2_tpu/ops/flash.py:186",
              long_counts["flash_fwd_lse_sm90"], training_kernels["flash_fwd_lse"], "long"),
        entry("flash_fwd_partial_sm90", fwd_sm90_src, "dragonfly2_tpu/ops/flash.py:177",
              ring_launches, partial, "ring-block-16k"),
        entry("flash_bwd_dkv_sm90", dkv_sm90_src, "dragonfly2_tpu/ops/flash.py:418",
              long_counts["flash_bwd_dkv_sm90"], training_kernels["flash_bwd_dkv"], "long"),
        entry("flash_bwd_dq_sm90", dq_sm90_src, "dragonfly2_tpu/ops/flash.py:474",
              long_counts["flash_bwd_dq_sm90"], training_kernels["flash_bwd_dq"], "long"),
        # slices 7-8's wide instances (head dims above 128): the wide
        # ranker's training and eval, the ring over its eval batch, the long
        # ring's blocks and the long Ulysses' shards
        entry("flash_fwd_wide", fwd_src, "dragonfly2_tpu/ops/flash.py:71",
              wide_launches["flash_fwd_wide"], wide["flash_fwd_wide"], "ranker-eval"),
        entry("flash_fwd_lse_wide", fwd_src, "dragonfly2_tpu/ops/flash.py:186",
              wide_launches["flash_fwd_lse_wide"], wide["flash_fwd_lse_wide"], "ranker-train"),
        entry("flash_fwd_partial_wide", fwd_src, "dragonfly2_tpu/ops/flash.py:177",
              wide_launches["flash_fwd_partial_wide"], wide["flash_fwd_partial_wide"],
              "eval-ring-shard"),
        entry("flash_bwd_dkv_wide", bwd_src, "dragonfly2_tpu/ops/flash.py:418",
              wide_launches["flash_bwd_dkv_wide"], wide["flash_bwd_dkv_wide"], "ranker-train"),
        entry("flash_bwd_dq_wide", bwd_src, "dragonfly2_tpu/ops/flash.py:474",
              wide_launches["flash_bwd_dq_wide"], wide["flash_bwd_dq_wide"], "ranker-train"),
        entry("flash_fwd_wide_sm90", fwd_sm90_src, "dragonfly2_tpu/ops/flash.py:71",
              wide_launches["flash_fwd_wide_sm90"], wide["flash_fwd_wide_sm90"], "ulysses-shard"),
        entry("flash_fwd_lse_wide_sm90", fwd_sm90_src, "dragonfly2_tpu/ops/flash.py:186",
              wide_launches["flash_fwd_lse_wide_sm90"], wide["flash_fwd_lse_wide_sm90"],
              "ulysses-shard"),
        entry("flash_fwd_partial_wide_sm90", fwd_sm90_src, "dragonfly2_tpu/ops/flash.py:177",
              wide_launches["flash_fwd_partial_wide_sm90"], wide["flash_fwd_partial_wide_sm90"],
              "ring-block"),
        entry("flash_bwd_dkv_wide_sm90", dkv_sm90_src, "dragonfly2_tpu/ops/flash.py:418",
              wide_launches["flash_bwd_dkv_wide_sm90"], wide["flash_bwd_dkv_wide_sm90"],
              "ulysses-shard"),
        entry("flash_bwd_dq_wide_sm90", dq_sm90_src, "dragonfly2_tpu/ops/flash.py:474",
              wide_launches["flash_bwd_dq_wide_sm90"], wide["flash_bwd_dq_wide_sm90"],
              "ulysses-shard"),
    ]}
    if not all(row["launches"] > 0 for row in line["kernels"]):
        _fail("a kernel of the path was launched no time on its main path: "
              + ", ".join(row["name"] for row in line["kernels"] if not row["launches"]))
    print(f"profiler: of {_WINDOWS['taken']} kernel windows, {_WINDOWS['short']} recorded fewer "
          f"launches than were made, {_WINDOWS['over']} more, and {_WINDOWS['uneven']} had a "
          "mean a fifth off their median; kernel times are medians over the launches recorded")
    print("phases: " + ", ".join(f"{name} {seconds:.1f}" for name, seconds in PHASE_SECONDS.items())
          + f"; total {time.perf_counter() - run_start:.1f} s ({card})")
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
