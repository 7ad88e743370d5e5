#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (odh_kubeflow_tpu_torch) on one
NVIDIA Hopper card: the quickest proof that the port builds, is right,
serves and trains on the GPU.

    python3 chip_smoke.py        # from the repository root, one card

Phases (any failure exits non-zero; no phase's failure is caught):
1. device: name, capability, power limit;
2. build: every kernel compiled from the sources in this checkout; the
   forward and backward libraries must each hold HGMMA (wgmma)
   instructions, their C entries must choose the kernels by (dtype, d)
   as attention._fwd_kernel_for and attention._bwd_kernel_for say, and
   dq's launch plan (q tile, cluster size) as attention._scalar_dq_plan;
3. the forward kernels against their plain PyTorch version, at the shapes
   the serving and training paths give them and at others, bf16 and f32,
   with and without lse, each case naming the kernel and q tile it ran; the
   tensor-core kernel also at the tile edges (sq = sk in 63, 64, 65, 127,
   129, 2049; d 128 and 64; causal and full; 64- and 128-row q tiles;
   strided views; GQA 16/4 and 8/1) and at sq != sk; the scalar kernel at
   its tile edges (f32 at sq = sk in 1, 15, 16, 17, 31, 33, 65, 129, 513,
   d 16/32/64/128, causal and full, at every q tile of 16, 32 and 64 rows
   the grid gives, GQA 8/2 on strided views and 4/1; bf16 d16/d32 at a
   subset; sq != sk), each case naming its q tile and cluster size;
3b. the backward kernels (dq, dk/dv; the tensor-core pair and the scalar
   pair) against their plain versions, at the training shape and others,
   each case naming the kernels it ran; the tensor-core pair also at the
   tile edges (sq = sk in 63, 64, 65, 127, 129, 2049; d 128 and 64; causal
   and full; GQA 16/4 on strided fused-qkv views and 8/1; sq != sk full);
   the scalar pair at the same edges as the scalar forward, once with the
   batch that gives dk/dv each of its k tiles and once with the batch that
   gives dq each of its q tiles, and at every (q tile, cluster size) dq's
   rule can give, each case naming dq's q tile and dk/dv's k tile and their
   cluster sizes (held against the Python mirrors); then through autograd
   with an lse cotangent;
4. timing (device time from CUDA-graph replays between CUDA events, median
   of 25): kernel, plain version, and the library SDPA as a yardstick only,
   beside the card's bound, with TFLOP/s, the share of the bound and the
   ratio to SDPA; and each call's time launched from Python; the
   tensor-core forward at the serving and 4x2048 shapes, the scalar forward
   in f32 at the serving shape, at the f32 gradient check's (with lse) and
   at the demo model's prefill; at the training shape, the forward with
   lse, dq and dk/dv (SDPA's backward, dq+dk+dv in one autograd call, is
   the pair's yardstick); the scalar dq and dk/dv, and their sum, at the
   f32 gradient check's shape; the kernels SDPA's f32 forward and backward
   ran;
5. the serving path at the full width of the repo's flagship model
   (vocab 32768, d_model 1024, 8 layers, 8 heads x 128, d_ff 4096, bf16;
   random weights from a seed): a ServingEngine behind ServingHTTPServer
   answers 8 concurrent POST /generate requests (prompt 128, max_new
   16..64); launch counts are zeroed just before and read just after: 8
   tensor-core forward launches per request, no scalar one; then an
   admission step and a burst step timed, and profiled for device time by
   kernel; then the demo model from build_engine_from_env({}) (f32, d 16:
   the scalar forward kernel's path, counted the same way), its f32 greedy
   tokens held against generate()'s;
6. the training path: a gradient check on the card (2-layer f32 model,
   loss and gradients through the scalar kernels against autograd through
   the reference attention), then make_train_step on the full-width bf16
   model (the bench.py train-step config, remat_policy "flash", batch 8 x
   2048): 1 warm-up and 5 timed steps with launch counts zeroed just before
   and read just after (8 tensor-core forward, 8 dq and 8 dk/dv launches per
   step, no scalar one), one step with remat_policy "" (twice the forward
   launches), host syncs in a step, and one profiled step;
7. checkpoint, restore and the probe agent, at full width: first
   `python -m odh_kubeflow_tpu_torch.probe` as a sidecar (its routes over
   HTTP, its exit on SIGTERM, and no CUDA context of its own where
   nvidia-smi lists compute apps); then, with launch counts zeroed, a
   NotebookAgent over a CudaMonitor of the card (window 3 s, samples every
   0.25 s) whose hooks close over phase 6's train state: /tpu/readiness
   (1 chip, ready, healthy), /tpu/utilization busy during train steps
   (> 0; each source printed) and idle after more than a window (the
   card counter's idle reading, not warming), /tpu/checkpoint (the step and
   state_checksum; wall time, GB written, GB/s), /tpu/restore onto params
   re-initialised from another seed (the same step and checksum), the
   same step twice from the saved state (bit-equal: deterministic on the
   card), the resumed step bit-equal to the uninterrupted one with 8/8/8
   tensor-core launches; then phase 5's bf16 model saved and served by
   build_engine_from_env from SERVING_CHECKPOINT: its logit fingerprint,
   4 greedy requests' tokens equal to an engine on the original params, 8
   forward launches per request, and tpu_decode_step_duration_seconds
   observed once per burst;
8. the MoE model family at the configuration of bench.py:389-400 (vocab
   32768, d_model 1024, 8 layers, 8 heads x 128, 8 experts of d_ff 2048,
   top-2, capacity factor 1.25, bf16; random weights from a seed): a
   2-layer f32 gradient check at capacity factor 4 (no drops) through the
   scalar kernels against the reference attention; the full-width model
   behind the HTTP server answering phase 5's 8 requests (8 tensor-core
   forward launches per request, one host sync per burst, first tokens
   equal to generate()'s), an admission and a burst timed and profiled, and
   the decode drop rate over a burst; a small f32 MoE model whose engine
   tokens equal generate()'s at capacity factor 2 (= experts / top-k); then
   make_train_step at batch 8 x 2048 with remat_policy "": 1 warm-up and 5
   timed steps (16 tensor-core forward, 8 dq and 8 dk/dv launches per step,
   no scalar one), no host sync in a step, the same step twice from one
   state bit-equal, one profiled step, the dispatch share (dispatch_only
   at the step's tokens, x 3 per layer, over the step) and the drop rate
   at layer 0's inputs;
9. the token router at phase 5's full width: two ServingEngine replicas of
   the flagship model (8 slots, max_seq 512, burst 8 each, one set of
   params) behind the port's TokenRouter in this process, with PROFILE=1
   and TORCHGUARD=1; launch counts zeroed just before and read just after
   the routed, drained and hedged requests: 8 clients send 16 routed
   requests (prompt 128, max_new from MAX_NEWS), each with its own
   traceparent, all ok with max_new in-vocab tokens, each trace one tree
   (router.request, router.pick, exactly one counted inference.request);
   replica 1 drained mid-run (its in-flight requests finish ok, it takes no
   pick after); a hedge after HEDGE_AFTER_S (shorter than any prefill)
   while replica 1's slots all hold long requests, whose loser (the copy
   queued there) is canceled, superseded in the same trace and not counted;
   8 tensor-core forward launches per admitted request (the long requests
   included) and no scalar one; serving.prefill entered once per
   admitted request; the five phases of serving.decode_burst covering
   90-110% of it, each phase's share printed; one host copy per burst and
   no recompile on both replicas; then the router's added latency (p50 of
   routed minus direct requests, bench.py:603-660), a burst step's host
   time with the profiler and guard off and on, and generate() under the
   armed guard (no copy, no hidden sync);
10. sequence parallelism on this card: 4 spawned ranks (sp 4 over
   the world, then sp 2 over a mesh of its ranks 0 and 1, a sub-group of
   the world whose other ranks wait), processes brought up by
   parallel.initialize_from_env from the env names
   the webhook injects (the pool of ranks phases 10-13 share: each phase
   sends its job to the same 4 processes, which start up once), on gloo
   (the ranks share the one card, and NCCL
   refuses two ranks on one device; the ring's payloads are staged through
   pinned host memory, counted): the f32 ring (scalar kernels; b1 s1024
   h8 hk2 d128), contiguous and zigzag, its out and q/k/v gradients within
   1e-4 of the largest against one-process mha_reference, each rank's
   launches as ring_launches (ring_balance_report's schedule) gives them;
   a 2-layer f32 model's sp loss and summed gradients within 1e-4 against
   one process through mha_reference, both layouts; then make_train_step
   over the mesh on the flagship model (bf16, remat_policy "flash"),
   global batch 2 x 8192, at sp 2 contiguous and zigzag and sp 4
   contiguous, each at 2 layers: depths cut (SP_LAYERS; sp 2 ran 4 until
   phase 15's park and wake needed the time) to keep the smoke near 900 s. Before each run, every flash call of one bf16 ring at the
   run's per-rank shapes (b2 s4096 or s2048 h8 d128; zigzag's half-pairs;
   the backward with the ring's merged lse and delta) is held against its
   plain version within phase 3/3b's tolerances. Against the one-process
   step on the same batch: the same first step in f32, its loss within
   1e-4 and each gradient leaf within 1e-4 of its own largest; the bf16
   warm-up step's loss within 1e-4, its gradients no farther from the f32
   ones than the one-process bf16 step's plus one bf16 ulp (per-leaf gaps
   printed). Then SP_STEPS 2 steps with launch counts zeroed just before and read just after
   (layers x ring_launches tensor-core forward, dq and dk/dv launches per step
   and rank, no scalar one: the ring is outside the layer checkpoint, so
   no policy runs it again), no host sync of the sync debug mode's kind
   inside the steps, losses falling and the params bit-equal across ranks;
   step time, peak memory per rank, bytes exchanged and the transport's
   host waits per step are printed, with a line saying that the ranks
   share one card.
11. fsdp and tp on this card: tools/gloo_cuda_probe.py's readings (which
   collectives gloo moves on a CUDA tensor), taken while the phase's ranks
   start its job; phase 10's 4 ranks, brought up by parallel.initialize_from_env from the webhook's env
   names on gloo, sharing the card, train the flagship (bf16, remat
   "flash"; SHARD_LAYERS 2 of its 8 layers, the depth cut to keep the smoke
   near 900 s; 4 until phase 15's park and wake needed the time) at fsdp 2 x tp 2, global batch 8 x 2048, and at tp 2 x sp 2
   zigzag, global batch 2 x 8192, params, gradients and AdamW state sharded
   as param_specs says. Before each run every flash call at the run's
   per-rank shapes (b4 s2048 h4 hk4 d128; the zigzag ring's b2 s4096 h4
   visits) is held against its plain version within phase 3/3b's
   tolerances. Against the one-process step on the same batch: the first
   step in f32, its loss within 1e-4 and each gathered gradient leaf within
   1e-4 of its own largest; the bf16 warm-up loss within 1e-4 relative and
   its gathered gradients no farther from the f32 ones than the
   one-process bf16 step's plus one bf16 ulp. Then SHARD_STEPS 2 steps with launch
   counts zeroed just before and read just after (4 tensor-core forward,
   dq and dk/dv launches per step and rank, x ring_launches under sp; no
   scalar one), no host sync inside the steps, losses falling, every
   replicated leaf bit-equal across the ranks that hold it; step time,
   peak memory per rank and the bytes per step and rank of each kind of
   exchange printed. In the fsdp 2 x tp 2 run each rank serves a
   NotebookAgent whose hooks close over its blocks: /tpu/checkpoint
   driven on all four at once gives four equal acks of the gathered
   state's checksum (bytes per rank and wall time printed), /tpu/restore
   onto a fresh init acks it too, and the step resumed from the restored
   blocks is bit-equal to the uninterrupted one; the saved step restored
   onto the tp 2 x sp 2 mesh and onto one process gives the saved params
   (checksum) and the next step's loss within 1e-4 relative.
12. tensor parallelism in decode, shared kv heads and the ep MoE on this
   card, phase 10's 4 ranks as in phase 11 (tp 2 on a mesh over its
   ranks 0 and 1; the one-process references computed while the ranks
   start the job): (a) generate(mesh=) of
   phase 5's flagship at tp 2 and fsdp 2 x tp 2, 8 prompts of 128, max_new
   TP_MAX_NEW 32 (64 before phase 15 took on admission): the flash forward
   at the per-rank prefill shape (b8 s128 h4 hk4 d128, no lse) against its plain version, the first step's logits (each
   rank's vocab block) within 2e-2 of the largest of one process's, every
   rank the same tokens (their agreement with one process printed), launch
   counts zeroed just before and read just after (8 tensor-core forward
   launches per generate and rank), per-token host time, and bytes a token
   by kind equal to the count from the shapes (the f32 tp sums, the
   vocab-parallel argmax; no gather); the same shapes in f32 at 2 layers:
   logits within 1e-4, greedy tokens and sampled tokens (one seed) equal to
   one process; (b) tp 4 with n_kv_heads 2 (each rank's 2 q heads read one
   kv head; wqkv replicated over tp), f32, 2 layers of the flagship's
   widths: the loss and gathered gradients within 1e-4 of each leaf's
   largest against one process, greedy tokens equal; (c) bench.py:389-400's
   MoE train step (remat "") at EP_LAYERS 2 of its 8 layers (the depth cut
   to keep the smoke near 900 s; 4 until phase 15's park and wake needed
   the time) at ep 2 x tp 2 and ep 2 x fsdp 2, global batch
   8 x 2048, a warm-up and EP_STEPS 2 timed steps (3 before phase 15 took
   on admission), with phase 11's gates: each flash call at the per-rank shapes
   (b8 s2048 h4, b4 s2048 h8) against its plain version; against one
   process routing each data shard alone (the ep path's capacity), the f32
   2-layer step per leaf within 1e-4, the bf16 loss within 1e-4 relative,
   the bf16 gradients within the one-process distance + one ulp; 8/4/4
   tensor-core launches per step and rank; no host sync; every replicated
   leaf bit-equal; the (exchanges, bytes) per step and rank of each kind
   equal to the count from the shapes; the drop rate and the dispatch
   share's bound printed; the ep 2 x tp 2 state checkpointed through four
   agents at once (equal acks), resumed bit-equal, and restored onto one
   process (checksum, next loss within 1e-4 relative).
13. the pipelines on this card, phase 10's 4 ranks as in phase 11, which
   then stop: (a) before
   each full-width run every flash call at its per-rank shapes (b2 s2048
   h4 at pp 2 x tp 2, b1 s2048 h8 at pp 2 x fsdp 2, b2 s2048 h8 at pp 2 x
   ep 2; at pp 2 x sp 2 one bf16 zigzag ring of b1 s4096 h8, its
   half-pairs) held against its plain version within phase 3/3b's
   tolerances; (b) the f32 flagship at 2 layers (4 for v 2), batch 8 x
   512, n_micro 4, through GPipe, 1F1B and interleaved 1F1B (v 2) at pp 2
   x tp 2 and interleaved 1F1B at pp 2 x fsdp 2: the loss and each
   gathered gradient leaf (pipeline layout) within 1e-4 (of its largest)
   of one process, the scalar launches per rank the schedule's; (c)
   PP_LAYERS 4 of the flagship's 8 layers in bf16 (the depth cut to keep
   the smoke in its budget), 1 warm-up and PP_STEPS 1 timed step: its 1F1B at pp
   2 x tp 2 and interleaved 1F1B (v 2) at pp 2 x fsdp 2, global batch 8 x
   2048, n_micro 4; phase 8's MoE by 1F1B at pp 2 x ep 2, the same batch;
   GPipe at pp 2 x sp 2 zigzag on phase 10's 2 x 8192 (n_micro 2, one
   sequence a microbatch). Gates: the warm-up loss within 1e-4 relative of
   one process's on the same batch (the MoE's averaged over the
   microbatches, each routed alone: the pipeline's capacity); losses
   falling; (exchanges, bytes) per step and rank of every kind but the
   ring equal to `_pp_bytes`' count from the shapes; tensor-core launches
   per step and rank of n_micro x layers/stages each of forward, dq and
   dk/dv for GPipe (x `ring_launches`' 5 under zigzag sp 2), the forward
   twice for 1F1B (its recompute from the saved stage input), no scalar
   one; no host sync of the sync debug mode's kind inside the steps (the
   staged transport's waits are counted apart); every replicated leaf
   bit-equal across its ranks. Reported, not gated: step time (slowest
   rank), peak memory per rank, each rank's share of the step in the stage
   hops beside the bubble (S-1)/(n_micro x v + S-1), the share in gloo
   transfers, and the peak memory of one step of GPipe against 1F1B at pp
   2 x tp 2 with n_micro 4 and 8. (d) The pp 2 x tp 2 1F1B state through
   four agents' /tpu/checkpoint and /tpu/restore at once: equal acks of
   the gathered state's checksum, the resumed step bit-equal to the
   uninterrupted one with 16/8/8 launches.
14. the device layer (alone: tools/device_phase.py), ranks started by torchrun
   from the env the port's GPU planner renders into a pod: (a) plan_slice
   ("h100") is 1 x 1; `python -m torch.distributed.run` with the pod env
   apply_slice renders (and PET_NODE_RANK 0) starts one worker, which
   calls initialize_from_env() and rank_device(), then prefill and
   generate of phase 5's flagship (8 prompts of 128, max_new 32) and one
   make_train_step step at 8 x 2048, remat "flash", in one fresh launch
   (phase 15's three launches from the reconciler's env give the
   fresh-launch p50): 8 tensor-core forward launches per prefill, 8/8/8
   per step, no scalar one; the flash forward at the prefill's shape (b8
   s128 h8 hk8 d128, no lse) against its plain version within phase 3's
   tolerance, after the timed path; launch -> CUDA context up, world
   formed and first token printed (the launch compiles Python's bytecode
   into the phase's temporary directory). (b)
   plan_slice("h100",
   topology="2x2"): two torchrun "pods" of 2 workers each, their env
   rendered, node ranks 0 and 1, the master moved to 127.0.0.1 and a free
   port (no cluster DNS; printed), the 4 ranks sharing this card on gloo:
   RANK = node_rank x 2 + LOCAL_RANK, distinct 0..3, world 4;
   slice_mesh_axes gives fsdp 2 x tp 2 with each tp group one pod's ranks;
   the flash calls at the per-rank shape (b4 s2048 h4 hk4 d128) within
   phase 3/3b's tolerances; one bf16 step of the flagship's widths at 2
   layers, global batch 8 x 2048, its loss within 1e-4 relative of one
   process's; a second step with no host sync and 2/2/2 tensor-core
   launches per rank, no scalar one.
15. the operator (alone: tools/operator_phase.py), from a Notebook CR to
   a GPU pod serving the flagship on this card and back to a freed card:
   the port's SimCluster with one h100 1x1 node (nvidia.com/gpu 1) and
   the deployed admission shape in front of its store
   (cluster.remote_fixture.build_remote_stack: a TLS ApiServer whose
   admission calls the HTTPS webhook, served as main.serve_webhook serves
   it, through a MutatingWebhookConfiguration; nb-denied is written over
   it through a RemoteStore, the user's other writes go to the store,
   whose admission chain runs the same webhook: with them all over the
   wire the smoke took 853.2 s at 12.0 s launch -> worker started, past
   its 850 s), and the Manager the port's own composition root builds
   (odh_kubeflow_tpu_torch.main.build_manager) with its debug mux bound
   before its start
   (serve_endpoints(metrics_port=0, health_port=0)) and the control-plane
   profiler armed (CPPROFILE=1): NotebookReconciler,
   EventMirrorController, TPUWorkbenchReconciler, ProbeStatusController
   (0.2 s), CullingReconciler (2 s idle, checks every 0.5 s),
   SliceRepairController (a 30 s checkpoint window; the flow sets its
   unreachable dwell and checkpoint probe timeout on the reconciler
   build_manager set up), SuspendResumeController, the InferenceEndpoint
   and TPUJob reconcilers (the job reconciler idles until the job
   episode), a StatusCoalescer at Config's window (0.05 s), one
   NotebookMetrics shared by the reconciler, the gate and the culler, and
   the judgement layer of main._wire_observability (observed by
   tests/torch_operator_flow.py Judgement): an SLOEngine over
   default_slos() at window scale 0.002 (5m -> 0.6 s, 1h -> 7.2 s, 6h ->
   43.2 s), an AlertManager over default_rules that mirrors onto the
   notebooks (SLOBurnRate events, the DegradedSLO condition) and
   snapshots the flight recorder, the slice-repair-in-progress inhibitor
   of the readiness category, a CanaryProber (a CPU notebook in
   slo-canary on one CPU node added to the SimCluster, a plain container
   with no process and no card; its loop's period longer than the phase,
   so it probes once a second after the start, which the flow waits out),
   a ReplicaAutoscaler ticking every AUTOSCALE_PERIOD_S over
   PodStatsSignals (each replica's /stats at its pod's IP, a loopback
   address of its own, and its serving container's port) and a
   ChipAccountant; the kubelet runs each
   pod through
   probe.behavior.pod_process_behavior: `torchrun chip_smoke.py
   --device-worker operator` with the env the reconciler rendered into
   the pod (the workers sharing one bytecode directory in the phase's
   temporary directory), beside a NotebookAgent over the card's
   CudaMonitor, which counts the cards on which a process of the pod
   holds a CUDA context (it maps the card's node and /dev/nvidia-uvm);
   each worker serves as phase 14 (a) does, writes its result and holds
   its CUDA context until SIGTERM. First nb-denied (h100 3x5, a slice
   gpu.plan_slice refuses) is denied at admission over HTTPS, the
   webhook's message in the Status body: no object of it is stored, no
   pod starts, the card's compute apps stay as they were, and no torchrun
   starts. nb-0 and nb-1 are created at once: one binds (the scheduler takes them in no fixed
   order; say nb-0), nb-1 stays Pending with a FailedScheduling naming
   nvidia.com/gpu mirrored onto the notebook; nb-0 comes mesh-ready,
   serves, goes idle and is culled; nb-1 binds on the freed card, serves
   and is culled; nb-2 follows alone; each culled notebook is deleted
   once its card is free. The canary probes once before the first wave and
   once at the end. Gates: every CR admitted with the
   reconciliation lock and the traceparent of its notebook.ready root,
   the lock lifted by the extension before the pod was bound, the
   notebook's HTTPRoute and NetworkPolicies present while it serves and
   gone once it is deleted; the root closed by the gate at mesh-ready,
   within one gate period of the watch event; mesh-ready no earlier than
   the worker's CUDA context less one gate period; each set requests
   nvidia.com/gpu 1 with PET_STANDALONE and PET_NPROC_PER_NODE 1; each
   worker on cuda:0; 8 tensor-core forward launches per prefill and per
   generate, no scalar one; the forward at the prefill's shape within
   phase 3's tolerance; status.tpu meshReady and firstReadyTime set; the
   stop annotation the culler's (its flight-recorder transition); the set
   at 0 replicas; after each cull no process of the pod alive and
   nvidia-smi's compute apps back to the phase's start; the notebooks
   bound and stopped in turn (by resourceVersion). Printed per notebook
   and as a p50 of the three, with the card's name and power limit: CR ->
   bound, -> mesh-ready (the watch event, and the root's duration), ->
   the worker's CUDA context, -> first token; idle -> culled; culled ->
   card free. The repair episode, on nb-2 (before its wave a second h100
   1x1 node joins in a pool of its own; both stand for this card): its
   worker (`--device-worker repair`) serves, then trains the flagship's
   widths at 2 layers, bf16, remat "flash", 8 x 2048, for 2 steps and
   takes step 3 on a copy of its state; its node is preempted (grace 60
   s); the repair opens Degraded (HostPreempted), drives the pod's
   /tpu/checkpoint, which the agent forwards to the worker (it saves the
   state at step 2 into the notebook's checkpoint directory and acks step
   and checksum), writes checkpoint-saved, evicts the pod (its processes
   stop before its object goes), and the replacement binds on the other
   pool's node, re-forms its world with reinitialize_after_repair,
   restores step 2 and takes step 3. Gates (tests/torch_operator_flow.py
   check_repair): the ack before the eviction; the machine degraded ->
   repairing -> rest, Degraded from HostPreempted to Repaired; no process
   of the old pod alive once the replacement is bound; the slice.repair
   span on the notebook.ready trace; one repair and one MTTR observation;
   a slice-degraded incident bundle; the restored checksum the ack's; step
   3's loss and params checksum bit-equal to the first worker's; mesh-ready
   again no earlier than the replacement's CUDA context less one gate
   period; 2/2/2 tensor-core launches in every step of both incarnations,
   no scalar one. Printed: preempt -> Degraded -> ack (with the save's
   seconds and GB) -> evicted -> rebound -> mesh-ready again -> resumed
   step, the MTTR and the goodput ratio. The suspend, after nb-2's resumed
   step 3 (its replacement's worker, `--device-worker promote`, stays busy,
   reports its params' logit fingerprint and answers the forwarded
   checkpoint requests, each with the next step taken on a copy): suspend
   is enabled in the SuspendResumeController (off through the waves, whose
   culls tear down), nb-2 is stopped with the culler's stamp (the stop and
   checkpointing in one patch), the controller drives its /tpu/checkpoint
   (forwarded: the worker saves step 3), writes suspended with the save's
   step and checksum and releases its pool warm; its processes go. Gates
   (check_suspend): one forwarded save, acked before Suspended, its step
   and checksum the annotations', the pool warm at priority 0, one save
   counted and no reclaim. The promotion episode: ep-0 is
   created with spec.notebookRef nb-2 and its checkpoint directory, and
   the InferenceEndpointReconciler claims the released pool under
   user/ep-0; ep-0's pod runs `python -m odh_kubeflow_tpu_torch.serving`
   (the model config in SERVING_MODEL_CONFIG), whose agent is ready once
   it has restored the whole saved train state and listens; Loading
   verifies the restore through the forwarded /tpu/restore; 8 requests
   (prompt 128, MAX_NEWS) at once to its server; then its stop. Gates
   (check_promotion and _operator_promotion): a warm bind
   (EndpointPromoted, promotions{warm} +1, the endpoint.promotion span on
   the endpoint's trace, the pool claimed before the pod bound on it);
   states "" -> loading -> serving -> draining -> terminated; mesh-ready
   no earlier than the serving process's CUDA context less one gate
   period; the restore's checksum the save's, verifications{ok} +1 and
   no other, "restore verified"; the served params' logit fingerprint
   nb-2's; the route while Serving, status.url; all 8 requests 200;
   REPAIR_LAYERS tensor-core forward launches per prefill and no other
   kernel; the forward at the prefill's shape within phase 3's tolerance;
   the route deleted before the set went to 0; Terminated, the pool warm
   again, no process of the pod alive, the card's compute apps back to
   the phase's start. Printed: each edge from the stop to the first token,
   TTFT median and max, tokens/s, and stop -> route gone -> Terminated ->
   card free. The park and the wake, between the 8 replies and the stop:
   ep-0 is created with autoscaling {minReplicas 1, maxReplicas 1,
   scaleToZero, scaleToZeroIdleS AUTOSCALE_IDLE_S}; the autoscaler's
   signals are the port's PodStatsSignals: the serving SLOs' fast burn
   with the queue and slots read from the pod's /stats (the engine serves
   in the pod's process, which the operator's registry cannot see; a
   replica it cannot read counts busy). Idle past the window after the last reply, the autoscaler writes
   desired 0; ep-0 parks Suspended (its route and url kept, its slice
   released warm, its processes gone); a TokenRouter over ep-0 with no
   live replica sheds the 8 requests and fires its cold wake once, which
   writes desired 1; the woken gang takes the parked slice back (the
   reconciler's idle-warm reclaim past the pending grace), its serving
   process restores nb-2's step-3 state, Loading verifies it, and once
   Serving the process joins the router as its replica and the 8 shed
   requests are served through it. Gates (check_autoscale and
   _operator_autoscale): no park before the last reply, one after it, no
   up or down; parked Suspended with status.replicas, servingReplicas and
   readyReplicas 0, the url and route kept, the pool warm, no process of
   the pod alive and the card's compute apps back to the phase's start;
   one cold wake, every request shed once; the woken pod on the parked
   pool; verifications {ok} +1 and no other result, no new promotion;
   the logit fingerprint nb-2's; all 8 woken requests 200; REPAIR_LAYERS
   tensor-core forward launches per prefill and no other kernel in the
   woken process; the episode within AUTOSCALE_BUDGET_S. Printed: the
   last reply -> desired 0 -> Suspended -> card free; the wake -> desired
   1 -> bound -> CUDA context -> restored -> listening -> restore ack ->
   Serving -> joined -> first token; the woken TTFT. The judgement layer's
   gates (check_judgement): slo_evaluations_total advanced; both canary
   probes ok, their CRs and pods gone, the compute apps unchanged by them;
   the availability page (notebook-availability-fast-burn) fired between
   nb-2's preemption and its mesh-ready again, each firing with its
   SLOBurnRate event, DegradedSLO True and an incident bundle, every
   firing resolved by the end, each resolve's notebooks back to
   DegradedSLO False (Recovered) unless another firing alert still covered
   them. Printed: every alert's transitions, every SLO's compliance over
   the phase, the coalescer's writes and merged patches, the autoscaler's
   decisions. The debug mux's gates (check_debug_mux, read at the phase's
   end): /healthz and /readyz 200; /metrics with the notebook families,
   slo_evaluations_total, the autoscaler's decisions (the park) and the
   tpu_chip_seconds_* families; /debug/slo with every default SLO and the
   availability page not firing; /debug/incidents with nb-2's
   slice-degraded bundle and its cpprofile and accounting blocks;
   /debug/accounting equal to the accountant's snapshot; each notebook's
   readiness root over /debug/traces as it closed; /debug/reconciles
   naming every controller that reconciled; every bad argument a 400.
   Printed: nb-denied's refusal time over HTTPS, each read's status,
   bytes and time. The job episode, after the waves: the TPUJobReconciler
   beside the other controllers, right after the promotion (nb-2 still
   suspended); OPERATOR_JOB (anakin, spec.tpu h100 1x1, JOB_STEPS steps, a
   JOB_PERIOD_S cadence) is admitted on a warm claim of ep-0's pool,
   its learner pod runs `--device-worker job` (tests/torch_pod_worker.py
   `job_run` at REPAIR_LAYERS of the flagship, bf16, DEVICE_TRAIN_BATCH),
   Ready once a process of the pod holds the card under a CUDA context,
   Running, checkpoints at its cadence through the forwarded
   /tpu/checkpoint; after its first acked save the flow unstops nb-2. No
   h100 1x1 node is free then: the repair's preempted node stays tainted
   and the job holds the other. nb-2 goes Resuming, its warm claim misses,
   its pod sits unschedulable, and past reclaim_pending_grace_s the
   reclaimer stamps the job (`capacity-pressure:user/nb-2`, the lowest
   priority); the job's save, Preempted with its slice returned to general
   capacity, requeued (its backoff from its pod's going); nb-2's pod binds
   there, its worker (`--device-worker promote`, which reports its restore
   before its CUDA context) restores step 3, answers the forwarded
   /tpu/restore once its agent opens the gate, the resume completes with
   the restore verified and the worker takes step 4; the flow stops nb-2
   again: it suspends (the save of step 4) and releases the slice warm;
   the job claims it warm, the new pod restores the acked step, takes the
   next step and trains on to JOB_STEPS; Succeeded, replicas 0, the card
   free. Config: chip_budget 2 (the notebook and the job, nothing more),
   a 15 s suspend window, Config's resume attempts. Gates
   (check_job, check_resume and _operator_job): the job's states in that
   order; preemptions {reclaim} +1 and {user} 0, requeues +1, jobs
   {succeeded} +1; status.preemptions 1; nb-2's suspend states "" ->
   checkpointing -> suspended -> resuming -> "" -> checkpointing ->
   suspended; notebook_reclaims_total {job-preempt} +1 and no other;
   verifications {ok} +1 and no other result, RestoreVerified; one
   notebook_resume_seconds observation and one notebook.resume span; the
   idle clock re-armed at the resume; the resumed step bit-equal to step 4
   on a copy in the worker that saved step 3; the resumed pod Ready and
   mesh-ready no earlier than its worker's CUDA context less one gate
   period; REPAIR_LAYERS tensor-core launches each in the resumed step;
   completedSteps at least JOB_STEPS and an acked step; the resume step
   the preempt's acked step, its checksum restored; the resumed step's
   loss and params checksum bit-equal to the first pod's step on a copy;
   the goodput ratio in (0, 1]; each pod Ready and each Running no earlier
   than its worker's CUDA context less one gate period; REPAIR_LAYERS
   tensor-core launches each of the forward, dq and dk/dv in every step and
   no scalar one; no process of either pod alive and the card's compute
   apps back to the phase's start. A ChipAccountant ticks every
   ACCOUNTANT_PERIOD_S over the whole phase: it never ticks in error, its
   ledger conserves (attributed = physical card-seconds within 1%), every
   GPU node is attributed once, and the job class banks card-seconds.
   Printed: nb-2's stop -> ack (the save's seconds and GB) -> Suspended;
   the unstop -> reclaim stamp -> the job's ack -> nb-2 bound -> CUDA
   context -> restored -> restore verified -> Active (the resume latency);
   the job's requeue -> warm claim -> resumed -> Succeeded; the saves'
   seconds and GB, the restores' seconds, the accountant's card-seconds by
   class and phase. The phase's time and each episode's, against their
   budgets (120 s for the phase less the episodes, 45 s for the repair
   episode, PROMOTION_BUDGET_S for the suspend and the promotion less the
   park and the wake, AUTOSCALE_BUDGET_S for the park and the wake,
   RESUME_JOB_BUDGET_S for the job with nb-2's resume). The deploy
   surface: before the flow, the port's four overlays
   (odh_kubeflow_tpu_torch.deploy: base, standalone, gke, dev) are built
   and rendered by its own YAML emitter and must equal the committed tree
   in the package (deploy/tree/) byte for byte (printed: each overlay's
   objects and bytes, and the time taken); over the whole flow the port's
   DEPLOYGUARD is armed, so every call of the manager's flows is held
   against the ClusterRole its generated manifests grant (a drift raised
   inside a reconcile may be swallowed by the controller's error path:
   the gate is the guard's drift count, 0). At the end the recorded
   surface is dumped as the guard's artifact and the rbac-coverage
   checker runs over the port's package with it: no call the ClusterRole
   does not grant (gated); its stale-rule findings (a granted rule that
   neither the package's code nor the surface uses) are printed, not
   gated. Printed: the surface's distinct (flow, verb, kind, subresource)
   tuples, how many are on the manager's flows, each flow's, and the
   granted (group, resource) pairs that no manager call of the run
   touched (one flow does not run every controller's every verb).
16. The lint lane on this machine (odh_kubeflow_tpu_torch.analysis), in
   PHASE16_BUDGET_S: (a) the full pass `python -m
   odh_kubeflow_tpu_torch.analysis` and its pragma gate against the
   package's allowlist, each in a subprocess that refuses every import of
   jax, PyYAML and the JAX package (LINT_REFUSED) and must exit 0
   (printed: the modules scanned, the checkers, the seconds, whether jax
   and PyYAML are installed here at all); (b) the live registry that phases 5-15
   filled in this process, held to the port's rules: check_registry and
   check_slo_definitions (the default SLOs and alert rules) both return
   [] (printed: the families); (c) the static and runtime halves of the
   serving hot regions side by side: host-transfer over serving/engine.py
   and models/decode.py finds nothing unsuppressed, its pragma'd lines
   are the burst's drain and the admission's first token, and phase 9's
   guarded engines copied 0 times inside a burst's region (budget 0) and
   once inside an admission's (budget 1), the drain once per burst
   outside it; (d) the interleaving explorer's job space
   (explore.explore_jobs) comes back exhausted, untruncated and clean
   (printed: schedules, scheduler states, seconds).

Every phase prints its time when it ends, and the end a line of them all.

The line before the last is a JSON object describing every kernel; the last
line is {"ok": true, "device": {...}}. Imports nothing of JAX.
"""
import json
import os
import re
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
import warnings

STARTED = time.time()  # the process's start (the smoke's, or a torchrun worker's), before torch is imported

import numpy as np  # noqa: E402
import torch  # noqa: E402

# published dense bf16 tensor-core FLOP/s, HBM bytes/s and f32 FLOP/s
# outside the tensor cores (NVIDIA data sheets), by a part of the name torch
# gives the card: the bound each kernel is held against, at the peak for the
# type its operations run in
PEAKS = {
    "H100 80GB HBM3": (989e12, 3.35e12, 67e12),  # H100 SXM
    "H100 PCIe": (756e12, 2.0e12, 51e12),
    "H200": (989e12, 4.8e12, 67e12),
}
TOLERANCE = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
DTYPE_NAMES = {torch.bfloat16: "bf16", torch.float32: "f32"}
LSE_TOLERANCE = 1e-3
# gradients: max abs error relative to the plain result's max |grad|. bf16:
# about two bf16 ulps at the largest gradient (2**-8 relative is one); f32:
# summation order only (<= 2.4e-7 measured on the card)
BWD_TOLERANCE = {torch.bfloat16: 1e-2, torch.float32: 1e-5}
MAIN_SHAPE = (1, 128, 8, 8, 128)  # one full-width prefill: b, s, h, hk, d
TIMING_SHAPE = (4, 2048, 8, 8, 128)
TRAIN_SHAPE = (8, 2048, 8, 8, 128)  # one layer's attention in the train step
GRAD_CHECK_SHAPE = (1, 512, 8, 8, 128)  # one layer's attention in phase 6's f32 gradient check
TENSOR_CORE_BWD = ("flash_bwd_dq", "flash_bwd_dkv")
SCALAR_BWD = ("flash_bwd_dq_scalar", "flash_bwd_dkv_scalar")
TRAIN_STEPS = 5
DEMO_PROMPTS = [[1, 2, 3, 4], [9, 8, 7], [100, 200, 300, 400, 500], [42]]  # f32 demo requests, phases 5, 8
MAX_NEWS = [16, 64, 24, 48, 32, 56, 40, 16]  # phases 5, 8 and 9: max_new of the 8 HTTP requests
HEDGE_AFTER_S = 0.0005  # phase 9: shorter than any prefill, so the hedge always fires
ADDED_LATENCY_REQUESTS = 24  # phase 9: sequential requests each, routed and direct
BURST_TIMING_ROUNDS = 8  # phase 9: timed bursts per profiler/guard setting
PHASE16_BUDGET_S = 60.0  # phase 16, the lint lane
LINT_REFUSED = ("jax", "jaxlib", "yaml", "odh_kubeflow_tpu")  # phase 16: imports its lint subprocesses refuse
PHASE9_GUARD = {}  # phase 9's guarded engines' copies per region entry, which phase 16 prints beside the lint's


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


PHASE_TIMES = {}  # phase -> its seconds, as each ends
_CURRENT = []  # the running phase's (name, start)


def phase(name: str) -> None:
    """Ends the running phase (its time printed) and starts `name`."""
    end_phase()
    _CURRENT[:] = [name, time.perf_counter()]
    print(f"== {name}", flush=True)


def end_phase() -> None:
    if _CURRENT:
        name, t0 = _CURRENT
        PHASE_TIMES[name.split()[0]] = time.perf_counter() - t0
        print(f"   (phase {name.split()[0]} took {PHASE_TIMES[name.split()[0]]:.1f} s)", flush=True)
        _CURRENT.clear()


def inputs(b, sq, sk, h, hk, d, dtype, seed, strided=False):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    if strided:  # q/k/v as the model's views of one fused qkv projection
        qkv = rnd(b, sq, h + 2 * hk, d)
        q, k, v = qkv.split([h, hk, hk], dim=2)
        return q, k, v
    return rnd(b, sq, h, d), rnd(b, sk, hk, d), rnd(b, sk, hk, d)


def work(b, sq, sk, h, hk, d, dtype, causal, with_lse):
    """(flops, bytes) the call needs: 4*d flops per visible (q, k) pair per
    head; q, k, v read once and out (and lse) written once."""
    if causal:
        pairs = sum(min(sk, i + 1) for i in range(sq))
    else:
        pairs = sq * sk
    flops = 4 * b * h * d * pairs
    item = torch.tensor([], dtype=dtype).element_size()
    nbytes = item * (2 * b * sq * h * d + 2 * b * sk * hk * d)
    if with_lse:
        nbytes += 4 * b * h * sq
    return flops, nbytes


def bwd_work(kind, b, sq, sk, h, hk, d, dtype, causal):
    """(flops, bytes) of one backward kernel: 6*d flops per visible pair
    and head for dq (three products), 8*d for dk/dv (four); q, k, v, dO,
    lse and delta read once, the outputs written once."""
    pairs = sum(min(sk, i + 1) for i in range(sq)) if causal else sq * sk
    flops = (6 if kind == "dq" else 8) * b * h * d * pairs
    item = torch.tensor([], dtype=dtype).element_size()
    nbytes = item * (2 * b * sq * h * d + 2 * b * sk * hk * d) + 2 * 4 * b * h * sq
    nbytes += item * (b * sq * h * d if kind == "dq" else 2 * b * sk * hk * d)
    return flops, nbytes


SCALAR_ARGS = re.compile(r"(flash_(?:fwd|bwd_dkv|bwd_dq)_scalar)_kernelI(f|13__nv_bfloat16)"
                         r"Li(\d+)ELi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E")


def ptxas_summary(log):
    """ptxas's report on each kernel of a build: registers and spill bytes
    a line, the redesigned scalar kernels named by their template arguments
    (dtype, d, rows x inner tile, rows x columns a thread, cluster size);
    warnings and errors as they are."""
    lines, kernel = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            m = SCALAR_ARGS.search(mangled)
            if m:
                name, t, d, rows, inner, per, lanes, ks = m.groups()
                dt = "f32" if t == "f" else "bf16"
                inner_cols = int(inner) // int(lanes)
                kernel = (f"{name} {dt} d{d}: {rows} rows x {inner} {'q' if 'dkv' in name else 'keys'}, "
                          f"{per}x{inner_cols} a thread, {ks}-block clusters")
            else:
                m = re.search(r"\d(flash_[a-z_]+?_kernel)I(.*)", mangled)
                kernel = (f"{m.group(1)}<{', '.join(re.findall(r'Li(\d+)E', m.group(2)))}>"
                          if m else mangled[:90])
        elif "Used" in line and "registers" in line and kernel:
            regs = line.split("Used")[1].split("registers")[0].strip()
            lines.append(f"{kernel}: {regs} registers")
        elif "spill stores" in line and kernel and lines:
            stores = line.split("bytes spill stores")[0].split(",")[-1].strip()
            loads = line.split("bytes spill loads")[0].split(",")[-1].strip()
            if stores != "0" or loads != "0":
                lines[-1] += f", spills {stores} B stored / {loads} B loaded"
        elif any(w in line for w in ("error", "warning", "Performance")):
            lines.append(line.strip())
    return lines


def count_sass(path, opcode):
    """How many instructions of `opcode` the library's SASS holds."""
    sass = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass", str(path)],
                          capture_output=True, text=True, timeout=300, check=True).stdout
    return sum(opcode in line for line in sass.splitlines())


def tile_edge_cases(sms):
    """bf16 cases for the tensor-core kernel at its tile edges: sq = sk at
    each length, d 128 and 64, causal and full, each run once with 128-row
    q tiles (a "wide" batch whose grid of 128-row tiles covers the card's
    `sms` SMs, GQA 16/4) and once with 64-row tiles (one sequence, GQA 8/1
    or 4/1); strided fused-qkv views on the causal cases, lse on half; then
    sq != sk full attention at both widths (contiguous: a fused view has
    one length)."""
    cases = []
    for d in (128, 64):
        for s in (63, 64, 65, 127, 129, 2049):
            blocks = -(-s // 128)
            wide_b = -(-sms // (blocks * 16))
            narrow_h = 8 if blocks * 8 < sms else 4
            for causal in (True, False):
                tag = f"d{d} s{s} {'causal' if causal else 'full'}"
                cases.append((f"edge {tag} wide", wide_b, s, s, 16, 4, d, torch.bfloat16, causal,
                              causal, causal))
                cases.append((f"edge {tag} narrow", 1, s, s, narrow_h, 1, d, torch.bfloat16, causal,
                              not causal, causal))
        cases.append((f"sq!=sk full d{d} wide", 4, 300, 700, 16, 4, d, torch.bfloat16, False, True,
                       False))
        cases.append((f"sq!=sk full d{d} narrow", 1, 129, 63, 8, 1, d, torch.bfloat16, False, True,
                       False))
    return cases


def bwd_tile_edge_cases():
    """bf16 cases for the tensor-core backward pair at its tile edges (64-row
    warpgroup and streamed tiles, 128-row blocks): sq = sk at each length, d
    128 and 64, causal and full, once as GQA 16/4 on strided fused-qkv views
    and once as GQA 8/1 on contiguous tensors; then sq != sk full attention
    at both widths (contiguous: a fused view has one length)."""
    cases = []
    for d in (128, 64):
        for s in (63, 64, 65, 127, 129, 2049):
            for causal in (True, False):
                tag = f"d{d} s{s} {'causal' if causal else 'full'}"
                cases.append((f"bwd edge {tag} gqa 16/4 strided", 2, s, s, 16, 4, d, torch.bfloat16,
                              causal, True))
                cases.append((f"bwd edge {tag} gqa 8/1", 1, s, s, 8, 1, d, torch.bfloat16, causal,
                              False))
        cases.append((f"bwd sq!=sk full d{d} gqa 16/4", 2, 300, 700, 16, 4, d, torch.bfloat16, False,
                      False))
        cases.append((f"bwd sq!=sk full d{d} gqa 8/1", 1, 129, 63, 8, 1, d, torch.bfloat16, False,
                      False))
    return cases


SCALAR_EDGE_LENGTHS = (1, 15, 16, 17, 31, 33, 65, 129, 513)


def _batch_for_tile(attention, tile, rows, heads, sms):
    """The smallest batch whose grid makes the scalar kernels take `tile`
    rows per block (`attention._scalar_tile`), or None where none does (a
    32-row tile adds no block over 64 rows at rows <= 32)."""
    return next((b for b in range(1, 2 * sms + 1)
                 if attention._scalar_tile(rows, b * heads, sms) == tile), None)


def scalar_tile_edge_cases(attention, sms, kernel="fwd"):
    """Cases for the scalar forward (`kernel` "fwd"), dk/dv ("dkv") or dq
    ("dq") at the edges of its tiles: f32 at sq = sk in
    SCALAR_EDGE_LENGTHS, d 16/32/64/128, causal and full, each at every q
    (k for dk/dv) tile the grid can give it (64: GQA 8/2 on strided
    fused-qkv views; 32: GQA 4/1; 16: either, by mask), the batch chosen so
    the grid gives that tile (it counts batch * heads, or batch * kv_heads
    for dk/dv); bf16 at d 16 and 32 at lengths 17, 33 and 129; one sq != sk
    full case at each tile. Each case is (label, b, sq, sk, h, hk, d, dtype,
    causal, strided, tile)."""
    by_kv = kernel == "dkv"
    prefix = "scalar dq edge" if kernel == "dq" else "scalar edge"
    cases = []
    grid = []
    for d in (16, 32, 64, 128):
        grid += [(torch.float32, d, s) for s in SCALAR_EDGE_LENGTHS]
    for d in (16, 32):
        grid += [(torch.bfloat16, d, s) for s in (17, 33, 129)]
    for dtype, d, s in grid:
        for causal in (True, False):
            for tile in (64, 32, 16):
                h, hk, strided = (8, 2, True) if tile == 64 or (tile == 16 and causal) else (4, 1, False)
                b = _batch_for_tile(attention, tile, s, hk if by_kv else h, sms)
                if b is None:
                    continue
                tag = f"{DTYPE_NAMES[dtype]} d{d} s{s} {'causal' if causal else 'full'} gqa {h}/{hk}"
                cases.append((f"{prefix} {tag}{' strided' if strided else ''} b{b}", b, s, s, h, hk,
                              d, dtype, causal, strided, tile))
    for tile in (64, 32, 16):  # sq != sk: the tile follows sq (forward, dq) or sk (dk/dv)
        sq, sk, h, hk = 129, 65, 8, 2
        b = _batch_for_tile(attention, tile, sk if by_kv else sq, hk if by_kv else h, sms)
        cases.append((f"{prefix} f32 d64 sq!=sk full b{b}", b, sq, sk, h, hk, 64, torch.float32, False,
                      False, tile))
    return cases


def scalar_dq_split_cases(attention, sms):
    """f32 cases that give the scalar dq kernel each (q tile, cluster size)
    its rule can give, causal and full: the first (length, heads, batch),
    lengths from SCALAR_EDGE_LENGTHS then 1024, heads 8/2 (strided
    fused-qkv views), 4/1, 2/1 and 1/1, for which `attention._scalar_dq_plan`
    names that pair; d 128 at 64-row tiles, else 64. Each case is (label, b,
    sq, sk, h, hk, d, dtype, causal, strided, tile)."""
    cases = []
    for tile in (64, 32, 16):
        for split in (2 ** i for i in range(attention._DQ_MAX_SPLIT.bit_length())):
            for causal in (True, False):
                found = next(((s, h, hk, b) for s in (*SCALAR_EDGE_LENGTHS, 1024)
                              for h, hk in ((8, 2), (4, 1), (2, 1), (1, 1))
                              for b in range(1, 2 * sms + 1)
                              if attention._scalar_dq_plan(b, s, s, h, causal, sms) == (tile, split)),
                             None)
                if found is None:
                    continue
                s, h, hk, b = found
                d = 128 if tile == 64 else 64
                cases.append((f"scalar dq split f32 d{d} s{s} {'causal' if causal else 'full'} gqa "
                              f"{h}/{hk} b{b} ({tile}-row q tiles, {split}-block clusters)", b, s, s, h,
                              hk, d, torch.float32, causal, h == 8, tile))
    return cases


def card_peaks(kind):
    for name, peaks in PEAKS.items():
        if name in kind:
            return peaks
    fail(f"no published peaks for {kind}: add its data-sheet rates to PEAKS")


def bound_ms(flops, nbytes, peaks, dtype=torch.bfloat16):
    t_ops = flops / peaks[0 if dtype == torch.bfloat16 else 2] * 1e3
    t_bytes = nbytes / peaks[1] * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _event_ms(fn):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def time_ms(fn, runs=25, reps=10):
    """Device time of one call: `reps` calls captured in one CUDA graph,
    replayed `runs` times between CUDA events; the median per call. The
    graph takes the host's launch cost out, so a short kernel is timed, not
    the Python that launches it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as torch asks
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    ms = statistics.median(_event_ms(graph.replay) for _ in range(runs)) / reps
    del graph
    return ms


def eager_ms(fn, runs=25, reps=10):
    """Time of one call launched from Python, `reps` calls back to back
    between events: the host's launch cost included where it exceeds the
    device's work."""
    fn()
    torch.cuda.synchronize()

    def burst():
        for _ in range(reps):
            fn()

    return statistics.median(_event_ms(burst) for _ in range(runs)) / reps


def _matmul_type(name):
    """The operand type a cuBLAS kernel's name gives, where it gives one."""
    if name.startswith("nvjet_t") or any(w in name for w in ("bf16", "bfloat16")):
        return "bf16"
    if any(w in name for w in ("sgemm", "f32f32_f32f32", "nvjet_s", "float, float, float")):
        return "f32"
    return "type unnamed"


def device_split(prof, wall_ms):
    """Device time of a profiled run by kernel group, beside the host
    clock's time for the same work unprofiled (the profiler slows the
    host); the matmul group also by operand type, with its largest kernels
    by name."""
    from torch.autograd import DeviceType

    groups, matmuls, launches = {}, {}, 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        name = e.name.lower()
        ms = e.device_time_total / 1e3
        # each "_scalar" name before its prefix, so the groups stay apart
        flash = [k for k in ("flash_fwd_scalar", "flash_bwd_dq_scalar", "flash_bwd_dkv_scalar",
                             "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv") if k in name]
        if flash:
            group = flash[0]
        elif any(w in name for w in ("gemm", "gemv", "xmma", "cutlass", "splitk", "nvjet")):
            group = "matmul"
            n, t = matmuls.get(e.name, (0, 0.0))
            matmuls[e.name] = (n + 1, t + ms)
        elif "memcpy" in name or "memset" in name:
            group = "copy"
        elif any(w in name for w in ("index", "gather", "scatter", "embedding")):
            group = "index/gather/scatter"
        else:
            group = "other"
        groups[group] = groups.get(group, 0.0) + ms
        launches += 1
    busy = sum(groups.values())
    if busy == 0:
        return "the profiler saw no device time: not measured"
    parts = ", ".join(f"{g} {ms:.3f} ms" for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]))
    by_type = {}
    for name, (_, t) in matmuls.items():
        kind = _matmul_type(name.lower())
        by_type[kind] = by_type.get(kind, 0.0) + t
    top = sorted(matmuls.items(), key=lambda kv: -kv[1][1])[:6]
    split = ", ".join(f"{k} {t:.3f} ms" for k, t in sorted(by_type.items(), key=lambda kv: -kv[1]))
    largest = "; ".join(f"{t:.3f} ms in {n}x {name[:90]}" for name, (n, t) in top)
    return (f"{busy:.3f} ms busy in {launches} device ops, {busy / wall_ms:.1%} of the "
            f"unprofiled {wall_ms:.2f} ms ({parts})"
            + (f"\n    matmul by operand type: {split}\n    largest matmul kernels: {largest}"
               if matmuls else ""))


def _grad_err(got, want, largest=None):
    """max |got - want| over max |want| (or over `largest`), in f32."""
    scale = want.float().abs().max().item() if largest is None else largest
    return (got.float() - want.float()).abs().max().item() / scale


def check_backward(attention, sms):
    """Phase 3b: each backward kernel against its plain version on the same
    inputs (lse from the forward kernel, delta = rowsum(dO * out)), each
    case naming the pair of kernels it launched (read from the launch
    counts), dq's q tile and dk/dv's k tile (and, for the scalar pair, each
    one's cluster size), each held against the Python mirrors, then autograd
    through the op with an lse cotangent against the plain versions. The
    scalar cases reach every dk/dv k tile, every dq q tile and every dq
    cluster size the rules can give. At sq = sk = 1 (one key: p = 1, dp =
    delta) dq and dk are 0 in exact arithmetic and hold only rounding
    noise, so each gradient is held against the case's largest plain
    gradient there. Returns each kernel's max abs error at its main-path
    shape (the training shape; the gradient check's for the scalar pair)."""
    cases = [
        # (label, b, sq, sk, h, hk, d, dtype, causal, strided)
        ("training shape", *TRAIN_SHAPE[:2], TRAIN_SHAPE[1], *TRAIN_SHAPE[2:], torch.bfloat16, True, True),
        ("1x128", 1, 128, 128, 8, 8, 128, torch.bfloat16, True, True),
        ("gqa 16/4", 2, 2048, 2048, 16, 4, 128, torch.bfloat16, True, False),
        ("ragged 200", 1, 200, 200, 8, 8, 128, torch.bfloat16, True, False),
        ("sq!=sk full", 2, 300, 700, 8, 4, 128, torch.bfloat16, False, False),
        ("f32 gradient-check shape", *GRAD_CHECK_SHAPE[:2], GRAD_CHECK_SHAPE[1], *GRAD_CHECK_SHAPE[2:],
         torch.float32, True, True),
        ("f32 d64 ragged gqa", 2, 333, 333, 8, 2, 64, torch.float32, True, False),
        ("f32 d32 sq!=sk full", 1, 100, 260, 4, 4, 32, torch.float32, False, False),
        ("f32 d16 gqa", 1, 37, 37, 4, 2, 16, torch.float32, True, True),
        ("bf16 d32 full", 1, 96, 96, 4, 4, 32, torch.bfloat16, False, False),
        *bwd_tile_edge_cases(),
    ]
    dkv_edges = scalar_tile_edge_cases(attention, sms, "dkv")
    dq_edges = scalar_tile_edge_cases(attention, sms, "dq") + scalar_dq_split_cases(attention, sms)
    want_tile_k = {c[0]: c[-1] for c in dkv_edges}
    want_tile_q = {c[0]: c[-1] for c in dq_edges}
    cases += [c[:-1] for c in dkv_edges + dq_edges]
    errors, main_err, ran, tiles, dq_plans = [], {}, set(), set(), set()
    for i, (label, b, sq, sk, h, hk, d, dtype, causal, strided) in enumerate(cases):
        q, k, v = inputs(b, sq, sk, h, hk, d, dtype, seed=200 + i, strided=strided)
        dout = inputs(b, sq, sq, h, h, d, dtype, seed=300 + i)[0]
        out, lse = attention.flash_attention(q, k, v, causal=causal, with_lse=True)
        delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        args = (q, k, v, dout, lse, delta, causal)
        before = dict(attention.launch_counts)
        got = (attention.flash_bwd_dq(*args), *attention.flash_bwd_dkv(*args))
        launched = tuple(n for n in attention.launch_counts if attention.launch_counts[n] != before[n])
        want = (attention.flash_bwd_dq_plain(*args), *attention.flash_bwd_dkv_plain(*args))
        torch.cuda.synchronize()
        largest = max(w.float().abs().max().item() for w in want) if sq == sk == 1 else None
        errs = [_grad_err(g, w, largest) for g, w in zip(got, want)]
        dkv_kernel, tile_k = attention.bwd_dkv_launch_plan(dtype, b, sk, hk, d)
        dq_kernel, tile_q = attention.bwd_dq_launch_plan(dtype, b, sq, h, d)
        if dkv_kernel == "flash_bwd_dkv_scalar":
            _, split_k, split_q = attention.scalar_splits(dtype, d, b, sq, sk, h, hk, causal)
            plan = (f"{', '.join(launched)}; dq {tile_q}-row q tiles, {split_q}-block clusters; "
                    f"dk/dv {tile_k}-row k tiles, {split_k}-block clusters")
            tiles.add(tile_k)
            dq_plans.add((tile_q, split_q))
            plan_ok = (tile_k == attention._scalar_tile(sk, b * hk, sms)
                       and tile_q == attention._scalar_tile(sq, b * h, sms)
                       and (tile_q, split_q) == attention._scalar_dq_plan(b, sq, sk, h, causal, sms))
        else:
            plan = f"{', '.join(launched)}; dq {tile_q}-row q tiles; dk/dv {tile_k}-row k tiles"
            plan_ok = tile_q == tile_k == 128
        ok = (all(g.dtype == w.dtype and g.shape == w.shape for g, w in zip(got, want))
              and all(torch.isfinite(g.float()).all().item() for g in got)
              and max(errs) <= BWD_TOLERANCE[dtype]
              and launched == attention._bwd_kernel_for(dtype, d)
              and (dq_kernel, dkv_kernel) == launched
              and tile_k == want_tile_k.get(label, tile_k)
              and tile_q == want_tile_q.get(label, tile_q)
              and plan_ok)
        ran.update(launched)
        print(f"  {label} [{plan}]: dq {errs[0]:.3e}, dk {errs[1]:.3e}, dv {errs[2]:.3e} "
              f"of max |grad|{' of the three' if largest else ''} (tol {BWD_TOLERANCE[dtype]:.0e})"
              + ("" if ok else "  <-- FAIL"), flush=True)
        if not ok:
            errors.append(label)
        if label in ("training shape", "f32 gradient-check shape"):
            abs_errs = [(g.float() - w.float()).abs().max().item() for g, w in zip(got, want)]
            dq_name, dkv_name = attention._bwd_kernel_for(dtype, d)
            main_err.update({dq_name: abs_errs[0], dkv_name: max(abs_errs[1:])})
    if ran != set(TENSOR_CORE_BWD + SCALAR_BWD):
        errors.append(f"kernels run {sorted(ran)}")
    if tiles != {16, 32, 64}:
        errors.append(f"scalar dk/dv k tiles run {sorted(tiles)}")
    if {t for t, _ in dq_plans} != {16, 32, 64}:
        errors.append(f"scalar dq q tiles run {sorted({t for t, _ in dq_plans})}")
    if {s for _, s in dq_plans} != {2 ** i for i in range(attention._DQ_MAX_SPLIT.bit_length())}:
        errors.append(f"scalar dq cluster sizes run {sorted({s for _, s in dq_plans})}")
    print(f"  scalar dq (q tile, cluster size) pairs run: {sorted(dq_plans)}", flush=True)
    # through autograd: a loss reading out and lse, so g_lse enters as delta - g_lse
    b, s, h, hk, d = 2, 256, 8, 2, 128
    q, k, v = (t.requires_grad_() for t in inputs(b, s, s, h, hk, d, torch.bfloat16, seed=400))
    g_out = inputs(b, s, s, h, h, d, torch.bfloat16, seed=401)[0]
    g_lse = torch.randn(b, h, s, device="cuda", generator=torch.Generator(device="cuda").manual_seed(402))
    before = dict(attention.launch_counts)
    out, lse = attention.flash_attention(q, k, v, causal=True, with_lse=True)
    got = torch.autograd.grad((out, lse), (q, k, v), (g_out, g_lse))
    launched = {n: attention.launch_counts[n] - before[n] for n in before}
    delta = (g_out.float() * out.detach().float()).sum(-1).transpose(1, 2) - g_lse
    args = (q.detach(), k.detach(), v.detach(), g_out, lse.detach(), delta.contiguous(), True)
    want = (attention.flash_bwd_dq_plain(*args), *attention.flash_bwd_dkv_plain(*args))
    errs = [_grad_err(g, w) for g, w in zip(got, want)]
    ok = (max(errs) <= BWD_TOLERANCE[torch.bfloat16]
          and launched == {"flash_fwd": 1, "flash_fwd_scalar": 0, "flash_bwd_dq": 1, "flash_bwd_dkv": 1,
                           "flash_bwd_dq_scalar": 0, "flash_bwd_dkv_scalar": 0})
    print(f"  autograd with g_lse (b{b} s{s} h{h} hk{hk} bf16): dq {errs[0]:.3e}, dk {errs[1]:.3e}, "
          f"dv {errs[2]:.3e}; launches {launched}" + ("" if ok else "  <-- FAIL"), flush=True)
    if not ok:
        errors.append("autograd with g_lse")
    if errors:
        fail(f"the backward kernels disagree with their plain versions: {errors}")
    return main_err


def sdpa_backward_ms(qt, kt, vt, dout_t):
    """(backward ms, forward-under-grad ms) of SDPA on (b, h, s, d) inputs
    that require grad, by CUDA-graph replay: forward and backward captured
    together, less the forward under grad alone."""
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def fwd_bwd():
        return torch.autograd.grad(sdpa(qt, kt, vt, is_causal=True), (qt, kt, vt), dout_t)

    fwd_ms = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True), runs=10, reps=5)
    return time_ms(fwd_bwd, runs=10, reps=5) - fwd_ms, fwd_ms


def time_kernel_rows(rows, peaks, smi, dtype, shape):
    """Each row (kernel, plain, (flops, bytes), library ms, library name)
    timed by CUDA-graph replay beside its plain version, its bound at the
    peak for `dtype` and its library yardstick; printed and returned by
    name."""
    timings = {}
    for name, (kernel, plain, (flops, nbytes), library_ms, library) in rows.items():
        b_ms, b_by = bound_ms(flops, nbytes, peaks, dtype)
        t = {"ms": time_ms(kernel, runs=10, reps=5), "plain_ms": time_ms(plain, runs=10, reps=3),
             "library_ms": library_ms, "library": library, "bound_ms": b_ms, "bound_by": b_by,
             "flops": flops, "bytes": nbytes, "shape": shape}
        timings[name] = t
        print(f"  {name} {shape}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
              f"{library} {library_ms:.4f} ms; {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB, "
              f"bound {b_ms:.4f} ms ({b_by}); kernel at {flops / (t['ms'] * 1e-3) / 1e12:.2f} "
              f"TFLOP/s, {b_ms / t['ms']:.3%} of bound, {t['ms'] / library_ms:.2f}x the "
              f"library's time on {smi}", flush=True)
    return timings


def time_scalar_bwd_kernels(attention, peaks, smi):
    """Phase 4 for the scalar backward pair at its main-path shape, phase
    6's f32 gradient check (one layer: b1 s512 h8 d128, causal), bound at
    the f32 peak outside the tensor cores; SDPA's f32 backward (dq+dk+dv in
    one autograd call, TF32 off) is the pair's yardstick."""
    b, s, h, hk, d = GRAD_CHECK_SHAPE
    q, k, v = inputs(b, s, s, h, hk, d, torch.float32, seed=510, strided=True)
    dout = inputs(b, s, s, h, h, d, torch.float32, seed=511)[0]
    out, lse = attention.flash_attention(q, k, v, causal=True, with_lse=True)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, dout, lse, delta, True)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    sdpa_bwd = sdpa_backward_ms(qt, kt, vt, dout.transpose(1, 2).contiguous())[0]
    library = "SDPA f32 backward (its default backend), dq+dk+dv in one call"
    rows = {
        "flash_bwd_dq_scalar": (lambda: attention.flash_bwd_dq(*args),
                                lambda: attention.flash_bwd_dq_plain(*args),
                                bwd_work("dq", b, s, s, h, hk, d, torch.float32, True), sdpa_bwd,
                                library),
        "flash_bwd_dkv_scalar": (lambda: attention.flash_bwd_dkv(*args),
                                 lambda: attention.flash_bwd_dkv_plain(*args),
                                 bwd_work("dkv", b, s, s, h, hk, d, torch.float32, True), sdpa_bwd,
                                 library),
    }
    shape = f"b{b} s{s} h{h} hk{hk} d{d} f32 causal"
    timings = time_kernel_rows(rows, peaks, smi, torch.float32, shape)
    pair = sum(timings[n]["ms"] for n in SCALAR_BWD)
    pair_bound = sum(timings[n]["bound_ms"] for n in SCALAR_BWD)
    print(f"  scalar backward pair (dq + dk/dv) {shape}: {pair:.4f} ms, {pair_bound / pair:.3%} of the "
          f"pair's bound {pair_bound:.4f} ms, {pair / sdpa_bwd:.2f}x SDPA's f32 backward "
          f"({sdpa_bwd:.4f} ms) on {smi}", flush=True)
    return timings


def device_kernel_names(fn):
    """Names of the kernels one profiled call of fn ran on the card."""
    from torch.autograd import DeviceType

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.name for e in prof.events() if e.device_type == DeviceType.CUDA})


def time_scalar_fwd_kernel(attention, peaks, smi, demo_prompt_len):
    """Phase 4 for the scalar forward at its main-path shapes besides the
    serving one: one layer of phase 6's f32 gradient check (b1 s512 h8 d128,
    causal, with lse, as training runs it) and the demo model's prefill as
    the engine gives it (b1, the prompt's length, h4 hk2 d16, no lse), each
    beside its plain version, its bound at the f32 peak outside the tensor
    cores and SDPA's f32 forward (no lse). Prints the kernels SDPA's f32
    forward and backward ran (one profiled call each), so the yardstick is
    known."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    timings = {}
    for tag, (b, s, h, hk, d), with_lse in (("grad check", GRAD_CHECK_SHAPE, True),
                                            ("demo prefill", (1, demo_prompt_len, 4, 2, 16), False)):
        q, k, v = inputs(b, s, s, h, hk, d, torch.float32, seed=520, strided=True)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        library_ms = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=h != hk))
        rows = {tag: (lambda: attention.flash_attention(q, k, v, causal=True, with_lse=with_lse),
                      lambda: attention.flash_attention_plain(q, k, v, causal=True, with_lse=with_lse),
                      work(b, s, s, h, hk, d, torch.float32, True, with_lse), library_ms,
                      "SDPA f32 forward (no lse)")}
        shape = f"b{b} s{s} h{h} hk{hk} d{d} f32 causal{' lse' if with_lse else ''}"
        timings.update(time_kernel_rows(rows, peaks, smi, torch.float32, shape))
        if tag == "grad check":
            qg, kg, vg = (x.detach().clone().requires_grad_() for x in (qt, kt, vt))
            fwd_names = device_kernel_names(lambda: sdpa(qt, kt, vt, is_causal=True))
            out = sdpa(qg, kg, vg, is_causal=True)
            bwd_names = device_kernel_names(lambda: torch.autograd.grad(out, (qg, kg, vg), out))
            print(f"  SDPA f32 at {shape}: forward ran {fwd_names}; backward ran {bwd_names}",
                  flush=True)
    return timings


def time_training_kernels(attention, peaks, smi):
    """Phase 4 at the training shape: the forward with lse, dq and dk/dv,
    each beside its plain version, its bound and a library yardstick (SDPA
    forward; for the pair, SDPA's backward, dq+dk+dv in one autograd call
    on the backend SDPA picks, timed by CUDA-graph replay as the kernels
    are: forward and backward captured together, less the forward under
    grad alone). Printed beside it: the same backward launched from Python,
    and aten's flash (FlashAttention-2) backward alone by graph replay."""
    b, s, h, hk, d = TRAIN_SHAPE
    q, k, v = inputs(b, s, s, h, hk, d, torch.bfloat16, seed=500, strided=True)
    dout = inputs(b, s, s, h, h, d, torch.bfloat16, seed=501)[0]
    out, lse = attention.flash_attention(q, k, v, causal=True, with_lse=True)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, dout, lse, delta, True)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sdpa_dout = dout.transpose(1, 2).contiguous()
    with torch.no_grad():
        sdpa_fwd_ms = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True), runs=10, reps=5)
    sdpa_bwd_ms, sdpa_fwd_grad_ms = sdpa_backward_ms(qt, kt, vt, sdpa_dout)
    sdpa_out = sdpa(qt, kt, vt, is_causal=True)
    sdpa_bwd_eager_ms = eager_ms(lambda: torch.autograd.grad(sdpa_out, (qt, kt, vt), sdpa_dout,
                                                             retain_graph=True), runs=10, reps=5)
    aten = torch.ops.aten
    with torch.no_grad():
        qd, kd, vd = qt.detach(), kt.detach(), vt.detach()
        fo, flse, cq, ck, mq, mk, seed, offset, _ = aten._scaled_dot_product_flash_attention(
            qd, kd, vd, 0.0, True)

        def fa2_bwd():
            return aten._scaled_dot_product_flash_attention_backward(
                sdpa_dout, qd, kd, vd, fo, flse, cq, ck, mq, mk, 0.0, True, seed, offset)

        fa2_bwd_ms = time_ms(fa2_bwd, runs=10, reps=5)
    print(f"  SDPA backward (dq+dk+dv) b{b} s{s} by CUDA-graph replay: {sdpa_bwd_ms:.4f} ms "
          f"(forward+backward less the forward under grad, {sdpa_fwd_grad_ms:.4f} ms); "
          f"launched from Python {sdpa_bwd_eager_ms:.4f} ms; aten flash (FA2) backward "
          f"{fa2_bwd_ms:.4f} ms", flush=True)
    shape = f"b{b} s{s} h{h} hk{hk} d{d} bf16 causal"
    rows = {
        "flash_fwd": (lambda: attention.flash_attention(q, k, v, causal=True, with_lse=True),
                      lambda: attention.flash_attention_plain(q, k, v, causal=True, with_lse=True),
                      work(b, s, s, h, hk, d, torch.bfloat16, True, True), sdpa_fwd_ms,
                      "SDPA forward (no lse)"),
        "flash_bwd_dq": (lambda: attention.flash_bwd_dq(*args),
                         lambda: attention.flash_bwd_dq_plain(*args),
                         bwd_work("dq", b, s, s, h, hk, d, torch.bfloat16, True), sdpa_bwd_ms,
                         "SDPA backward (its default backend), dq+dk+dv in one call"),
        "flash_bwd_dkv": (lambda: attention.flash_bwd_dkv(*args),
                          lambda: attention.flash_bwd_dkv_plain(*args),
                          bwd_work("dkv", b, s, s, h, hk, d, torch.bfloat16, True), sdpa_bwd_ms,
                          "SDPA backward (its default backend), dq+dk+dv in one call"),
    }
    timings = time_kernel_rows(rows, peaks, smi, torch.bfloat16, shape)
    pair = timings["flash_bwd_dq"]["ms"] + timings["flash_bwd_dkv"]["ms"]
    pair_bound = sum(bound_ms(timings[n]["flops"], timings[n]["bytes"], peaks)[0]
                     for n in TENSOR_CORE_BWD)
    print(f"  backward pair (dq + dk/dv) {shape}: {pair:.4f} ms, {pair_bound / pair:.3%} of the "
          f"pair's bound {pair_bound:.4f} ms, {pair / sdpa_bwd_ms:.2f}x SDPA's backward on {smi}",
          flush=True)
    return timings


def host_split_us(attention, q, k, v):
    """Host-clock cost in µs of one no-lse forward call on q/k/v (CUDA
    tensors), the mean of 2000 back-to-back calls after 50 warm-ups, split
    into the public function, the registered op alone, and the C entry
    alone (its tensor maps and the launch). Launched from Python, a short
    kernel's call costs its host path, not its device time."""
    b, sq, h, d = q.shape
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lib, entry = attention._entry("odh_flash_fwd")
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None,
            attention._DTYPE_CODES[q.dtype], b, sq, k.shape[1], h, k.shape[2], d,
            *(attention._strides(t) for t in (q, k, v)), 1, d**-0.5 * attention.LOG2E,
            torch.cuda.current_stream().cuda_stream)
    calls = {
        "public flash_attention": lambda: attention.flash_attention(q, k, v, causal=True),
        "registered op": lambda: torch.ops.odh_kubeflow_tpu_torch.flash_fwd(q, k, v, True, False),
        "C entry": lambda: entry(*args),
    }
    split = {}
    for name, fn in calls.items():
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            fn()
        split[name] = (time.perf_counter() - t0) / 2000 * 1e6
        torch.cuda.synchronize()
    return split


def count_sync_warnings(fn):
    """Runs fn under torch's CUDA sync debug mode "warn" and returns the
    number of host-device synchronisations it reported."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # torch's own notice that the mode is a prototype, given once per
    # process when a mode is first set, is not a synchronisation
    return sum("called a synchronizing CUDA operation" in str(w.message) for w in caught)


def train_phase(attention, peaks, smi):
    """Phase 6: the gradient check on the card, then the full-width train
    step. Returns the launch counts of the timed steps and of the gradient
    check, and the train run (cfg, step function, batch, params, optimizer
    state) for phase 7."""
    from odh_kubeflow_tpu_torch.models import TransformerConfig, init_params, loss_fn, make_train_step
    from odh_kubeflow_tpu_torch.models.tree import tree_leaves, tree_map

    full = dict(vocab=32768, d_model=1024, n_heads=8, d_ff=4096, max_seq=2048)
    # gradient check: 2 layers in f32 (head_dim 128, seq 512), loss and
    # gradients through the kernels against autograd through mha_reference
    cfg32 = TransformerConfig(**full, n_layers=2, dtype=torch.float32, use_flash=True,
                              remat=True, remat_policy="flash")
    params = init_params(torch.Generator().manual_seed(1), cfg32, device="cuda")
    tokens = torch.as_tensor(np.random.default_rng(2).integers(0, cfg32.vocab, (1, 512)), device="cuda")
    results = []
    for cfg in (cfg32, TransformerConfig(**{**cfg32.__dict__, "use_flash": False, "remat": False})):
        live = tree_map(lambda t: t.detach().requires_grad_(), params)
        before = dict(attention.launch_counts)
        loss = loss_fn(live, {"tokens": tokens}, cfg)
        grads = torch.autograd.grad(loss, tree_leaves(live))
        launched = {n: attention.launch_counts[n] - before[n] for n in before}
        results.append((loss.detach(), grads, launched))
    (loss_k, grads_k, launched), (loss_r, grads_r, _) = results
    loss_err = abs((loss_k - loss_r) / loss_r).item()
    grad_err = max(_grad_err(g, w) for g, w in zip(grads_k, grads_r))
    print(f"  gradient check (2 layers f32, 1x512): loss {loss_k.item():.6f} vs reference "
          f"{loss_r.item():.6f} (rel err {loss_err:.3e}), grads max rel err {grad_err:.3e} "
          f"(tol 1e-4); kernel launches {launched}", flush=True)
    if not (loss_err <= 1e-4 and grad_err <= 1e-4):
        fail("loss or gradients through the kernels disagree with the reference attention")
    if min(launched[n] for n in ("flash_fwd_scalar",) + SCALAR_BWD) < cfg32.n_layers:
        fail(f"the gradient check did not run through the scalar kernels: {launched}")
    del params, grads_k, grads_r, results

    # the full-width train step: bench.py's train-step config
    cfg = TransformerConfig(**full, n_layers=8, dtype=torch.bfloat16, use_flash=True,
                            remat=True, remat_policy="flash")
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cuda")
    n_params = sum(t.numel() for t in tree_leaves(params))
    b, s = TRAIN_SHAPE[:2]
    batch = {"tokens": torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab, (b, s)),
                                       device="cuda")}
    step, opt = make_train_step(cfg)
    state = opt.init(params)
    params, state, first = step(params, state, batch)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = [first]
    attention.reset_launch_counts()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(TRAIN_STEPS):
        params, state, loss = step(params, state, batch)
        losses.append(loss)
    end.record()
    end.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
    launches = dict(attention.launch_counts)
    step_ms = start.elapsed_time(end) / TRAIN_STEPS
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = torch.stack(losses).tolist()  # the one host copy of the losses
    tokens_per_s = b * s / (step_ms * 1e-3)
    flops_per_token = 6 * n_params + 12 * cfg.n_layers * cfg.d_model * s  # bench.py's count
    mfu = flops_per_token * tokens_per_s / peaks[0]
    print(f"  {n_params / 1e6:.1f}M params, batch {b}x{s}, remat_policy flash: losses "
          f"{', '.join(f'{x:.4f}' for x in losses)} (warm-up first)", flush=True)
    print(f"  {step_ms:.2f} ms per step (CUDA events; host clock {host_ms:.2f} ms), "
          f"{tokens_per_s:.0f} tokens/s, model FLOPs {flops_per_token * b * s / 1e12:.2f} TFLOP "
          f"per step = {mfu:.2%} of the bf16 peak; peak memory {peak_gb:.2f} GB; launches in "
          f"{TRAIN_STEPS} steps {launches} on {smi}", flush=True)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"train-step losses not finite and falling: {losses}")
    # every launch of the step runs a tensor-core kernel
    want = {"flash_fwd": cfg.n_layers, "flash_fwd_scalar": 0, "flash_bwd_dq": cfg.n_layers,
            "flash_bwd_dkv": cfg.n_layers, "flash_bwd_dq_scalar": 0, "flash_bwd_dkv_scalar": 0}
    if {n: c / TRAIN_STEPS for n, c in launches.items()} != want:
        fail(f"launches per step {launches} over {TRAIN_STEPS} steps, want {want} per step")

    syncs = count_sync_warnings(lambda: step(params, state, batch))
    print(f"  host syncs inside one step (sync debug mode): {syncs} (target 0)", flush=True)

    attention.reset_launch_counts()
    step_none, _ = make_train_step(TransformerConfig(**{**cfg.__dict__, "remat_policy": ""}), opt)
    step_none(params, state, batch)
    torch.cuda.synchronize()
    if attention.launch_counts["flash_fwd"] != 2 * cfg.n_layers or attention.launch_counts["flash_fwd_scalar"]:
        fail(f"remat_policy '' launched {dict(attention.launch_counts)} in one step, want "
             f"flash_fwd {2 * cfg.n_layers} and flash_fwd_scalar 0")
    print(f"  one step with remat_policy '': launches {dict(attention.launch_counts)}", flush=True)

    with torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA,
    ]) as prof:
        step(params, state, batch)
        torch.cuda.synchronize()
    print(f"  one step, device time: {device_split(prof, step_ms)}", flush=True)
    # every step above updated params and state in place (AdamW's count
    # says how many)
    run = {"cfg": cfg, "step": step, "opt": opt, "batch": batch, "params": params, "state": state}
    return launches, launched, run


def _get(host, port, route, timeout=600):
    with urllib.request.urlopen(f"http://{host}:{port}{route}", timeout=timeout) as resp:
        return json.loads(resp.read())


def _launches_since(attention, before):
    return {n: c - before[n] for n, c in attention.launch_counts.items()}


def _compute_apps():
    """How many processes hold a CUDA context on the card, as nvidia-smi
    lists them (None where it lists none, as in a PID namespace that hides
    even this process)."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout
    n = len([line for line in out.splitlines() if line.strip()])
    return n or None


def sidecar_probe(smi):
    """`python -m odh_kubeflow_tpu_torch.probe` as a sidecar beside this
    process: its routes answer over HTTP, it exits on SIGTERM, and reading
    the card's counter creates no CUDA context in it."""
    import signal
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    apps_before = _compute_apps()
    env = {**os.environ, "NB_PROBE_PORT": str(port), "NB_TPU_CHIPS_EXPECTED": "1"}
    proc = subprocess.Popen([sys.executable, "-m", "odh_kubeflow_tpu_torch.probe"], env=env,
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 120
        while True:
            try:
                ready = _get("127.0.0.1", port, "/tpu/readiness", timeout=10)
                break
            except OSError:
                if proc.poll() is not None or time.monotonic() > deadline:
                    fail(f"the probe sidecar did not answer: rc {proc.poll()}, {proc.stderr.read()[-2000:]}")
                time.sleep(0.2)
        util = _get("127.0.0.1", port, "/tpu/utilization", timeout=60)
        apps_during = _compute_apps()
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
            rc = None
    print(f"  sidecar (python -m odh_kubeflow_tpu_torch.probe): readiness {ready}; utilization "
          f"{util}; exit on SIGTERM rc {rc}; compute apps on the card {apps_before} before, "
          f"{apps_during} with the sidecar up, on {smi}", flush=True)
    if not (ready["chips_visible"] == 1 and ready["ready"]) or util["warming"] is not True or rc != 0:
        fail("the probe sidecar's readiness, utilization or exit is wrong")
    if apps_before is not None and apps_during != apps_before:
        fail("the probe sidecar created a CUDA context on the card")
    if apps_before is None:
        print("  nvidia-smi lists no compute apps here: the sidecar's context is not observable",
              flush=True)


def checkpoint_phase(attention, smi, serve_cfg, serve_params, run):
    """Phase 7: the probe agent over a CudaMonitor of the card, its
    utilization while busy and idle, checkpoint and restore through its
    routes, the exact resume of the train step, and an endpoint served from
    a checkpoint. Returns the path's launch counts."""
    import tempfile

    sidecar_probe(smi)
    attention.reset_launch_counts()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        _checkpoint_round_trip(attention, smi, run, f"{tmp}/train")
        _serve_from_checkpoint(attention, serve_cfg, serve_params, f"{tmp}/serve")
    return dict(attention.launch_counts)


def _checkpoint_round_trip(attention, smi, run, train_dir):
    """Phase 7's agent: readiness, utilization busy and idle, then
    checkpoint, restore and the exact resume of the train step."""
    from odh_kubeflow_tpu_torch import telemetry
    from odh_kubeflow_tpu_torch.models import (
        init_params, make_checkpoint_hook, make_restore_hook, restore_train_state, state_checksum)
    from odh_kubeflow_tpu_torch.models.tree import tree_map
    from odh_kubeflow_tpu_torch.probe import CudaMonitor, NotebookAgent, NvidiaSmiUtilization

    cfg, step, batch = run["cfg"], run["step"], run["batch"]
    live = {"state": {"params": run["params"], "opt_state": run["state"]}}

    window_s, period_s = 3.0, 0.25
    counter = NvidiaSmiUtilization(ttl_s=0.5)
    mon = CudaMonitor(chips_expected=1, window_s=window_s, sample_period_s=period_s,
                      metrics_port=0, utilization_reader=counter)
    agent = NotebookAgent(mon, checkpoint_hook=make_checkpoint_hook(
        train_dir, lambda: (int(live["state"]["opt_state"]["count"]), live["state"])))
    agent.restore_hook = make_restore_hook(train_dir, lambda: live["state"])
    host, port, close = agent.serve()
    try:
        ready = _get(host, port, "/tpu/readiness")
        print(f"  agent on port {port}: readiness {ready}", flush=True)
        if not (ready["chips_visible"] == 1 and ready["ready"] is True
                and ready["device_health"] == [{"id": 0, "healthy": True}]):
            fail(f"readiness {ready}, want 1 chip visible, ready, device 0 healthy")

        # busy: train steps for about one window
        t0 = time.perf_counter()
        busy_steps = 0
        while time.perf_counter() - t0 < window_s:
            state = live["state"]
            step(state["params"], state["opt_state"], batch)
            busy_steps += 1
        torch.cuda.synchronize()
        busy = _get(host, port, "/tpu/utilization")
        print(f"  busy ({busy_steps} train steps in {time.perf_counter() - t0:.2f} s): "
              f"/tpu/utilization {busy}; "
              f"sources: nvidia-smi counter {counter()}, allocator sampler "
              f"{mon.window_duty_cycle():.3f}, best {mon.duty_cycle():.3f}; "
              f"tpu_device_memory_bytes {telemetry.snapshot()['tpu_device_memory_bytes']} on {smi}",
              flush=True)
        if not busy["duty_cycle"] > 0 or not mon.window_duty_cycle() > 0 or counter() is None:
            fail("the agent read the busy card as idle, or the card's counter read nothing")
        # idle for more than one window (and the counter's cache)
        time.sleep(window_s + 2.0)
        before_get = counter()
        idle = _get(host, port, "/tpu/utilization")
        after_get = counter()
        print(f"  idle ({window_s + 2.0:.1f} s): /tpu/utilization {idle}; sources: nvidia-smi counter "
              f"{before_get} / {after_get}, allocator sampler {mon.window_duty_cycle():.3f}", flush=True)
        if (mon.window_duty_cycle() != 0.0 or idle["warming"]
                or idle["duty_cycle"] not in (before_get or 0.0, after_get or 0.0)):
            fail("the window did not drain to the card counter's idle reading, or still warming")

        # checkpoint through the route
        want = state_checksum(live["state"])
        t0 = time.perf_counter()
        saved = _get(host, port, "/tpu/checkpoint")
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        digest = state_checksum(live["state"])
        digest_s = time.perf_counter() - t0
        step_no = int(live["state"]["opt_state"]["count"])
        nbytes = sum(os.path.getsize(os.path.join(root, f)) for root, _, files in os.walk(train_dir)
                     for f in files)
        print(f"  /tpu/checkpoint {saved}: {save_s:.3f} s (save and digest; the digest alone "
              f"{digest_s:.3f} s), {nbytes / 1e9:.3f} GB written, "
              f"{nbytes / 1e9 / (save_s - digest_s):.3f} GB/s without the digest, on {smi}", flush=True)
        if saved != {"saved": True, "step": step_no, "checksum": want} or digest != want:
            fail(f"checkpoint ack {saved}, want step {step_no} and checksum {want}")

        # the run that is never interrupted: the same step twice from one state
        # (deterministic on the card), then the reference step
        saved_state = live["state"]
        twin = tree_map(torch.clone, saved_state)
        _, _, loss_twin = step(twin["params"], twin["opt_state"], batch)
        twin_digest = state_checksum(twin["params"])
        del twin
        _, _, loss_ref = step(saved_state["params"], saved_state["opt_state"], batch)
        ref_digest = state_checksum(saved_state["params"])
        print(f"  one step twice from the saved state: loss {loss_twin.item():.6f} / "
              f"{loss_ref.item():.6f}, params {twin_digest} / {ref_digest}", flush=True)
        if loss_twin.item() != loss_ref.item() or twin_digest != ref_digest:
            fail("the train step is not deterministic on the card (PERF.md section 7)")

        # restore: the params re-initialised from another seed, then the route
        fresh = init_params(torch.Generator().manual_seed(7), cfg, device="cuda")
        live["state"] = {"params": fresh, "opt_state": run["opt"].init(fresh)}
        t0 = time.perf_counter()
        restored_ack = _get(host, port, "/tpu/restore")
        restore_route_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        restored = restore_train_state(train_dir, live["state"])
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        print(f"  /tpu/restore {restored_ack}: {restore_route_s:.3f} s (restore and digest); "
              f"restore_train_state alone {restore_s:.3f} s, "
              f"{nbytes / 1e9 / restore_s:.3f} GB/s, on {smi}", flush=True)
        if restored_ack != {"restored": True, "step": step_no, "checksum": want, "reason": None}:
            fail(f"restore ack {restored_ack}, want step {step_no} and checksum {want}")
        if restored["params"]["embed"].device.type != "cuda":
            fail("the restored state is not on the card")

        # resume: one step from the restored state equals the uninterrupted one
        before = dict(attention.launch_counts)
        _, _, loss_res = step(restored["params"], restored["opt_state"], batch)
        torch.cuda.synchronize()
        resumed = _launches_since(attention, before)
        res_digest = state_checksum(restored["params"])
        print(f"  resumed step: loss {loss_res.item():.6f} (uninterrupted {loss_ref.item():.6f}), "
              f"params {res_digest} (uninterrupted {ref_digest}); launches {resumed}", flush=True)
        if loss_res.item() != loss_ref.item() or res_digest != ref_digest:
            fail("the resumed step differs from the uninterrupted run")
        want_launches = {"flash_fwd": cfg.n_layers, "flash_fwd_scalar": 0, "flash_bwd_dq": cfg.n_layers,
                         "flash_bwd_dkv": cfg.n_layers, "flash_bwd_dq_scalar": 0, "flash_bwd_dkv_scalar": 0}
        if resumed != want_launches:
            fail(f"the resumed step launched {resumed}, want {want_launches}")
    finally:
        close()


def _serve_from_checkpoint(attention, serve_cfg, serve_params, serve_dir):
    """Phase 7's endpoint: the bf16 serving model saved, then restored by
    build_engine_from_env from SERVING_CHECKPOINT, against an engine on the
    original params."""
    import dataclasses

    from odh_kubeflow_tpu_torch import telemetry
    from odh_kubeflow_tpu_torch.models import logit_fingerprint, save_train_state
    from odh_kubeflow_tpu_torch.serving.engine import ServingEngine
    from odh_kubeflow_tpu_torch.serving.server import build_engine_from_env

    save_train_state(serve_dir, 1, {"params": serve_params})
    fields = {f.name: getattr(serve_cfg, f.name) for f in dataclasses.fields(serve_cfg)}
    fields["dtype"] = "bfloat16"
    env = {"SERVING_CHECKPOINT": serve_dir, "SERVING_MODEL_CONFIG": json.dumps(fields),
           "SERVING_MAX_SLOTS": "8", "SERVING_MAX_SEQ": "512", "SERVING_DECODE_BURST": "8"}
    t0 = time.perf_counter()
    endpoint = build_engine_from_env(env)
    build_s = time.perf_counter() - t0
    prompt = list(range(1, 129))
    before = dict(attention.launch_counts)
    fp_saved = logit_fingerprint(serve_params, serve_cfg, prompt)
    fp_restored = logit_fingerprint(endpoint.params, endpoint.cfg, prompt)
    fp_launches = _launches_since(attention, before)["flash_fwd"]
    print(f"  endpoint from SERVING_CHECKPOINT in {build_s:.3f} s: logit fingerprint {fp_restored} "
          f"(saved params {fp_saved}); forward launches {fp_launches}", flush=True)
    if fp_restored != fp_saved or endpoint.cfg != serve_cfg or fp_launches != 2 * serve_cfg.n_layers:
        fail("the restored endpoint's model differs from the saved one")
    original = ServingEngine(serve_params, serve_cfg, max_slots=8, max_seq=512, decode_burst=8,
                             device="cuda")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, serve_cfg.vocab, 128).tolist() for _ in range(4)]
    tokens = []
    for eng in (original, endpoint):
        bursts_before = telemetry.snapshot()["tpu_decode_step_duration_seconds"]["count"]
        before = dict(attention.launch_counts)
        handles = [eng.submit(p, max_new=24) for p in prompts]
        if not eng.run_until_idle(timeout=300):
            fail("an engine did not finish phase 7's requests")
        launched = _launches_since(attention, before)
        observed = telemetry.snapshot()["tpu_decode_step_duration_seconds"]["count"] - bursts_before
        bursts = eng.stats()["decode_steps"] // eng.decode_burst
        tokens.append([h.tokens for h in handles])
        if any(h.result != "ok" for h in handles):
            fail(f"phase 7's requests: {[h.result for h in handles]}")
        if launched["flash_fwd"] != serve_cfg.n_layers * len(prompts) or launched["flash_fwd_scalar"]:
            fail(f"forward launches {launched} for {len(prompts)} requests, want "
                 f"flash_fwd {serve_cfg.n_layers * len(prompts)} and no scalar one")
        if observed != bursts:
            fail(f"tpu_decode_step_duration_seconds observed {observed} times in {bursts} bursts")
    print(f"  4 greedy requests: the restored endpoint's tokens equal the original engine's: "
          f"{tokens[0] == tokens[1]}; launches {launched}; decode-step telemetry {observed} "
          f"observations for {bursts} bursts", flush=True)
    if tokens[0] != tokens[1]:
        fail("the restored endpoint's tokens differ from the original engine's")


def warm_engine(engine):
    """One request through a new engine: first-use allocations and handles."""
    warm = engine.submit(list(range(1, 129)), max_new=9)
    if not engine.run_until_idle(timeout=300) or warm.result != "ok":
        fail("warm-up request did not complete")
    return engine


def serve_over_http(engine, prompts, attention):
    """A ServingHTTPServer in front of the engine, started; every prompt
    POSTed to /generate at once from its own thread (max_new from
    MAX_NEWS), launch counts zeroed just before and read just after; then
    the server and the engine stopped. Fails unless every reply is 200 with
    max_new in-vocab tokens and the last burst made one host sync. Returns
    the replies {i: (status, body)} and the launches."""
    from odh_kubeflow_tpu_torch.serving.server import ServingHTTPServer

    server = ServingHTTPServer(engine, host="127.0.0.1", port=0)
    host, port = server.start()
    engine.start()
    replies = {}

    def post(i):
        body = json.dumps({"prompt": prompts[i], "max_new": MAX_NEWS[i]}).encode()
        req = urllib.request.Request(f"http://{host}:{port}/generate", data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as resp:
            replies[i] = (resp.status, json.loads(resp.read()))

    attention.reset_launch_counts()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=post, args=(i,)) for i in range(len(prompts))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    wall = time.perf_counter() - t0
    launches = dict(attention.launch_counts)
    stats = engine.stats()
    server.stop()
    if any(th.is_alive() for th in threads) or len(replies) != len(prompts):
        fail(f"only {len(replies)} of {len(prompts)} requests came back")
    n_tokens = 0
    for i, (status, body) in sorted(replies.items()):
        toks = body.get("tokens", [])
        if status != 200 or len(toks) != MAX_NEWS[i] or not all(0 <= t < engine.cfg.vocab for t in toks):
            fail(f"request {i}: status {status}, {len(toks)} tokens, want {MAX_NEWS[i]} in range")
        n_tokens += len(toks)
    ttfts = sorted(body["ttft_s"] for _, body in replies.values())
    print(f"  {len(replies)} requests, {n_tokens} tokens in {wall:.3f} s: "
          f"{n_tokens / wall:.1f} tokens/s over HTTP; TTFT median "
          f"{statistics.median(ttfts) * 1e3:.2f} ms, max {ttfts[-1] * 1e3:.2f} ms; "
          f"host_syncs_last_burst {stats['host_syncs_last_burst']}; launches {launches}",
          flush=True)
    if stats["host_syncs_last_burst"] != 1:
        fail(f"host_syncs_last_burst {stats['host_syncs_last_burst']}, want 1")
    return replies, launches


def burst_split(engine, prompts):
    """Where the serving time goes: one step that admits every prompt (one
    prefill each) and runs a burst, then a burst alone; host clock around
    each (a step ends in the engine's host copy), then the same two steps
    again under torch.profiler for the device time by kernel."""
    walls = {}
    for profiled in (False, True):
        for p in prompts:
            engine.submit(p, max_new=1 + 2 * engine.decode_burst)
        for label in (f"admit {len(prompts)} + burst", "burst alone"):
            if profiled:
                with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA,
                ]) as prof:
                    engine.step()
                print(f"  {label}, device time: {device_split(prof, walls[label])}")
            else:
                t0 = time.perf_counter()
                engine.step()
                walls[label] = (time.perf_counter() - t0) * 1e3
                print(f"  {label}: {walls[label]:.2f} ms host clock; "
                      f"{walls[label] / engine.decode_burst:.3f} ms per burst step")
        if not engine.idle():
            fail("two steps did not finish requests of 1 + 2 bursts")


def _bits(t):
    """The tensor's raw bits, for bit-equality (-0.0 and NaN included)."""
    return t.view({torch.float32: torch.int32, torch.bfloat16: torch.int16}.get(t.dtype, t.dtype))


def moe_phase(attention, peaks, smi):
    """Phase 8: the MoE configuration of bench.py:389-400 on the card: a
    2-layer f32 gradient check, the full-width model served over HTTP, a
    small f32 engine held to generate()'s tokens, then trained. Returns the
    launches of each path."""
    from dataclasses import replace

    from odh_kubeflow_tpu_torch.models import (MoEConfig, TransformerConfig, dispatch_only, generate,
                                               init_params, loss_fn, make_train_step, routing_stats)
    from odh_kubeflow_tpu_torch.models import transformer
    from odh_kubeflow_tpu_torch.models.tree import tree_leaves, tree_map
    from odh_kubeflow_tpu_torch.serving.engine import ServingEngine

    t_phase = time.perf_counter()
    moe = MoEConfig(n_experts=8, experts_per_token=2, capacity_factor=1.25)
    full = dict(vocab=32768, d_model=1024, n_heads=8, d_ff=2048, max_seq=2048)
    paths = {}

    # gradient check: 2 layers in f32 at capacity factor E/k (capacity = the
    # token count: no drops, so rounding cannot move a token off an expert's
    # buffer), remat "" (the backward routes again), loss and gradients
    # through the scalar kernels against autograd through mha_reference
    cfg32 = TransformerConfig(**full, n_layers=2, dtype=torch.float32, use_flash=True, remat=True,
                              remat_policy="", moe=replace(moe, capacity_factor=8 / 2))
    params = init_params(torch.Generator().manual_seed(3), cfg32, device="cuda")
    tokens = torch.as_tensor(np.random.default_rng(4).integers(0, cfg32.vocab, (1, 512)), device="cuda")
    results = []
    for cfg in (cfg32, replace(cfg32, use_flash=False, remat=False)):
        live = tree_map(lambda t: t.detach().requires_grad_(), params)
        attention.reset_launch_counts()
        loss = loss_fn(live, {"tokens": tokens}, cfg)
        grads = torch.autograd.grad(loss, tree_leaves(live))
        results.append((loss.detach(), grads, dict(attention.launch_counts)))
    (loss_k, grads_k, launched), (loss_r, grads_r, _) = results
    loss_err = abs((loss_k - loss_r) / loss_r).item()
    grad_err = max(_grad_err(g, w) for g, w in zip(grads_k, grads_r))
    print(f"  gradient check (2 MoE layers f32, 1x512, capacity factor 4): loss {loss_k.item():.6f} "
          f"vs reference {loss_r.item():.6f} (rel err {loss_err:.3e}), grads max rel err "
          f"{grad_err:.3e} (tol 1e-4); kernel launches {launched}", flush=True)
    if not (loss_err <= 1e-4 and grad_err <= 1e-4):
        fail("MoE loss or gradients through the kernels disagree with the reference attention")
    want = {"flash_fwd": 0, "flash_fwd_scalar": 2 * cfg32.n_layers, "flash_bwd_dq": 0,
            "flash_bwd_dkv": 0, "flash_bwd_dq_scalar": cfg32.n_layers,
            "flash_bwd_dkv_scalar": cfg32.n_layers}
    if launched != want:
        fail(f"the MoE gradient check launched {launched}, want {want}")
    paths["moe f32 gradient check"] = launched
    del params, grads_k, grads_r, results

    # the full-width model: served, then trained
    cfg = TransformerConfig(**full, n_layers=8, dtype=torch.bfloat16, use_flash=True, remat=True,
                            remat_policy="", moe=moe)
    t0 = time.perf_counter()
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cuda")
    n_params = sum(t.numel() for t in tree_leaves(params))
    expert = sum(params["layers"][n].numel() for n in ("we_gate", "we_up", "we_out"))
    n_active = n_params - expert + expert * moe.experts_per_token // moe.n_experts
    print(f"  init {n_params / 1e6:.1f}M params ({n_active / 1e6:.1f}M active) in "
          f"{time.perf_counter() - t0:.1f} s; router {params['layers']['router'].dtype}", flush=True)

    engine = warm_engine(ServingEngine(params, cfg, max_slots=8, max_seq=512, decode_burst=8,
                                       check_syncs=True, device="cuda"))
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, cfg.vocab, 128).tolist() for _ in MAX_NEWS]
    replies, launches = serve_over_http(engine, prompts, attention)
    want = cfg.n_layers * len(prompts)
    if launches["flash_fwd"] != want or launches["flash_fwd_scalar"]:
        fail(f"forward launches on the MoE serving path {launches}, want flash_fwd {want} "
             "and flash_fwd_scalar 0")
    paths["moe serve"] = launches
    # the engine's first token comes from a batch-1 prefill, as generate()'s
    first = [generate(params, [p], cfg, 1, max_seq=512, device="cuda")[0, 0].item() for p in prompts]
    first_same = sum(replies[i][1]["tokens"][0] == f for i, f in enumerate(first))
    print(f"  first tokens equal generate()'s: {first_same}/{len(prompts)}", flush=True)
    if first_same != len(prompts):
        fail("the MoE engine's first tokens (prefill logits) differ from generate()'s")
    burst_split(engine, prompts)
    # the decode drop rate: each MoE layer's input rows of one burst (8
    # slots, capacity 2 per expert), routed again by routing_stats
    seen, moe_ffn = [], transformer.moe_ffn

    def recording(x, p, c, *args):
        seen.append(x.detach().clone())
        return moe_ffn(x, p, c, *args)

    transformer.moe_ffn = recording
    try:
        for p in prompts:
            engine.submit(p, max_new=1 + engine.decode_burst)
        engine.step()
    finally:
        transformer.moe_ffn = moe_ffn
    if not engine.idle():
        fail("one step did not finish requests of 1 + 1 burst")
    decode_in = [x for x in seen if tuple(x.shape[:2]) == (engine.max_slots, 1)]
    drops = [routing_stats(x, transformer.layer_view(params, i % cfg.n_layers), cfg.moe_resolved)
             for i, x in enumerate(decode_in)]
    decode_drop = torch.stack([d["drop_rate"] for d in drops]).mean().item()
    print(f"  decode drop rate over one burst ({len(decode_in)} layer calls of {engine.max_slots} "
          f"rows, capacity {drops[0]['capacity']} per expert): {decode_drop:.4f}", flush=True)
    if len(decode_in) != engine.decode_burst * cfg.n_layers:
        fail(f"{len(decode_in)} MoE decode calls in one burst, want {engine.decode_burst * cfg.n_layers}")
    del engine

    # f32 on the card, at capacity factor E/k (capacity = the token count
    # of every call, so a batch-8 burst and a batch-1 generate() drop
    # nothing): the engine's greedy tokens equal generate()'s
    small = TransformerConfig(vocab=512, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128,
                              max_seq=512, dtype=torch.float32, use_flash=True, remat=False,
                              moe=MoEConfig(n_experts=4, experts_per_token=2, capacity_factor=4 / 2))
    small_params = init_params(torch.Generator().manual_seed(0), small, device="cuda")
    eng = ServingEngine(small_params, small, max_slots=8, max_seq=512, decode_burst=8,
                        check_syncs=True, device="cuda")
    attention.reset_launch_counts()
    handles = [eng.submit(p, max_new=24) for p in DEMO_PROMPTS]
    if not eng.run_until_idle(timeout=120) or any(h.result != "ok" for h in handles):
        fail("the small f32 MoE engine did not finish")
    small_launches = dict(attention.launch_counts)
    same = sum(h.tokens == generate(small_params, [p], small, 24, max_seq=512, device="cuda")[0].tolist()
               for h, p in zip(handles, DEMO_PROMPTS))
    print(f"  small f32 MoE model (d{small.head_dim}, capacity factor 2): engine tokens equal "
          f"generate()'s for {same}/{len(handles)} requests; launches {small_launches}", flush=True)
    if small_launches["flash_fwd_scalar"] != small.n_layers * len(DEMO_PROMPTS):
        fail(f"the small f32 MoE model's forward launches {small_launches}, want flash_fwd_scalar "
             f"{small.n_layers * len(DEMO_PROMPTS)}")
    if same != len(handles):
        fail("the small f32 MoE engine's tokens differ from generate()'s")
    paths["moe f32 serve"] = small_launches

    # the train step: bench_moe_train_step's config and batch
    b, s = TRAIN_SHAPE[:2]
    batch = {"tokens": torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab, (b, s)),
                                       device="cuda")}
    step, opt = make_train_step(cfg)
    state = opt.init(params)
    params, state, first_loss = step(params, state, batch)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = [first_loss]
    attention.reset_launch_counts()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(TRAIN_STEPS):
        params, state, loss = step(params, state, batch)
        losses.append(loss)
    end.record()
    end.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
    launches = dict(attention.launch_counts)
    step_ms = start.elapsed_time(end) / TRAIN_STEPS
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = torch.stack(losses).tolist()
    tokens_per_s = b * s / (step_ms * 1e-3)
    flops_per_token = 6 * n_active + 12 * cfg.n_layers * cfg.d_model * s  # bench.py's count
    mfu = flops_per_token * tokens_per_s / peaks[0]
    print(f"  {n_params / 1e6:.1f}M params ({n_active / 1e6:.1f}M active), batch {b}x{s}, remat_policy "
          f"'': losses {', '.join(f'{x:.4f}' for x in losses)} (warm-up first)", flush=True)
    print(f"  {step_ms:.2f} ms per step (CUDA events; host clock {host_ms:.2f} ms), "
          f"{tokens_per_s:.0f} tokens/s, active model FLOPs {flops_per_token * b * s / 1e12:.2f} TFLOP "
          f"per step = {mfu:.2%} of the bf16 peak; peak memory {peak_gb:.2f} GB; launches in "
          f"{TRAIN_STEPS} steps {launches} on {smi}", flush=True)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"MoE train-step losses not finite and falling: {losses}")
    want = {"flash_fwd": 2 * cfg.n_layers, "flash_fwd_scalar": 0, "flash_bwd_dq": cfg.n_layers,
            "flash_bwd_dkv": cfg.n_layers, "flash_bwd_dq_scalar": 0, "flash_bwd_dkv_scalar": 0}
    if {n: c / TRAIN_STEPS for n, c in launches.items()} != want:
        fail(f"MoE launches per step {launches} over {TRAIN_STEPS} steps, want {want} per step")
    paths["moe train"] = launches

    syncs = count_sync_warnings(lambda: step(params, state, batch))
    print(f"  host syncs inside one MoE step (sync debug mode): {syncs} (target 0)", flush=True)
    if syncs:
        fail(f"the MoE train step synced with the host {syncs} times")

    # the same step twice from one state: bit-equal loss, params and
    # optimizer state
    snapshot = tree_map(torch.clone, {"params": params, "state": state})
    runs = []
    for _ in range(2):
        run = tree_map(torch.clone, snapshot)
        _, _, loss = step(run["params"], run["state"], batch)
        runs.append((loss, run))
    (loss_a, run_a), (loss_b, run_b) = runs
    equal = torch.equal(_bits(loss_a), _bits(loss_b)) and all(
        torch.equal(_bits(x), _bits(y)) for x, y in zip(tree_leaves(run_a), tree_leaves(run_b)))
    print(f"  the same MoE step twice from one state: loss {loss_a.item():.6f} and "
          f"{loss_b.item():.6f}; params and optimizer state bit-equal: {equal}", flush=True)
    if not equal:
        fail("the MoE train step is not deterministic on the card")
    del snapshot, runs, run_a, run_b

    with torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA,
    ]) as prof:
        step(params, state, batch)
        torch.cuda.synchronize()
    print(f"  one MoE step, device time: {device_split(prof, step_ms)}", flush=True)

    # the dispatch share (bench.py:441-455): routing, dispatch and combine
    # alone at the step's token count, on layer 0's input, times 3 (forward
    # and about twice that backward) per layer, over the step
    x_tokens = params["embed"][batch["tokens"]]
    layer0 = transformer.layer_view(params, 0)
    t_disp = time_ms(lambda: dispatch_only(x_tokens, layer0, cfg.moe_resolved), runs=10, reps=5)
    stats = routing_stats(x_tokens, layer0, cfg.moe_resolved)
    print(f"  dispatch_only at {b * s} tokens: {t_disp:.4f} ms (CUDA graph); dispatch share "
          f"3 x {cfg.n_layers} x {t_disp:.4f} / {step_ms:.2f} ms = "
          f"{3 * cfg.n_layers * t_disp / step_ms:.2%}; drop rate at layer 0's inputs "
          f"{stats['drop_rate'].item():.4f} (capacity {stats['capacity']}); phase 8 took "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return paths


def _clients(jobs, send):
    """One thread per client, each sending its jobs in turn; returns the
    threads (started) and the list their failures land in."""
    errors = []

    def client(batch):
        try:
            for job in batch:
                send(*job)
        except BaseException as e:  # reported by _join_clients, which fails the phase
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(batch,)) for batch in jobs]
    for th in threads:
        th.start()
    return threads, errors


def _join_clients(threads, errors, what):
    for th in threads:
        th.join(timeout=600)
    if errors or any(th.is_alive() for th in threads):
        fail(f"{what}: {errors or 'a client did not finish'}")


def _wait_until(cond, what, timeout=300):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            fail(f"timed out waiting for {what}")
        time.sleep(0.001)


def where_time_went(burst, label):
    """Prints each phase's self time as a share of serving.decode_burst's
    total (the profiler's snapshot of the region); returns the phases and
    their coverage of the region."""
    phases = burst["phases"]
    covered = sum(p["self_s"] for p in phases.values()) / burst["total_s"]
    print(f"  where_time_went, {label}, serving.decode_burst ({burst['count']} steps, "
          f"{burst['total_s']:.4f} s, host clock): " + ", ".join(
              f"{name} {phases[name]['self_s'] / burst['total_s']:.2%}"
              for name in ("admit", "prefill", "scan", "batched_drain", "emit") if name in phases)
          + f"; phases cover {covered:.4f} of it", flush=True)
    return phases, covered


def router_phase(attention, smi, cfg, params):
    """Phase 9: two replicas of the flagship serving model behind the port's
    TokenRouter in this process, with PROFILE=1 and TORCHGUARD=1. Routed
    requests with their own traceparents, a drain of replica 1 mid-run and
    a hedge; then the profile, the guard's counts, the router's added
    latency and a burst's host time with the profiler and guard on and off.
    Returns the forward launches of its main path (the routed, drained and
    hedged requests), counted from 0 just before it."""
    from odh_kubeflow_tpu_torch.models import generate
    from odh_kubeflow_tpu_torch.serving import metrics as serving_metrics
    from odh_kubeflow_tpu_torch.serving.engine import ServingEngine
    from odh_kubeflow_tpu_torch.serving.router import TokenRouter
    from odh_kubeflow_tpu_torch.utils import profiler, torchguard, tracing

    t_phase = time.perf_counter()
    os.environ["PROFILE"] = "1"
    os.environ["TORCHGUARD"] = "1"
    engines = [warm_engine(ServingEngine(params, cfg, max_slots=8, max_seq=512, decode_burst=8,
                                         device="cuda")) for _ in range(2)]
    for eng in engines:
        eng.start()
    router = TokenRouter(endpoint="smoke/flagship")
    for i, eng in enumerate(engines):
        router.add_replica(i, eng)
    rng = np.random.default_rng(9)

    def prompt():
        return rng.integers(0, cfg.vocab, 128).tolist()

    results = {}

    def send(key, prompt_, max_new, via=router):
        trace_id, caller = tracing.new_trace_id(), tracing.new_span_id()
        res = via.generate(prompt_, max_new, traceparent=tracing.format_traceparent(trace_id, caller),
                           wait_timeout_s=300)
        results[key] = (trace_id, caller, max_new, res)

    requests_total = serving_metrics.inference_requests_total
    retries = serving_metrics.inference_router_retries_total
    counts0 = {r: requests_total.value(result=r) for r in ("ok", "canceled", "error")}
    retries0 = sum(retries.value(reason=r) for r in ("queue_full", "error", "canceled"))
    profiler.reset()
    tracing.clear()
    attention.reset_launch_counts()

    # routing and traces: 8 clients, 2 requests each
    jobs = [[(f"route {c}.{j}", prompt(), MAX_NEWS[(2 * c + j) % len(MAX_NEWS)]) for j in range(2)]
            for c in range(8)]
    t0 = time.perf_counter()
    _join_clients(*_clients(jobs, send), "routed requests")
    wall = time.perf_counter() - t0
    routed = [key for batch in jobs for key, _, _ in batch]
    n_tokens = 0
    for key in routed:
        trace_id, caller, max_new, res = results[key]
        toks = res.handle.tokens
        if res.handle.result != "ok" or len(toks) != max_new or not all(0 <= t < cfg.vocab for t in toks):
            fail(f"{key}: {res.handle.result}, {len(toks)} tokens, want {max_new} in range")
        n_tokens += len(toks)
        spans = tracing.global_buffer.spans(trace_id=trace_id)
        envelope = [s for s in spans if s.name == "router.request"]
        counted = [s for s in spans if s.name == "inference.request" and not s.attributes["superseded"]]
        picks = [s for s in spans if s.name == "router.pick"]
        if (len(envelope) != 1 or envelope[0].parent_id != caller or len(counted) != 1 or not picks
                or {s.parent_id for s in counted + picks} != {envelope[0].span_id}):
            fail(f"{key}: trace {trace_id} is not one tree: {[(s.name, s.parent_id) for s in spans]}")
    by_replica = [sum(results[k][3].replica == i for k in routed) for i in (0, 1)]
    ttfts = sorted(results[k][3].handle.ttft_s for k in routed)
    print(f"  {len(routed)} routed requests from 8 clients, {n_tokens} tokens in {wall:.3f} s: "
          f"{n_tokens / wall:.1f} tokens/s; replicas {by_replica}; TTFT median "
          f"{statistics.median(ttfts) * 1e3:.2f} ms, min {ttfts[0] * 1e3:.2f} ms, max "
          f"{ttfts[-1] * 1e3:.2f} ms; each request one trace (router.request, router.pick, one "
          f"counted inference.request) on {smi}", flush=True)

    # a drain of replica 1 mid-run: every early request picked and on its
    # replica, replica 1 busy, then the drain, then the late requests
    early = [[(f"drain early {c}", prompt(), 64)] for c in range(8)]
    late = [[(f"drain late {c}", prompt(), 16)] for c in range(4)]

    def n_picks(replica=None):
        return sum(replica is None or s.attributes["replica"] == replica
                   for s in tracing.global_buffer.spans(name="router.pick"))

    picks_before = n_picks()
    early_run = _clients(early, send)
    _wait_until(lambda: n_picks() >= picks_before + len(early), "the early requests' picks")
    _wait_until(lambda: engines[1].stats()["active_slots"] + engines[1].stats()["queued"] > 0,
                "replica 1 to hold a request", timeout=120)
    router.set_draining(1)
    drained_at = n_picks(1)
    _join_clients(*_clients(late, send), "requests after the drain")
    _join_clients(*early_run, "requests in flight at the drain")
    early_keys = [b[0][0] for b in early]
    late_keys = [b[0][0] for b in late]
    on_1 = [k for k in early_keys if results[k][3].replica == 1]
    if n_picks(1) != drained_at or any(results[k][3].replica != 0 for k in late_keys):
        fail(f"replica 1 took {n_picks(1) - drained_at} picks after its drain")
    if not on_1 or any(results[k][3].handle.result != "ok" or len(results[k][3].handle.tokens) != results[k][2]
                       for k in early_keys + late_keys):
        fail(f"the drain: {len(on_1)} requests in flight on replica 1, results "
             f"{[results[k][3].handle.result for k in early_keys + late_keys]}")
    print(f"  drain: {len(on_1)} requests in flight on replica 1 finished ok; {len(late)} later requests "
          f"all on replica 0; replica 1 took no pick after the drain", flush=True)
    router.set_draining(1, False)

    # a hedge: the first token cannot come before a prefill, so a hedge
    # after HEDGE_AFTER_S always fires; the loser is canceled, superseded.
    # Replica 1 is the slow tail: all its slots hold long requests, so the
    # copy routed there waits in its queue while replica 0 serves the other.
    # (Two idle replicas race: both copies decode in step on one stream, and
    # a loser that completes before the router cancels it is a finished
    # duplicate, counted, in the reference router as here.)
    if not HEDGE_AFTER_S < ttfts[0]:
        fail(f"hedge_after_s {HEDGE_AFTER_S} is not shorter than a prefill (TTFT min {ttfts[0]})")
    backlog = [engines[1].submit(prompt(), engines[1].max_seq - 128) for _ in range(engines[1].max_slots)]
    _wait_until(lambda: engines[1].stats()["active_slots"] == engines[1].max_slots
                and not engines[1].stats()["queued"], "replica 1's slots to fill")
    hedger = TokenRouter(endpoint="smoke/flagship-hedged", hedge_after_s=HEDGE_AFTER_S)
    for i, eng in enumerate(engines):
        hedger.add_replica(i, eng)
    counts = {r: requests_total.value(result=r) for r in ("ok", "canceled")}
    send("hedge", prompt(), 64, via=hedger)
    trace_id, _, _, res = results["hedge"]
    spans = tracing.global_buffer.spans(trace_id=trace_id, name="inference.request")
    outcomes = sorted((s.attributes["result"], s.attributes["superseded"]) for s in spans)
    delta = {r: requests_total.value(result=r) - counts[r] for r in counts}
    busy = sum(not h.done.is_set() for h in backlog)
    print(f"  hedge after {HEDGE_AFTER_S * 1e3:.1f} ms, replica 1's {len(backlog)} slots busy: launched "
          f"{res.hedged}, hedge won {res.hedge_won}, replica {res.replica}; inference.request spans in "
          f"its trace {outcomes}; inference_requests_total rose {delta}; {busy} long requests still "
          "decoding", flush=True)
    if (not res.hedged or res.handle.result != "ok" or outcomes != [("canceled", True), ("ok", False)]
            or delta != {"ok": 1, "canceled": 0} or busy != len(backlog)):
        fail("the hedge loser was not canceled, superseded and left uncounted")
    for h in backlog:
        engines[1].cancel(h)

    launches = dict(attention.launch_counts)
    # the hedge loser's engine may still be in the burst it was canceled in:
    # stop both loops (stop() joins them) so no step is half recorded
    for eng in engines:
        eng.stop()
    request_spans = tracing.global_buffer.spans(name="inference.request")
    admitted = sum(s.attributes["ttft_s"] is not None for s in request_spans)
    regions = profiler.snapshot()["regions"]
    burst, prefill = regions["serving.decode_burst"], regions["serving.prefill"]
    stats = [eng.stats() for eng in engines]
    print(f"  launches {launches} for {admitted} admitted requests (replica 1's long requests included); "
          f"serving.prefill entries {prefill['count']}", flush=True)
    if launches["flash_fwd"] != cfg.n_layers * admitted or launches["flash_fwd_scalar"]:
        fail(f"forward launches {launches}, want flash_fwd {cfg.n_layers * admitted} and no scalar one")
    if prefill["count"] != admitted:
        fail(f"serving.prefill entries {prefill['count']}, admitted requests {admitted}")

    # where the time went: the five phases' self times against the region
    phases, covered = where_time_went(burst, "TORCHGUARD=1")
    if set(phases) != {"admit", "prefill", "scan", "batched_drain", "emit"} or not 0.9 <= covered <= 1.1:
        fail(f"serving.decode_burst phases {sorted(phases)} cover {covered:.4f} of the region")

    # the guard: armed all along; no engine died of a budget error
    retried = sum(retries.value(reason=r) for r in ("queue_full", "error", "canceled")) - retries0
    errors = requests_total.value(result="error") - counts0["error"]
    print(f"  guard: host_transfers_last_burst {[s['host_transfers_last_burst'] for s in stats]}, "
          f"recompiles {[(s['decode_burst_recompiles'], s['prefill_recompiles']) for s in stats]}, "
          f"router retries {retried}, error results {errors}, {torchguard.transfer_count()} copies "
          "through to_host in this process", flush=True)
    if (any(s["host_transfers_last_burst"] != 1 for s in stats) or retried or errors
            or any(s["decode_burst_recompiles"] or s["prefill_recompiles"] for s in stats)):
        fail("the guard: an engine copied more than once per burst, recompiled or failed a request")
    PHASE9_GUARD.update(
        burst_region=[eng._burst_guard._entry_transfers for eng in engines],
        prefill_region=[eng._prefill_guard._entry_transfers for eng in engines],
        drain=[st["host_transfers_last_burst"] for st in stats], admitted=admitted, errors=errors)

    # the same routed batch with the guard off: what its lock (held across
    # each burst's "error" window and each copy) costs two replicas
    os.environ["TORCHGUARD"] = "0"
    profiler.reset()
    for eng in engines:
        eng.start()
    unguarded = [[(f"unguarded {c}.{j}", prompt(), MAX_NEWS[(2 * c + j) % len(MAX_NEWS)]) for j in range(2)]
                 for c in range(8)]
    t0 = time.perf_counter()
    _join_clients(*_clients(unguarded, send), "routed requests, guard off")
    wall = time.perf_counter() - t0
    if any(results[k][3].handle.result != "ok" for batch in unguarded for k, _, _ in batch):
        fail("a routed request with the guard off did not finish ok")
    for eng in engines:
        eng.stop()
    print(f"  the same 16 routed requests with TORCHGUARD=0: {n_tokens / wall:.1f} tokens/s", flush=True)
    where_time_went(profiler.snapshot()["regions"]["serving.decode_burst"], "TORCHGUARD=0")
    os.environ["TORCHGUARD"] = "1"
    for eng in engines:
        eng.start()

    # the router's added latency (bench.py:603-660): p50 of routed minus
    # p50 of direct submits at one request shape, sequential, in turns
    shape_prompt = prompt()
    added = serving_metrics.inference_router_added_latency_seconds
    added0 = added.snapshot()
    direct, routed_t = [], []
    for _ in range(ADDED_LATENCY_REQUESTS):
        t0 = time.perf_counter()
        handle = engines[0].submit(shape_prompt, 8)
        if not handle.wait(300) or handle.result != "ok":
            fail("a direct request did not finish")
        direct.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        if router.generate(shape_prompt, 8, wait_timeout_s=300).handle.result != "ok":
            fail("a routed request did not finish")
        routed_t.append(time.perf_counter() - t0)
    added_ms = (statistics.median(routed_t) - statistics.median(direct)) * 1e3
    # the router's own measure of the same thing: generate() entry to the
    # accepted engine submit, summed in its histogram
    own = added.snapshot()
    own_ms = (own["sum"] - added0["sum"]) / (own["count"] - added0["count"]) * 1e3
    print(f"  router added latency p50 {added_ms:.3f} ms (routed {statistics.median(routed_t) * 1e3:.3f} ms, "
          f"direct {statistics.median(direct) * 1e3:.3f} ms; {ADDED_LATENCY_REQUESTS} each, prompt 128, "
          f"max_new 8, PROFILE=1 TORCHGUARD=1); the router's histogram, generate() entry to engine "
          f"submit: mean {own_ms:.4f} ms over {own['count'] - added0['count']} on {smi}", flush=True)

    # route first, then stop
    for i in (0, 1):
        router.remove_replica(i)
        hedger.remove_replica(i)
    for eng in engines:
        eng.stop()

    # a burst's host time, 8 active slots, the profiler and guard off / on,
    # in turns on one engine
    modes = (("off", "0", "0"), ("PROFILE", "1", "0"), ("PROFILE+TORCHGUARD", "1", "1"))
    eng = engines[0]
    for _ in range(8):
        eng.submit(prompt(), 1 + 8 * (3 * BURST_TIMING_ROUNDS + 1))
    eng.step()
    burst_ms = {name: [] for name, _, _ in modes}
    for _ in range(BURST_TIMING_ROUNDS):
        for name, prof, guard in modes:
            os.environ["PROFILE"], os.environ["TORCHGUARD"] = prof, guard
            t0 = time.perf_counter()
            eng.step()
            burst_ms[name].append((time.perf_counter() - t0) * 1e3)
    os.environ["PROFILE"] = os.environ["TORCHGUARD"] = "1"
    if not eng.run_until_idle(timeout=300):
        fail("the timing requests did not finish")
    print("  burst step, 8 slots, host clock, median of " f"{BURST_TIMING_ROUNDS}: " + ", ".join(
        f"{name} {statistics.median(ms):.3f} ms" for name, ms in burst_ms.items()) + f" on {smi}", flush=True)

    # generate() in its models.generate region, armed: no copy, no hidden sync
    before = torchguard.transfer_count()
    out = generate(params, [prompt()], cfg, 16, max_seq=512, device="cuda")
    if tuple(out.shape) != (1, 16) or torchguard.transfer_count() != before:
        fail("generate() under the armed guard copied to the host")
    if profiler.snapshot(region="models.generate")["regions"]["models.generate"]["count"] != 1:
        fail("generate() did not run in its models.generate region")
    del os.environ["PROFILE"], os.environ["TORCHGUARD"]
    print(f"  generate() armed: no copy, no hidden sync; phase 9 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return launches


# ---------------------------------------------------------------------------
# Phase 10: sequence parallelism, ranks spawned on this one card
# ---------------------------------------------------------------------------

SP_WORLDS = (2, 4)
RANK_POOL_WORLD = 4  # the ranks phases 10-13 share: max(SP_WORLDS), SHARD_WORLD, EP_WORLD and PP_WORLD
SP_RUNS = {2: ("contiguous", "zigzag"), 4: ("contiguous",)}  # world -> layouts of the train runs
# world -> layers of the full-width train runs, cut to keep the smoke near
# 900 s (every check stays; the widths are the flagship's): sp 2 ran 4
# layers until phase 15's park and wake needed the time
SP_LAYERS = {2: 2, 4: 2}
SP_BATCH = (2, 8192)  # the full-width train runs' global batch
SP_STEPS = 2  # timed steps after the warm-up (3 until the smoke needed the time)
SP_RING_SHAPE = (1, 1024, 8, 2, 128)  # the f32 ring check: b, s, h, hk, d (global)
SP_GRAD_CHECK = (1, 1024)  # the 2-layer f32 model's global batch
SP_TIMEOUT_S = 600  # a rank's group (and its collectives) and the wait for one job's results
SP_RING_TOLERANCE = 1e-4  # f32: out and q/k/v gradients, of the largest value
# the bf16 warm-up loss against the one-process step's, relative: read
# 1.8e-6 to 8.3e-6 on an H100 (PERF.md, PR 10)
SP_LOSS_TOLERANCE = 1e-4
# the f32 full-width step's gradients, each leaf of its own largest value
# against the one-process f32 step's (summation order only)
SP_GRAD_TOLERANCE = 1e-4
BF16_ULP = 2.0 ** -8  # bf16's relative rounding step
SP_VISIT_SEED = 11  # the bf16 ring whose every flash call is held against its plain version
FULL_WIDTH = dict(vocab=32768, d_model=1024, n_heads=8, d_ff=4096, max_seq=8192)


def _rank_main(job, rank, world, port, results, go, *args):
    """One job in a rank of phases 10-13: job's results, or its traceback,
    go to the parent through `results`."""
    import traceback

    try:
        results.put((rank, "done", job(rank, world, port, results, go, *args)))
    except BaseException:  # reported to the parent, which fails the phase
        results.put((rank, "error", traceback.format_exc()))


def _rank_loop(rank, world, tasks, results, go):
    """A spawned rank of the pool phases 10-13 share: it runs the jobs the
    parent sends (job, port, args) in turn, each from a clean slate (its
    process group destroyed by the job, the allocator's cache emptied and
    its peak reset), until the parent sends None."""
    while True:
        task = tasks.get()
        if task is None:
            return
        job, port, args = task
        if torch.cuda.is_initialized():
            torch.cuda.reset_peak_memory_stats()
        _rank_main(job, rank, world, port, results, go, *args)
        if torch.cuda.is_initialized():
            torch.cuda.empty_cache()


class _RankPool:
    """`world` spawned processes that run jobs in turn (`_spawn_ranks`).
    Phases 10-13 share one: each phase used to spawn its own ranks, and
    every spawn paid the processes' start-up (Python, torch's import, the
    CUDA context and the first kernels' loading) again."""

    def __init__(self, world):
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        self.world = world
        self.results = ctx.Queue()
        self.go = ctx.Event()
        self.tasks = [ctx.Queue() for _ in range(world)]
        self.procs = [ctx.Process(target=_rank_loop, args=(r, world, self.tasks[r], self.results, self.go),
                                  daemon=True) for r in range(world)]
        for p in self.procs:
            p.start()
        self.jobs = 0

    def close(self):
        for q in self.tasks:
            q.put(None)
        for p in self.procs:
            p.join(timeout=30)
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=30)


def _spawn_ranks(world, job, what, *args, ranks, on_agents=None, meanwhile=None):
    """Runs job(rank, world, port, results, go, *args) on `world` ranks;
    their results by rank. The ranks are the processes of `ranks`, a
    _RankPool of that world, left up for the caller's next job.
    `meanwhile()`, when given, runs here once the job is sent, while the
    ranks start it. A rank may post (rank, "agent", port) first: once
    every rank has, on_agents(ports) runs here and then `go` is set for
    the ranks. A rank that raises, dies or takes longer than SP_TIMEOUT_S
    fails the phase."""
    import queue
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    pool = ranks
    if pool.world != world:
        fail(f"{what}: a job for {world} ranks sent to a pool of {pool.world}")
    pool.go.clear()
    for q in pool.tasks:
        q.put((job, port, args))
    pool.jobs += 1
    got, agents, error = {}, {}, None
    deadline = time.monotonic() + SP_TIMEOUT_S
    try:
        if meanwhile is not None:
            meanwhile()
        while len(got) < world and error is None:
            try:
                rank, kind, payload = pool.results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r in range(world) if r not in got and pool.procs[r].exitcode is not None]
                if dead:
                    error = f"ranks {dead} exited without a result"
                elif time.monotonic() > deadline:
                    error = f"ranks {sorted(set(range(world)) - set(got))} gave no result in {SP_TIMEOUT_S} s"
                continue
            if kind == "error":
                error = f"rank {rank} of {world} raised:\n{payload}"
            elif kind == "agent":
                agents[rank] = payload
                if len(agents) == world:
                    on_agents([agents[r] for r in range(world)])
                    pool.go.set()
            else:
                got[rank] = payload
    finally:
        if error is not None:
            pool.close()
    if error is not None:
        fail(f"{what}, {world} ranks: {error}")
    print(f"  the {world} ranks ran this phase's job as their job {pool.jobs} (one pool for phases 10-13)",
          flush=True)
    return [got[r] for r in range(world)]


def _leaf_names(tree, prefix=""):
    """Dotted names of a params tree's leaves, in tree_leaves order."""
    if isinstance(tree, dict):
        return [n for key, child in tree.items() for n in _leaf_names(child, f"{prefix}{key}.")]
    return [prefix[:-1]]


def _ring_visits_vs_plain(mesh, layout, b=SP_BATCH[0], s=SP_BATCH[1], h=FULL_WIDTH["n_heads"]):
    """One bf16 ring (forward and backward, through autograd) at a train
    run's per-rank shape (b, s/sp, h heads, d 128, q/k/v strided views of
    one fused projection), each of its flash calls held against the plain
    version on the same inputs as the ring made them: the forward's out
    (TOLERANCE) and lse (LSE_TOLERANCE) per visit (zigzag: per half-pair,
    strided half-views), dq and dk/dv with the ring's merged global lse and
    delta (BWD_TOLERANCE of the plain result's largest). Returns a list of
    (kernel, causal, error over its tolerance)."""
    from odh_kubeflow_tpu_torch.ops import attention
    from odh_kubeflow_tpu_torch.ops import ring_attention as ring_mod

    d = FULL_WIDTH["d_model"] // FULL_WIDTH["n_heads"]
    sl = s // mesh.size("sp")
    dtype = torch.bfloat16
    q, k, v = (t.detach().requires_grad_()
               for t in inputs(b, sl, sl, h, h, d, dtype, seed=SP_VISIT_SEED + mesh.index("sp"), strided=True))
    dout = inputs(b, sl, sl, h, h, d, dtype, seed=SP_VISIT_SEED + 100 + mesh.index("sp"))[0]
    checked = []
    fwd, dq, dkv = ring_mod.flash_attention, ring_mod.flash_bwd_dq, ring_mod.flash_bwd_dkv

    def fwd_checked(q, k, v, causal=True, with_lse=False, device="cuda"):
        out, lse = fwd(q, k, v, causal=causal, with_lse=True, device=device)
        ref, ref_lse = attention.flash_attention_plain(q, k, v, causal=causal, with_lse=True)
        checked.append(("fwd", causal, max((out.float() - ref.float()).abs().max().item() / TOLERANCE[dtype],
                                           (lse - ref_lse).abs().max().item() / LSE_TOLERANCE)))
        return (out, lse) if with_lse else out

    def bwd_checked(name, kernel, plain):
        def call(*args):
            got = kernel(*args)
            want = plain(*args)
            got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
            largest = max(w.float().abs().max().item() for w in want)
            checked.append((name, args[-1], max(_grad_err(g, w, largest) for g, w in zip(got, want))
                            / BWD_TOLERANCE[dtype]))
            return got if len(got) > 1 else got[0]
        return call

    ring_mod.flash_attention = fwd_checked
    ring_mod.flash_bwd_dq = bwd_checked("dq", dq, attention.flash_bwd_dq_plain)
    ring_mod.flash_bwd_dkv = bwd_checked("dkv", dkv, attention.flash_bwd_dkv_plain)
    try:
        if layout == "zigzag":
            out = ring_mod.ring_attention_zigzag(q, k, v, mesh, use_kernel=True)
        else:
            out = ring_mod.ring_attention(q, k, v, mesh, causal=True, use_kernel=True)
        out.backward(dout)
        torch.cuda.synchronize()
    finally:
        ring_mod.flash_attention, ring_mod.flash_bwd_dq, ring_mod.flash_bwd_dkv = fwd, dq, dkv
    return checked


def _sp_rank_jobs(rank, world, port, results, go):
    """Phase 10 in one rank of the pool: for each sp size of
    SP_WORLDS, largest first, its runs over a mesh of the world's first sp
    ranks (a sub-group of the world for sp 2, whose other ranks wait);
    {sp: results} of the meshes this rank was in."""
    import torch.distributed as dist

    # the env names the operator's webhook injects into a slice's pods
    os.environ.update({"JAX_NUM_PROCESSES": str(world), "JAX_PROCESS_ID": str(rank),
                       "TPU_WORKER_ID": str(rank), "JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}"})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from odh_kubeflow_tpu_torch.parallel import MeshPlan, initialize_from_env

    # gloo: the ranks share one card, and NCCL refuses two ranks on one device
    initialize_from_env(timeout_s=SP_TIMEOUT_S, backend="gloo", device="cuda")
    out = {}
    for sp in sorted(SP_WORLDS, reverse=True):
        mesh = MeshPlan(sp=sp).build("cuda", ranks=range(sp))
        if mesh is not None:
            out[sp] = _sp_runs(rank, sp, mesh)
        torch.cuda.empty_cache()
        dist.barrier()
    dist.destroy_process_group()
    return out


def _sp_runs(rank, world, mesh):
    """Phase 10's runs over one sp mesh of `world` ranks, in one of them."""
    import dataclasses

    import torch.distributed as dist

    from odh_kubeflow_tpu_torch.models import (TransformerConfig, adamw, init_params, make_train_step,
                                               make_zigzag_batch, state_checksum, value_and_grad)
    from odh_kubeflow_tpu_torch.models.tree import tree_unflatten
    from odh_kubeflow_tpu_torch.ops import attention
    from odh_kubeflow_tpu_torch.ops.ring_attention import (ring_attention, ring_attention_zigzag,
                                                           zigzag_permutation)
    from odh_kubeflow_tpu_torch.parallel import comm, shard_batch

    group = mesh.group("sp")[0]
    dev = mesh.device
    out = {"device": str(dev), "transport": comm.Ring(mesh, "sp").transport()}

    def natural(s):
        return np.arange(s)

    # 1. the f32 ring (scalar kernels) on q/k/v: out and gradients of sum(out**2)
    b, s, h, hk, d = SP_RING_SHAPE
    rng = np.random.default_rng(10)
    qkv = [rng.standard_normal(shape).astype(np.float32)
           for shape in ((b, s, h, d), (b, s, hk, d), (b, s, hk, d))]
    for layout in ("contiguous", "zigzag"):
        perm = zigzag_permutation(s, world) if layout == "zigzag" else natural(s)
        shards = shard_batch(mesh, {n: x[:, perm] for n, x in zip("qkv", qkv)})
        q, k, v = (shards[n].requires_grad_() for n in "qkv")
        attention.reset_launch_counts()
        if layout == "zigzag":
            o = ring_attention_zigzag(q, k, v, mesh)
        else:
            o = ring_attention(q, k, v, mesh, causal=True)
        (o.float() ** 2).sum().backward()
        torch.cuda.synchronize()
        out[f"ring {layout}"] = {"launches": dict(attention.launch_counts),
                                 **{n: t.detach().cpu().numpy() for n, t in
                                    (("out", o), ("dq", q.grad), ("dk", k.grad), ("dv", v.grad))}}

    # 2. a 2-layer f32 model: sp loss and summed gradients against one process
    cfg32 = TransformerConfig(**FULL_WIDTH, n_layers=2, dtype=torch.float32, use_flash=True, remat=True,
                              remat_policy="flash", seq_axis="sp")
    params = init_params(torch.Generator().manual_seed(1), cfg32, device=dev)
    tokens = np.random.default_rng(2).integers(0, cfg32.vocab, SP_GRAD_CHECK)
    if rank == 0:  # the one-process reference: autograd through mha_reference
        ref = value_and_grad(params, {"tokens": torch.as_tensor(tokens, device=dev)},
                             dataclasses.replace(cfg32, seq_axis="", use_flash=False, remat=False))
    for layout in ("contiguous", "zigzag"):
        batch = make_zigzag_batch(tokens, world) if layout == "zigzag" else {"tokens": tokens}
        attention.reset_launch_counts()
        loss, grads = value_and_grad(params, shard_batch(mesh, batch),
                                     dataclasses.replace(cfg32, seq_layout=layout), mesh)
        torch.cuda.synchronize()
        res = {"launches": dict(attention.launch_counts), "loss": loss.item()}
        if rank == 0:
            res["loss_err"] = abs((loss - ref[0]) / ref[0]).item()
            res["grad_err"] = max(_grad_err(g, w) for g, w in zip(grads, ref[1]))
        out[f"model32 {layout}"] = res
        del grads
    del params
    if rank == 0:
        del ref

    # 3. the full-width train step: 1 warm-up and SP_STEPS steps per layout.
    # The warm-up's gradients are held against the one-process step's on the
    # same batch twice: in f32 (the model's arithmetic, each leaf within
    # SP_GRAD_TOLERANCE of its largest), and in bf16 against the f32 one
    # (the truth): no farther from it than the one-process bf16 step, plus
    # one bf16 ulp at the largest. A bf16 gradient of this model is itself
    # 1.1-1.4e-2 of the largest from the truth on an H100 (the per-leaf
    # gaps this phase prints), so two bf16 gradients cannot agree within
    # 1e-2 of each other. Before each layout's run, every flash call of a
    # bf16 ring at the run's per-rank shapes is held against its plain
    # version (_ring_visits_vs_plain).
    tokens = np.random.default_rng(3).integers(0, FULL_WIDTH["vocab"], SP_BATCH)
    base = TransformerConfig(**FULL_WIDTH, n_layers=SP_LAYERS[world], dtype=torch.bfloat16, use_flash=True,
                             remat=True, remat_policy="flash", seq_axis="sp")
    one = dataclasses.replace(base, seq_axis="")
    ref = truth = None
    if rank == 0:  # the one-process step's loss and gradients, same batch, bf16 and f32
        params = init_params(torch.Generator().manual_seed(0), base, device=dev)
        ref = value_and_grad(params, {"tokens": torch.as_tensor(tokens, device=dev)}, one)
        params = {k: (v.float() if torch.is_tensor(v) else {n: t.float() for n, t in v.items()})
                  for k, v in params.items()}
        truth = value_and_grad(params, {"tokens": torch.as_tensor(tokens, device=dev)},
                               dataclasses.replace(one, dtype=torch.float32))
        del params
        torch.cuda.synchronize()
    for layout in SP_RUNS[world]:
        cfg = dataclasses.replace(base, seq_layout=layout)
        batch = make_zigzag_batch(tokens, world) if layout == "zigzag" else {"tokens": tokens}
        local = shard_batch(mesh, batch)
        res = {"visits": _ring_visits_vs_plain(mesh, layout)}
        # the f32 step: the same weights, upcast
        params = init_params(torch.Generator().manual_seed(0), cfg, device=dev)
        names = _leaf_names(params)
        params32 = {k: (v.float() if torch.is_tensor(v) else {n: t.float() for n, t in v.items()})
                    for k, v in params.items()}
        loss32, grads32 = value_and_grad(params32, local, dataclasses.replace(cfg, dtype=torch.float32), mesh)
        del params32
        if rank == 0:
            largest = max(w.abs().max().item() for w in truth[1])
            res["f32_loss_err"] = abs((loss32 - truth[0]) / truth[0]).item()
            res["f32_leaf_err"] = {n: _grad_err(g, w) for n, g, w in zip(names, grads32, truth[1])}
        del grads32
        opt = adamw()
        state = opt.init(params)
        step, _ = make_train_step(cfg, opt, mesh)
        # the bf16 warm-up step
        first, grads = value_and_grad(params, local, cfg, mesh)
        if rank == 0:
            res["loss_err"] = abs((first - ref[0]) / ref[0]).item()
            res["ref_loss"] = ref[0].item()
            res["grad_err"] = max(_grad_err(g, w, largest) for g, w in zip(grads, ref[1]))
            res["grad_truth_err"] = max(_grad_err(g, w, largest) for g, w in zip(grads, truth[1]))
            res["ref_truth_err"] = max(_grad_err(g, w, largest) for g, w in zip(ref[1], truth[1]))
            # each leaf of its own largest: sp from f32, one process from f32, sp from one process
            res["bf16_leaf_gaps"] = {n: (_grad_err(g, t), _grad_err(r, t), _grad_err(g, r))
                                     for n, g, r, t in zip(names, grads, ref[1], truth[1])}
        opt.update_(tree_unflatten(params, grads), state, params)
        del grads
        torch.cuda.synchronize()
        dist.barrier(group=group)
        torch.cuda.reset_peak_memory_stats()
        attention.reset_launch_counts()
        comm.reset_exchange_counts()
        losses = [first]
        t0 = time.perf_counter()
        syncs = count_sync_warnings(lambda: losses.extend(
            step(params, state, local)[2] for _ in range(SP_STEPS)))
        torch.cuda.synchronize()
        res.update({
            "step_ms": (time.perf_counter() - t0) * 1e3 / SP_STEPS,
            "launches": dict(attention.launch_counts),
            "exchanges": dict(comm.exchange_counts),
            "syncs": syncs,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "losses": torch.stack(losses).tolist(),
            "params": state_checksum(params),
        })
        out[f"train {layout}"] = res
        del params, state, opt, step, local
        torch.cuda.empty_cache()
    dist.barrier(group=group)
    return out


def sp_phase(attention, smi, ranks):
    """Phase 10. Returns the launches of its paths by kernel name."""
    from odh_kubeflow_tpu_torch.ops.attention import mha_reference
    from odh_kubeflow_tpu_torch.ops.ring_attention import ring_launches, zigzag_permutation

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()  # the ranks' memory comes from the same card
    print(f"  the ranks of each run share this one card ({smi}) as processes on gloo: the "
          "times below prove the path, they are not a multi-card number", flush=True)
    b, s, h, hk, d = SP_RING_SHAPE
    rng = np.random.default_rng(10)
    qkv = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).cuda().requires_grad_()
           for shape in ((b, s, h, d), (b, s, hk, d), (b, s, hk, d))]
    ref_out = mha_reference(*qkv, causal=True)
    (ref_out ** 2).sum().backward()
    ref = {"out": ref_out.detach().cpu().numpy(),
           **{n: t.grad.cpu().numpy() for n, t in zip(("dq", "dk", "dv"), qkv)}}
    launched = {"sp f32 ring check": {}, "sp train": {}}

    def add(path, counts):
        for name, n in counts.items():
            launched[path][name] = launched[path].get(name, 0) + n

    t0 = time.perf_counter()
    spawned = _spawn_ranks(max(SP_WORLDS), _sp_rank_jobs, "phase 10", ranks=ranks)
    print(f"  {max(SP_WORLDS)} ranks, the sp {min(SP_WORLDS)} runs on a mesh over ranks "
          f"0-{min(SP_WORLDS) - 1} of its world: job to results {time.perf_counter() - t0:.1f} s", flush=True)
    for world in SP_WORLDS:
        ranks = [r[world] for r in spawned[:world]]
        print(f"  sp {world}: {world} ranks on {ranks[0]['device']}, transport: {ranks[0]['transport']}",
              flush=True)
        for layout in ("contiguous", "zigzag"):
            perm = zigzag_permutation(s, world) if layout == "zigzag" else np.arange(s)
            want_launches = ring_launches(world, layout)
            errs = {}
            for name in ("out", "dq", "dk", "dv"):
                got = np.concatenate([r[f"ring {layout}"][name] for r in ranks], axis=1)
                want = ref[name][:, perm]
                errs[name] = float(np.abs(got - want).max() / np.abs(want).max())
            per_rank = [r[f"ring {layout}"]["launches"] for r in ranks]
            for r, counts in enumerate(per_rank):
                want = {n: (want_launches[r] if n in ("flash_fwd_scalar",) + SCALAR_BWD else 0)
                        for n in counts}
                if counts != want:
                    fail(f"f32 ring {layout}, {world} ranks: rank {r} launched {counts}, want {want} "
                         "(ring_balance_report's schedule)")
                add("sp f32 ring check", counts)
            print(f"  f32 ring {layout}, sp={world}, b{b} s{s} h{h} hk{hk} d{d}: max err of the largest "
                  + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
                  + f" (tol {SP_RING_TOLERANCE:.0e}); scalar launches per rank {want_launches}", flush=True)
            if not max(errs.values()) <= SP_RING_TOLERANCE:
                fail(f"the f32 ring ({layout}, sp={world}) disagrees with one-process attention: {errs}")
            m = ranks[0][f"model32 {layout}"]
            for r in ranks:
                add("sp f32 ring check", r[f"model32 {layout}"]["launches"])
            print(f"  2-layer f32 model, {layout}, sp={world}, batch {SP_GRAD_CHECK}: loss {m['loss']:.6f}, "
                  f"rel err {m['loss_err']:.3e}, grads max err of the largest {m['grad_err']:.3e} "
                  f"(tol {SP_RING_TOLERANCE:.0e}) against one process through mha_reference", flush=True)
            if not (m["loss_err"] <= SP_RING_TOLERANCE and m["grad_err"] <= SP_RING_TOLERANCE):
                fail(f"the sp f32 model ({layout}, sp={world}) disagrees with one process: {m}")
        for layout in SP_RUNS[world]:
            runs = [r[f"train {layout}"] for r in ranks]
            first = runs[0]
            want_launches = ring_launches(world, layout)
            # every flash call of the bf16 ring at this run's shapes, against its plain version
            visits = [run["visits"] for run in runs]
            worst = {}
            for r, calls in enumerate(visits):
                for kernel in ("fwd", "dq", "dkv"):
                    mine = [c for c in calls if c[0] == kernel]
                    if len(mine) != want_launches[r]:
                        fail(f"bf16 ring {layout}, {world} ranks: rank {r} made {len(mine)} {kernel} calls, "
                             f"want {want_launches[r]}")
                for kernel, causal, err in calls:
                    key = (kernel, "causal" if causal else "full")
                    worst[key] = max(worst.get(key, 0.0), err)
            print(f"  bf16 ring {layout}, sp={world}, per rank b{SP_BATCH[0]} s{SP_BATCH[1] // world} h8 hk8 d128 "
                  f"(strided views{', zigzag half-pairs' if layout == 'zigzag' else ''}): "
                  f"{sum(map(len, visits))} flash calls against their plain versions, backward with the "
                  f"ring's merged lse and delta; worst error over its tolerance per kind "
                  + ", ".join(f"{k} {c} {e:.3f}" for (k, c), e in sorted(worst.items())), flush=True)
            if set(worst) != {(k, c) for k in ("fwd", "dq", "dkv") for c in ("causal", "full")} \
                    or not max(worst.values()) <= 1.0:
                fail(f"the bf16 ring's flash calls ({layout}, sp={world}) disagree with their plain "
                     f"versions or missed a kind: {worst}")
            for r, run in enumerate(runs):
                per_step = {n: c / SP_STEPS for n, c in run["launches"].items()}
                want = {n: (SP_LAYERS[world] * want_launches[r] if n in ("flash_fwd",) + TENSOR_CORE_BWD else 0)
                        for n in per_step}
                if per_step != want:
                    fail(f"sp train {layout}, {world} ranks: rank {r} launched {per_step} per step, "
                         f"want {want}")
                add("sp train", run["launches"])
            digests = {run["params"] for run in runs}
            losses = first["losses"]
            ex = first["exchanges"]
            print(f"  train {layout}, sp={world}, {SP_LAYERS[world]} layers, global batch {SP_BATCH[0]}x{SP_BATCH[1]}, remat flash: "
                  f"losses {', '.join(f'{x:.4f}' for x in losses)} (warm-up first); against the "
                  f"one-process step on the same batch: f32 loss rel err {first['f32_loss_err']:.3e}, "
                  f"grads max err of each leaf's largest {max(first['f32_leaf_err'].values()):.3e} "
                  f"(tol {SP_GRAD_TOLERANCE:.0e}); "
                  f"bf16 loss {first['ref_loss']:.4f} rel err {first['loss_err']:.3e} (tol "
                  f"{SP_LOSS_TOLERANCE:.0e}), grads max err of the largest {first['grad_err']:.3e}; from "
                  f"the f32 gradients: sp bf16 {first['grad_truth_err']:.3e}, one-process bf16 "
                  f"{first['ref_truth_err']:.3e} (tol: the one-process + {BF16_ULP:.2e})", flush=True)
            print("    per leaf, of its own largest: f32 sp from f32 one process; bf16 sp from f32, "
                  "bf16 one process from f32, bf16 sp from bf16 one process: "
                  + "; ".join(f"{n} {first['f32_leaf_err'][n]:.2e}; " + ", ".join(f"{x:.2e}" for x in gaps)
                              for n, gaps in first["bf16_leaf_gaps"].items()), flush=True)
            print(f"    step {max(run['step_ms'] for run in runs):.1f} ms (host clock, slowest rank; per rank "
                  f"{[round(run['step_ms'], 1) for run in runs]}); peak memory per rank GB "
                  f"{[round(run['peak_gb'], 2) for run in runs]}; per step and rank: ring bytes "
                  f"{[run['exchanges']['ring_bytes'] // SP_STEPS for run in runs]}, gradient and loss sums "
                  f"{ex['sum_bytes'] // SP_STEPS} bytes, host waits of the staged transport "
                  f"{[run['exchanges']['host_waits'] // SP_STEPS for run in runs]}, the host's ms in them "
                  f"waiting for the device {[round(run['exchanges']['device_wait_s'] * 1e3 / SP_STEPS, 1) for run in runs]} "
                  f"and in the transfers {[round(run['exchanges']['transfer_s'] * 1e3 / SP_STEPS, 1) for run in runs]}; "
                  f"host syncs in "
                  f"{SP_STEPS} steps (sync debug mode) {[run['syncs'] for run in runs]}; tensor-core "
                  f"forward launches per step and rank {[SP_LAYERS[world] * n for n in want_launches]}; params "
                  f"digests {sorted(digests)} on {smi}", flush=True)
            if not (first["f32_loss_err"] <= SP_RING_TOLERANCE
                    and max(first["f32_leaf_err"].values()) <= SP_GRAD_TOLERANCE
                    and first["loss_err"] <= SP_LOSS_TOLERANCE
                    and first["grad_truth_err"] <= first["ref_truth_err"] + BF16_ULP):
                fail(f"the sp step ({layout}, sp={world}) disagrees with the one-process step: {first}")
            if len(digests) != 1:
                fail(f"the params differ across ranks after the sp steps ({layout}, sp={world}): {digests}")
            if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
                fail(f"sp train losses not finite and falling ({layout}, sp={world}): {losses}")
            if any(run["syncs"] for run in runs):
                fail(f"host syncs inside the sp steps ({layout}, sp={world}): {[run['syncs'] for run in runs]}")
    print(f"  phase 10 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launched


SHARD_WORLD = 4
# phase 11's runs: name -> (plan, global batch, layout): phase 6's batch at
# fsdp 2 x tp 2, phase 10's at tp 2 x sp 2 zigzag
SHARD_RUNS = {
    "fsdp2 x tp2": ({"fsdp": 2, "tp": 2}, (8, 2048), "contiguous"),
    "tp2 x sp2 zigzag": ({"tp": 2, "sp": 2}, SP_BATCH, "zigzag"),
}
SHARD_CHECKPOINT_RUN = "fsdp2 x tp2"  # the run whose state goes through the agents' routes
SHARD_STEPS = 2  # timed steps after the warm-up (3 until the smoke needed the time)
# the runs' depth (of the flagship's 8 layers), cut to keep the smoke near
# 900 s (4 until phase 15's park and wake needed the time)
SHARD_LAYERS = 2


def _flash_calls_vs_plain(b, s, h, d):
    """The flash calls of a layer of the sharded step without a ring, at its
    per-rank shape (q/k/v strided views of one fused projection, bf16,
    causal): the forward with lse, then dq and dk/dv with that lse and
    delta = rowsum(dO * out), each held against its plain version on the
    same inputs. Returns [(kernel, True, error over its tolerance)]."""
    from odh_kubeflow_tpu_torch.ops import attention

    dtype = torch.bfloat16
    q, k, v = inputs(b, s, s, h, h, d, dtype, seed=SP_VISIT_SEED, strided=True)
    dout = inputs(b, s, s, h, h, d, dtype, seed=SP_VISIT_SEED + 100)[0]
    out, lse = attention.flash_attention(q, k, v, causal=True, with_lse=True, device=q.device)
    ref, ref_lse = attention.flash_attention_plain(q, k, v, causal=True, with_lse=True)
    checked = [("fwd", True, max((out.float() - ref.float()).abs().max().item() / TOLERANCE[dtype],
                                 (lse - ref_lse).abs().max().item() / LSE_TOLERANCE))]
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, dout, lse, delta, True)
    got, want = attention.flash_bwd_dq(*args), attention.flash_bwd_dq_plain(*args)
    checked.append(("dq", True, _grad_err(got, want) / BWD_TOLERANCE[dtype]))
    got, want = attention.flash_bwd_dkv(*args), attention.flash_bwd_dkv_plain(*args)
    largest = max(w.float().abs().max().item() for w in want)
    checked.append(("dkv", True, max(_grad_err(g, w, largest) for g, w in zip(got, want))
                    / BWD_TOLERANCE[dtype]))
    torch.cuda.synchronize()
    return checked


def _replicas(tree, placements, mesh):
    """{leaf: (the rank's coordinates on the axes that cut it, the digest of
    its block)}: ranks with equal coordinates hold one block."""
    from odh_kubeflow_tpu_torch.models import state_checksum
    from odh_kubeflow_tpu_torch.models.convert import placement_at

    out = {}
    for name in _leaf_names(tree):
        path = tuple(name.split("."))
        leaf = tree
        for key in path:
            leaf = leaf[key]
        cut = placement_at(placements, path).axes()
        out[name] = (tuple(mesh.coords[a] for a in cut), state_checksum({"x": leaf}))
    return out


def _shard_rank_jobs(rank, world, port, results, go, ckpt_dir):
    """Phase 11 in one rank: both runs in turn, the checkpoint through the
    agent's routes in the first, and the saved step restored onto the
    second run's mesh."""
    import torch.distributed as dist

    os.environ.update({"JAX_NUM_PROCESSES": str(world), "JAX_PROCESS_ID": str(rank),
                       "TPU_WORKER_ID": str(rank), "JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}"})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from odh_kubeflow_tpu_torch.parallel import MeshPlan, comm, initialize_from_env

    # gloo: the ranks share one card, and NCCL refuses two ranks on one device
    initialize_from_env(timeout_s=SP_TIMEOUT_S, backend="gloo", device="cuda")
    from odh_kubeflow_tpu_torch.models import init_params
    from odh_kubeflow_tpu_torch.parallel import rank_device

    # the global params of both runs (the same seed and widths)
    full = init_params(torch.Generator().manual_seed(0), _shard_cfg({}, "contiguous"), device=rank_device("cuda"))
    out, saved = {}, {}
    for name, (plan, shape, layout) in SHARD_RUNS.items():
        mesh = MeshPlan(**plan).build("cuda")
        out["device"] = str(mesh.device)
        out.setdefault("transport", comm.transport(mesh.group("tp")[0], mesh.device))
        if saved:
            out["restored onto " + name] = _restore_onto(mesh, saved, full)
        out[name] = _shard_run(mesh, full, shape, layout, name == SHARD_CHECKPOINT_RUN, results, go, ckpt_dir,
                               saved)
        torch.cuda.empty_cache()
    dist.barrier()
    dist.destroy_process_group()
    return out


def _shard_cfg(plan, layout):
    from odh_kubeflow_tpu_torch.models import TransformerConfig

    return TransformerConfig(**FULL_WIDTH, n_layers=SHARD_LAYERS, dtype=torch.bfloat16, use_flash=True, remat=True,
                             remat_policy="flash", seq_axis="sp" if plan.get("sp", 1) > 1 else "",
                             seq_layout=layout)


def _shard_run(mesh, full, shape, layout, checkpoint, results, go, ckpt_dir, saved):
    """One run of phase 11 in this rank: the flash calls at the per-rank
    shapes against their plain versions; the first step in f32 and the
    bf16 warm-up against the one-process step on the same batch (rank 0
    holds the one-process references; the gradients are gathered); three
    timed steps; with `checkpoint`, the agent's routes."""
    import dataclasses

    import torch.distributed as dist

    from odh_kubeflow_tpu_torch.models import (adamw, gather_params, make_train_step,
                                               make_zigzag_batch, shard_params, state_checksum,
                                               train_state_placements, value_and_grad)
    from odh_kubeflow_tpu_torch.models.tree import tree_leaves, tree_map, tree_unflatten
    from odh_kubeflow_tpu_torch.ops import attention
    from odh_kubeflow_tpu_torch.parallel import comm, shard_batch

    dev = mesh.device
    plan = {a: n for a, n in mesh.sizes.items() if n > 1}
    sp, tp = mesh.sizes["sp"], mesh.sizes["tp"]
    cfg = _shard_cfg(plan, layout)
    one = dataclasses.replace(cfg, seq_axis="", seq_layout="contiguous")
    tokens = np.random.default_rng(3).integers(0, FULL_WIDTH["vocab"], shape)
    batch = make_zigzag_batch(tokens, sp) if layout == "zigzag" else {"tokens": tokens}
    local = shard_batch(mesh, batch)
    b_rank = shape[0] // mesh.size(("dp", "fsdp"))
    h_rank = cfg.n_heads // tp
    res = {"shape": f"b{b_rank} s{shape[1] // sp} h{h_rank} hk{h_rank} d{cfg.head_dim}"}
    if sp > 1:
        res["visits"] = _ring_visits_vs_plain(mesh, layout, b_rank, shape[1], h_rank)
    else:
        res["visits"] = _flash_calls_vs_plain(b_rank, shape[1], h_rank, cfg.head_dim)
    names = _leaf_names(full)
    ref = truth = None
    if mesh.rank == 0:  # the one-process step's loss and gradients, same batch, bf16 and f32
        one_batch = {"tokens": torch.as_tensor(tokens, device=dev)}
        ref = value_and_grad(full, one_batch, one)
        full32 = tree_map(lambda t: t.float(), full)
        truth = value_and_grad(full32, one_batch, dataclasses.replace(one, dtype=torch.float32))
        del full32
        torch.cuda.synchronize()
    # the f32 step: the same weights, upcast, then sharded
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params32 = shard_params(tree_map(lambda t: t.float(), full), cfg32, mesh)
    loss32, grads32 = value_and_grad(params32, local, cfg32, mesh)
    grads32 = gather_params(tree_unflatten(params32, grads32), cfg32, mesh)
    del params32
    if mesh.rank == 0:
        res["f32_loss_err"] = abs((loss32 - truth[0]) / truth[0]).item()
        res["f32_leaf_err"] = {n: _grad_err(g, w) for n, g, w in
                               zip(names, tree_leaves(grads32), truth[1])}
    del grads32
    params = shard_params(full, cfg, mesh)
    opt = adamw()
    state = opt.init(params)
    step, _ = make_train_step(cfg, opt, mesh)
    # the bf16 warm-up step
    first, grads = value_and_grad(params, local, cfg, mesh)
    gathered = tree_leaves(gather_params(tree_unflatten(params, grads), cfg, mesh))
    if mesh.rank == 0:
        largest = max(w.abs().max().item() for w in truth[1])
        res["loss_err"] = abs((first - ref[0]) / ref[0]).item()
        res["ref_loss"] = ref[0].item()
        res["grad_err"] = max(_grad_err(g, w, largest) for g, w in zip(gathered, ref[1]))
        res["grad_truth_err"] = max(_grad_err(g, w, largest) for g, w in zip(gathered, truth[1]))
        res["ref_truth_err"] = max(_grad_err(g, w, largest) for g, w in zip(ref[1], truth[1]))
        res["bf16_leaf_gaps"] = {n: (_grad_err(g, t), _grad_err(r, t), _grad_err(g, r))
                                 for n, g, r, t in zip(names, gathered, ref[1], truth[1])}
    del gathered, ref, truth
    opt.update_(tree_unflatten(params, grads), state, params)
    del grads
    torch.cuda.synchronize()
    dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    attention.reset_launch_counts()
    comm.reset_exchange_counts()
    losses = [first]
    t0 = time.perf_counter()
    syncs = count_sync_warnings(lambda: losses.extend(
        step(params, state, local)[2] for _ in range(SHARD_STEPS)))
    torch.cuda.synchronize()
    res.update({
        "step_ms": (time.perf_counter() - t0) * 1e3 / SHARD_STEPS,
        "launches": dict(attention.launch_counts),
        "exchanges": dict(comm.exchange_counts),
        "syncs": syncs,
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        "losses": torch.stack(losses).tolist(),
    })
    train_state = {"params": params, "opt_state": state}
    placements = train_state_placements(cfg, mesh)
    res["replicas"] = _replicas(train_state, placements, mesh)
    if checkpoint:
        res["checkpoint"] = _checkpoint_through_agent(mesh, cfg, step, opt, train_state, placements, local,
                                                      results, go, ckpt_dir, saved)
        saved["tokens"] = tokens
    return res


def _checkpoint_through_agent(mesh, cfg, step, opt, train_state, placements, local, results, go, ckpt_dir,
                              saved, layout=None):
    """This rank's NotebookAgent, its hooks closing over its blocks: the
    parent drives /tpu/checkpoint and then /tpu/restore (onto a fresh init
    from another seed, put in the run's `layout` first: the pipeline's)
    on all ranks at once; then the uninterrupted step and the step resumed
    from the restored blocks."""
    from odh_kubeflow_tpu_torch.models import (gather_tree, init_params, make_checkpoint_hook,
                                               make_restore_hook, restore_train_state, shard_params,
                                               state_checksum)
    from odh_kubeflow_tpu_torch.ops import attention
    from odh_kubeflow_tpu_torch.probe import CudaMonitor, NotebookAgent

    step_no = int(train_state["opt_state"]["count"])
    global_state = gather_tree(train_state, placements, mesh)
    out = {"step": step_no, "global_checksum": state_checksum(global_state),
           "params_checksum": state_checksum(global_state["params"])}
    del global_state
    fresh = init_params(torch.Generator().manual_seed(7), cfg, device=mesh.device)
    fresh = shard_params(layout(fresh) if layout is not None else fresh, cfg, mesh)
    fresh_state = {"params": fresh, "opt_state": opt.init(fresh)}
    mon = CudaMonitor(chips_expected=1, window_s=3.0, sample_period_s=1.0, metrics_port=0,
                      utilization_reader=lambda: None)
    agent = NotebookAgent(mon, checkpoint_hook=make_checkpoint_hook(
        ckpt_dir, lambda: (step_no, train_state), mesh=mesh, placements=placements))
    agent.restore_hook = make_restore_hook(ckpt_dir, lambda: fresh_state, mesh=mesh, placements=placements)
    _, agent_port, close = agent.serve()
    try:
        results.put((mesh.rank, "agent", agent_port))
        if not go.wait(SP_TIMEOUT_S):
            raise TimeoutError("the parent did not drive the agents")
    finally:
        close()
    step_dir = os.path.join(ckpt_dir, str(step_no))
    out["bytes_written"] = sum(os.path.getsize(os.path.join(step_dir, f)) for f in os.listdir(step_dir)
                               if f.startswith(f"shard-{mesh.rank:05d}-"))
    # the run that is never interrupted
    _, _, loss_ref = step(train_state["params"], train_state["opt_state"], local)
    out["ref_loss"] = loss_ref.item()
    out["ref_digest"] = state_checksum(train_state["params"])
    # resumed from the restored blocks
    t0 = time.perf_counter()
    restored = restore_train_state(ckpt_dir, fresh_state, mesh=mesh, placements=placements)
    torch.cuda.synchronize()
    out["restore_s"] = time.perf_counter() - t0
    before = dict(attention.launch_counts)
    _, _, loss_res = step(restored["params"], restored["opt_state"], local)
    torch.cuda.synchronize()
    out["resumed_launches"] = _launches_since(attention, before)
    out["resumed_loss"] = loss_res.item()
    out["resumed_digest"] = state_checksum(restored["params"])
    saved.update(dir=ckpt_dir, step=step_no, params_checksum=out["params_checksum"], ref_loss=out["ref_loss"])
    return out


def _restore_onto(mesh, saved, full):
    """The checkpointed step restored onto this run's mesh (onto blocks of
    zeros): the gathered params' checksum, and the next step's loss on the
    checkpointed run's batch (contiguous layout)."""
    from odh_kubeflow_tpu_torch.models import (adamw, gather_params, make_train_step, restore_train_state,
                                               shard_params, state_checksum, train_state_placements)
    from odh_kubeflow_tpu_torch.models.tree import tree_map
    from odh_kubeflow_tpu_torch.parallel import shard_batch

    cfg = _shard_cfg({a: n for a, n in mesh.sizes.items() if n > 1}, "contiguous")
    like = shard_params(tree_map(torch.zeros_like, full), cfg, mesh)
    opt = adamw()
    restored = restore_train_state(saved["dir"], {"params": like, "opt_state": opt.init(like)},
                                   step=saved["step"], mesh=mesh, placements=train_state_placements(cfg, mesh))
    out = {"params_checksum": state_checksum(gather_params(restored["params"], cfg, mesh))}
    step, _ = make_train_step(cfg, opt, mesh)
    _, _, loss = step(restored["params"], restored["opt_state"],
                      shard_batch(mesh, {"tokens": saved["tokens"]}))
    out["loss"] = loss.item()
    return out


def _drive_agents(ports):
    """/tpu/checkpoint on every rank's agent at once, then /tpu/restore: the
    acks and the wall time of each."""
    from concurrent.futures import ThreadPoolExecutor

    out = {}
    with ThreadPoolExecutor(len(ports)) as pool:
        for route in ("/tpu/checkpoint", "/tpu/restore"):
            t0 = time.perf_counter()
            out[route] = list(pool.map(lambda p: _get("127.0.0.1", p, route), ports))
            out[route + " s"] = time.perf_counter() - t0
    return out


def _one_process_restore(saved, smi, cfg=None):
    """The checkpointed step (of `cfg`, phase 11's by default) restored
    onto one process: the params' checksum and the next step's loss."""
    from odh_kubeflow_tpu_torch.models import (adamw, init_params, make_train_step, restore_train_state,
                                               state_checksum)

    cfg = cfg or _shard_cfg({}, "contiguous")
    like = init_params(torch.Generator().manual_seed(9), cfg, device="cuda")
    opt = adamw()
    restored = restore_train_state(saved["dir"], {"params": like, "opt_state": opt.init(like)},
                                   step=saved["step"])
    out = {"params_checksum": state_checksum(restored["params"])}
    step, _ = make_train_step(cfg, opt)
    _, _, loss = step(restored["params"], restored["opt_state"],
                      {"tokens": torch.as_tensor(saved["tokens"], device="cuda")})
    out["loss"] = loss.item()
    return out


def shard_phase(attention, smi, ranks):
    """Phase 11. Returns the launches of its paths by kernel name."""
    import shutil
    import tempfile

    from odh_kubeflow_tpu_torch.ops.ring_attention import ring_launches

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()  # the ranks' memory comes from the same card

    def gloo_probe():  # here, while the ranks start the job
        probe = subprocess.run([sys.executable, os.path.join("tools", "gloo_cuda_probe.py")],
                               cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True,
                               timeout=300)
        readings = [line for line in probe.stdout.splitlines() if line.startswith("gloo ")]
        for line in readings:
            print(f"  {line}", flush=True)
        if probe.returncode != 0 or len(readings) != 5:
            fail(f"tools/gloo_cuda_probe.py exited {probe.returncode} with {len(readings)} readings: "
                 f"{probe.stderr[-2000:]}")

    print(f"  the {SHARD_WORLD} ranks of each run share this one card ({smi}) as processes brought up "
          "by initialize_from_env from the webhook's env names, on gloo, every collective on a CUDA "
          "tensor staged through pinned host memory: the times below prove the path, they are not a "
          "multi-card number", flush=True)
    ckpt_dir = tempfile.mkdtemp(prefix="shard-ckpt-")
    drive = {}
    try:
        t0 = time.perf_counter()
        ranks = _spawn_ranks(SHARD_WORLD, _shard_rank_jobs, "phase 11", ckpt_dir,
                             on_agents=lambda ports: drive.update(_drive_agents(ports)), meanwhile=gloo_probe,
                             ranks=ranks)
        print(f"  {SHARD_WORLD} ranks on {ranks[0]['device']}, transport: {ranks[0]['transport']}; "
              f"job to results {time.perf_counter() - t0:.1f} s", flush=True)
        launched = {}
        for name, (plan, shape, layout) in SHARD_RUNS.items():
            runs = [r[name] for r in ranks]
            _check_shard_run(name, plan, shape, layout, runs, smi, ring_launches)
            for run in runs:
                for kernel, n in run["launches"].items():
                    launched[kernel] = launched.get(kernel, 0) + n
        ck = [r[SHARD_CHECKPOINT_RUN]["checkpoint"] for r in ranks]
        _check_shard_checkpoint(ck, drive, smi)
        saved = {"dir": ckpt_dir, "step": ck[0]["step"], "ref_loss": ck[0]["ref_loss"],
                 "tokens": np.random.default_rng(3).integers(0, FULL_WIDTH["vocab"],
                                                             SHARD_RUNS[SHARD_CHECKPOINT_RUN][1])}
        for name in SHARD_RUNS:
            onto = [r.get("restored onto " + name) for r in ranks]
            if onto[0] is not None:
                _check_restored(f"the {name} mesh", onto[0], onto, ck[0])
        one = _one_process_restore(saved, smi)
        _check_restored("one process", one, [one], ck[0])
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    print(f"  phase 11 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"shard train": launched}


def _check_restored(where, first, per_rank, ck):
    rel = abs(first["loss"] - ck["ref_loss"]) / abs(ck["ref_loss"])
    print(f"  the saved step restored onto {where}: params checksum "
          f"{sorted({r['params_checksum'] for r in per_rank})} (saved {ck['params_checksum']}); the next "
          f"step's loss {first['loss']:.6f} against the uninterrupted {ck['ref_loss']:.6f}, rel err "
          f"{rel:.3e} (tol {SP_LOSS_TOLERANCE:.0e})", flush=True)
    if {r["params_checksum"] for r in per_rank} != {ck["params_checksum"]} or not rel <= SP_LOSS_TOLERANCE:
        fail(f"the step restored onto {where} differs from the saved one: {per_rank}")


def _check_shard_run(name, plan, shape, layout, runs, smi, ring_launches):
    first = runs[0]
    sp = plan.get("sp", 1)
    sched = ring_launches(sp, layout) if sp > 1 else [1]
    worst = {}
    for r, run in enumerate(runs):
        calls = run["visits"]
        for kernel in ("fwd", "dq", "dkv"):
            mine = [c for c in calls if c[0] == kernel]
            if len(mine) != sched[r % sp]:
                fail(f"{name}: rank {r} made {len(mine)} {kernel} calls, want {sched[r % sp]}")
        for kernel, causal, err in calls:
            key = (kernel, "causal" if causal else "full")
            worst[key] = max(worst.get(key, 0.0), err)
    kinds = {(k, c) for k in ("fwd", "dq", "dkv") for c in (("causal", "full") if sp > 1 else ("causal",))}
    print(f"  {name}, per rank {first['shape']} (strided views"
          f"{', zigzag half-pairs' if layout == 'zigzag' else ''}): "
          f"{sum(len(run['visits']) for run in runs)} flash calls against their plain versions; worst "
          f"error over its tolerance per kind " + ", ".join(f"{k} {c} {e:.3f}" for (k, c), e in sorted(worst.items())),
          flush=True)
    if set(worst) != kinds or not max(worst.values()) <= 1.0:
        fail(f"{name}: the flash calls disagree with their plain versions or missed a kind: {worst}")
    for r, run in enumerate(runs):
        per_step = {n: c / SHARD_STEPS for n, c in run["launches"].items()}
        want = {n: (SHARD_LAYERS * sched[r % sp] if n in ("flash_fwd",) + TENSOR_CORE_BWD else 0)
                for n in per_step}
        if per_step != want:
            fail(f"{name}: rank {r} launched {per_step} per step, want {want}")
    losses = first["losses"]
    print(f"  train {name}, global batch {shape[0]}x{shape[1]}, remat flash: losses "
          f"{', '.join(f'{x:.4f}' for x in losses)} (warm-up first); against the one-process step on the "
          f"same batch: f32 loss rel err {first['f32_loss_err']:.3e}, gathered grads max err of each "
          f"leaf's largest {max(first['f32_leaf_err'].values()):.3e} (tol {SP_GRAD_TOLERANCE:.0e}); bf16 "
          f"loss {first['ref_loss']:.4f} rel err {first['loss_err']:.3e} (tol {SP_LOSS_TOLERANCE:.0e}), "
          f"grads max err of the largest {first['grad_err']:.3e}; from the f32 gradients: sharded bf16 "
          f"{first['grad_truth_err']:.3e}, one-process bf16 {first['ref_truth_err']:.3e} (tol: the "
          f"one-process + {BF16_ULP:.2e})", flush=True)
    print("    per leaf, of its own largest: f32 sharded from f32 one process; bf16 sharded from f32, "
          "bf16 one process from f32, bf16 sharded from bf16 one process: "
          + "; ".join(f"{n} {first['f32_leaf_err'][n]:.2e}; " + ", ".join(f"{x:.2e}" for x in gaps)
                      for n, gaps in first["bf16_leaf_gaps"].items()), flush=True)
    kinds = ("gather", "scatter", "tp_sum", "vocab", "ring", "sum")
    print(f"    step {max(run['step_ms'] for run in runs):.1f} ms (host clock, slowest rank; per rank "
          f"{[round(run['step_ms'], 1) for run in runs]}); peak memory per rank GB "
          f"{[round(run['peak_gb'], 2) for run in runs]}; per step and rank, bytes (and exchanges): "
          + ", ".join(f"{k} {first['exchanges'][k + '_bytes'] // SHARD_STEPS} ({first['exchanges'][k] // SHARD_STEPS})"
                      for k in kinds)
          + f"; host waits of the staged transport {[run['exchanges']['host_waits'] // SHARD_STEPS for run in runs]}, "
          f"the host's ms in them waiting for the device "
          f"{[round(run['exchanges']['device_wait_s'] * 1e3 / SHARD_STEPS, 1) for run in runs]} and in the "
          f"transfers {[round(run['exchanges']['transfer_s'] * 1e3 / SHARD_STEPS, 1) for run in runs]}; host "
          f"syncs in {SHARD_STEPS} steps (sync debug mode) {[run['syncs'] for run in runs]}; tensor-core "
          f"launches per step and rank {[SHARD_LAYERS * sched[r % sp] for r in range(len(runs))]} on {smi}",
          flush=True)
    if not (first["f32_loss_err"] <= SP_RING_TOLERANCE
            and max(first["f32_leaf_err"].values()) <= SP_GRAD_TOLERANCE
            and first["loss_err"] <= SP_LOSS_TOLERANCE
            and first["grad_truth_err"] <= first["ref_truth_err"] + BF16_ULP):
        fail(f"the sharded step ({name}) disagrees with the one-process step: "
             f"{ {k: v for k, v in first.items() if k not in ('replicas', 'visits')} }")
    bad = []
    for leaf in first["replicas"]:
        blocks = {}
        for run in runs:
            coords, digest = run["replicas"][leaf]
            blocks.setdefault(coords, set()).add(digest)
        bad += [leaf for d in blocks.values() if len(d) != 1]
    print(f"    replicated leaves bit-equal across the ranks that hold them: "
          f"{len(first['replicas']) - len(set(bad))} of {len(first['replicas'])} leaves", flush=True)
    if bad:
        fail(f"{name}: replicated leaves differ across ranks: {sorted(set(bad))}")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        fail(f"{name}: train losses not finite and falling: {losses}")
    if any(run["syncs"] for run in runs):
        fail(f"{name}: host syncs inside the steps: {[run['syncs'] for run in runs]}")


def _check_shard_checkpoint(ck, drive, smi, want_launches=None):
    want = {"saved": True, "step": ck[0]["step"], "checksum": ck[0]["global_checksum"]}
    acks = drive["/tpu/checkpoint"]
    restore_acks = drive["/tpu/restore"]
    print(f"  /tpu/checkpoint on the {len(acks)} ranks' agents at once: {drive['/tpu/checkpoint s']:.3f} s, "
          f"acks {acks}; bytes written per rank {[c['bytes_written'] for c in ck]} "
          f"({sum(c['bytes_written'] for c in ck) / 1e9:.3f} GB); /tpu/restore onto a fresh init: "
          f"{drive['/tpu/restore s']:.3f} s, acks {restore_acks}; restore_train_state alone per rank s "
          f"{[round(c['restore_s'], 3) for c in ck]}, on {smi}", flush=True)
    if acks != [want] * len(ck) or {c["global_checksum"] for c in ck} != {want["checksum"]}:
        fail(f"checkpoint acks {acks}, want four equal acks {want} (the gathered state's checksum)")
    if restore_acks != [{"restored": True, "step": want["step"], "checksum": want["checksum"],
                         "reason": None}] * len(ck):
        fail(f"restore acks {restore_acks}, want step {want['step']} and checksum {want['checksum']}")
    print(f"  resumed step: losses {[c['resumed_loss'] for c in ck]} (uninterrupted "
          f"{[c['ref_loss'] for c in ck]}), params bit-equal per rank "
          f"{[c['resumed_digest'] == c['ref_digest'] for c in ck]}; launches {ck[0]['resumed_launches']}",
          flush=True)
    if any(c["resumed_loss"] != c["ref_loss"] or c["resumed_digest"] != c["ref_digest"] for c in ck):
        fail("the resumed sharded step differs from the uninterrupted one")
    n = SHARD_LAYERS
    want_launches = want_launches or {"flash_fwd": n, "flash_fwd_scalar": 0, "flash_bwd_dq": n,
                                      "flash_bwd_dkv": n, "flash_bwd_dq_scalar": 0, "flash_bwd_dkv_scalar": 0}
    if any(c["resumed_launches"] != want_launches for c in ck):
        fail(f"the resumed steps launched {[c['resumed_launches'] for c in ck]}, want {want_launches}")


# ---------------------------------------------------------------------------
# Phase 12: tensor-parallel generate, tp with shared kv heads, and the ep
# MoE train step, ranks spawned on this one card
# ---------------------------------------------------------------------------

EP_WORLD = 4
SERVE_WIDTH = dict(vocab=32768, d_model=1024, n_heads=8, d_ff=4096, max_seq=2048)  # bench.py:951-961
SERVE_LAYERS = 8
# (a) phase 5's flagship through generate(mesh=): mesh name -> plan
TP_DECODE_MESHES = {"tp2": {"tp": 2}, "fsdp2 x tp2": {"fsdp": 2, "tp": 2}}
TP_PROMPTS = (8, 128)  # prompts x tokens
TP_MAX_NEW = 32  # 64 until the smoke's budget needed the time back for phase 15's admission
TP_F32_LAYERS = 2  # the f32 run of the same shapes
TP_SAMPLE = (0.8, 5)  # the f32 sampled run's temperature and generator seed
# the first step's logits of a tp rank's vocab block against one process's,
# bf16, of the largest |logit|
TP_LOGIT_TOLERANCE = TOLERANCE[torch.bfloat16]
# (b) tp 4 with n_kv_heads 2 (tp does not divide kv_heads), f32, the
# flagship's widths
SHARED_KV = dict(n_kv_heads=2, n_layers=2)
SHARED_TP = 4
SHARED_BATCH = (2, 512)
SHARED_PROMPTS = (2, 32)
SHARED_MAX_NEW = 16
# (c) bench.py:389-400's MoE train step (phase 8's config)
MOE_WIDTH = dict(vocab=32768, d_model=1024, n_heads=8, d_ff=2048, max_seq=2048)
EP_RUNS = {"ep2 x tp2": {"ep": 2, "tp": 2}, "ep2 x fsdp2": {"ep": 2, "fsdp": 2}}
EP_BATCH = (8, 2048)
EP_LAYERS = 2  # of the MoE's 8 layers (4 until phase 15's park and wake needed the time)
EP_STEPS = 2  # timed steps after the warm-up (3 until phase 15 needed the time)
EP_F32_LAYERS = 2  # the f32 step held per leaf against one process
EP_CHECKPOINT_RUN = "ep2 x tp2"  # the run whose state goes through the agents' routes


def _serve_cfg(layers, dtype):
    """Phase 5's flagship serving config (bench.py:951-961) at `layers`."""
    from odh_kubeflow_tpu_torch.models import TransformerConfig

    return TransformerConfig(**SERVE_WIDTH, n_layers=layers, dtype=dtype, use_flash=True, remat=False)


def _moe_cfg(layers, dtype):
    from odh_kubeflow_tpu_torch.models import MoEConfig, TransformerConfig

    return TransformerConfig(**MOE_WIDTH, n_layers=layers, dtype=dtype, use_flash=True, remat=True,
                             remat_policy="", moe=MoEConfig(n_experts=8, experts_per_token=2, capacity_factor=1.25))


def _tp_prompts():
    return np.random.default_rng(12).integers(0, SERVE_WIDTH["vocab"], TP_PROMPTS)


def _tp_decode_reference():
    """Phase 12 (a)'s one-process references on the card: the bf16
    flagship's first-step logits and greedy tokens, and the f32 2-layer
    model's greedy and sampled tokens."""
    from odh_kubeflow_tpu_torch.models import generate, init_params
    from odh_kubeflow_tpu_torch.models.decode import _prefill_parts

    prompts = torch.as_tensor(_tp_prompts(), device="cuda")
    out = {}
    for key, cfg in (("bf16", _serve_cfg(SERVE_LAYERS, torch.bfloat16)),
                     ("f32", _serve_cfg(TP_F32_LAYERS, torch.float32))):
        params = init_params(torch.Generator().manual_seed(0), cfg, device="cuda")
        with torch.no_grad():
            out[key + " logits"] = _prefill_parts(params, prompts, cfg, TP_PROMPTS[1] + TP_MAX_NEW)[0].float().cpu().numpy()
        out[key] = generate(params, prompts, cfg, TP_MAX_NEW, device="cuda").cpu().numpy()
        if key == "f32":
            gen = torch.Generator(device="cuda").manual_seed(TP_SAMPLE[1])
            out["f32 sampled"] = generate(params, prompts, cfg, TP_MAX_NEW, generator=gen,
                                          temperature=TP_SAMPLE[0], device="cuda").cpu().numpy()
        del params
    torch.cuda.empty_cache()
    return out


def _ep_bytes(plan, b, s, cfg):
    """Phase 12 (c)'s exchanges per step and rank by kind, from the shapes:
    {kind: (exchanges, bytes)}. remat "" recomputes every layer in the
    backward up to the last op whose saved tensors the backward needs: the
    gathers and wo's tp sum again, not the experts' sum over ep nor the
    aux mean after it (the checkpoint's early stop); the fsdp gathers move
    bf16, every sum and reduce-scatter f32."""
    fsdp, tp, ep = plan.get("fsdp", 1), plan.get("tp", 1), plan.get("ep", 1)
    L, d, V, hd = cfg.n_layers, cfg.d_model, cfg.vocab, cfg.head_dim
    h, kv, moe = cfg.n_heads, cfg.kv_heads, cfg.moe_resolved
    e_local, f = moe.n_experts // ep, moe.d_ff
    rows = b // fsdp * s * d * 4  # an f32 activation of the rank's tokens
    attn_w = d * (h + 2 * kv) // tp * hd + h // tp * hd * d  # wqkv and wo blocks after the fsdp gather
    expert = e_local * d * f // tp  # one stack after the fsdp gather
    out = {k: (0, 0) for k in ("gather", "scatter", "tp_sum", "vocab", "ep", "aux", "sum")}
    gathers = scatters = []
    if fsdp > 1:  # per layer: wqkv, wo, three stacks; twice forward, once backward
        gathers = [(10 * L, 2 * L * (attn_w + 3 * expert) * 2), (2, (V * d + d * V // tp) * 2)]
        scatters = [(5 * L, L * (attn_w + 3 * expert) * 4), (2, (V * d + d * V // tp) * 4)]
    if tp > 1:  # the stacks over tp, twice forward
        gathers = gathers + [(6 * L, 2 * L * 3 * e_local * d * f * 2)]
        # wo's sum twice forward, the qkv input's once backward; the unembedding's input
        out["tp_sum"] = (3 * L + 1, (3 * L + 1) * rows)
    out["gather"] = tuple(map(sum, zip((0, 0), *gathers)))
    out["scatter"] = tuple(map(sum, zip((0, 0), *scatters)))
    out["vocab"] = (2, 3 * rows // d) if tp > 1 else (0, 0)
    out["ep"] = (2 * L, 2 * L * rows)  # the sum forward, the tokens' gradient backward
    data = fsdp > 1
    out["aux"] = (L, L * 4) if data else (0, 0)
    router = L * d * moe.n_experts * 4
    # the router's gradient over ep; the replica's: the loss's two values,
    # then the leaves no axis of it cuts (the norms and the router)
    out["sum"] = (1 + 2 * data, router + data * (8 + (2 * L * d + d) * 4 + router))
    return out


def ep_phase(attention, smi, ranks):
    """Phase 12. Returns the launches of its paths by kernel name."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()  # the ranks' memory comes from the same card
    print(f"  the ranks of each run share this one card ({smi}) as processes brought up by "
          "initialize_from_env from the webhook's env names, on gloo, every collective on a CUDA tensor "
          "staged through pinned host memory: the times below prove the path, they are not a "
          "multi-card number", flush=True)
    ckpt_dir = tempfile.mkdtemp(prefix="ep-ckpt-")
    drive = {}
    launched = {}

    def add(path, counts):
        into = launched.setdefault(path, {})
        for kernel, n in counts.items():
            into[kernel] = into.get(kernel, 0) + n

    try:
        ref = {}

        def references():  # here, while the ranks start the job
            t_ref = time.perf_counter()
            ref.update(_tp_decode_reference())
            print(f"  (a) one-process references, while the ranks start the job: {time.perf_counter() - t_ref:.1f} s",
                  flush=True)

        t0 = time.perf_counter()
        got = _spawn_ranks(EP_WORLD, _ep_rank_jobs, "phase 12", ckpt_dir, ("tp2", "fsdp2 x tp2", "shared kv", "ep"),
                           on_agents=lambda ports: drive.update(_drive_agents(ports)), meanwhile=references,
                           ranks=ranks)
        print(f"  {EP_WORLD} ranks on {got[0]['device']}, transport: {got[0]['transport']}; the tp2 "
              f"generate on a mesh over ranks 0-1 of its world; job to results {time.perf_counter() - t0:.1f} s",
              flush=True)
        # each part's results from the ranks of its mesh (tp2's: ranks 0 and 1)
        ranks = {key: [r[key] for r in got if key in r] for key in got[0]}
        for name, plan in TP_DECODE_MESHES.items():
            _check_tp_decode(name, plan, ranks[name], ref, smi)
            for run in ranks[name]:
                add("tp generate", run["launches"])
        del ref
        _check_shared_kv(ranks["shared kv"], smi)
        for run in ranks["shared kv"]:
            add("shared kv f32", run["launches"])
        for name, plan in EP_RUNS.items():
            _check_ep_run(name, plan, ranks[name], smi)
            for run in ranks[name]:
                add("ep train", run["launches"])
        ck = [r["checkpoint"] for r in ranks[EP_CHECKPOINT_RUN]]
        want = {"flash_fwd": 2 * EP_LAYERS, "flash_fwd_scalar": 0, "flash_bwd_dq": EP_LAYERS,
                "flash_bwd_dkv": EP_LAYERS, "flash_bwd_dq_scalar": 0, "flash_bwd_dkv_scalar": 0}
        _check_shard_checkpoint(ck, drive, smi, want)
        saved = {"dir": ckpt_dir, "step": ck[0]["step"], "ref_loss": ck[0]["ref_loss"],
                 "tokens": np.random.default_rng(14).integers(0, MOE_WIDTH["vocab"], EP_BATCH)}
        one = _one_process_restore(saved, smi, _moe_cfg(EP_LAYERS, torch.bfloat16))
        _check_restored("one process", one, [one], ck[0])
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    print(f"  phase 12 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launched


def _ep_rank_jobs(rank, world, port, results, go, ckpt_dir, parts):
    """Phase 12 in one rank: each of `parts` in turn."""
    import torch.distributed as dist

    os.environ.update({"JAX_NUM_PROCESSES": str(world), "JAX_PROCESS_ID": str(rank),
                       "TPU_WORKER_ID": str(rank), "JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}"})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from odh_kubeflow_tpu_torch.parallel import MeshPlan, comm, initialize_from_env

    # gloo: the ranks share one card, and NCCL refuses two ranks on one device
    initialize_from_env(timeout_s=SP_TIMEOUT_S, backend="gloo", device="cuda")
    out = {}
    for part in parts:
        if part in TP_DECODE_MESHES:
            # a mesh over the world's first ranks when the plan needs fewer
            plan = MeshPlan(**TP_DECODE_MESHES[part])
            mesh = plan.build("cuda", ranks=range(plan.n_devices))
            if mesh is not None:
                out[part] = _tp_decode_run(mesh)
            dist.barrier()
            if mesh is None:
                continue
        elif part == "shared kv":
            mesh = MeshPlan(tp=SHARED_TP).build("cuda")
            out[part] = _shared_kv_run(mesh)
        else:
            saved = {}
            for name, plan in EP_RUNS.items():
                mesh = MeshPlan(**plan).build("cuda")
                out[name] = _ep_run(mesh, name == EP_CHECKPOINT_RUN, results, go, ckpt_dir, saved)
        out["device"] = str(mesh.device)
        group = mesh.group("tp")[0] if mesh.sizes["tp"] > 1 else mesh.group("ep")[0]
        out.setdefault("transport", comm.transport(group, mesh.device))
        torch.cuda.empty_cache()
    dist.barrier()
    dist.destroy_process_group()
    return out


def _flash_fwd_vs_plain(b, s, h, d):
    """The flash forward without lse at a tp rank's prefill shape (q/k/v
    strided views of one fused projection, bf16, causal) against its plain
    version: the error over its tolerance."""
    from odh_kubeflow_tpu_torch.ops import attention

    dtype = torch.bfloat16
    q, k, v = inputs(b, s, s, h, h, d, dtype, seed=SP_VISIT_SEED, strided=True)
    out = attention.flash_attention(q, k, v, causal=True, device=q.device)
    ref = attention.flash_attention_plain(q, k, v, causal=True)
    return (out.float() - ref.float()).abs().max().item() / TOLERANCE[dtype]


def _tp_decode_run(mesh):
    """Phase 12 (a) in one rank: the flagship's first-step logits (the
    rank's vocab block) and generate(mesh=)'s tokens, per-token time and
    bytes by kind, in bf16 at 8 layers, then the greedy and sampled tokens
    of the f32 2-layer model."""
    from odh_kubeflow_tpu_torch.models import generate, init_params, shard_params
    from odh_kubeflow_tpu_torch.models.decode import _prefill_parts
    from odh_kubeflow_tpu_torch.ops import attention
    from odh_kubeflow_tpu_torch.parallel import comm

    dev = mesh.device
    tp = mesh.sizes["tp"]
    prompts = torch.as_tensor(_tp_prompts(), device=dev)
    cfg = _serve_cfg(SERVE_LAYERS, torch.bfloat16)
    local = shard_params(init_params(torch.Generator().manual_seed(0), cfg, device=dev), cfg, mesh)
    b, s = TP_PROMPTS
    res = {"shape": f"b{b} s{s} h{cfg.n_heads // tp} hk{cfg.n_heads // tp} d{cfg.head_dim}",
           "visit": _flash_fwd_vs_plain(b, s, cfg.n_heads // tp, cfg.head_dim)}
    with torch.no_grad():
        res["logits"] = _prefill_parts(local, prompts, cfg, s + TP_MAX_NEW, mesh)[0].float().cpu().numpy()
    generate(local, prompts, cfg, 2, mesh=mesh)  # warm-up
    timed = {}
    for n in (1, TP_MAX_NEW):
        attention.reset_launch_counts()
        comm.reset_exchange_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tokens = generate(local, prompts, cfg, n, mesh=mesh)
        torch.cuda.synchronize()
        timed[n] = (time.perf_counter() - t0, dict(comm.exchange_counts), dict(attention.launch_counts))
    res["tokens"] = tokens.cpu().numpy()
    steps = TP_MAX_NEW - 1
    res["token_ms"] = (timed[TP_MAX_NEW][0] - timed[1][0]) * 1e3 / steps
    res["generate_s"] = timed[TP_MAX_NEW][0]
    res["token_bytes"] = {k: (timed[TP_MAX_NEW][1][k + "_bytes"] - timed[1][1][k + "_bytes"]) / steps
                          for k in ("tp_sum", "argmax", "gather", "vocab")}
    res["exchanges"] = timed[TP_MAX_NEW][1]
    res["launches"] = timed[TP_MAX_NEW][2]
    del local
    cfg32 = _serve_cfg(TP_F32_LAYERS, torch.float32)
    local = shard_params(init_params(torch.Generator().manual_seed(0), cfg32, device=dev), cfg32, mesh)
    with torch.no_grad():
        res["f32 logits"] = _prefill_parts(local, prompts, cfg32, s + TP_MAX_NEW, mesh)[0].float().cpu().numpy()
    res["f32"] = generate(local, prompts, cfg32, TP_MAX_NEW, mesh=mesh).cpu().numpy()
    gen = torch.Generator(device=dev).manual_seed(TP_SAMPLE[1])
    res["f32 sampled"] = generate(local, prompts, cfg32, TP_MAX_NEW, generator=gen, temperature=TP_SAMPLE[0],
                                  mesh=mesh).cpu().numpy()
    res["offset"] = mesh.index("tp") * (cfg.vocab // tp)
    return res


def _check_tp_decode(name, plan, runs, ref, smi):
    vocab = ref["bf16 logits"].shape[-1]
    errs, f32_errs = [], []
    for run in runs:
        width = run["logits"].shape[-1]
        want = ref["bf16 logits"][:, run["offset"]:run["offset"] + width]
        errs.append(float(np.abs(run["logits"] - want).max() / np.abs(ref["bf16 logits"]).max()))
        want = ref["f32 logits"][:, run["offset"]:run["offset"] + width]
        f32_errs.append(float(np.abs(run["f32 logits"] - want).max() / np.abs(ref["f32 logits"]).max()))
    first = runs[0]
    same = float((first["tokens"] == ref["bf16"]).mean())
    first_same = float((first["tokens"][:, 0] == ref["bf16"][:, 0]).mean())
    tokens_equal = all(np.array_equal(r["tokens"], first["tokens"]) for r in runs)
    f32_equal = all(np.array_equal(r["f32"], ref["f32"]) for r in runs)
    sampled_equal = all(np.array_equal(r["f32 sampled"], ref["f32 sampled"]) for r in runs)
    n_layers, d = SERVE_LAYERS, SERVE_WIDTH["d_model"]
    want_launches = {"flash_fwd": n_layers, "flash_fwd_scalar": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
                     "flash_bwd_dq_scalar": 0, "flash_bwd_dkv_scalar": 0}
    b = TP_PROMPTS[0]
    want_bytes = {"tp_sum": 2 * n_layers * b * d * 4, "argmax": b * (4 + 8), "gather": 0, "vocab": 0}
    tb = first["token_bytes"]
    print(f"  (a) generate over {name}, the flagship (bf16, {n_layers} layers, vocab block {vocab // plan['tp']} a "
          f"rank), {TP_PROMPTS[0]} prompts of {TP_PROMPTS[1]}, max_new {TP_MAX_NEW}: the flash forward at the "
          f"per-rank prefill {first['shape']} against its plain version, worst "
          f"{max(r['visit'] for r in runs):.3f} of its tolerance; first-step logits against one process, max "
          f"err of the largest {max(errs):.3e} (tol {TP_LOGIT_TOLERANCE:.0e}); first tokens equal "
          f"{first_same:.3f}, all tokens {same:.3f}, every rank the same tokens {tokens_equal}", flush=True)
    print(f"    {first['token_ms']:.2f} ms a token (host clock, rank 0; whole generate "
          f"{first['generate_s']:.2f} s), bytes a token and rank: tp sums {tb['tp_sum']:.0f}, argmax "
          f"{tb['argmax']:.0f}, gathers {tb['gather']:.0f}, vocab {tb['vocab']:.0f} (want {want_bytes}); "
          f"launches per generate and rank {[r['launches'] for r in runs][0]}; f32 {TP_F32_LAYERS} layers: "
          f"logits max err {max(f32_errs):.3e} (tol {SP_GRAD_TOLERANCE:.0e}), greedy tokens equal one process {f32_equal}, sampled "
          f"(T {TP_SAMPLE[0]}, seed {TP_SAMPLE[1]}) equal {sampled_equal} on {smi}", flush=True)
    if not (max(r["visit"] for r in runs) <= 1.0 and max(errs) <= TP_LOGIT_TOLERANCE and tokens_equal
            and max(f32_errs) <= SP_GRAD_TOLERANCE and f32_equal and sampled_equal):
        fail(f"tp generate over {name} disagrees with one process")
    if any(r["launches"] != want_launches for r in runs):
        fail(f"tp generate over {name} launched {[r['launches'] for r in runs]}, want {want_launches}")
    if tb != want_bytes:
        fail(f"tp generate over {name} moved {tb} a token, want {want_bytes}")


def _shared_kv_run(mesh):
    """Phase 12 (b) in one rank: the f32 2-layer flagship with n_kv_heads 2
    over tp 4: the loss and gathered gradients, and greedy tokens, against
    one process (rank 0)."""
    import dataclasses

    from odh_kubeflow_tpu_torch.models import (gather_params, generate, init_params, shard_params,
                                               value_and_grad)
    from odh_kubeflow_tpu_torch.models.tree import tree_leaves, tree_unflatten
    from odh_kubeflow_tpu_torch.ops import attention
    from odh_kubeflow_tpu_torch.parallel import shard_batch

    dev = mesh.device
    cfg = dataclasses.replace(_serve_cfg(SHARED_KV["n_layers"], torch.float32),
                              n_kv_heads=SHARED_KV["n_kv_heads"], remat=True, remat_policy="flash")
    full = init_params(torch.Generator().manual_seed(0), cfg, device=dev)
    tokens = np.random.default_rng(13).integers(0, cfg.vocab, SHARED_BATCH)
    prompts = torch.as_tensor(np.random.default_rng(15).integers(0, cfg.vocab, SHARED_PROMPTS), device=dev)
    res = {}
    if mesh.rank == 0:
        ref = value_and_grad(full, {"tokens": torch.as_tensor(tokens, device=dev)}, cfg)
        ref_tokens = generate(full, prompts, cfg, SHARED_MAX_NEW, device=dev)
    local = shard_params(full, cfg, mesh)
    del full
    attention.reset_launch_counts()
    loss, grads = value_and_grad(local, shard_batch(mesh, {"tokens": tokens}), cfg, mesh)
    torch.cuda.synchronize()
    res["launches"] = dict(attention.launch_counts)
    gathered = tree_leaves(gather_params(tree_unflatten(local, grads), cfg, mesh))
    res["tokens"] = generate(local, prompts, cfg, SHARED_MAX_NEW, mesh=mesh).cpu().numpy()
    res["shape"] = f"b{SHARED_BATCH[0]} s{SHARED_BATCH[1]} h{cfg.n_heads // SHARED_TP} hk1 d{cfg.head_dim} f32"
    if mesh.rank == 0:
        res["loss_err"] = abs((loss - ref[0]) / ref[0]).item()
        res["leaf_err"] = max(_grad_err(g, w) for g, w in zip(gathered, ref[1]))
        res["tokens_equal"] = bool(np.array_equal(res["tokens"], ref_tokens.cpu().numpy()))
    return res


def _check_shared_kv(runs, smi):
    first = runs[0]
    same = all(np.array_equal(r["tokens"], first["tokens"]) for r in runs)
    print(f"  (b) tp {SHARED_TP} with n_kv_heads {SHARED_KV['n_kv_heads']} (each rank 2 q heads and the kv head "
          f"they read, wqkv replicated over tp), the flagship's widths in f32 at {SHARED_KV['n_layers']} layers, "
          f"batch {SHARED_BATCH[0]}x{SHARED_BATCH[1]} (per rank {first['shape']}): loss rel err "
          f"{first['loss_err']:.3e}, gathered grads max err of each leaf's largest {first['leaf_err']:.3e} (tol "
          f"{SP_GRAD_TOLERANCE:.0e}); greedy tokens ({SHARED_PROMPTS[0]} prompts, max_new {SHARED_MAX_NEW}) equal "
          f"one process {first['tokens_equal']}, every rank the same {same}; launches per rank "
          f"{first['launches']} on {smi}", flush=True)
    if not (first["loss_err"] <= SP_GRAD_TOLERANCE and first["leaf_err"] <= SP_GRAD_TOLERANCE
            and first["tokens_equal"] and same):
        fail(f"tp with shared kv heads disagrees with one process: {first}")
    want = {"flash_fwd": 0, "flash_fwd_scalar": SHARED_KV["n_layers"], "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
            "flash_bwd_dq_scalar": SHARED_KV["n_layers"], "flash_bwd_dkv_scalar": SHARED_KV["n_layers"]}
    if any(r["launches"] != want for r in runs):
        fail(f"the shared-kv step launched {[r['launches'] for r in runs]}, want {want}")


def _one_process_vg(params, tokens, cfg, shards):
    """The one-process loss and gradients (f32) of the global batch as a
    mesh with `shards` data shards routes it: each shard's tokens routed
    alone (capacity from its count, as the reference's ep path), the loss
    and gradients averaged over the shards (each counts the same number of
    targets)."""
    from odh_kubeflow_tpu_torch.models import value_and_grad

    loss, grads = 0.0, None
    for part in torch.as_tensor(tokens, device=params["embed"].device).chunk(shards):
        l, g = value_and_grad(params, {"tokens": part}, cfg)
        loss = loss + l.float() / shards
        g = [x.float() / shards for x in g]
        grads = g if grads is None else [a + x for a, x in zip(grads, g)]
        del l
    return loss, grads


def _ep_run(mesh, checkpoint, results, go, ckpt_dir, saved):
    """One run of phase 12 (c) in this rank: the flash calls at the per-rank
    shapes against their plain versions; the f32 2-layer step and the bf16
    warm-up against one process on the same batch (rank 0 holds the
    references; the gradients are gathered); EP_STEPS timed steps; the drop
    rate and dispatch share; with `checkpoint`, the agent's routes."""
    import torch.distributed as dist

    from odh_kubeflow_tpu_torch.models import (adamw, dispatch_only, gather_params, init_params,
                                               make_train_step, routing_stats, shard_params,
                                               train_state_placements, transformer, value_and_grad)
    from odh_kubeflow_tpu_torch.models.tree import tree_leaves, tree_map, tree_unflatten
    from odh_kubeflow_tpu_torch.ops import attention
    from odh_kubeflow_tpu_torch.parallel import comm, shard_batch

    dev = mesh.device
    plan = {a: n for a, n in mesh.sizes.items() if n > 1}
    shards = mesh.size(("dp", "fsdp"))
    tp = mesh.sizes["tp"]
    cfg = _moe_cfg(EP_LAYERS, torch.bfloat16)
    tokens = np.random.default_rng(14).integers(0, cfg.vocab, EP_BATCH)
    local_batch = shard_batch(mesh, {"tokens": tokens})
    b_rank, h_rank = EP_BATCH[0] // shards, cfg.n_heads // tp
    res = {"shape": f"b{b_rank} s{EP_BATCH[1]} h{h_rank} hk{h_rank} d{cfg.head_dim}", "plan": plan}
    res["visits"] = _flash_calls_vs_plain(b_rank, EP_BATCH[1], h_rank, cfg.head_dim)
    # the f32 2-layer step against one process (per leaf)
    cfg32 = _moe_cfg(EP_F32_LAYERS, torch.float32)
    full32 = init_params(torch.Generator().manual_seed(3), cfg32, device=dev)
    if mesh.rank == 0:
        ref32 = _one_process_vg(full32, tokens, cfg32, shards)
    local32 = shard_params(full32, cfg32, mesh)
    del full32
    loss32, grads32 = value_and_grad(local32, local_batch, cfg32, mesh)
    gathered32 = tree_leaves(gather_params(tree_unflatten(local32, grads32), cfg32, mesh))
    if mesh.rank == 0:
        res["f32_loss_err"] = abs((loss32 - ref32[0]) / ref32[0]).item()
        res["f32_leaf_err"] = {n: _grad_err(g, w) for n, g, w in
                               zip(_leaf_names(local32), gathered32, ref32[1])}
        del ref32
    del local32, grads32, gathered32
    torch.cuda.empty_cache()
    # the bf16 model: one-process references (bf16, and f32 for the truth)
    full = init_params(torch.Generator().manual_seed(0), cfg, device=dev)
    names = _leaf_names(full)
    ref = truth = None
    if mesh.rank == 0:
        ref = _one_process_vg(full, tokens, cfg, shards)
        full32 = tree_map(lambda t: t.float(), full)
        truth = _one_process_vg(full32, tokens, _moe_cfg(EP_LAYERS, torch.float32), shards)
        del full32
        torch.cuda.empty_cache()
    params = shard_params(full, cfg, mesh)
    del full
    opt = adamw()
    state = opt.init(params)
    step, _ = make_train_step(cfg, opt, mesh)
    first, grads = value_and_grad(params, local_batch, cfg, mesh)
    gathered = tree_leaves(gather_params(tree_unflatten(params, grads), cfg, mesh))
    if mesh.rank == 0:
        largest = max(w.abs().max().item() for w in truth[1])
        res["loss_err"] = abs((first - ref[0]) / ref[0]).item()
        res["ref_loss"] = ref[0].item()
        # the bf16 losses' distances from the f32 one's
        res["loss_truth_errs"] = (abs((first - truth[0]) / truth[0]).item(),
                                  abs((ref[0] - truth[0]) / truth[0]).item())
        res["grad_err"] = max(_grad_err(g, w, largest) for g, w in zip(gathered, ref[1]))
        res["grad_truth_err"] = max(_grad_err(g, w, largest) for g, w in zip(gathered, truth[1]))
        res["ref_truth_err"] = max(_grad_err(g, w, largest) for g, w in zip(ref[1], truth[1]))
        res["bf16_leaf_gaps"] = {n: (_grad_err(g, t), _grad_err(r, t), _grad_err(g, r))
                                 for n, g, r, t in zip(names, gathered, ref[1], truth[1])}
    del gathered, ref, truth
    opt.update_(tree_unflatten(params, grads), state, params)
    del grads
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    attention.reset_launch_counts()
    comm.reset_exchange_counts()
    losses = [first]
    t0 = time.perf_counter()
    syncs = count_sync_warnings(lambda: losses.extend(
        step(params, state, local_batch)[2] for _ in range(EP_STEPS)))
    torch.cuda.synchronize()
    res.update({
        "step_ms": (time.perf_counter() - t0) * 1e3 / EP_STEPS,
        "launches": dict(attention.launch_counts),
        "exchanges": dict(comm.exchange_counts),
        "syncs": syncs,
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        "losses": torch.stack(losses).tolist(),
    })
    # routing at layer 0's inputs of the rank's tokens: the drop rate, and
    # routing + dispatch + combine of every expert's picks alone (the
    # rank's own experts' are a part of it): the dispatch share's bound
    with torch.no_grad():
        x0 = comm.gather_shards(params["embed"], mesh.group("fsdp")[0], 1)[local_batch["tokens"]]
        router0 = {"router": params["layers"]["router"][0]}
        res["drop_rate"] = routing_stats(x0, router0, cfg.moe_resolved)["drop_rate"].item()
        res["dispatch_ms"] = time_ms(lambda: dispatch_only(x0, router0, cfg.moe_resolved), runs=5, reps=3)
    del x0
    train_state = {"params": params, "opt_state": state}
    placements = train_state_placements(cfg, mesh)
    res["replicas"] = _replicas(train_state, placements, mesh)
    if checkpoint:
        res["checkpoint"] = _checkpoint_through_agent(mesh, cfg, step, opt, train_state, placements, local_batch,
                                                      results, go, ckpt_dir, saved)
    del params, state, train_state
    torch.cuda.empty_cache()
    return res


def _check_ep_run(name, plan, runs, smi):
    first = runs[0]
    cfg = _moe_cfg(EP_LAYERS, torch.bfloat16)
    worst = {}
    for r, run in enumerate(runs):
        for kernel, causal, err in run["visits"]:
            worst[kernel] = max(worst.get(kernel, 0.0), err)
    print(f"  (c) {name}, per rank {first['shape']} (strided views): "
          f"{sum(len(run['visits']) for run in runs)} flash calls against their plain versions; worst error "
          f"over its tolerance " + ", ".join(f"{k} {e:.3f}" for k, e in sorted(worst.items())), flush=True)
    if set(worst) != {"fwd", "dq", "dkv"} or not max(worst.values()) <= 1.0:
        fail(f"{name}: the flash calls disagree with their plain versions: {worst}")
    want = {"flash_fwd": 2 * EP_LAYERS, "flash_fwd_scalar": 0, "flash_bwd_dq": EP_LAYERS,
            "flash_bwd_dkv": EP_LAYERS, "flash_bwd_dq_scalar": 0, "flash_bwd_dkv_scalar": 0}
    for r, run in enumerate(runs):
        per_step = {n: c / EP_STEPS for n, c in run["launches"].items()}
        if per_step != want:
            fail(f"{name}: rank {r} launched {per_step} per step, want {want}")
    losses = first["losses"]
    print(f"  train {name}, the MoE of bench.py:389-400, global batch {EP_BATCH[0]}x{EP_BATCH[1]}, remat '': "
          f"losses {', '.join(f'{x:.4f}' for x in losses)} (warm-up first); against one process on the same "
          f"batch (each data shard routed alone, as the ep path routes it): f32 {EP_F32_LAYERS} layers loss rel "
          f"err {first['f32_loss_err']:.3e}, gathered grads max err of each leaf's largest "
          f"{max(first['f32_leaf_err'].values()):.3e} (tol {SP_GRAD_TOLERANCE:.0e}); bf16 loss "
          f"{first['ref_loss']:.4f} rel err {first['loss_err']:.3e} (tol {SP_LOSS_TOLERANCE:.0e}; from the f32 "
          f"loss: sharded {first['loss_truth_errs'][0]:.3e}, one process {first['loss_truth_errs'][1]:.3e}), grads max "
          f"err of the largest {first['grad_err']:.3e}; from the f32 gradients: sharded bf16 "
          f"{first['grad_truth_err']:.3e}, one-process bf16 {first['ref_truth_err']:.3e} (tol: the one-process "
          f"+ {BF16_ULP:.2e})", flush=True)
    print("    per leaf, of its own largest: f32 sharded from f32 one process; bf16 sharded from f32, bf16 one "
          "process from f32, bf16 sharded from bf16 one process: "
          + "; ".join(f"{n} {first['f32_leaf_err'][n]:.2e}; " + ", ".join(f"{x:.2e}" for x in gaps)
                      for n, gaps in first["bf16_leaf_gaps"].items()), flush=True)
    want_bytes = _ep_bytes(plan, *EP_BATCH, cfg)
    got_bytes = {k: (first["exchanges"][k] // EP_STEPS, first["exchanges"][k + "_bytes"] // EP_STEPS)
                 for k in want_bytes}
    print(f"    step {max(run['step_ms'] for run in runs):.1f} ms (host clock, slowest rank; per rank "
          f"{[round(run['step_ms'], 1) for run in runs]}); peak memory per rank GB "
          f"{[round(run['peak_gb'], 2) for run in runs]}; per step and rank, (exchanges, bytes) by kind "
          f"{got_bytes} (from the shapes {want_bytes}); host waits of the staged transport "
          f"{[run['exchanges']['host_waits'] // EP_STEPS for run in runs]}, the host's ms in them waiting for "
          f"the device {[round(run['exchanges']['device_wait_s'] * 1e3 / EP_STEPS, 1) for run in runs]} and in "
          f"the transfers {[round(run['exchanges']['transfer_s'] * 1e3 / EP_STEPS, 1) for run in runs]}; host "
          f"syncs in {EP_STEPS} steps (sync debug mode) {[run['syncs'] for run in runs]}; tensor-core launches "
          f"per step and rank {want}", flush=True)
    step_ms = max(run["step_ms"] for run in runs)
    print(f"    drop rate at layer 0's inputs per rank {[round(run['drop_rate'], 4) for run in runs]}; "
          f"dispatch_only at a rank's tokens (all experts' picks) {first['dispatch_ms']:.4f} ms: dispatch "
          f"share bound 3 x {EP_LAYERS} x {first['dispatch_ms']:.4f} / {step_ms:.1f} ms = "
          f"{3 * EP_LAYERS * first['dispatch_ms'] / step_ms:.2%} on {smi}", flush=True)
    if not (first["f32_loss_err"] <= SP_RING_TOLERANCE
            and max(first["f32_leaf_err"].values()) <= SP_GRAD_TOLERANCE
            and first["loss_err"] <= SP_LOSS_TOLERANCE
            and first["grad_truth_err"] <= first["ref_truth_err"] + BF16_ULP):
        fail(f"the ep step ({name}) disagrees with one process: "
             f"{ {k: v for k, v in first.items() if k not in ('replicas', 'visits', 'checkpoint')} }")
    if got_bytes != want_bytes:
        fail(f"{name}: exchanges per step {got_bytes}, want from the shapes {want_bytes}")
    bad = []
    for leaf in first["replicas"]:
        blocks = {}
        for run in runs:
            coords, digest = run["replicas"][leaf]
            blocks.setdefault(coords, set()).add(digest)
        bad += [leaf for d in blocks.values() if len(d) != 1]
    print(f"    replicated leaves bit-equal across the ranks that hold them: "
          f"{len(first['replicas']) - len(set(bad))} of {len(first['replicas'])} leaves", flush=True)
    if bad:
        fail(f"{name}: replicated leaves differ across ranks: {sorted(set(bad))}")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        fail(f"{name}: train losses not finite and falling: {losses}")
    if any(run["syncs"] for run in runs):
        fail(f"{name}: host syncs inside the steps: {[run['syncs'] for run in runs]}")



# ---------------------------------------------------------------------------
# Phase 13: the pipelines (GPipe, 1F1B, interleaved 1F1B) over a pp axis,
# ranks spawned on this one card
# ---------------------------------------------------------------------------

PP_WORLD = 4
PP_STEPS = 1  # timed steps after the warm-up (2 until the smoke needed the time)
PP_BATCH = (8, 2048)  # the dense and MoE runs' global batch
PP_MICRO = 4
PP_LAYERS = 4  # (c)'s and the memory steps' depth of the flagship's 8 layers (interleaved pp 2 x v 2 needs 4)
# (c) name -> (plan, config, schedule, n_chunks, global batch, n_micro): the
# flagship (phase 6) and phase 8's MoE, PP_LAYERS layers, bf16; the sp run takes
# phase 10's 2 x 8192 zigzag, whose 2 sequences make 2 microbatches
PP_RUNS = {
    "1f1b pp2 x tp2": ({"pp": 2, "tp": 2}, "dense", "1f1b", 1, PP_BATCH, PP_MICRO),
    "interleaved 1f1b pp2 x fsdp2": ({"fsdp": 2, "pp": 2}, "dense", "1f1b", 2, PP_BATCH, PP_MICRO),
    "1f1b pp2 x ep2 moe": ({"pp": 2, "ep": 2}, "moe", "1f1b", 1, PP_BATCH, PP_MICRO),
    "gpipe pp2 x sp2 zigzag": ({"pp": 2, "sp": 2}, "zigzag", "gpipe", 1, SP_BATCH, 2),
}
PP_CHECKPOINT_RUN = "1f1b pp2 x tp2"  # the run whose state goes through the agents' routes
# (b) f32 at 2 layers (4 for v 2), batch 8 x 512: name -> (plan, schedule, n_chunks)
PP_F32_RUNS = {
    "gpipe pp2 x tp2": ({"pp": 2, "tp": 2}, "gpipe", 1),
    "1f1b pp2 x tp2": ({"pp": 2, "tp": 2}, "1f1b", 1),
    "interleaved 1f1b pp2 x tp2": ({"pp": 2, "tp": 2}, "1f1b", 2),
    "interleaved 1f1b pp2 x fsdp2": ({"fsdp": 2, "pp": 2}, "1f1b", 2),
}
PP_F32_BATCH = (8, 512)
# peak memory per rank, GPipe against 1F1B at pp 2 x tp 2 (the flagship, bf16)
PP_MEMORY_MICRO = (4, 8)
PP_KINDS = ("pp", "pp_bcast", "pp_sum", "gather", "scatter", "tp_sum", "vocab", "ep", "aux", "sum")


def _pp_cfg(name, layers, dtype):
    """Phase 13's configurations: the flagship (phase 6's widths), its
    zigzag sp form, and phase 8's MoE."""
    import dataclasses

    if name == "moe":
        return _moe_cfg(layers, dtype)
    cfg = _shard_cfg({}, "contiguous")
    cfg = dataclasses.replace(cfg, n_layers=layers, dtype=dtype, remat=False, remat_policy="")
    if name == "zigzag":
        cfg = dataclasses.replace(cfg, seq_axis="sp", seq_layout="zigzag")
    return cfg


def _pp_bytes(plan, schedule, n_chunks, batch, cfg, n_micro, stage):
    """The exchanges of one pipeline step of the rank at pipeline stage
    `stage`, by kind, from the shapes: {kind: (exchanges, bytes)} (the ring
    of sp inside the stages is not counted here). Per layer visit (each of
    a stage's layers once per microbatch; 1F1B runs its forward twice, the
    forward visit and the recompute): under the stages' tp the
    row-parallel sums forward and the column-parallel inputs' gradients
    (2 and 2 dense, 1 and 1 MoE), under ep the experts' sum and the
    tokens' gradient, in f32. The hops: every visit's output goes on but
    the last virtual stage's, every visit's input cotangent back but the
    first's. GPipe broadcasts the output (every stage runs the head), 1F1B
    runs the head per microbatch on the last stage; the head's input
    gradient (tp_sum) and the vocab-parallel loss's max and sums. fsdp:
    the stage's dense weights gathered once a step and reduce-scattered
    once, the embedding on the first stage and the unembedding where the
    head runs. Over pp one sum of what one stage computed; over the data
    axes the loss's and the gradients' sums (`_sum_grads`), over ep the
    router's."""
    g = {a: plan.get(a, 1) for a in ("dp", "fsdp", "pp", "ep", "tp", "sp")}
    S, fsdp, tp, ep = g["pp"], g["fsdp"], g["tp"], g["ep"]
    first, last, gpipe = stage == 0, stage == S - 1, schedule == "gpipe"
    B, s = batch[0] // (g["dp"] * fsdp), batch[1] // g["sp"]
    m, mb = n_micro, batch[0] // (g["dp"] * fsdp) // n_micro
    d, V, h, kv, hd, f = cfg.d_model, cfg.vocab, cfg.n_heads, cfg.kv_heads, cfg.head_dim, cfg.d_ff
    A = torch.empty((), dtype=cfg.dtype).element_size()
    Ls = cfg.n_layers // S
    moe = cfg.moe_resolved
    t = tp if tp > 1 and h % tp == 0 and kv % tp == 0 and (moe is not None or f % tp == 0) else 1
    rows, visits = mb * s * d, m * Ls
    out = {k: [0, 0] for k in PP_KINDS}

    def add(kind, n, nbytes):
        out[kind][0] += n
        out[kind][1] += nbytes

    hops = 2 * m * n_chunks - (m if last else 0) - (m if first else 0)
    add("pp", hops, hops * rows * A)
    heads = [B] if gpipe else [mb] * m if last else []
    if gpipe:
        add("pp_bcast", 1, B * s * d * A)
    gathered = [Ls * d * (h + 2 * kv) // t * hd, Ls * (h // t) * hd * d]
    if moe is None:
        gathered += [Ls * d * f // t] * 2 + [Ls * f // t * d]
    if fsdp > 1:
        add("gather", len(gathered), sum(gathered) * A)
        add("scatter", len(gathered), sum(gathered) * 4)
        if first:
            add("gather", 1, V * d * A)
            add("scatter", 1, V * d * 4)
        if heads:
            add("gather", 1, d * V // tp * A)
            add("scatter", 1, d * V // tp * 4)
    emb = V * d // fsdp
    add("pp_sum", 1, ((1 + emb) if gpipe else (2 + emb + d + d * V // (fsdp * tp))) * 4)
    per_visit = (2, 2) if moe is None else (1, 1)
    if t > 1:
        n = visits * (sum(per_visit) if gpipe else 2 * per_visit[0] + per_visit[1])
        add("tp_sum", n, n * rows * 4)
    if tp > 1:
        for bh in heads:
            add("tp_sum", 1, bh * s * d * 4)
            add("vocab", 2, 3 * bh * s * 4)
    # this rank's leaves: (elements, cut over fsdp)
    leaves = [(V * d // fsdp, fsdp > 1), (d, False), (d * V // (fsdp * tp), fsdp > 1), (Ls * d, False),
              (Ls * d, False)] + [(n // fsdp, fsdp > 1) for n in gathered]
    if moe is not None:
        e = moe.n_experts
        leaves += [(Ls * d * e, False)] + [(Ls * e // ep * d * moe.d_ff, False)] * 3
        if ep > 1:
            n = visits * (2 if gpipe else 3)
            add("ep", n, n * rows * 4)
            add("sum", 1, Ls * d * e * 4)
    if g["dp"] * fsdp * g["sp"] > 1:
        add("sum", 1, 8)  # the loss's sums over the data axes
        if gpipe and moe is not None:
            add("aux", 1, 4)
        add("sum", 1, sum(n for n, cut in leaves if not cut) * 4)
    if g["dp"] * g["sp"] > 1 and fsdp > 1:
        add("sum", 1, sum(n for n, cut in leaves if cut) * 4)
    return {k: tuple(v) for k, v in out.items()}


def pp_phase(attention, smi, ranks):
    """Phase 13. Returns the launches of its paths by kernel name."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()  # the ranks' memory comes from the same card
    print(f"  the {PP_WORLD} ranks of each run share this one card ({smi}) as processes brought up by "
          "initialize_from_env from the webhook's env names, on gloo, every stage hop and collective on a "
          "CUDA tensor staged through pinned host memory: the stages take turns on the device, so the "
          "times below prove the path, they are not a multi-card number", flush=True)
    ckpt_dir = tempfile.mkdtemp(prefix="pp-ckpt-")
    drive = {}
    launched = {}

    def add(path, counts):
        into = launched.setdefault(path, {})
        for kernel, n in counts.items():
            into[kernel] = into.get(kernel, 0) + n

    try:
        t0 = time.perf_counter()
        got = _spawn_ranks(PP_WORLD, _pp_rank_jobs, "phase 13", ckpt_dir,
                           on_agents=lambda ports: drive.update(_drive_agents(ports)), ranks=ranks)
        print(f"  {PP_WORLD} ranks on {got[0]['device']}, transport: {got[0]['transport']}; job to results "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        ranks = {key: [r[key] for r in got] for key in got[0]}
        for name, (plan, schedule, v) in PP_F32_RUNS.items():
            _check_pp_f32(name, plan, schedule, v, ranks["f32 " + name], smi)
            for run in ranks["f32 " + name]:
                add("pp f32 exactness", run["launches"])
        for name, spec in PP_RUNS.items():
            _check_pp_run(name, spec, ranks[name], smi)
            for run in ranks[name]:
                add("pp train", run["launches"])
        _check_pp_memory(ranks["memory"], smi)
        for run in ranks["memory"]:
            add("pp memory", run["launches"])
        ck = [r["checkpoint"] for r in ranks[PP_CHECKPOINT_RUN]]
        n = PP_MICRO * PP_LAYERS // 2
        _check_shard_checkpoint(ck, drive, smi, {"flash_fwd": 2 * n, "flash_fwd_scalar": 0, "flash_bwd_dq": n,
                                                 "flash_bwd_dkv": n, "flash_bwd_dq_scalar": 0,
                                                 "flash_bwd_dkv_scalar": 0})
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    print(f"  phase 13 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launched


def _pp_rank_jobs(rank, world, port, results, go, ckpt_dir):
    """Phase 13 in one rank: the f32 runs, the full-width runs (the
    checkpoint through the agent's routes in one), the memory runs."""
    import torch.distributed as dist

    os.environ.update({"JAX_NUM_PROCESSES": str(world), "JAX_PROCESS_ID": str(rank),
                       "TPU_WORKER_ID": str(rank), "JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}"})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from odh_kubeflow_tpu_torch.parallel import MeshPlan, comm, initialize_from_env

    # gloo: the ranks share one card, and NCCL refuses two ranks on one device
    initialize_from_env(timeout_s=SP_TIMEOUT_S, backend="gloo", device="cuda")
    out, saved = {}, {}
    for name, (plan, schedule, v) in PP_F32_RUNS.items():
        mesh = MeshPlan(**plan).build("cuda")
        out["f32 " + name] = _pp_f32_run(mesh, schedule, v)
        torch.cuda.empty_cache()
    for name, (plan, cfg_name, schedule, v, batch, n_micro) in PP_RUNS.items():
        mesh = MeshPlan(**plan).build("cuda")
        out[name] = _pp_run(mesh, cfg_name, schedule, v, batch, n_micro, name == PP_CHECKPOINT_RUN, results, go,
                            ckpt_dir, saved)
        torch.cuda.empty_cache()
    mesh = MeshPlan(pp=2, tp=2).build("cuda")
    out["memory"] = _pp_memory(mesh)
    out["device"] = str(mesh.device)
    out["transport"] = comm.transport(mesh.group("pp")[0], mesh.device)
    dist.barrier()
    dist.destroy_process_group()
    return out


def _pp_vg(schedule):
    from odh_kubeflow_tpu_torch.models import pp_1f1b_value_and_grad, pp_value_and_grad

    return pp_1f1b_value_and_grad if schedule == "1f1b" else pp_value_and_grad


def _pp_f32_run(mesh, schedule, v):
    """Phase 13 (b) in one rank: the f32 flagship at 2 layers (4 for v 2)
    through the pipeline against one process on the same batch (rank 0):
    the loss and each gathered gradient leaf (in the pipeline layout), and
    the launches of the step."""
    from odh_kubeflow_tpu_torch.models import (gather_params, init_params, shard_params, to_pp_params,
                                               value_and_grad)
    from odh_kubeflow_tpu_torch.models.tree import tree_leaves, tree_unflatten
    from odh_kubeflow_tpu_torch.ops import attention
    from odh_kubeflow_tpu_torch.parallel import shard_batch

    cfg = _pp_cfg("dense", 2 * v, torch.float32)
    full = init_params(torch.Generator().manual_seed(3), cfg, device=mesh.device)
    tokens = np.random.default_rng(15).integers(0, cfg.vocab, PP_F32_BATCH)
    res = {}
    if mesh.rank == 0:
        loss, grads = value_and_grad(full, {"tokens": torch.as_tensor(tokens, device=mesh.device)}, cfg)
        ref = (loss, tree_leaves(to_pp_params(tree_unflatten(full, grads), 2, cfg, mesh, v)))
        del grads
    staged = to_pp_params(full, 2, cfg, mesh, v)
    local, names = shard_params(staged, cfg, mesh), _leaf_names(staged)
    del full, staged
    attention.reset_launch_counts()
    loss, grads = _pp_vg(schedule)(local, shard_batch(mesh, {"tokens": tokens}), cfg, mesh, PP_MICRO, v)
    torch.cuda.synchronize()
    res["launches"] = dict(attention.launch_counts)
    gathered = tree_leaves(gather_params(tree_unflatten(local, grads), cfg, mesh))
    if mesh.rank == 0:
        res["loss_err"] = abs((loss - ref[0]) / ref[0]).item()
        res["leaf_err"] = {n: _grad_err(g, w) for n, g, w in zip(names, gathered, ref[1])}
    return res


def _check_pp_f32(name, plan, schedule, v, runs, smi):
    first = runs[0]
    layers = 2 * v
    n = PP_MICRO * layers // 2
    want = {"flash_fwd": 0, "flash_fwd_scalar": n * (2 if schedule == "1f1b" else 1), "flash_bwd_dq": 0,
            "flash_bwd_dkv": 0, "flash_bwd_dq_scalar": n, "flash_bwd_dkv_scalar": n}
    print(f"  (b) f32 {name} (v {v}, {layers} layers, global batch {PP_F32_BATCH[0]}x{PP_F32_BATCH[1]}, n_micro "
          f"{PP_MICRO}) against one process: loss rel err {first['loss_err']:.3e}, gathered grads max err of "
          f"each leaf's largest {max(first['leaf_err'].values()):.3e} (tol {SP_GRAD_TOLERANCE:.0e}; worst leaf "
          f"{max(first['leaf_err'], key=first['leaf_err'].get)}); scalar launches per rank "
          f"{[r['launches'] for r in runs][0]} on {smi}", flush=True)
    if not (first["loss_err"] <= SP_GRAD_TOLERANCE and max(first["leaf_err"].values()) <= SP_GRAD_TOLERANCE):
        fail(f"the f32 pipeline ({name}) disagrees with one process: {first}")
    if any(r["launches"] != want for r in runs):
        fail(f"the f32 pipeline ({name}) launched {[r['launches'] for r in runs]}, want {want} per rank")


def _pp_batch(cfg_name, batch, mesh):
    """The run's global batch (zigzag-ordered for the zigzag run), this
    rank's shard of it, and the natural-order tokens."""
    from odh_kubeflow_tpu_torch.models import make_zigzag_batch
    from odh_kubeflow_tpu_torch.parallel import shard_batch

    tokens = np.random.default_rng(16).integers(0, FULL_WIDTH["vocab"], batch)
    if cfg_name == "zigzag":
        glob = {k: t.numpy() for k, t in make_zigzag_batch(tokens, mesh.sizes["sp"]).items()}
    else:
        glob = {"tokens": tokens}
    return shard_batch(mesh, glob), tokens


def _pp_one_process_loss(full, tokens, cfg, n_micro):
    """The one-process loss of the run's global batch (natural order, no
    mesh): the dense model's on the whole batch, the MoE model's averaged
    over the microbatches each routed alone (the pipeline's capacity)."""
    import dataclasses

    from odh_kubeflow_tpu_torch.models import loss_fn

    cfg = dataclasses.replace(cfg, seq_axis="", seq_layout="contiguous")
    parts = torch.as_tensor(tokens, device=full["embed"].device).chunk(n_micro if cfg.moe is not None else 1)
    with torch.no_grad():
        return sum(loss_fn(full, {"tokens": p}, cfg).float() for p in parts).item() / len(parts)


def _pp_run(mesh, cfg_name, schedule, v, batch, n_micro, checkpoint, results, go, ckpt_dir, saved):
    """One full-width run of phase 13 (c) in this rank: the flash calls at
    the per-rank shapes against their plain versions; the warm-up loss
    against one process (rank 0); PP_STEPS timed steps; with
    `checkpoint`, the agent's routes."""
    import torch.distributed as dist

    from odh_kubeflow_tpu_torch.models import (init_params, make_pp_train_step, pp_train_state_placements,
                                               shard_params, to_pp_params)
    from odh_kubeflow_tpu_torch.ops import attention
    from odh_kubeflow_tpu_torch.parallel import comm

    cfg = _pp_cfg(cfg_name, PP_LAYERS, torch.bfloat16)
    plan = {a: n for a, n in mesh.sizes.items() if n > 1}
    local_batch, tokens = _pp_batch(cfg_name, batch, mesh)
    tp_stage = mesh.sizes["tp"]
    mb = batch[0] // mesh.size(("dp", "fsdp")) // n_micro
    h = cfg.n_heads // tp_stage
    res = {"plan": plan, "stage": mesh.coords["pp"]}
    if cfg.seq_axis:
        res["shape"] = f"b{mb} s{batch[1] // mesh.sizes['sp']} h{h} d{cfg.head_dim} (zigzag half-pairs)"
        res["visits"] = _ring_visits_vs_plain(mesh, "zigzag", b=mb, s=batch[1], h=h)
    else:
        res["shape"] = f"b{mb} s{batch[1]} h{h} hk{h} d{cfg.head_dim}"
        res["visits"] = _flash_calls_vs_plain(mb, batch[1], h, cfg.head_dim)
    full = init_params(torch.Generator().manual_seed(0), cfg, device=mesh.device)
    if mesh.rank == 0:
        res["ref_loss"] = _pp_one_process_loss(full, tokens, cfg, n_micro)
    local = shard_params(to_pp_params(full, 2, cfg, mesh, v), cfg, mesh)
    del full
    torch.cuda.empty_cache()
    step, opt = make_pp_train_step(cfg, mesh, n_micro, schedule=schedule, n_chunks=v)
    state = opt.init(local)
    first = step(local, state, local_batch)[2]
    if mesh.rank == 0:
        res["loss_err"] = abs(first.item() - res["ref_loss"]) / abs(res["ref_loss"])
    torch.cuda.synchronize()
    dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    attention.reset_launch_counts()
    comm.reset_exchange_counts()
    losses = [first]
    t0 = time.perf_counter()
    syncs = count_sync_warnings(lambda: losses.extend(step(local, state, local_batch)[2] for _ in range(PP_STEPS)))
    torch.cuda.synchronize()
    res.update({
        "step_ms": (time.perf_counter() - t0) * 1e3 / PP_STEPS,
        "launches": dict(attention.launch_counts),
        "exchanges": dict(comm.exchange_counts),
        "syncs": syncs,
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        "losses": torch.stack(losses).float().tolist(),
    })
    train_state = {"params": local, "opt_state": state}
    placements = pp_train_state_placements(cfg, mesh, v)
    res["replicas"] = _replicas(train_state, placements, mesh)
    if checkpoint:
        res["checkpoint"] = _checkpoint_through_agent(
            mesh, cfg, step, opt, train_state, placements, local_batch, results, go, ckpt_dir, saved,
            layout=lambda params: to_pp_params(params, 2, cfg, mesh, v))
    del local, state, train_state
    torch.cuda.empty_cache()
    return res


def _check_pp_run(name, spec, runs, smi):
    from odh_kubeflow_tpu_torch.ops.ring_attention import ring_launches

    plan, cfg_name, schedule, v, batch, n_micro = spec
    first = runs[0]
    cfg = _pp_cfg(cfg_name, PP_LAYERS, torch.bfloat16)
    worst = {}
    for run in runs:
        for kernel, causal, err in run["visits"]:
            key = (kernel, "causal" if causal else "full")
            worst[key] = max(worst.get(key, 0.0), err)
    print(f"  (a) {name}, per rank {first['shape']} (strided views): "
          f"{sum(len(run['visits']) for run in runs)} flash calls against their plain versions; worst error "
          f"over its tolerance " + ", ".join(f"{k} {c} {e:.3f}" for (k, c), e in sorted(worst.items())),
          flush=True)
    if {k for k, _ in worst} != {"fwd", "dq", "dkv"} or not max(worst.values()) <= 1.0:
        fail(f"{name}: the flash calls disagree with their plain versions: {worst}")
    S = plan["pp"]
    calls = n_micro * cfg.n_layers // S * (ring_launches(plan["sp"], "zigzag")[0] if cfg.seq_axis else 1)
    want = {"flash_fwd": calls * (2 if schedule == "1f1b" else 1), "flash_fwd_scalar": 0, "flash_bwd_dq": calls,
            "flash_bwd_dkv": calls, "flash_bwd_dq_scalar": 0, "flash_bwd_dkv_scalar": 0}
    for r, run in enumerate(runs):
        per_step = {k: c / PP_STEPS for k, c in run["launches"].items()}
        if per_step != want:
            fail(f"{name}: rank {r} launched {per_step} per step, want {want}")
    losses = first["losses"]
    what = "averaged over its microbatches each routed alone" if cfg.moe is not None else "on the whole batch"
    print(f"  (c) train {name} (v {v}, n_micro {n_micro}, {PP_LAYERS} layers bf16), global batch {batch[0]}x{batch[1]}: "
          f"losses {', '.join(f'{x:.4f}' for x in losses)} (warm-up first); one process {what}: "
          f"{first['ref_loss']:.4f}, rel err {first['loss_err']:.3e} (tol {SP_LOSS_TOLERANCE:.0e}); "
          f"tensor-core launches per step and rank {want}", flush=True)
    kinds = [k for k in PP_KINDS]
    got = {}
    for run in runs:
        want_b = _pp_bytes(plan, schedule, v, batch, cfg, n_micro, run["stage"])
        got_b = {k: (run["exchanges"][k] // PP_STEPS, run["exchanges"][k + "_bytes"] // PP_STEPS) for k in kinds}
        got[run["stage"]] = (got_b, want_b)
        if got_b != want_b:
            fail(f"{name}: stage {run['stage']} exchanged {got_b} per step, want from the shapes {want_b}")
    bubble = (S - 1) / (n_micro * v + S - 1)
    print(f"    step {max(run['step_ms'] for run in runs):.1f} ms (host clock, slowest rank; per rank "
          f"{[round(run['step_ms'], 1) for run in runs]}); peak memory per rank GB "
          f"{[round(run['peak_gb'], 2) for run in runs]}; per step and rank, (exchanges, bytes) by kind, equal "
          f"to the count from the shapes: " + "; ".join(f"stage {st}: {b[0]}" for st, b in sorted(got.items()))
          + f"; ring (sp, not gated) {[(run['exchanges']['ring'] // PP_STEPS, run['exchanges']['ring_bytes'] // PP_STEPS) for run in runs]}",
          flush=True)
    print(f"    per rank, the share of the step the host spent in the stage hops and the broadcast (waiting "
          f"for a neighbour or the transfer) "
          f"{[round(run['exchanges']['pp_s'] * 1e3 / PP_STEPS / run['step_ms'], 3) for run in runs]} against "
          f"the bubble (S-1)/(m*v+S-1) = {bubble:.3f}; in gloo transfers of every kind "
          f"{[round(run['exchanges']['transfer_s'] * 1e3 / PP_STEPS / run['step_ms'], 3) for run in runs]}, "
          f"waiting for the device to hand over staged payloads "
          f"{[round(run['exchanges']['device_wait_s'] * 1e3 / PP_STEPS / run['step_ms'], 3) for run in runs]}; "
          f"host syncs in {PP_STEPS} steps (sync debug mode) {[run['syncs'] for run in runs]} on {smi}",
          flush=True)
    if not first["loss_err"] <= SP_LOSS_TOLERANCE:
        fail(f"{name}: the warm-up loss {losses[0]} is not within {SP_LOSS_TOLERANCE} of one process's "
             f"{first['ref_loss']}")
    bad = []
    for leaf in first["replicas"]:
        blocks = {}
        for run in runs:
            coords, digest = run["replicas"][leaf]
            blocks.setdefault(coords, set()).add(digest)
        bad += [leaf for d in blocks.values() if len(d) != 1]
    print(f"    replicated leaves bit-equal across the ranks that hold them: "
          f"{len(first['replicas']) - len(set(bad))} of {len(first['replicas'])} leaves", flush=True)
    if bad:
        fail(f"{name}: replicated leaves differ across ranks: {sorted(set(bad))}")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        fail(f"{name}: train losses not finite and falling: {losses}")
    if any(run["syncs"] for run in runs):
        fail(f"{name}: host syncs inside the steps: {[run['syncs'] for run in runs]}")


def _pp_memory(mesh):
    """Peak memory of one step per rank, GPipe against 1F1B, at each of
    PP_MEMORY_MICRO microbatch counts (the flagship, bf16, pp 2 x tp 2,
    global batch 8 x 2048), and the launches of those steps."""
    from odh_kubeflow_tpu_torch.models import init_params, make_pp_train_step, shard_params, to_pp_params
    from odh_kubeflow_tpu_torch.ops import attention

    cfg = _pp_cfg("dense", PP_LAYERS, torch.bfloat16)
    local_batch, _ = _pp_batch("dense", PP_BATCH, mesh)
    local = shard_params(to_pp_params(init_params(torch.Generator().manual_seed(0), cfg, device=mesh.device), 2,
                                      cfg, mesh), cfg, mesh)
    out = {"peak_gb": {}}
    attention.reset_launch_counts()
    for schedule in ("gpipe", "1f1b"):
        for m in PP_MEMORY_MICRO:
            step, opt = make_pp_train_step(cfg, mesh, m, schedule=schedule)
            state = opt.init(local)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            step(local, state, local_batch)
            torch.cuda.synchronize()
            out["peak_gb"][f"{schedule} n_micro {m}"] = torch.cuda.max_memory_allocated() / 1e9
            del state
    out["launches"] = dict(attention.launch_counts)
    return out


def _check_pp_memory(runs, smi):
    print(f"  peak memory of one step per rank GB, the flagship at pp 2 x tp 2, global batch "
          f"{PP_BATCH[0]}x{PP_BATCH[1]}: " + "; ".join(
              f"{k} {[round(r['peak_gb'][k], 2) for r in runs]}" for k in runs[0]["peak_gb"]) + f" on {smi}",
          flush=True)


# phase 14: the device layer, ranks started by torchrun from a rendered pod env
DEVICE_PROMPTS = (8, 128)  # (a): prompts x tokens
DEVICE_MAX_NEW = 32
DEVICE_TRAIN_BATCH = (8, 2048)
DEVICE_LAUNCHES = 1  # (a)'s fresh launches, the first also training; phase 15's launch three more
DEVICE_MESH_TOPOLOGY = "2x2"
DEVICE_MESH_LAYERS = 2  # (b)'s depth of the flagship's 8 layers
DEVICE_MESH_BATCH = (8, 2048)
DEVICE_PROCESS_TIMEOUT_S = 300  # one torchrun process, its workers' bring-up and work included
DEVICE_INIT_TIMEOUT_S = 120  # (b)'s gloo group: its init and collectives
DEVICE_TORCHRUN_NAMES = ("RANK", "LOCAL_RANK", "GROUP_RANK", "WORLD_SIZE", "LOCAL_WORLD_SIZE")
TENSOR_CORE = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def _device_torchrun(pods, out_dir, what, *args, pycache):
    """Starts one `python -m torch.distributed.run chip_smoke.py
    --device-worker ...` per pod env, all at once, and waits for all within
    DEVICE_PROCESS_TIMEOUT_S (tests/torch_dist.py's run_processes). Python's
    bytecode goes to `pycache`, where the next launch reads it (the card's
    machine may forbid writing bytecode: PYTHONDONTWRITEBYTECODE is dropped,
    and nothing is written outside the phase's directory). Returns the
    workers' results by global rank; a process that fails or does not exit
    in time fails the phase."""
    import torch_dist

    out_dir.mkdir(parents=True)
    argv = [sys.executable, "-m", "torch.distributed.run", os.path.abspath(__file__), "--device-worker",
            *args, str(out_dir), repr(time.time())]
    env = {k: v for k, v in torch_dist.clean_env().items() if k != "PYTHONDONTWRITEBYTECODE"}
    env["PYTHONPYCACHEPREFIX"] = str(pycache)
    got = torch_dist.run_processes([(argv, {**env, **pod}) for pod in pods], out_dir, DEVICE_PROCESS_TIMEOUT_S)
    bad = [f"--- torchrun {i} ({code}):\n{log[-4000:]}" for i, (code, log) in enumerate(got) if code != 0]
    if bad:
        fail(f"{what}: torchrun processes failed:\n" + "\n".join(bad))
    results = {}
    for path in sorted(out_dir.glob("rank-*.json")):
        run = json.loads(path.read_text())
        results[run["rank"]] = run
    return results


def device_phase(attention, smi):
    """Phase 14 (docstring item 14). Returns the launches of its paths by
    kernel name."""
    import tempfile
    from pathlib import Path

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    with tempfile.TemporaryDirectory(prefix="device-phase-") as tmp:
        return _device_phase(attention, smi, Path(tmp))


def _device_phase(attention, smi, out_root):
    import torch_dist
    from odh_kubeflow_tpu_torch.gpu import plan_slice, validate_spec

    t_phase = time.perf_counter()
    zero = {name: 0 for name in attention.launch_counts}
    pycache = out_root / "pycache"

    # (a) one host x one card
    shape = validate_spec({"accelerator": "h100"})
    if (shape.hosts, shape.chips_per_host) != (1, 1) or shape != plan_slice("h100"):
        fail(f"plan_slice('h100') planned {shape}, want 1 x 1")
    env = torch_dist.pod_env(shape, 0)
    print(f"  (a) {shape.accelerator_type} {shape.topology}: the pod env apply_slice renders "
          f"{sorted(env.items())}", flush=True)
    runs = []
    for i in range(DEVICE_LAUNCHES):
        got = _device_torchrun([env], out_root / f"serve-{i}", f"phase 14 (a) launch {i}", "serve",
                               str(int(i == 0)), pycache=pycache)
        if sorted(got) != [0]:
            fail(f"phase 14 (a): want one rank, got {sorted(got)}")
        runs.append(got[0])
    serve = dict(zero)
    for i, run in enumerate(runs):
        want = {n: (SERVE_LAYERS if n == "flash_fwd" else 0) for n in zero}
        for what in ("prefill", "generate"):
            if run["launches"][what] != want:
                fail(f"phase 14 (a) launch {i}: {what} launched {run['launches'][what]}, want {want}")
            for n, c in run["launches"][what].items():
                serve[n] += c
        if run["device"] != "cuda:0" or run["world"] != [0, 1]:
            fail(f"phase 14 (a) launch {i}: device {run['device']}, world {run['world']}")
        if not run["tokens_ok"]:
            fail(f"phase 14 (a) launch {i}: generate's tokens {run['tokens_shape']} are not in the vocabulary "
                 "or their first differ from prefill's argmax")
        if not run["visit"] <= 1.0:
            fail(f"phase 14 (a) launch {i}: the flash forward at the prefill's shape disagrees with its plain "
                 f"version: {run['visit']:.3f} of its tolerance")
    first = runs[0]
    want = {n: (SERVE_LAYERS if n in TENSOR_CORE else 0) for n in zero}
    if first["launches"]["train"] != want or not np.isfinite(first["train_loss"]):
        fail(f"phase 14 (a): the train step launched {first['launches']['train']} (want {want}), "
             f"loss {first['train_loss']}")
    b, s = DEVICE_PROMPTS
    print(f"  (a) {DEVICE_LAUNCHES} fresh launches of `torchrun` with that env, prefill + generate of the flagship "
          f"({b} prompts x {s}, max_new {DEVICE_MAX_NEW}) on {first['device']}: forward launches per prefill "
          f"{first['launches']['prefill']['flash_fwd']} and per generate {first['launches']['generate']['flash_fwd']}, "
          f"no scalar one; the flash forward at the prefill's {first['shape']} against its plain version, "
          f"worst {max(run['visit'] for run in runs):.3f} of its tolerance; the first launch's train step "
          f"({DEVICE_TRAIN_BATCH[0]} x {DEVICE_TRAIN_BATCH[1]}, remat flash) loss {first['train_loss']:.4f}, "
          f"launches {first['launches']['train']}", flush=True)
    steps = (("started", "worker started"), ("context", "CUDA context up"), ("world", "world formed"),
             ("params", "params on the card"), ("first_token", "first token"))
    times = {k: [run["times"][k] for run in runs] for k, _ in steps}
    print("  (a) launch -> " + "; ".join(
        f"{label} p50 {statistics.median(times[k]):.3f} s (first launch {times[k][0]:.3f} s; all "
        f"{[round(t, 3) for t in times[k]]})" for k, label in steps)
        + f"; the launch compiles Python's bytecode; on {smi}", flush=True)

    # (b) two hosts x two cards, on gloo on this card
    shape = plan_slice("h100", topology=DEVICE_MESH_TOPOLOGY)
    master = ("127.0.0.1", torch_dist.free_port())
    rendered = torch_dist.pod_env(shape, 0)
    pods = [torch_dist.pod_env(shape, node, master) for node in range(shape.hosts)]
    print(f"  (b) {shape.accelerator_type} {shape.topology}: two pods' env as apply_slice renders it; the master "
          f"{rendered['PET_MASTER_ADDR']}:{rendered['PET_MASTER_PORT']} replaced by {master[0]}:{master[1]} (no "
          f"cluster DNS here); node ranks 0 and 1; the 4 ranks share this one card on gloo ({smi}): this proves "
          "the bring-up and the step right, not their scaling", flush=True)
    got = _device_torchrun(pods, out_root / "mesh", "phase 14 (b)", "mesh", "0", pycache=pycache)
    if sorted(got) != list(range(shape.chips)):
        fail(f"phase 14 (b): ranks {sorted(got)}, want 0..{shape.chips - 1}")
    for r, run in got.items():
        env = run["env"]
        node, local = int(env["GROUP_RANK"]), int(env["LOCAL_RANK"])
        if not (int(env["RANK"]) == r == node * shape.chips_per_host + local and run["world"] == [r, shape.chips]
                and int(env["WORLD_SIZE"]) == shape.chips):
            fail(f"phase 14 (b): rank {r} got {env} and world {run['world']}")
        if run["plan"] != {"fsdp": 2, "tp": 2} or run["tp_ranks"] != [node * 2, node * 2 + 1]:
            fail(f"phase 14 (b): rank {r} planned {run['plan']} with tp group {run['tp_ranks']}, want fsdp 2 x "
                 f"tp 2 with its pod's ranks {[node * 2, node * 2 + 1]}")
    worst = {}
    for run in got.values():
        for kernel, _, err in run["visits"]:
            worst[kernel] = max(worst.get(kernel, 0.0), err)
    print(f"  (b) ranks RANK = node_rank x 2 + LOCAL_RANK: "
          f"{[(got[r]['env']['GROUP_RANK'], got[r]['env']['LOCAL_RANK'], r) for r in sorted(got)]}, world "
          f"{shape.chips}; slice_mesh_axes: {got[0]['plan']}, tp groups "
          f"{sorted({tuple(run['tp_ranks']) for run in got.values()})} (one pod each); devices "
          f"{sorted({run['device'] for run in got.values()})}", flush=True)
    print(f"  (b) per rank {got[0]['shape']} (strided views): {sum(len(run['visits']) for run in got.values())} "
          f"flash calls against their plain versions; worst error over its tolerance "
          + ", ".join(f"{k} {e:.3f}" for k, e in sorted(worst.items())), flush=True)
    if set(worst) != {"fwd", "dq", "dkv"} or not max(worst.values()) <= 1.0:
        fail(f"phase 14 (b): the flash calls disagree with their plain versions: {worst}")
    ref = got[0]
    print(f"  (b) train, {DEVICE_MESH_LAYERS} layers of the flagship's widths, bf16, global batch "
          f"{DEVICE_MESH_BATCH[0]}x{DEVICE_MESH_BATCH[1]}, remat flash: losses {[round(x, 4) for x in ref['losses']]}; "
          f"the first against one process's {ref['ref_loss']:.4f}: rel err {ref['loss_err']:.3e} (tol "
          f"{SP_LOSS_TOLERANCE:.0e}); the second step: host syncs {[run['syncs'] for run in got.values()]}, "
          f"{[round(run['step_ms'], 1) for run in got.values()]} ms per rank (host clock); launches per rank "
          f"{got[0]['launches']}", flush=True)
    if not (ref["loss_err"] <= SP_LOSS_TOLERANCE and all(np.isfinite(ref["losses"]))):
        fail(f"phase 14 (b): the sharded loss disagrees with one process's: {ref['loss_err']}")
    if len({tuple(run["losses"]) for run in got.values()}) != 1:
        fail(f"phase 14 (b): the ranks' losses differ: {[run['losses'] for run in got.values()]}")
    if any(run["syncs"] for run in got.values()):
        fail(f"phase 14 (b): host syncs inside the step: {[run['syncs'] for run in got.values()]}")
    want = {n: (DEVICE_MESH_LAYERS if n in TENSOR_CORE else 0) for n in zero}
    mesh = dict(zero)
    for r, run in got.items():
        if run["launches"] != want:
            fail(f"phase 14 (b): rank {r} launched {run['launches']} in a step, want {want}")
        for n, c in run["launches"].items():
            mesh[n] += c
    print(f"  phase 14 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"device layer: torchrun serve": serve, "device layer: torchrun train": first["launches"]["train"],
            "device layer: torchrun 2x2 fsdp2 x tp2": mesh}


def _device_worker(mode, train, out_dir, t0):
    """One rank of phase 14 or 15, started by torchrun (`chip_smoke.py
    --device-worker MODE TRAIN OUT_DIR T0`): bring-up from the pod env, then
    (a)'s serving (and train step), (b)'s mesh step, or phase 15's
    "operator" mode: (a)'s serving in a notebook pod, after which the rank
    holds its CUDA context until SIGTERM, as a notebook kernel holds its
    card. Phase 15's "repair" mode is the repaired notebook's worker
    (tests/torch_pod_worker.py `repair_run` at REPAIR_LAYERS of the
    flagship, bf16, remat "flash", on DEVICE_TRAIN_BATCH): the first pod
    serves as "operator" does, then trains and answers the forwarded
    checkpoint requests until SIGTERM; its replacement re-forms its world
    with `reinitialize_after_repair`, restores the notebook's checkpoint
    and takes the next step. Mode "promote" is "repair" for the notebook
    phase 15 then promotes: the replacement stays busy after its step,
    reports its params' logit fingerprint and answers the forwarded
    checkpoint requests until SIGTERM. Mode "job" is phase 15's TPUJob
    learner (tests/torch_pod_worker.py `job_run` at REPAIR_LAYERS, as
    "repair" trains): it trains to TPU_JOB_STEPS from TPU_JOB_RESUME_STEP's
    checkpoint and answers the forwarded checkpoint requests between its
    steps until SIGTERM. Its result goes to OUT_DIR/rank-R.json (written
    whole, then renamed), its times from T0, the parent's launch (phase 15
    passes 0: times since the epoch)."""
    from odh_kubeflow_tpu_torch.parallel import initialize_from_env, rank_device, reinitialize_after_repair

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    import torch_pod_worker

    resumed = mode in ("repair", "promote") and torch_pod_worker.resuming(out_dir)
    if resumed:  # before the CUDA context: the pod's agent waits for the restore
        torch_pod_worker.announce_restore(out_dir)
    t0 = float(t0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = rank_device("cuda")
    torch.cuda.set_device(dev)
    torch.empty(1, device=dev)
    torch.cuda.synchronize(dev)
    t_context = time.time()
    if resumed:
        world = reinitialize_after_repair()
    elif mode in ("serve", "operator", "repair", "promote"):
        world = initialize_from_env()
    else:  # the ranks share one card: gloo, as NCCL refuses two ranks on one device
        world = initialize_from_env(timeout_s=DEVICE_INIT_TIMEOUT_S, backend="gloo", device="cuda")
    t_world = time.time()
    out = {"rank": world[0], "world": list(world), "device": str(dev), "pid": os.getpid(),
           "env": {n: os.environ.get(n) for n in DEVICE_TORCHRUN_NAMES + OPERATOR_POD_NAMES}}
    if mode == "mesh":
        out.update(_device_mesh(dev))
    elif not resumed and mode != "job":
        out.update(_device_serve(dev, train == "1", t0))
    out["times"] = dict(out.get("times", {}), started=STARTED - t0, context=t_context - t0, world=t_world - t0,
                        done=time.time() - t0)
    if mode in ("repair", "promote", "job"):
        import signal

        stop = threading.Event()
        signal.signal(signal.SIGTERM, lambda *a: stop.set())
        cfg = _repair_cfg()

        def batch_of(i):
            return {"tokens": torch.as_tensor(np.random.default_rng(100 + i).integers(0, cfg.vocab,
                                                                                    DEVICE_TRAIN_BATCH), device=dev)}

        if mode == "job":
            torch_pod_worker.job_run(dev, out_dir, cfg, batch_of, out, stop)
        else:
            torch_pod_worker.repair_run(dev, out_dir, cfg, batch_of, out, stop, promote=mode == "promote")
        return
    path = os.path.join(out_dir, f"rank-{world[0]}.json")
    with open(path + ".tmp", "w") as f:
        json.dump(out, f)
    os.replace(path + ".tmp", path)
    if mode == "operator":
        while True:  # SIGTERM's default action ends the process
            time.sleep(3600)


def _device_serve(dev, train, t0):
    """(a) in the one rank: prefill's first token (timed from the launch),
    generate, the flash forward at the prefill's shape against its plain
    version (after the timed path), and in the first launch one train
    step."""
    from odh_kubeflow_tpu_torch.models import TransformerConfig, generate, init_params, make_train_step, prefill
    from odh_kubeflow_tpu_torch.ops import attention

    cfg = _serve_cfg(SERVE_LAYERS, torch.bfloat16)
    params = init_params(torch.Generator().manual_seed(0), cfg, device=dev)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab, DEVICE_PROMPTS), device=dev)
    torch.cuda.synchronize(dev)
    t_params = time.time()
    launches = {}
    attention.reset_launch_counts()
    logits, _ = prefill(params, tokens, cfg, max_seq=DEVICE_PROMPTS[1] + DEVICE_MAX_NEW)
    first = logits.argmax(-1).cpu()  # the first token on the host
    t_first = time.time()
    launches["prefill"] = dict(attention.launch_counts)
    attention.reset_launch_counts()
    out = generate(params, tokens, cfg, DEVICE_MAX_NEW, device=dev).cpu()
    launches["generate"] = dict(attention.launch_counts)
    res = {"times": {"params": t_params - t0, "first_token": t_first - t0}, "launches": launches,
           "tokens_shape": list(out.shape),
           "tokens_ok": (tuple(out.shape) == (DEVICE_PROMPTS[0], DEVICE_MAX_NEW) and bool((out >= 0).all())
                         and bool((out < cfg.vocab).all()) and bool((out[:, 0] == first).all())),
           "shape": f"b{DEVICE_PROMPTS[0]} s{DEVICE_PROMPTS[1]} h{cfg.n_heads} hk{cfg.n_heads} d{cfg.head_dim}",
           "visit": _flash_fwd_vs_plain(*DEVICE_PROMPTS, cfg.n_heads, cfg.head_dim)}
    del params
    if train:
        cfg = TransformerConfig(**SERVE_WIDTH, n_layers=SERVE_LAYERS, dtype=torch.bfloat16, use_flash=True,
                                remat=True, remat_policy="flash")
        params = init_params(torch.Generator().manual_seed(0), cfg, device=dev)
        batch = {"tokens": torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab, DEVICE_TRAIN_BATCH),
                                           device=dev)}
        step, opt = make_train_step(cfg)
        state = opt.init(params)
        attention.reset_launch_counts()
        _, _, loss = step(params, state, batch)
        torch.cuda.synchronize(dev)
        launches["train"] = dict(attention.launch_counts)
        res["train_loss"] = loss.item()
    return res


def _device_mesh(dev):
    """(b) in one of the 4 ranks: slice_mesh_axes over the slice the env
    names, the flash calls at the per-rank shape against their plain
    versions, one step against one process's loss, a second step counted
    for host syncs and launches."""
    import torch.distributed as dist

    from odh_kubeflow_tpu_torch.gpu import slice_from_env
    from odh_kubeflow_tpu_torch.models import TransformerConfig, init_params, make_train_step, shard_params
    from odh_kubeflow_tpu_torch.models import value_and_grad
    from odh_kubeflow_tpu_torch.ops import attention
    from odh_kubeflow_tpu_torch.parallel import shard_batch, slice_mesh_axes

    plan = slice_mesh_axes(slice_from_env())
    mesh = plan.build("cuda")
    cfg = TransformerConfig(**FULL_WIDTH, n_layers=DEVICE_MESH_LAYERS, dtype=torch.bfloat16, use_flash=True,
                            remat=True, remat_policy="flash")
    b_rank, h_rank = DEVICE_MESH_BATCH[0] // mesh.size(("dp", "fsdp")), cfg.n_heads // mesh.sizes["tp"]
    res = {"plan": {a: n for a, n in plan.sizes().items() if n > 1}, "tp_ranks": mesh.ranks("tp"),
           "shape": f"b{b_rank} s{DEVICE_MESH_BATCH[1]} h{h_rank} hk{h_rank} d{cfg.head_dim}",
           "visits": _flash_calls_vs_plain(b_rank, DEVICE_MESH_BATCH[1], h_rank, cfg.head_dim)}
    full = init_params(torch.Generator().manual_seed(0), cfg, device=dev)
    tokens = np.random.default_rng(3).integers(0, cfg.vocab, DEVICE_MESH_BATCH)
    if mesh.rank == 0:  # the one-process loss on the same batch
        res["ref_loss"] = value_and_grad(full, {"tokens": torch.as_tensor(tokens, device=dev)}, cfg)[0].item()
        torch.cuda.empty_cache()
    local = shard_params(full, cfg, mesh)
    del full
    batch = shard_batch(mesh, {"tokens": tokens})
    step, opt = make_train_step(cfg, mesh=mesh)
    state = opt.init(local)
    local, state, first = step(local, state, batch)
    torch.cuda.synchronize(dev)
    dist.barrier()
    attention.reset_launch_counts()
    losses = [first]
    t = time.perf_counter()
    res["syncs"] = count_sync_warnings(lambda: losses.append(step(local, state, batch)[2]))
    torch.cuda.synchronize(dev)
    res["step_ms"] = (time.perf_counter() - t) * 1e3
    res["launches"] = dict(attention.launch_counts)
    res["losses"] = torch.stack(losses).tolist()
    if mesh.rank == 0:
        res["loss_err"] = abs(res["losses"][0] - res["ref_loss"]) / abs(res["ref_loss"])
    dist.barrier()
    dist.destroy_process_group()
    return res


# phase 15: the operator, from a Notebook CR to a pod serving the flagship on this card and back
OPERATOR_WAVES = (("nb-0", "nb-1"), ("nb-2",))  # notebooks created at once, wave after wave
OPERATOR_POD_NAMES = ("PET_STANDALONE", "PET_NPROC_PER_NODE", "NB_TPU_CHIPS_EXPECTED", "TPU_ACCELERATOR_TYPE")
OPERATOR_PROBE_S = 0.2  # the readiness gate's period
OPERATOR_CULL_IDLE_S = 2.0  # the culler's idle time
OPERATOR_CHECK_S = 0.5  # the culler's check period
OPERATOR_WINDOW_S = 2.0  # the agents' CudaMonitor window (no idle verdict before one)
OPERATOR_SAMPLE_S = 0.25  # its sample period, and how long nvidia-smi's reading is reused
OPERATOR_GRACE_S = 20.0  # a culled pod's SIGTERM -> SIGKILL
OPERATOR_STEP_TIMEOUT_S = 120  # each wait of the sequence
OPERATOR_BUDGET_S = 120  # the phase, less the repair episode, fails past it
OPERATOR_REPAIR = "nb-2"  # the notebook whose node is preempted once its worker has trained
REPAIR_LAYERS = 2  # the repaired notebook's depth of the flagship's 8 layers (phase 14 (b)'s)
REPAIR_BUDGET_S = 45  # the repair episode fails past it: 25.1 s on the card in its first run, and a margin
OPERATOR_ENDPOINT = "ep-0"  # the InferenceEndpoint nb-2 is promoted into
PROMOTION_SLOTS = 8  # its engine's slots (spec.serving.maxBatchSlots)
PROMOTION_MAX_SEQ = 512
PROMOTION_DRAIN_S = 1.0  # spec.serving.drainTimeoutS: the route-first drain's window
PROMOTION_BUDGET_S = 40  # the promotion episode fails past it: 20.5 s on the card in its first run, and a margin
AUTOSCALE_PERIOD_S = 0.25  # the ReplicaAutoscaler's tick
AUTOSCALE_IDLE_S = 1.0  # ep-0's scaleToZeroIdleS
# the park and the wake fail past it: the idle window, the park, one serving
# start-up (bind -> listening 9.7-14.5 s in the promotion's earlier card
# runs), the reclaim's grace, the requests, and a margin
AUTOSCALE_BUDGET_S = 45
OPERATOR_JOB = "rl-0"  # the TPUJob of the job episode: an anakin gang on an h100 1x1 slice (this card)
# its spec.steps and spec.checkpointPeriodS (PR 19's, on which
# RESUME_JOB_BUDGET_S rests): the first pod is still short of JOB_STEPS when
# the reclaim's preempt lands, one cadence save after Running and then the
# reclaim's grace and a save later (a pod's first step takes seconds of
# warm-up, the next ~0.11 s: the first save came at step 1 and the
# reclaim's at steps 8-11 on the card, PR 20's runs 1-4; at most ~35 and
# ~45 on a host whose warm-up took no time), and the period leaves a few
# seconds of steps between two 3 s saves
JOB_STEPS = 48
JOB_PERIOD_S = 5.0
# the job episode with nb-2's resume fails past it: PR 19's job episode took
# 52.5-89.9 s on the card; the resume adds one torchrun start-up (up to
# 15.9 s to the CUDA context), one save (up to 3.5 s) and one restore (up to
# 2.9 s): 112.2 s, and a margin
RESUME_JOB_BUDGET_S = 120
ACCOUNTANT_PERIOD_S = 0.5  # the ChipAccountant's tick over the phase


def _repair_cfg():
    """The repaired (and promoted) notebook's model: the flagship's widths
    at REPAIR_LAYERS layers, bf16, remat "flash"."""
    from odh_kubeflow_tpu_torch.models import TransformerConfig

    return TransformerConfig(**SERVE_WIDTH, n_layers=REPAIR_LAYERS, dtype=torch.bfloat16, use_flash=True,
                             remat=True, remat_policy="flash")


def operator_phase(attention, smi):
    """Phase 15 (docstring item 15), through tests/torch_operator_flow.py's
    flow. Returns the launches of its path by kernel name."""
    import tempfile
    from pathlib import Path

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    with tempfile.TemporaryDirectory(prefix="operator-phase-") as tmp:
        return _operator_phase(attention, smi, Path(tmp))


def _operator_phase(attention, smi, out_root):
    import torch_dist
    import torch_operator_flow as flow
    from odh_kubeflow_tpu_torch.probe.behavior import cuda_monitor

    t_phase = time.perf_counter()
    _operator_overlays(smi)
    env = {k: v for k, v in torch_dist.clean_env().items() if k != "PYTHONDONTWRITEBYTECODE"}
    env["PYTHONPYCACHEPREFIX"] = str(out_root / "pycache")  # the pods' launches share one bytecode directory
    apps_before = flow.compute_app_pids()
    print(f"  the port's SimCluster: one h100 1x1 node (one card, nvidia.com/gpu 1), nb-denied written over a TLS "
          f"ApiServer whose admission calls the HTTPS webhook (build_remote_stack); the Manager of "
          f"odh_kubeflow_tpu_torch.main.build_manager (its webhook in the store's chain), its debug mux on free ports, "
          f"CPPROFILE=1: NotebookReconciler, EventMirrorController, "
          f"TPUWorkbenchReconciler, ProbeStatusController (every {OPERATOR_PROBE_S} s), "
          f"CullingReconciler (idle {OPERATOR_CULL_IDLE_S} s, checks every {OPERATOR_CHECK_S} s) and "
          f"SliceRepairController (checkpoint window {flow.REPAIR_CFG['checkpoint_window_s']} s, Config's default "
          f"backoff), SuspendResumeController (suspend off until {OPERATOR_REPAIR}'s suspend; checkpoint window "
          f"{flow.RESUME_CFG['suspend_checkpoint_window_s']} s, card budget {flow.RESUME_CFG['chip_budget']}, "
          f"Config's resume attempts), the InferenceEndpoint and TPUJob reconcilers; each pod "
          f"runs `torchrun chip_smoke.py --device-worker operator` ({OPERATOR_REPAIR}'s: `repair`) with the env "
          f"the reconciler rendered, beside a NotebookAgent over CudaMonitor(window {OPERATOR_WINDOW_S} s, samples "
          f"every {OPERATOR_SAMPLE_S} s) that counts the cards on which the pod's processes hold a CUDA context; "
          f"before {OPERATOR_REPAIR}'s wave a second h100 1x1 node joins in a pool of its own (both nodes stand "
          f"for this card); compute apps on the card before: {apps_before}", flush=True)
    rng = np.random.default_rng(15)
    promotion = flow.Promotion(
        model_config=flow.model_config(_repair_cfg()), device="cuda",
        requests=[(rng.integers(0, SERVE_WIDTH["vocab"], DEVICE_PROMPTS[1]).tolist(), n) for n in MAX_NEWS],
        slots=PROMOTION_SLOTS, max_seq=PROMOTION_MAX_SEQ, drain_s=PROMOTION_DRAIN_S, name=OPERATOR_ENDPOINT,
        idle_s=AUTOSCALE_IDLE_S)
    try:
        seen = flow.run(
            out_root, lambda out_dir, role: [
                sys.executable, "-m", "torch.distributed.run", os.path.abspath(__file__), "--device-worker",
                "operator" if role == "serve" else role, "0", str(out_dir), "0.0"],
            cuda_monitor(OPERATOR_WINDOW_S, OPERATOR_SAMPLE_S), waves=OPERATOR_WAVES,
            cfg=dict(readiness_probe_period_s=OPERATOR_PROBE_S, enable_culling=True,
                     cull_idle_time_min=OPERATOR_CULL_IDLE_S / 60.0,
                     idleness_check_period_min=OPERATOR_CHECK_S / 60.0,
                     accounting_period_s=ACCOUNTANT_PERIOD_S, autoscale_period_s=AUTOSCALE_PERIOD_S),
            env=env, grace_s=OPERATOR_GRACE_S, timeout=OPERATOR_STEP_TIMEOUT_S, released=flow.card_released(),
            while_serving=flow.compute_app_pids, card_state=flow.compute_app_pids, repair=OPERATOR_REPAIR,
            promotion=promotion, job=flow.Job(steps=JOB_STEPS, period_s=JOB_PERIOD_S, name=OPERATOR_JOB),
            resume=True)
        flow.check(seen, "cuda:0", gate_waits=True)  # the gate reads the pod's processes, not this one
    except AssertionError as e:
        fail(f"phase 15: {e}")

    zero = {n: 0 for n in attention.launch_counts}
    want = {n: (SERVE_LAYERS if n == "flash_fwd" else 0) for n in zero}
    launched = dict(zero)
    names = seen["turns"]
    rows = {}
    for name in names:
        got = seen[name]
        run = got["result"]
        for what in ("prefill", "generate"):
            if run["launches"][what] != want:
                fail(f"phase 15 {name}: {what} launched {run['launches'][what]}, want {want}")
            for n, c in run["launches"][what].items():
                launched[n] += c
        if run["device"] != "cuda:0" or not run["tokens_ok"]:
            fail(f"phase 15 {name}: device {run['device']}, tokens ok {run['tokens_ok']}")
        if not run["visit"] <= 1.0:
            fail(f"phase 15 {name}: the flash forward at the prefill's shape disagrees with its plain version: "
                 f"{run['visit']:.3f} of its tolerance")
        t0 = got["created"]
        rows[name] = {"CR -> bound": got["bound"][0] - t0, "CR -> mesh-ready": got["mesh-ready"][0] - t0,
                      "notebook.ready root (admission -> gate)": got["root"][0]["duration_ms"] / 1e3,
                      "CR -> worker started": run["times"]["started"] - t0,
                      "CR -> CUDA context": run["times"]["context"] - t0,
                      "CR -> first token": run["times"]["first_token"] - t0}
        if "promotion" not in got:  # the promoted notebook is stopped by its suspend, never idle
            # the repaired notebook's kernel goes idle once its replacement has stepped
            rows[name].update({
                "idle -> culled": got["stopped"][0] - got.get("repair", got)["result"]["times"]["done"],
                "culled -> card free": got["free"] - got["stopped"][0]})
    order = [seen[n][k][1] for n in names for k in ("bound", "stopped")]
    waited = next(n for n in names if "pending" in seen[n])
    first = seen[names[0]]["result"]
    print(f"  {waited} Pending while another held the card: {seen[waited]['pending']!r} (mirrored onto the "
          f"notebook); the card's turns {names}, resourceVersions bound/stopped in turn: {order}", flush=True)
    print(f"  each pod: StatefulSet requests nvidia.com/gpu 1 with PET_STANDALONE 1, PET_NPROC_PER_NODE 1 (the "
          f"worker saw {first['env']['PET_STANDALONE']}, {first['env']['PET_NPROC_PER_NODE']}, NB_TPU_CHIPS_EXPECTED "
          f"{first['env']['NB_TPU_CHIPS_EXPECTED']}); worker on {first['device']}; prefill + generate of the flagship "
          f"({DEVICE_PROMPTS[0]} prompts x {DEVICE_PROMPTS[1]}, max_new {DEVICE_MAX_NEW}): forward launches per "
          f"prefill {first['launches']['prefill']['flash_fwd']}, per generate "
          f"{first['launches']['generate']['flash_fwd']}, no scalar one; the flash forward at the prefill's "
          f"{first['shape']} against its plain version, worst {max(seen[n]['result']['visit'] for n in names):.3f} "
          f"of its tolerance; status.tpu meshReady with firstReadyTime once a pod process held the card under "
          f"a CUDA context "
          f"(chips visible {seen[names[0]]['status']['chipsVisible']}; each agent's readiness "
          f"{seen[names[0]]['agent ready']}); the stop annotation the culler's; the set "
          f"at 0", flush=True)
    denied = seen["denied"]
    print(f"  {denied['name']} ({flow.DENIED[1]} {flow.DENIED[2]}) denied at admission: {denied['error']!r}; "
          f"objects of it stored {denied['left']}, at the end {denied['left at the end']}; compute apps before "
          f"and after its admission {denied['card'][0]} -> {denied['card'][1]}", flush=True)
    print("  admission and the extension: " + "; ".join(
        f"{n} admitted with the lock and traceparent {seen[n]['admitted'][flow.C.TRACEPARENT_ANNOTATION]}, "
        f"unlocked at resourceVersion {seen[n]['unlocked'][1]} before bound at {seen[n]['bound'][1]}, "
        f"serving beside {sorted(seen[n]['while running'])}, all gone once deleted" for n in names), flush=True)
    print("  the readiness root, opened at admission and closed by the gate, against the watch event: " + "; ".join(
        f"{n} root {seen[n]['root'][0]['duration_ms'] / 1e3:.3f} s, CR -> mesh-ready event "
        f"{seen[n]['mesh-ready'][0] - seen[n]['created']:.3f} s, event after the root's end by "
        f"{flow.root_lag(seen[n]):.3f} s" for n in names) + f" (within one gate period, {OPERATOR_PROBE_S} s)",
        flush=True)
    print("  mesh-ready against the worker's CUDA context (gate: no earlier than the context less one gate "
          f"period, {OPERATOR_PROBE_S} s): " + "; ".join(
              f"{n} {seen[n]['mesh-ready'][0] - seen[n]['result']['times']['context']:+.3f} s" for n in names),
          flush=True)
    print("  compute apps while a worker served: " + "; ".join(
        f"{n} {seen[n]['serving']}" for n in names) + f"; after each cull {apps_before} (the culled pods' pids "
        + "; ".join(f"{n} {seen[n]['pids']}" for n in names) + " gone)", flush=True)
    for label in rows[names[0]]:
        named = [(n, rows[n][label]) for n in names if label in rows[n]]
        values = [v for _, v in named]
        print(f"  {label}: p50 {statistics.median(values):.3f} s ({', '.join(f'{n} {v:.3f}' for n, v in named)})"
              f"; {smi}", flush=True)
    repair_launches = _operator_repair(seen[OPERATOR_REPAIR], smi, zero)
    promotion_launches, visit = _operator_promotion(seen[OPERATOR_REPAIR], promotion, smi, zero)
    autoscale_launches = _operator_autoscale(seen[OPERATOR_REPAIR], promotion, smi, zero, visit)
    resume_launches = _operator_resume(seen[OPERATOR_REPAIR], seen["job"], smi, zero)
    job_launches = _operator_job(seen["job"], smi, zero)
    _operator_accounting(seen["accounting"], smi)
    _operator_judgement(seen, smi)
    _operator_debug(seen, smi)
    _operator_deployguard(seen, out_root, smi)
    took = time.perf_counter() - t_phase
    episode = seen[OPERATOR_REPAIR]["repair"]["wall"]
    autoscaled = seen[OPERATOR_REPAIR]["promotion"]["autoscale"]["wall"]
    promoted = seen[OPERATOR_REPAIR]["promotion"]["wall"] - autoscaled
    jobbed = seen["job"]["wall"]
    print(f"  phase 15 took {took:.1f} s, of which the repair episode {episode:.1f} s, the promotion episode "
          f"{promoted:.1f} s, the park and the wake {autoscaled:.1f} s and the job episode {jobbed:.1f} s (budgets: "
          f"{OPERATOR_BUDGET_S} s without the episodes, {REPAIR_BUDGET_S} s the repair, {PROMOTION_BUDGET_S} s the "
          f"suspend and the promotion, {AUTOSCALE_BUDGET_S} s the park and the wake, {RESUME_JOB_BUDGET_S} s the "
          f"job with {OPERATOR_REPAIR}'s resume); {smi}", flush=True)
    if took - episode - promoted - autoscaled - jobbed > OPERATOR_BUDGET_S:
        fail(f"phase 15 took {took - episode - promoted - autoscaled - jobbed:.1f} s without its episodes, over its "
             f"budget of {OPERATOR_BUDGET_S} s")
    if autoscaled > AUTOSCALE_BUDGET_S:
        fail(f"phase 15's park and wake took {autoscaled:.1f} s, over its budget of {AUTOSCALE_BUDGET_S} s")
    if episode > REPAIR_BUDGET_S:
        fail(f"phase 15's repair episode took {episode:.1f} s, over its budget of {REPAIR_BUDGET_S} s")
    if promoted > PROMOTION_BUDGET_S:
        fail(f"phase 15's promotion episode took {promoted:.1f} s, over its budget of {PROMOTION_BUDGET_S} s")
    if jobbed > RESUME_JOB_BUDGET_S:
        fail(f"phase 15's job episode with {OPERATOR_REPAIR}'s resume took {jobbed:.1f} s, over its budget of "
             f"{RESUME_JOB_BUDGET_S} s")
    return {"operator": launched, **repair_launches, **promotion_launches, **autoscale_launches, **resume_launches,
            **job_launches}


def _operator_repair(got, smi, zero):
    """Phase 15's repair episode, past torch_operator_flow.check_repair's
    gates: every flash launch of both incarnations' steps on the tensor-core
    kernels (REPAIR_LAYERS each of forward, dq and dk/dv a step, no scalar
    one); the episode's edges printed. Returns the launches by path."""
    r, train = got["repair"], got["result"]["train"]
    resumed = r["result"]["resumed"]
    want = {n: (REPAIR_LAYERS if n in TENSOR_CORE else 0) for n in zero}
    for i, launched in enumerate(train["launches"] + [resumed["launches"]]):
        if {**zero, **launched} != want:
            fail(f"phase 15 {OPERATOR_REPAIR}: train step {i + 1} launched {launched}, want {want}")
    _, ack = r["acks"][0]
    t0 = r["preempted"]
    print(f"  {OPERATOR_REPAIR} trained {train['steps']} steps of the flagship's widths at {REPAIR_LAYERS} layers, bf16, "
          f"{DEVICE_TRAIN_BATCH[0]} x {DEVICE_TRAIN_BATCH[1]}, remat flash (losses "
          f"{[round(x, 4) for x in train['losses']]}), and step {train['next']['step']} on a copy: loss "
          f"{train['next']['loss']:.6f}, params {train['next']['checksum']}; its node {r['old node']} (pool "
          f"{r['old pool']}) preempted with a grace of {r['grace']:.0f} s", flush=True)
    print(f"  repair: preempt -> Degraded (HostPreempted) {r['degraded'] - t0:.3f} s; -> ack "
          f"{r['acks'][0][0] - t0:.3f} s (the worker's save {ack['seconds']:.3f} s, {ack['bytes'] / 1e9:.3f} GB, step "
          f"{ack['step']}, checksum {ack['checksum']}; checkpoint-saved {r['checkpoint-saved']}); -> evicted "
          f"{r['old terminating'] - t0:.3f} s; -> the old pod's processes gone {r['old closed at'] - t0:.3f} s; -> "
          f"rebound on {r['node']} (pool {r['pool']}) {r['rebound'] - t0:.3f} s; -> the replacement's CUDA context "
          f"{r['result']['times']['context'] - t0:.3f} s; -> mesh-ready again {r['mesh-ready again'] - t0:.3f} s; -> "
          f"resumed step {r['result']['times']['stepped'] - t0:.3f} s; {smi}", flush=True)
    (span,) = [a for a in r["spans"]["slice.repair"] if a["result"] == "repaired"]
    print(f"  repair: MTTR {span['mttr_s']:.3f} s (slice.repair on the notebook.ready trace, cause {span['cause']}, "
          f"attempts {span['attempts']}); goodput ratio {r['goodput']:.4f}; states {r['states']}; Degraded "
          f"{r['conditions']}; counters {r['counters']}; incidents {r['incidents']}; the replacement restored step "
          f"{resumed['restored']['step']} ({resumed['restored']['checksum']}) in {resumed['restored']['seconds']:.3f} "
          f"s and took step {resumed['step']}: loss {resumed['loss']:.6f}, params {resumed['checksum']}, bit-equal "
          f"to the uninterrupted run's; launches per step {resumed['launches']}; {smi}", flush=True)
    steps = dict(zero)
    for launched in train["launches"]:
        for n, c in launched.items():
            steps[n] += c
    return {f"operator repair: train ({train['steps']} steps, step {train['next']['step']} on a copy)": steps,
            "operator repair: resumed step": {**zero, **resumed["launches"]}}


def _operator_promotion(got, promotion, smi, zero):
    """Phase 15's promotion episode, past torch_operator_flow.check_promotion's
    gates: the serving process's flash launches are REPAIR_LAYERS
    tensor-core forwards per prefill (one prefill a request) and no other
    kernel, and the forward at the prefill's shape is within phase 3's
    tolerance of its plain version; the episode's edges printed, each line
    with the card. Returns the launches by path."""
    import torch_operator_flow as flow

    pe = got["promotion"]
    n = len(promotion.requests)
    launched = {**zero, **pe["exit"]["launches"]}
    want = {k: (REPAIR_LAYERS * n if k == "flash_fwd" else 0) for k in zero}
    if launched != want:
        fail(f"phase 15 {OPERATOR_ENDPOINT}: the serving process launched {launched} for {n} requests, want {want}")
    d = SERVE_WIDTH["d_model"] // SERVE_WIDTH["n_heads"]
    visit = _flash_fwd_vs_plain(1, DEVICE_PROMPTS[1], SERVE_WIDTH["n_heads"], d)
    if not visit <= 1.0:
        fail(f"phase 15 {OPERATOR_ENDPOINT}: the flash forward at the prefill's shape disagrees with its plain "
             f"version: {visit:.3f} of its tolerance")
    t0, ready = pe["t0"], pe["ready"]
    times, restore = ready["times"], ready["restore"]
    (rt, rack), = pe["restores"]
    _, ack = pe["ack"]
    replies = pe["replies"]
    ttfts = [body["ttft_s"] for _, body, _, _ in replies]
    first_token = min(sent + body["ttft_s"] for _, body, sent, _ in replies)
    tokens = sum(len(body["tokens"]) for _, body, _, _ in replies)
    wall = max(done for _, _, _, done in replies) - pe["requests sent"]
    se = got["suspend"]
    print(f"  suspend: {OPERATOR_REPAIR} stopped with the culler's stamp -> the forwarded save's ack "
          f"{pe['ack'][0] - t0:.3f} s (the worker's save {ack['seconds']:.3f} s, {ack['bytes'] / 1e9:.3f} GB, step "
          f"{ack['step']}, checksum {ack['checksum']}) -> Suspended {pe['suspended'] - t0:.3f} s (pool "
          f"{pe['released pool']} released warm: {se['pool marks']}) -> its processes gone {se['closed at'] - t0:.3f} s; "
          f"counters {se['counters']}; {smi}", flush=True)
    print(f"  promotion: create {OPERATOR_ENDPOINT} {pe['created'] - t0:.3f} s -> promoted {pe['promoted'][0] - t0:.3f} s "
          f"-> pool claimed under {flow.NS}/{OPERATOR_ENDPOINT} {pe['claimed'][0] - t0:.3f} s -> bound on "
          f"{pe['served node']} (pool {pe['served pool']}) {pe['bound'][0] - t0:.3f} s -> the serving process's CUDA "
          f"context {times['context'] - t0:.3f} s -> restored {times['restored'] - t0:.3f} s ({restore['seconds']:.3f} s, "
          f"{restore['bytes'] / 1e9:.3f} GB, step {restore['step']}, checksum {restore['checksum']}) -> listening "
          f"{times['listening'] - t0:.3f} s -> restore ack {rt - t0:.3f} s (verified: {rack['checksum']} = the save's) "
          f"-> mesh-ready {pe['mesh-ready'][0] - t0:.3f} s (the context {pe['mesh-ready'][0] - times['context']:+.3f} s) "
          f"-> Serving {pe['serving'][0] - t0:.3f} s -> first token {first_token - t0:.3f} s; {smi}", flush=True)
    print(f"  promotion: logit fingerprint served {ready['logit_fingerprint']} = the notebook's "
          f"{got['repair']['result']['resumed']['logit_fingerprint']}; route {pe['route while serving']}, url "
          f"{pe['url']}; {n} requests (prompt {DEVICE_PROMPTS[1]}, max_new {list(MAX_NEWS)}): all 200, TTFT median "
          f"{statistics.median(ttfts) * 1e3:.2f} ms, max {max(ttfts) * 1e3:.2f} ms, {tokens / wall:.1f} tokens/s "
          f"({tokens} tokens in {wall:.3f} s); forward launches {launched['flash_fwd']} ({REPAIR_LAYERS} a prefill), "
          f"no scalar one; the flash forward at the prefill's shape {visit:.3f} of its tolerance; counters "
          f"{pe['counters']}; {smi}", flush=True)
    stop = pe["stop"]
    print(f"  promotion: stop -> route gone {pe['route gone'][0] - stop:.3f} s (rv {pe['route gone'][1]}) -> the set "
          f"at 0 {pe['set at 0'][0] - stop:.3f} s (rv {pe['set at 0'][1]}) -> Terminated {pe['terminated'][0] - stop:.3f} s "
          f"-> card free {pe['card free'] - stop:.3f} s (pool {pe['served pool']} {pe['served pool after']}); counters "
          f"from the last replies to the card free {pe['counters after replies']}; states "
          f"{pe['states']}; the episode {pe['wall']:.1f} s; {smi}", flush=True)
    return {f"operator promotion: {n} requests served by {OPERATOR_ENDPOINT}": launched}, visit


def _operator_autoscale(got, promotion, smi, zero, visit):
    """Phase 15's park and wake, past torch_operator_flow.check_autoscale's
    gates: the woken serving process's flash launches are REPAIR_LAYERS
    tensor-core forwards per prefill and no other kernel (the forward at the
    prefill's shape held against its plain version once, `visit`, for both
    processes); the edges printed, each line with the card. Returns the
    launches by path."""
    pe = got["promotion"]
    ae = pe["autoscale"]
    n = len(promotion.requests)
    launched = {**zero, **ae["exit"]["launches"]}
    want = {k: (REPAIR_LAYERS * n if k == "flash_fwd" else 0) for k in zero}
    if launched != want:
        fail(f"phase 15 {OPERATOR_ENDPOINT}: the woken serving process launched {launched} for {n} requests, "
             f"want {want}")
    t0, wake, ready = ae["t0"], ae["wake"], ae["ready"]
    times, restore = ready["times"], ready["restore"]
    (rt, rack), = ae["restores"]
    replies = ae["replies"]
    ttfts = [body["ttft_s"] for _, body, _, _, _, _, _ in replies]
    first_token = min(resent + body["ttft_s"] for _, body, resent, _, _, _, _ in replies)
    tokens = sum(len(body["tokens"]) for _, body, _, _, _, _, _ in replies)
    wall = max(done for _, _, _, done, _, _, _ in replies) - ae["joined"]
    st = ae["parked status"]
    print(f"  park: the last reply -> the autoscaler's desired 0 {ae['desired 0'][0] - t0:.3f} s (idle "
          f"{AUTOSCALE_IDLE_S} s, ticks every {AUTOSCALE_PERIOD_S} s) -> Suspended {ae['suspended'][0] - t0:.3f} s "
          f"-> card free {ae['card free'] - t0:.3f} s (park -> card free "
          f"{ae['card free'] - ae['desired 0'][0]:.3f} s); parked status phase {st['phase']}, replicas "
          f"{st.get('replicas', 0)}, servingReplicas {st.get('servingReplicas', 0)}, readyReplicas "
          f"{st.get('readyReplicas', 0)}, url {st['url']}, route {ae['route while parked']}, pool {pe['served pool']} "
          f"{ae['pool at park']}; {smi}", flush=True)
    print(f"  wake: 8 requests to the router -> cold wake {ae['wakes'][0] - wake:.3f} s (fired {len(ae['wakes'])} "
          f"time, {ae['counters']['no replica']:.0f} requests shed) -> desired 1 {ae['desired 1'][0] - wake:.3f} s -> "
          f"bound on {ae['node']} (pool {ae['pool']}; idle-warm reclaims {ae['counters']['reclaims pool-idle']:.0f}) "
          f"{ae['bound'][0] - wake:.3f} s -> the serving process's CUDA context {times['context'] - wake:.3f} s -> "
          f"restored {times['restored'] - wake:.3f} s ({restore['seconds']:.3f} s, {restore['bytes'] / 1e9:.3f} GB, "
          f"step {restore['step']}, checksum {restore['checksum']}) -> listening {times['listening'] - wake:.3f} s "
          f"-> restore ack {rt - wake:.3f} s (verified: {rack['checksum']}) -> Serving {ae['serving'][0] - wake:.3f} s "
          f"-> joined the router {ae['joined'] - wake:.3f} s -> first token {first_token - wake:.3f} s; {smi}",
          flush=True)
    print(f"  wake: logit fingerprint served {ready['logit_fingerprint']} = the notebook's; {n} requests through "
          f"the router: all 200, woken TTFT median {statistics.median(ttfts) * 1e3:.2f} ms, max "
          f"{max(ttfts) * 1e3:.2f} ms, {tokens / wall:.1f} tokens/s ({tokens} tokens in {wall:.3f} s); forward "
          f"launches {launched['flash_fwd']} ({REPAIR_LAYERS} a prefill), no scalar one; the flash forward at the "
          f"prefill's shape {visit:.3f} of its tolerance; counters {ae['counters']}; states {ae['states']}; the park "
          f"and the wake {ae['wall']:.1f} s; {smi}", flush=True)
    return {f"operator park and wake: {n} requests served by the woken {OPERATOR_ENDPOINT}": launched}


def _operator_judgement(seen, smi):
    """Phase 15's judgement layer, past torch_operator_flow.check_judgement's
    gates: every alert's transitions, every SLO's compliance over the
    phase, the canaries, the coalescer and the autoscaler printed, each
    line with the card."""
    j = seen["judgement"]
    t0 = j["t0"]
    r = seen[OPERATOR_REPAIR]["repair"]
    print(f"  judgement: {j['evaluations']:.0f} SLO evaluations (windows {j['windows']}); canaries " + "; ".join(
        f"{c['name']} {c['result']} in {c['latency']:.3f} s, gone {c['gone']:.3f} s, compute apps {c['card'][0]} -> "
        f"{c['card'][1]}" for c in j["canaries"]) + f"; {smi}", flush=True)
    print(f"  judgement: alerts (seconds from the manager's start; {OPERATOR_REPAIR} preempted "
          f"{r['preempted'] - t0:.3f}, mesh-ready again {r['mesh-ready again'] - t0:.3f}): " + "; ".join(
              f"{t - t0:.3f} {ev} {a['rule']} ({a['burn_long']:.1f}x/{a.get('burn_short', 0.0):.1f}x, "
              f"{a.get('mirrored', [])}{', still covered by ' + str(m['covering']) if m.get('still covered') else ''})"
              for t, ev, a, m in j["transitions"]) + f"; inhibited {j['inhibited']}; DegradedSLO "
          + str({k: [(round(t - t0, 3), c) for t, _, c in v] for k, v in j["slo_log"].items() if v}) + f"; {smi}",
          flush=True)
    print("  judgement: compliance over the phase (good / total events): " + "; ".join(
        f"{name} " + (f"{c['compliance']:.6f} ({c['good']:.3f} / {c['total']:.3f})" if c["compliance"] is not None
                      else "no events") for name, c in j["compliance"].items())
        + f"; the coalescer {j['coalescer']['writes']} writes, {j['coalescer']['coalesced']} patches merged; "
        f"autoscaler decisions {j['decisions']}; {smi}", flush=True)


def _operator_overlays(smi):
    """Phase 15's deploy tree: the port's four overlays built with the
    tree's params.env and rendered here (no PyYAML on this machine: the
    port's own emitter) must equal the tree committed in its package, byte
    for byte."""
    from odh_kubeflow_tpu_torch import deploy
    from odh_kubeflow_tpu_torch.deploy.__main__ import TREE

    t0 = time.perf_counter()
    with open(os.path.join(TREE, "params.env")) as f:
        params = deploy.load_params(f.read())  # as `generate` builds the tree
    built = {}
    for name in sorted(deploy.OVERLAYS):
        manifests = deploy.build(name, params)
        text = deploy.render_yaml(manifests)
        rel = "base" if name == "base" else os.path.join("overlays", name)
        with open(os.path.join(TREE, rel, "manifests.yaml")) as f:
            if f.read() != text:
                fail(f"phase 15: the {name} overlay built here differs from the committed "
                     f"odh_kubeflow_tpu_torch/deploy/tree/{rel}/manifests.yaml")
        built[name] = (len(manifests), len(text.encode()))
    took = time.perf_counter() - t0
    print("  deploy tree: the port's overlays built and rendered, each equal to the committed tree byte for byte: "
          + "; ".join(f"{n} {k} objects, {b} B" for n, (k, b) in built.items())
          + f"; {took * 1e3:.1f} ms in all; {smi}", flush=True)


def _operator_deployguard(seen, out_root, smi):
    """Phase 15 under DEPLOYGUARD, past torch_operator_flow.check_deployguard's
    gates (no drift; the rbac-coverage checker over the port's package,
    given the dumped surface, finds no ungranted call): the surface
    printed, and the checker's stale-rule findings, ungated."""
    import torch_operator_flow as flow
    from odh_kubeflow_tpu_torch.analysis import deploysurface

    t0 = time.perf_counter()
    artifact = out_root / "deploy-surface.json"
    try:
        stale = flow.check_deployguard(seen, artifact)
    except AssertionError as e:
        fail(f"phase 15: DEPLOYGUARD: {e}")
    took = time.perf_counter() - t0
    surface = seen["deployguard"]["surface"]
    manager = [t for t in surface if t[0] in deploysurface.MANAGER_FLOWS]
    by_flow = {}
    for f, method, kind, sub in manager:
        by_flow.setdefault(f, []).append(f"{method} {kind}")
    from odh_kubeflow_tpu_torch.cluster.flowcontrol import LEADER_ELECTION_FLOW

    # the elector's Lease calls run under the manager's ServiceAccount too
    untouched = _untouched_rbac(manager + [t for t in surface if t[0] == LEADER_ELECTION_FLOW])
    print(f"  DEPLOYGUARD over the flow: drifts {seen['deployguard']['drifts']}; {len(surface)} distinct (flow, verb, "
          f"kind, subresource) tuples, {len(manager)} on the manager's flows ({len(by_flow)} flows), the rest the "
          f"sim actors' and the flow's own clients (record-only); artifact {artifact.stat().st_size} B; rbac-coverage "
          f"with it over the port's package: 0 ungranted calls, {len(stale)} rules that neither the code nor the "
          f"surface uses {[f.message.split(' but ')[0] for f in stale]} (printed, not gated); {took:.1f} s; {smi}",
          flush=True)
    print(f"  DEPLOYGUARD: {len(untouched)} of the ClusterRole's {len(deploysurface.declared_rbac())} granted "
          f"(group, resource) pairs no manager call of this run touched (its informers' list/watch are not calls): "
          + ", ".join(f"{g or 'core'}/{r}" for g, r in untouched), flush=True)
    print("  DEPLOYGUARD manager surface: " + "; ".join(
        f"{f}: {', '.join(sorted(calls))}" for f, calls in sorted(by_flow.items())), flush=True)


def _untouched_rbac(manager):
    """The ClusterRole's granted (apiGroup, resource) pairs that none of
    the (flow, method, kind, subresource) calls in `manager` needs."""
    from odh_kubeflow_tpu_torch.analysis import deploysurface

    touched = set()
    for _, method, kind, _ in manager:
        need = deploysurface.required_rbac(method, kind)
        if need is not None:
            touched.add(need[:2])
    return sorted(set(deploysurface.declared_rbac()) - touched)


def _operator_debug(seen, smi):
    """Phase 15's debug mux and wire, past torch_operator_flow.check_debug_mux's
    gates: nb-denied's refusal over HTTPS, and each read of the mux (its
    status, bytes and seconds), each line with the card."""
    d, denied = seen["debug"], seen["denied"]
    print(f"  wire: {denied['name']} refused over HTTPS (ApiServer -> MutatingWebhookConfiguration -> the webhook) "
          f"in {denied['wall']:.3f} s; {smi}", flush=True)
    reads = {k: v for k, v in d.items() if k.startswith("/")}
    print("  debug mux at the phase's end: " + "; ".join(
        f"{path} {status} {size} B {took * 1e3:.1f} ms" for path, (status, _, size, took) in reads.items())
        + f"; bad arguments {sorted(set(d['bad args'].values()))} over {len(d['bad args'])} reads; {smi}", flush=True)
    print("  debug mux: each notebook's readiness root over /debug/traces as it closed: " + "; ".join(
        f"{n} {status} {size} B {took * 1e3:.1f} ms" for n, (status, _, size, took) in d["roots"].items())
        + f"; the ring at the end holds {len(d['/debug/traces?name=notebook.ready'][1]['spans'])} notebook.ready "
        f"roots; controllers that reconciled {d['reconciled']}; {smi}", flush=True)


def _operator_resume(got, j, smi, zero):
    """Phase 15's resume of nb-2, past torch_operator_flow.check_resume's
    gates: the resumed step launched REPAIR_LAYERS each of the tensor-core
    forward, dq and dk/dv and no scalar kernel; the edges from the unstop to
    Active and the second suspend printed, each line with the card. Returns
    the launches by path."""
    re_ = got["resume"]
    resumed = re_["result"]["resumed"]
    want = {n: (REPAIR_LAYERS if n in TENSOR_CORE else 0) for n in zero}
    if {**zero, **resumed["launches"]} != want:
        fail(f"phase 15 {OPERATOR_REPAIR}: its resumed step launched {resumed['launches']}, want {want}")
    t0, times = re_["unstop"], re_["result"]["times"]
    replicas = "not seen" if re_["ready replicas"] is None else f"{re_['ready replicas'][0] - t0:.3f} s"
    (span,) = re_["spans"]
    job_ack_at, job_ack = j["first"]["acks"][-1]
    (restore_at, restore_ack), = [(t, a) for t, a in re_["restores"] if isinstance(a, dict)]
    print(f"  resume: unstop {OPERATOR_REPAIR} -> Resuming {re_['resuming'][0] - t0:.3f} s (warm claim missed: "
          f"counters {re_['counters']}) -> the reclaim's stamp on {OPERATOR_JOB} {re_['reclaim stamp'][0] - t0:.3f} s "
          f"-> the job's save acked {job_ack_at - t0:.3f} s (step {job_ack['step']}, {job_ack['seconds']:.3f} s, "
          f"{job_ack['bytes'] / 1e9:.3f} GB) -> {OPERATOR_REPAIR} bound on {re_['node']} (pool {re_['pool']}) "
          f"{re_['bound'][0] - t0:.3f} s -> its worker's CUDA context {times['context'] - t0:.3f} s -> restored "
          f"{times['restored'] - t0:.3f} s ({resumed['restored']['seconds']:.3f} s, step {resumed['restored']['step']}) "
          f"-> Ready {re_['ready'][0] - t0:.3f} s -> the notebook's readyReplicas {replicas} "
          f"-> mesh-ready {re_['mesh-ready'][0] - t0:.3f} s (the context "
          f"{re_['mesh-ready'][0] - times['context']:+.3f} s) -> restore verified {restore_at - t0:.3f} s "
          f"({restore_ack['checksum']}) -> Active {re_['resumed'][0] - t0:.3f} s: resume latency {span['latency_s']:.3f} s "
          f"(attempts seen {re_['attempts']}); {smi}", flush=True)
    _, second = re_["acks"][0]
    print(f"  resume: {OPERATOR_REPAIR} took step {resumed['step']}: loss {resumed['loss']:.6f}, params "
          f"{resumed['checksum']}, bit-equal to the step on a copy in the worker that saved; launches "
          f"{resumed['launches']}; stopped again {re_['stop'] - t0:.3f} s -> the save of step {second['step']} "
          f"({second['seconds']:.3f} s, {second['bytes'] / 1e9:.3f} GB) -> Suspended "
          f"{re_['suspend']['suspended'] - t0:.3f} s -> its processes gone {re_['suspend']['closed at'] - t0:.3f} s; "
          f"events {sorted(re_['events'])}; {smi}", flush=True)
    return {"operator resume: resumed step": {**zero, **resumed["launches"]}}


def _operator_job(j, smi, zero):
    """Phase 15's job episode, past torch_operator_flow.check_job's gates:
    every train step of both incarnations launched REPAIR_LAYERS each of the
    tensor-core forward, dq and dk/dv and no scalar kernel; the episode's
    edges and each pod's steps printed, each line with the card. Returns
    the launches by path."""
    want = {n: (REPAIR_LAYERS if n in TENSOR_CORE else 0) for n in zero}
    first, second = j["first"], j["second"]
    launched = {}
    for label, inc in (("first", first), ("second", second)):
        start, end = int(inc["env"]["TPU_JOB_RESUME_STEP"]), inc["result"]["train"]["steps"]
        steps = dict(zero)
        for key, n in inc["result"]["train"]["launches"].items():
            per_step = {**zero, **json.loads(key)}
            if per_step != want:
                fail(f"phase 15 {OPERATOR_JOB}: {n} steps of its {label} pod launched {per_step}, want {want}")
            for name, c in per_step.items():
                steps[name] += c * n
        launched[f"operator job: {label} pod"] = steps
        print(f"  job {OPERATOR_JOB}: the {label} pod trained steps {start} -> {end}", flush=True)
    t0, stamp = j["t0"], j["stamp"]
    states = j["states"]
    resume = first["acks"][-1][1]
    resumed = second["result"]["resumed"]

    def edges(since):
        return " -> ".join(f"{st or 'pending'} {t - since:+.3f} s" for t, _, st in states)

    losses = first["result"]["train"]["losses"] + second["result"]["train"]["losses"]
    print(f"  job {OPERATOR_JOB}: anakin, spec.tpu h100 1x1, spec.steps {j['steps']}, checkpointPeriodS "
          f"{j['period']:.1f} s, priority {j['priority']}; the learner trains the flagship's widths at "
          f"{REPAIR_LAYERS} layers, bf16, {DEVICE_TRAIN_BATCH[0]} x {DEVICE_TRAIN_BATCH[1]}, remat flash "
          f"(losses {losses[0]:.4f} -> {losses[-1]:.4f} over {len(losses)} steps); {smi}", flush=True)
    print(f"  job: states from the create: {edges(t0)}; {smi}", flush=True)
    print(f"  job: from the create: first pod bound {first['bound'][0] - t0:.3f} s on {first['node']} (pool "
          f"{first['pool']}), its worker's CUDA context {first['result']['times']['context'] - t0:.3f} s, ready "
          f"{first['ready'][0] - t0:.3f} s (the context {first['ready'][0] - first['result']['times']['context']:+.3f}"
          f" s); {'the notebook unstopped' if j['cause'] == 'reclaim' else 'the preempt stamped'} {stamp - t0:.3f} s; "
          f"{smi}", flush=True)
    parked = (f"the slice parked warm at priority {j['priority']} {j['parked'][0] - stamp:.3f} s"
              if j["parked"] else "the slice returned to general capacity")
    print(f"  job: from the {'unstop' if j['cause'] == 'reclaim' else 'stamp'} (cause {j['cause']}): states "
          f"{edges(stamp)}; {parked}; the first pod's processes gone {first['closed at'] - stamp:.3f} s; "
          f"second pod bound {second['bound'][0] - stamp:.3f} s on {second['node']} (pool {second['pool']}), its "
          f"context {second['result']['times']['context'] - stamp:.3f} s, ready {second['ready'][0] - stamp:.3f} s "
          f"(the context {second['ready'][0] - second['result']['times']['context']:+.3f} s), the resumed step "
          f"{second['result']['times']['stepped'] - stamp:.3f} s; card free {j['card free'] - stamp:.3f} s; "
          f"{smi}", flush=True)
    for label, inc in (("first", first), ("second", second)):
        print(f"  job: the {label} pod's saves (step, save seconds, GB): " + "; ".join(
            f"{x['step']} {x['seconds']:.3f} s {x['bytes'] / 1e9:.3f} GB" for x in inc["result"]["saves"])
            + f"; {smi}", flush=True)
    print(f"  job: the second pod restored step {resumed['restored']['step']} ({resumed['restored']['checksum']} = the "
          f"preempt's ack {resume['checksum']}) in {resumed['restored']['seconds']:.3f} s and took step "
          f"{resumed['step']}: loss {resumed['loss']:.6f}, params {resumed['checksum']}, bit-equal to the first pod's "
          f"step on a copy; completedSteps {j['status']['completedSteps']}; counters {j['counters']}; goodput ratio "
          f"{j['goodput']:.4f}; events {sorted(j['events'])}; the episode {j['wall']:.1f} s; {smi}", flush=True)
    return launched


def _operator_accounting(acct, smi):
    """Phase 15's ChipAccountant, past torch_operator_flow.check_accounting's
    gates: its chip-seconds over the phase by class and phase printed."""
    cons = acct["conservation"]
    print(f"  accountant (every {acct['period']} s, {acct['ticks']['ok']} ticks, {acct['ticks']['error']} in error): "
          f"card-seconds by class and phase {({k: round(v, 3) for k, v in acct['by class and phase'].items()})}; "
          f"attributed {cons['attributed_chip_seconds']:.3f} against physical {cons['physical_chip_seconds']:.3f} "
          f"(residual {cons['residual_ratio']:.2e}, tolerance 1e-02); utilization "
          f"{acct['snapshot']['fleet_utilization']}; nodes {acct['attributed nodes']} (each stands for this card); "
          f"{smi}", flush=True)


# ---------------------------------------------------------------------------
# Phase 16: the lint lane (odh_kubeflow_tpu_torch.analysis) on this machine
# ---------------------------------------------------------------------------


def lint_phase(smi):
    """Phase 16 (module docstring): the lint's full pass and pragma gate in
    subprocesses, the live registry against the metric and SLO rules, the
    hot regions' static findings beside phase 9's guard, and the job space
    of the interleaving explorer."""
    import importlib.util
    import logging
    from pathlib import Path

    import odh_kubeflow_tpu_torch
    from odh_kubeflow_tpu_torch.analysis import explore, framework, metric_rules, run_analysis
    from odh_kubeflow_tpu_torch.analysis.checkers import make_checkers
    from odh_kubeflow_tpu_torch.analysis.checkers.torchlint import HostTransferChecker
    from odh_kubeflow_tpu_torch.runtime.alerts import default_rules
    from odh_kubeflow_tpu_torch.runtime.metrics import global_registry
    from odh_kubeflow_tpu_torch.runtime.slo import default_slos
    from odh_kubeflow_tpu_torch.utils import hotregions

    t_phase = time.perf_counter()
    pkg = Path(odh_kubeflow_tpu_torch.__file__).resolve().parent
    root = pkg.parent
    installed = {name: importlib.util.find_spec(name) is not None for name in ("jax", "yaml")}

    # (a) the full pass and the pragma gate, as a user runs them
    modules = sum(1 for _ in framework._iter_py_files(pkg))
    checkers = [c.name for c in make_checkers()]
    allowlist = pkg / "analysis" / "pragma_allowlist.txt"
    # `python -m odh_kubeflow_tpu_torch.analysis ARGS` with the imports refused
    refusing = (f"import runpy, sys\nfor name in {LINT_REFUSED!r}:\n    sys.modules[name] = None\n"
                "sys.argv = ['odh_kubeflow_tpu_torch.analysis'] + sys.argv[1:]\n"
                "runpy.run_module('odh_kubeflow_tpu_torch.analysis', run_name='__main__', alter_sys=True)\n")
    for label, args in (("full pass", []), ("pragma gate", ["--pragma-gate", str(allowlist)])):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", refusing, *args], cwd=root,
                              capture_output=True, text=True, timeout=PHASE16_BUDGET_S)
        took = time.perf_counter() - t0
        said = (proc.stdout.strip().splitlines() or [""])[-1]
        print(f"  lint {label}: exit {proc.returncode} in {took:.1f} s: {said}", flush=True)
        if proc.returncode != 0:
            fail(f"phase 16: the lint's {label} exited {proc.returncode}:\n{proc.stdout}{proc.stderr}")
    print(f"  the lint scanned {modules} modules of {pkg.name} with {len(checkers)} checkers "
          f"({', '.join(checkers)}), its imports of {', '.join(LINT_REFUSED)} refused; installed here: "
          f"jax {installed['jax']}, PyYAML {installed['yaml']}", flush=True)

    # (b) the registry phases 5-15 filled in this process
    families = len(global_registry._metrics)
    broken = metric_rules.check_registry(global_registry)
    slos = default_slos()
    rules = default_rules(slos)
    broken += metric_rules.check_slo_definitions(slos, rules, global_registry)
    print(f"  the live registry: {families} families, {len(slos)} SLOs, {len(rules)} alert rules; "
          f"violations {broken}", flush=True)
    if broken:
        fail(f"phase 16: the live registry breaks the port's metric rules: {broken}")

    # (c) the serving hot regions, static beside runtime
    regions = ("serving.decode_burst", "serving.prefill", "models.generate")
    paths = sorted({str(root / hotregions.get(name).module) for name in regions})
    shown = run_analysis(paths, checkers=[HostTransferChecker()], include_suppressed=True)
    left = run_analysis(paths, checkers=[HostTransferChecker()])
    engine = (pkg / "serving" / "engine.py").read_text().splitlines()
    skipped = {name: [f.line for f in shown if f"hot region {name!r}" in f.message] for name in regions}
    want = {"serving.decode_burst": [i for i, line in enumerate(engine, 1) if "host = torchguard.to_host(" in line],
            "serving.prefill": [i for i, line in enumerate(engine, 1) if "first = int(torchguard.to_host(" in line],
            "models.generate": []}
    guard = PHASE9_GUARD
    for name in regions:
        spec = hotregions.get(name)
        runtime = {"serving.decode_burst": f"{guard['burst_region']} copies inside a burst's region per engine, "
                                           f"{guard['drain']} drains after it",
                   "serving.prefill": f"{guard['prefill_region']} copies inside an admission's region per engine "
                                      f"({guard['admitted']} admitted)",
                   "models.generate": "0 copies (phase 9's armed generate())"}[name]
        print(f"  {name}: host-transfer {sum(f'hot region {name!r}' in f.message for f in left)} unsuppressed, "
              f"pragma'd lines {skipped[name]}; torchguard {runtime}; transfer budget {spec.transfer_budget}",
              flush=True)
    if left or skipped != want:
        fail(f"phase 16: host-transfer over the serving regions: unsuppressed {[str(f) for f in left]}, "
             f"pragma'd lines {skipped}, want {want}")
    if (guard["errors"] or any(n != 0 for n in guard["burst_region"]) or any(n != 1 for n in guard["drain"])
            or any(n != 1 for n in guard["prefill_region"])):
        fail(f"phase 16: phase 9's guard counts {guard}: want 0 copies in a burst's region, 1 drain after it "
             "and 1 copy in an admission's region")

    # (d) the job space of the interleaving explorer
    t0 = time.perf_counter()
    logging.disable(logging.CRITICAL)
    try:
        jobs = explore.explore_jobs()
    finally:
        logging.disable(logging.NOTSET)
    print(f"  explorer[jobs]: {jobs.schedules} quiesced schedules, {jobs.visited} scheduler states "
          f"({jobs.pruned} pruned), truncated={jobs.truncated}, exhausted={jobs.exhausted}, "
          f"violations {len(jobs.violations)}, {time.perf_counter() - t0:.1f} s", flush=True)
    if not jobs.ok:
        fail(f"phase 16: the job space is not clean and exhausted: {[(v.invariant, v.detail) for v in jobs.violations]}")

    took = time.perf_counter() - t_phase
    print(f"  phase 16 took {took:.1f} s (budget {PHASE16_BUDGET_S:.0f} s) on {smi}", flush=True)
    if took > PHASE16_BUDGET_S:
        fail(f"phase 16 took {took:.1f} s, over its budget of {PHASE16_BUDGET_S:.0f} s")


def main() -> None:
    if sys.argv[1:2] == ["--device-worker"]:  # phase 14's script in a rank torchrun starts
        _device_worker(*sys.argv[2:6])
        return
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs an NVIDIA card")
    try:
        from odh_kubeflow_tpu_torch.device import hopper_present
        from odh_kubeflow_tpu_torch.models import TransformerConfig, forward, generate, init_params
        from odh_kubeflow_tpu_torch.ops import _build, attention
        from odh_kubeflow_tpu_torch.serving.engine import ServingEngine
        from odh_kubeflow_tpu_torch.serving.server import build_engine_from_env
    except ImportError as e:
        fail(f"the port's package is not importable from here: {e}")
    if any(m == "jax" or m.startswith("jax.") or m == "odh_kubeflow_tpu"
           or m.startswith("odh_kubeflow_tpu.") for m in sys.modules):
        fail("the port pulled in jax or the JAX package")
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 matmuls in full f32
    torch.backends.cudnn.allow_tf32 = False

    phase("1 device")
    kind = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"device {kind} capability {cap} torch {torch.__version__} cuda {torch.version.cuda}")
    print(smi, flush=True)
    if not hopper_present(0):
        fail(f"{kind} (capability {cap}) is not a Hopper card; the kernels are sm_90a")
    peaks = card_peaks(kind)

    phase("2 build")
    t0 = time.perf_counter()
    _build.build_all()
    print(f"built {sorted(_build.SOURCES)} in {time.perf_counter() - t0:.1f} s")
    for name, info in _build.build_info.items():
        for line in ptxas_summary(info["log"]):
            print(f"  {name}: {line}")
    for lib in ("flash_fwd", "flash_bwd"):
        hgmma = count_sass(_build.library_path(lib), "HGMMA")
        print(f"  {lib} library: {hgmma} HGMMA (wgmma) instructions in its SASS", flush=True)
        if hgmma == 0:
            fail(f"the {lib} library holds no HGMMA instructions: no tensor-core kernel was built")
    for dtype in (torch.float32, torch.bfloat16):
        for d in attention.HEAD_DIMS:
            built = attention.fwd_launch_plan(dtype, 1, 128, 8, d)[0]
            if built != attention._fwd_kernel_for(dtype, d):
                fail(f"{dtype} d{d}: the C entry launches the {built} kernel, "
                     f"attention._fwd_kernel_for says {attention._fwd_kernel_for(dtype, d)}")
            built = attention.bwd_kernels_built(dtype, d)
            if built != attention._bwd_kernel_for(dtype, d):
                fail(f"{dtype} d{d}: the C entry launches the {built} backward kernels, "
                     f"attention._bwd_kernel_for says {attention._bwd_kernel_for(dtype, d)}")
    print("  kernels by (dtype, d), C entries = Python mirrors: " + ", ".join(
        f"{DTYPE_NAMES[dt]} d{d} {attention._fwd_kernel_for(dt, d)} + "
        f"{'/'.join(attention._bwd_kernel_for(dt, d))}"
        for dt in (torch.float32, torch.bfloat16) for d in attention.HEAD_DIMS), flush=True)
    # dq's launch plan: the C entries (odh_flash_bwd_dq_tile_q, _k_split)
    # against the Python mirror at the main paths' shapes and at each
    # (q tile, cluster size) the rule gives
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan_shapes = [GRAD_CHECK_SHAPE, MAIN_SHAPE, TRAIN_SHAPE, (1, len(DEMO_PROMPTS[0]), 4, 2, 16)]
    plan_shapes += [(b, s, h, hk, d) for _, b, s, _, h, hk, d, *_ in scalar_dq_split_cases(attention, sms)]
    plans = []
    for dtype in (torch.float32, torch.bfloat16):
        for b, s, h, hk, d in plan_shapes:
            for causal in (True, False):
                kernel, tile = attention.bwd_dq_launch_plan(dtype, b, s, h, d)
                split = attention.scalar_splits(dtype, d, b, s, s, h, hk, causal)[2]
                want = ((attention._bwd_kernel_for(dtype, d)[0],
                         *attention._scalar_dq_plan(b, s, s, h, causal, sms))
                        if kernel == "flash_bwd_dq_scalar" else ("flash_bwd_dq", 128, 1))
                if (kernel, tile, split) != want:
                    fail(f"{DTYPE_NAMES[dtype]} b{b} s{s} h{h} d{d} causal={causal}: the C entries "
                         f"plan dq as {(kernel, tile, split)}, the Python mirror says {want}")
                plans.append((kernel, tile, split))
    print(f"  dq launch plans, C entries = Python mirror at {len(plans)} shapes: "
          f"{sorted(set(plans))}", flush=True)

    phase("3 flash_fwd kernels vs plain")
    cases = [
        # (label, b, sq, sk, h, hk, d, dtype, causal, with_lse, strided)
        ("main-path prefill", *MAIN_SHAPE[:2], 128, *MAIN_SHAPE[2:], torch.bfloat16, True, False, True),
        ("main-path prefill lse", 1, 128, 128, 8, 8, 128, torch.bfloat16, True, True, True),
        ("4x2048 causal", 4, 2048, 2048, 8, 8, 128, torch.bfloat16, True, False, False),
        ("4x2048 causal lse", 4, 2048, 2048, 8, 8, 128, torch.bfloat16, True, True, False),
        ("training shape 8x2048 lse", 8, 2048, 2048, 8, 8, 128, torch.bfloat16, True, True, True),
        ("4x2048 non-causal", 4, 2048, 2048, 8, 8, 128, torch.bfloat16, False, False, False),
        ("gqa 16/4", 2, 2048, 2048, 16, 4, 128, torch.bfloat16, True, True, False),
        ("ragged 200", 1, 200, 200, 8, 8, 128, torch.bfloat16, True, True, False),
        ("sq!=sk non-causal", 2, 300, 700, 8, 4, 128, torch.bfloat16, False, True, False),
        ("f32 main-path", 1, 128, 128, 8, 8, 128, torch.float32, True, True, True),
        ("f32 ragged gqa", 2, 333, 333, 8, 2, 64, torch.float32, True, True, False),
        ("f32 sq!=sk", 1, 100, 260, 4, 4, 32, torch.float32, False, True, False),
        ("f32 demo-model d16", 1, 37, 37, 4, 2, 16, torch.float32, True, False, True),
        ("bf16 d64 gqa", 2, 130, 130, 8, 2, 64, torch.bfloat16, True, True, False),
        ("bf16 d32 non-causal", 1, 96, 96, 4, 4, 32, torch.bfloat16, False, False, False),
        *tile_edge_cases(sms),
    ]
    # the scalar kernel at its tile edges: lse on the causal half
    scalar_edges = scalar_tile_edge_cases(attention, sms)
    want_tile = {c[0]: c[-1] for c in scalar_edges}
    cases += [(label, b, sq, sk, h, hk, d, dtype, causal, causal, strided)
              for label, b, sq, sk, h, hk, d, dtype, causal, strided, _ in scalar_edges]
    errors, plans = [], set()
    main_err = train_fwd_err = f32_main_err = 0.0
    for i, (label, b, sq, sk, h, hk, d, dtype, causal, with_lse, strided) in enumerate(cases):
        q, k, v = inputs(b, sq, sk, h, hk, d, dtype, seed=i, strided=strided)
        kernel, tile_q = attention.fwd_launch_plan(dtype, b, sq, h, d)
        plans.add((kernel, tile_q))
        plan = f"{kernel}, {tile_q}-row q tiles"
        if kernel == "flash_fwd_scalar":
            split = attention.scalar_splits(dtype, d, b, sq, sk, h, hk, causal)[0]
            plan += f", {split}-block clusters"
            if tile_q != want_tile.get(label, attention._scalar_tile(sq, b * h, sms)):
                errors.append(f"{label}: q tile {tile_q}")
        got = attention.flash_attention(q, k, v, causal=causal, with_lse=with_lse)
        ref = attention.flash_attention_plain(q, k, v, causal=causal, with_lse=with_lse)
        torch.cuda.synchronize()
        out, lse = got if with_lse else (got, None)
        ref_out, ref_lse = ref if with_lse else (ref, None)
        if out.shape != ref_out.shape or out.dtype != q.dtype:
            fail(f"{label}: out {tuple(out.shape)} {out.dtype}, want {tuple(ref_out.shape)} {q.dtype}")
        err = (out.float() - ref_out.float()).abs().max().item()
        ok = torch.isfinite(out.float()).all().item() and err <= TOLERANCE[dtype]
        msg = f"  {label} [{plan}]: out max_abs_err {err:.3e} (tol {TOLERANCE[dtype]:.0e})"
        if with_lse:
            lse_err = (lse - ref_lse).abs().max().item()
            ok = ok and lse_err <= LSE_TOLERANCE
            msg += f", lse {lse_err:.3e} (tol {LSE_TOLERANCE:.0e})"
        print(msg + ("" if ok else "  <-- FAIL"), flush=True)
        if not ok:
            errors.append(label)
        if label.startswith("main-path prefill"):
            main_err = max(main_err, err)
        if label.startswith("training shape"):
            train_fwd_err = err
        if label == "f32 main-path":
            f32_main_err = err
    if errors:
        fail(f"flash_fwd disagrees with its plain version: {errors}")
    if not {("flash_fwd", 64), ("flash_fwd", 128), ("flash_fwd_scalar", 64), ("flash_fwd_scalar", 32),
            ("flash_fwd_scalar", 16)} <= plans:
        fail(f"phase 3 did not run every forward kernel and q tile: {sorted(plans)}")

    phase("3b flash_bwd_dq / flash_bwd_dkv kernels vs plain")
    bwd_err = check_backward(attention, sms)

    phase("4 timing")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    timings = {}
    for tag, (b, s, h, hk, d), dtype in (("main", MAIN_SHAPE, torch.bfloat16),
                                          ("large", TIMING_SHAPE, torch.bfloat16),
                                          ("scalar main", MAIN_SHAPE, torch.float32)):
        q, k, v = inputs(b, s, s, h, hk, d, dtype, seed=100)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        flops, nbytes = work(b, s, s, h, hk, d, dtype, True, False)
        b_ms, b_by = bound_ms(flops, nbytes, peaks, dtype)
        def kernel():
            return attention.flash_attention(q, k, v, causal=True)

        def library():
            return sdpa(qt, kt, vt, is_causal=True)

        t = {
            "ms": time_ms(kernel),
            "plain_ms": time_ms(lambda: attention.flash_attention_plain(q, k, v, causal=True)),
            "library_ms": time_ms(library),
            "eager_ms": eager_ms(kernel), "library_eager_ms": eager_ms(library),
            "bound_ms": b_ms, "bound_by": b_by, "flops": flops, "bytes": nbytes,
            "shape": f"b{b} s{s} h{h} hk{hk} d{d} {DTYPE_NAMES[dtype]} causal",
            "kernel": attention._fwd_kernel_for(dtype, d),
        }
        timings[tag] = t
        print(f"  {t['kernel']} kernel, {t['shape']}: kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, sdpa {t['library_ms']:.4f} ms (device, CUDA graph); "
              f"launched from Python: kernel {t['eager_ms']:.4f} ms, sdpa "
              f"{t['library_eager_ms']:.4f} ms; {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB, "
              f"bound {b_ms:.4f} ms ({b_by}); kernel at {flops / (t['ms'] * 1e-3) / 1e12:.2f} "
              f"TFLOP/s, {b_ms / t['ms']:.3%} of bound, {t['ms'] / t['library_ms']:.2f}x SDPA's "
              f"time on {smi}", flush=True)
    q, k, v = inputs(*MAIN_SHAPE[:2], MAIN_SHAPE[1], *MAIN_SHAPE[2:], torch.bfloat16, seed=101,
                     strided=True)
    split = host_split_us(attention, q, k, v)
    print("  tensor-core forward, serving shape, host clock per call: " + ", ".join(
        f"{name} {us:.1f} us" for name, us in split.items()), flush=True)
    train_timings = time_training_kernels(attention, peaks, smi)
    train_timings.update(time_scalar_bwd_kernels(attention, peaks, smi))
    scalar_fwd_timings = time_scalar_fwd_kernel(attention, peaks, smi, len(DEMO_PROMPTS[0]))

    phase("5 serving path, full width")
    cfg = TransformerConfig(
        vocab=32768, d_model=1024, n_layers=8, n_heads=8, d_ff=4096,
        max_seq=2048, dtype=torch.bfloat16, use_flash=True, remat=False,
    )
    t0 = time.perf_counter()
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cuda")
    n_params = sum(t.numel() for t in [params["embed"], params["unembed"], *params["layers"].values()])
    print(f"  init {n_params / 1e6:.1f}M params in {time.perf_counter() - t0:.1f} s")

    # the flash kernel against the reference attention through the whole
    # model, in f32 on the same weights
    params32 = {k: v.float() for k, v in params.items() if k != "layers"}
    params32["layers"] = {k: v.float() for k, v in params["layers"].items()}
    probe = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab, (1, 128)), device="cuda")
    cfg32 = TransformerConfig(**{**cfg.__dict__, "dtype": torch.float32})
    cfg32_ref = TransformerConfig(**{**cfg32.__dict__, "use_flash": False})
    logit_err = (forward(params32, probe, cfg32) - forward(params32, probe, cfg32_ref)).abs().max().item()
    print(f"  f32 forward logits, flash kernel vs reference attention: max_abs_err {logit_err:.3e} (tol 2e-3)")
    if not logit_err <= 2e-3:
        fail(f"forward through the kernel disagrees with the reference: {logit_err}")
    del params32

    engine = warm_engine(ServingEngine(params, cfg, max_slots=8, max_seq=512, decode_burst=8,
                                       check_syncs=True, device="cuda"))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, 128).tolist() for _ in MAX_NEWS]
    replies, launches = serve_over_http(engine, prompts, attention)
    # every forward launch of the serving path runs the tensor-core kernel
    want = cfg.n_layers * len(prompts)
    if launches["flash_fwd"] != want or launches["flash_fwd_scalar"]:
        fail(f"forward launches on the serving path {launches}, want flash_fwd {want} "
             "and flash_fwd_scalar 0")

    same = total = first_same = 0
    for i, (_, body) in sorted(replies.items()):
        ref = generate(params, [prompts[i]], cfg, MAX_NEWS[i], max_seq=512, device="cuda")[0].tolist()
        same += sum(a == b for a, b in zip(body["tokens"], ref))
        total += len(ref)
        first_same += body["tokens"][0] == ref[0]
    print(f"  token agreement with generate(): {same}/{total} ({same / total:.3f}); "
          f"first tokens {first_same}/{len(replies)}")
    if first_same != len(replies):
        fail("the engine's first tokens (prefill logits) differ from generate()'s")
    burst_split(engine, prompts)

    demo = build_engine_from_env({}).start()
    handle = demo.submit([1, 2, 3, 4], max_new=8)
    ok = handle.wait(timeout=120) and handle.result == "ok" and len(handle.tokens) == 8
    demo.stop()
    print(f"  demo model (build_engine_from_env): {handle.result} {handle.tokens}")
    if not ok:
        fail("the demo engine did not serve its request")
    # f32 on the card: the engine's greedy tokens against generate()'s
    demo_prompts = DEMO_PROMPTS
    attention.reset_launch_counts()
    handles = [demo.submit(p, max_new=24) for p in demo_prompts]
    if not demo.run_until_idle(timeout=120):
        fail("the demo engine did not finish")
    demo_launches = dict(attention.launch_counts)
    print(f"  demo model (f32, d{demo.cfg.head_dim}): launches for "
          f"{len(demo_prompts)} requests {demo_launches}")
    if demo_launches["flash_fwd_scalar"] != demo.cfg.n_layers * len(demo_prompts):
        fail(f"the demo model's forward launches {demo_launches}, want flash_fwd_scalar "
             f"{demo.cfg.n_layers * len(demo_prompts)}")
    same = sum(
        h.tokens == generate(demo.params, [p], demo.cfg, 24, max_seq=demo.max_seq,
                             device="cuda")[0].tolist()
        for h, p in zip(handles, demo_prompts)
    )
    print(f"  demo model f32: engine tokens equal generate()'s for {same}/{len(handles)} requests")

    phase("6 training path, full width")
    train_launches, grad_check_launches, run = train_phase(attention, peaks, smi)

    phase("7 checkpoint, restore and the probe agent, full width")
    ckpt_launches = checkpoint_phase(attention, smi, cfg, params, run)
    del run

    phase("8 MoE serving and training path, full width")
    moe_paths = moe_phase(attention, peaks, smi)

    phase("9 the token router over two engines, traced, profiled and guarded, full width")
    router_launches = router_phase(attention, smi, cfg, params)

    ranks = _RankPool(RANK_POOL_WORLD)  # phases 10-13's ranks, spawned once
    try:
        phase("10 sequence parallelism: ring attention and the sp train step, ranks sharing this card")
        sp_launches = sp_phase(attention, smi, ranks)

        phase("11 the fsdp/tp sharded train step and the sharded checkpoint, ranks sharing this card")
        sp_launches.update(shard_phase(attention, smi, ranks))

        phase("12 tensor-parallel generate, tp with shared kv heads and the ep MoE train step, ranks sharing "
              "this card")
        sp_launches.update(ep_phase(attention, smi, ranks))

        phase("13 the pipelines: GPipe, 1F1B and interleaved 1F1B over a pp axis, ranks sharing this card")
        sp_launches.update(pp_phase(attention, smi, ranks))
    finally:
        ranks.close()

    phase("14 the device layer: ranks started by torchrun from a rendered pod env, on this card")
    sp_launches.update(device_phase(attention, smi))

    phase("15 the operator: Notebook CR -> a GPU pod serving the flagship -> culled, on this card")
    sp_launches.update(operator_phase(attention, smi))

    phase("16 the lint lane: the port's analysis on this machine, beside phase 9's guard and the live registry")
    lint_phase(smi)

    def moe_launches(name):
        return {path: launched[name] for path, launched in moe_paths.items() if launched[name]}

    def sp(name):  # phases 10-15's launches of the kernel, summed over their ranks
        return {path: launched[name] for path, launched in sp_launches.items() if launched.get(name)}

    def timing_keys(t):
        return {k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")}

    main, scalar = timings["main"], timings["scalar main"]
    src = "odh_kubeflow_tpu_torch/ops/csrc/"
    kernels = [{
        "name": "flash_fwd",
        "variant": "tensor cores (wgmma, TMA): bf16 at d 64 and 128",
        "route": "cuda",
        "source": src + "flash_fwd.cu",
        "replaces": "odh_kubeflow_tpu/ops/attention.py:176",
        # every main path launches it: 8 per request served, 8 per train
        # step; phase 7's steps, logit fingerprints and restored endpoint;
        # phase 8's MoE requests and steps; phase 9's routed, drained and
        # hedged requests
        "launches": (launches["flash_fwd"] + train_launches["flash_fwd"] + ckpt_launches["flash_fwd"]
                     + sum(moe_launches("flash_fwd").values()) + router_launches["flash_fwd"]
                     + sum(sp("flash_fwd").values())),
        "launches_by_path": {"serve": launches["flash_fwd"], "train": train_launches["flash_fwd"],
                             "checkpoint/restore": ckpt_launches["flash_fwd"],
                             **moe_launches("flash_fwd"), "router": router_launches["flash_fwd"],
                             **sp("flash_fwd")},
        "max_abs_err": main_err,
        **timing_keys(main),
        "eager_ms": main["eager_ms"],
        "train": {**timing_keys(train_timings["flash_fwd"]), "max_abs_err": train_fwd_err,
                  "library": train_timings["flash_fwd"]["library"]},
    }, {
        "name": "flash_fwd_scalar",
        "variant": ("register-tiled f32 FMAs on the CUDA cores, cp.async ring, key split over "
                    "clusters: f32 at every d, bf16 at d 16 and 32"),
        "route": "cuda",
        "source": src + "flash_fwd.cu",
        "replaces": "odh_kubeflow_tpu/ops/attention.py:176",
        # the demo model's serving path (f32, d 16) and phase 6's f32
        # gradient check (d 128, s 512)
        "launches": (demo_launches["flash_fwd_scalar"] + grad_check_launches["flash_fwd_scalar"]
                     + ckpt_launches["flash_fwd_scalar"] + sum(moe_launches("flash_fwd_scalar").values())
                     + sum(sp("flash_fwd_scalar").values())),
        "launches_by_path": {"serve demo model": demo_launches["flash_fwd_scalar"],
                             "f32 gradient check": grad_check_launches["flash_fwd_scalar"],
                             "checkpoint/restore": ckpt_launches["flash_fwd_scalar"],
                             **moe_launches("flash_fwd_scalar"), **sp("flash_fwd_scalar")},
        "max_abs_err": f32_main_err,
        **timing_keys(scalar),
        "eager_ms": scalar["eager_ms"],
        "grad_check": {**timing_keys(scalar_fwd_timings["grad check"]),
                       "library": scalar_fwd_timings["grad check"]["library"]},
        "demo_prefill": {**timing_keys(scalar_fwd_timings["demo prefill"]),
                         "library": scalar_fwd_timings["demo prefill"]["library"]},
    }]
    for name, fn, line, variant, launched, path in (
            ("flash_bwd_dq", "_flash_bwd_dq_kernel", 464, "tensor cores (wgmma, TMA): bf16 at d 64 and 128",
             train_launches, "train"),
            ("flash_bwd_dkv", "_flash_bwd_dkv_kernel", 505, "tensor cores (wgmma, TMA): bf16 at d 64 and 128",
             train_launches, "train"),
            # the f32 gradient check of phase 6 (2 layers)
            ("flash_bwd_dq_scalar", "_flash_bwd_dq_kernel", 464,
             "register-tiled f32 FMAs on the CUDA cores, cp.async ring, key split over clusters: f32 at "
             "every d, bf16 at d 16 and 32", grad_check_launches, "f32 gradient check"),
            ("flash_bwd_dkv_scalar", "_flash_bwd_dkv_kernel", 505,
             "register-tiled f32 FMAs on the CUDA cores, cp.async ring, q split over clusters: f32 at "
             "every d, bf16 at d 16 and 32", grad_check_launches, "f32 gradient check")):
        t = train_timings[name]
        kernels.append({
            "name": name,
            "variant": variant,
            "route": "cuda",
            "source": src + "flash_bwd.cu",
            "replaces": f"odh_kubeflow_tpu/ops/attention.py:{line} ({fn})",
            "launches": (launched[name] + ckpt_launches[name] + sum(moe_launches(name).values())
                         + sum(sp(name).values())),
            "launches_by_path": {path: launched[name], "checkpoint/restore": ckpt_launches[name],
                                 **moe_launches(name), **sp(name)},
            "max_abs_err": bwd_err[name],
            **timing_keys(t),
            "library": t["library"],
        })
    end_phase()
    print("phase times: " + ", ".join(f"{n} {t:.1f} s" for n, t in PHASE_TIMES.items())
          + f"; {smi}", flush=True)
    print(f"the smoke took {time.time() - STARTED:.1f} s on {smi}", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
