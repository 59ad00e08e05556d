#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # from the repository root, one CUDA card

Phases, in order; any failure raises and exits non-zero without the final
ok line:

1. the card's name and power limit (nvidia-smi) and the kernel build
   (``nvcc`` of every ``mpi_tpu_torch/csrc`` source, in parallel, timed),
   with the registers and spills ``ptxas`` reports for every kernel
   instance;
2. Jacobi through ``mpi_tpu_torch.run(jacobi_program, nranks=8)`` on the
   card, against the same program on the CPU;
3. the main path of the collectives: a data-parallel step through ``run(..., nranks=8)`` with a
   256 MiB float32 gradient per rank that differs by rank — the north-star
   ``allreduce(algorithm="pallas_ring")``, then the ZeRO pair
   ``reduce_scatter`` / ``allgather`` on the same kernel.  Launch counters
   are zeroed just before and read just after; every mode must have
   launched.  Each result must equal the plain version on the card
   (``torch.equal``, bitwise) and the allreduce must agree with a float64
   sum (rtol 1e-5);
4. kernel vs plain version on the card, bitwise (``torch.equal``, NaN
   positions included), for every mode x {float32, bfloat16} x
   {SUM, MAX, MIN} x {whole world, 2 groups of 4, the dry run's dp groups
   of 2 at stride 4} at ragged and aligned small sizes;
5. the multi-parallel dry run, ``mpi_tpu_torch.entry.dryrun_multichip(8)``
   on the card with the reference's shapes (a 2 x 4 layout, then the 1-D
   attention leg against its float64 oracle).  Counters zeroed before and
   read after: the attention forward and both backward kernels must have
   launched;
6. the full-width multi-parallel step: one ``entry._build_step(2, 4, ...)``
   step at Llama-3-8B's MLP widths (``meta-llama/Meta-Llama-3-8B``
   ``config.json``: hidden_size 4096, intermediate_size 14336, so 3584 per
   mp rank), 2048 rows per dp shard, float32, the reference's init (x, y
   ~ N(0, 1), weights 0.1 N(0, 1)), once with ``dp_algorithm="ring"`` and
   once with ``"pallas_ring"``, whose ring kernel must launch on the dp
   groups [[0, 4], [1, 5], [2, 6], [3, 7]] (counters and the groups it was
   handed).  The two spellings agree within rtol 1e-5, atol 1e-6
   (``tests/test_dryrun.py:63-65``), and each agrees with a float64 dense
   step on the card: the loss within rtol 1e-5, the w1 and w2 updates
   within 1e-2 of their norm (relu kinks under float32 rounding, see
   ``step_phase``; the largest share of each allowance is recorded); a
   second step takes the first one's outputs.  Then the step is timed by both spellings with CUDA events
   (median of 5 after 1 warm-up; pallas_ring also by
   ``mpi_tpu_torch.profiling.timeit``), the ring kernel alone on the step's
   gradient (its share of the step), the fused SUM backward's rule alone
   and the step with it against the step with the old pass-through rule
   (in turns), and one pallas_ring step is traced with
   ``profiling.trace``, whose Chrome trace is read back
   (``profiling.trace_summary``: device time by kernel, the device's busy
   time and idle share, kernel launches counted apart from copies and
   fills);
6a. checkpoint: the full-width step's w1 and w2 after step 1, laid out as
   the reference's out_specs over the 2 x 4 mesh, through
   ``checkpoint.save_sharded`` under chiprun_out/ and ``load_sharded``
   onto the card; step 2 from the loaded state equals step 2 from the
   state in memory, bitwise (bytes, save and load seconds printed; the
   files are removed after);
6b. AOT: ``entry.lower_multichip(8)`` at the reference's shapes on fake
   tensors (no change in allocated device memory; the pallas_ring graph
   holds one ``ring_fold`` node and ``attn_fwd`` nodes), then
   ``entry.export_multichip(8, "pallas_ring")`` at full width through
   ``torch.export.save`` / ``load``: the loaded program's outputs equal the
   eager step's bitwise and it launches K1 and K2 (counters zeroed before
   and read after); both timed with CUDA events (median of 5);
6c. gradient: the fused SUM's gradient where the reduced value meets
   rank-varying values (marked by ``comm.localize``), in a residual block,
   and where it feeds replicated computation, on the card against the CPU
   (rtol 1e-5, atol 1e-6); the unmarked mixed program raises naming
   ``comm.localize`` on both;
7. the examples ``jacobi2d``, ``pipeline``, ``moe``, ``ulysses_attention``
   and ``data_parallel`` through ``run(..., nranks=8)`` on the card at
   their default sizes, each against the same program on the CPU (the
   programs that draw with ``rank_normal`` on the card's draws, carried
   across), moe and pipeline also against their numpy oracles (see each
   ``agree`` call for its tolerance);
8. timing with CUDA events at the north-star sizes: the kernel and one
   PyTorch library call computing the same function, in turns (kernel,
   library, library, kernel, twice), each turn timed two ways: launched one
   at a time with a synchronisation after each (``time_ms``, median of 10
   runs after 2 warm-up runs; it holds the host's time to prepare the
   launch: the ``ms`` and ``library_ms`` of the ``kernels`` line) and 20
   back-to-back launches (``time_b2b``, median of 5: the card's time alone,
   ``ms_b2b`` and ``library_ms_b2b``), the median of each side's four
   turns; the plain version (``time_ms``); beside the least time the card
   could take (bytes moved over the 3.35 TB/s datasheet rate), and the
   measured device-to-device copy rate;
9. ring attention, serving leg: a per-rank program that draws its Q/K/V
   with ``mpi_tpu_torch.rank_normal`` and calls
   ``mpi_tpu_torch.gpu.attention.ring_attention``, through ``run(...,
   nranks=8)``, at Llama-3-8B's attention geometry (32 query heads, 8 K/V
   heads, head dim 128; ``meta-llama/Meta-Llama-3-8B`` ``config.json``)
   over a causal sequence of 32 768 (4096 rows per rank), bfloat16 and then
   float32.  The forward kernel must have launched; the output must agree
   with the plain version on the card (see ``check_close``);
10. ring attention, training leg: one ``sharded_train_step`` of
    ``mpi_tpu_torch.examples.long_context_training`` through ``run(...,
    nranks=8)`` at 4096 rows per rank, d = 128, float32, causal.  Every
    attention kernel must have launched; loss and gradients must agree with
    the dense one-device step on the card (the tolerances of
    ``tests/test_long_context.py:180-185``);
11. attention kernels vs plain versions on the card: {float32, bfloat16} x
    {full, causal} x {MHA 4/4, GQA 4/2, MQA 4/1} x {world of 8, 2 groups of
    4} x Sb in {16, 48, 112, 128} (and 8, the dry run's block, in float32)
    x d in {128, 256}, and the forms above d = 256 at d in {384, 512, 1024}
    x {GQA 4/2, MQA 4/1} x Sb in {16, 112} x the same dtypes, masks and
    groupings (and at d = 640 and 1152, Sb = 112: the clusters of 5
    blocks, and of 3 blocks of 3 passes each, of the forward and of the
    backward), forward (out and lse) and backward (dq, dk, dv), with the
    tolerances of ``check_close`` (Sb = 8, 16, 48 and 112 end in a partial
    tile; the grid is ``parity_grid``); then the bf16 backward at d = 128,
    causal, on the split check's inputs (``SPLIT_SEEDS`` x
    ``SPLIT_SHAPES``, numpy draws as tests/test_torch_attention_split.py
    makes them), held the same way and its largest share recorded;
12. attention at the serving shape, in bfloat16 (the ``kernels`` line) and
    float32 (the record): the forward (out and lse) and the backward
    kernels against the plain version (see ``check_close``), the forward
    and the backward each against itself (two launches must be bitwise
    equal: no atomics, a fixed order of sums); then timing with CUDA events (medians of 3:
    forward and backward count the checks' launches, which were their
    warm-up; each backward kernel alone 3 launches after them): forward,
    backward (both kernels and each alone), the plain versions (the
    checks' runs, once), and as a
    yardstick only ``scaled_dot_product_attention`` on the whole sequence
    (forward, backward alone from the forward's saved outputs, and both;
    1 warm-up before the first two),
    beside the least time the card could take (operations over the
    datasheet peak: 989 TFLOP/s for bfloat16 inputs; for float32, 495/3
    TFLOP/s, the rate of a float32-accurate product split into three TF32
    tensor-core products, as every attention kernel multiplies; bytes over
    3.35 TB/s), the achieved TFLOP/s and each kernel's design floor
    (``FLOOR_FLOPS_PER_ENTRY``); for bfloat16 also the forward's time over
    SDPA's forward, the backward pair's over SDPA's backward, and the
    kernels' registers and spills (``fwd_ptxas``, ``bwd_ptxas``);
12a. the forms above d = 256 (``csrc/attention_wide.cu``,
    ``csrc/attention_bwd_wide.cu``) on their main paths: the wide-head
    serving leg, ``serving_program`` through ``run(..., nranks=8)`` at
    ``WIDE_SERVE`` (8 query heads, 2 K/V heads, d = 512: Llama-3-8B's
    attention width 4096 and GQA group of 4, over the serving leg's causal
    sequence of 32 768), bfloat16 and float32, counters zeroed before and
    read after (the wide forward must have launched, no d <= 256 form),
    against the plain version (timed once); at that shape the forward once
    (bitwise the serving leg's) and each backward kernel once, in bfloat16
    twice (CUDA events, the median of the launches; the two bfloat16
    launches must be bitwise equal; the float32 forms' are the training
    step's below), the
    backward against the plain version (timed once, ``check_close``
    normwise), and as a yardstick only SDPA's memory-efficient backend
    (flash and cuDNN stop at d = 256; K/V heads repeated, since it takes
    no GQA; forward and backward alone, once each after a warm-up forward;
    its error kept if it refuses), beside the operations bound and the
    design floor
    (``wide_floor_flops``: the clusters form Q K^T and dO V^T once a
    pass), each cluster kernel's
    cluster size, passes, registers and spills; then one step of
    ``long_context_training``'s ``sharded_program`` at d = 512
    (``init_params(512, 1024)``, 8 x 4096 rows, float32) through ``run``:
    all three wide forms launched under autograd, a second step on the same
    inputs bitwise equal, loss and gradients against the dense step (phase
    10's tolerances);
13. host-local: the host layer's local backend, 8 rank threads on the
    card through ``run(..., backend="local", nranks=8)``, seeded normal
    float32: the north-star ``ring`` allreduce at 256 MiB per rank, and at
    32 MiB per rank (``HOST_LOCAL_SMALL_ELEMS``) allreduce by
    ``recursive_halving``, ``rabenseifner`` and ``reduce_bcast``,
    reduce_scatter, allgather (``ring`` and ``doubling``, 4 MiB per rank
    in), bcast (the segmented tree) and alltoall.  Each result is held bitwise across ranks (or
    against the copies it must be), bitwise against the same program run
    by the same engine with ``device="cpu"`` in this process, and the
    reductions within rtol 1e-5, atol 1e-5 of a float64 sum; each
    collective's median ms over 2 timed calls after 1 warm-up (a
    synchronize before the clock stops, the slowest rank's time) and its
    bandwidth; one ring allreduce traced with ``profiling.trace`` for the
    card's busy share;
14. host-socket: ``python -m mpi_tpu_torch.launcher -n 4
    mpi_tpu_torch/examples/host_allreduce.py`` — 4 rank processes on the
    card over loopback TCP: ring and Rabenseifner allreduce at 256 MiB per
    rank (every rank regenerates every input for a float64 check and
    matches rank 0 bitwise, and the ``bytes_pickled_sent`` pvar must not
    move), a 1 KiB float32 allreduce on 2 ranks (the ``BASELINE.json``
    latency config), and the examples of phase 15 as socket ranks;
15. the examples ``pi`` and ``jacobi``, unmodified, under
    ``backend="local"`` on the card and as the launcher's socket ranks,
    against their SPMD results on the card (bitwise);
16. host-nbc: 8 local rank threads on the card with ``progress="thread"``:
    (a) 1000 concurrent 1 KiB ``iallreduce``s per rank, then a waitall —
    ``nbc_threads_spawned`` must read 0 and ``nbc_state_machines`` 1000 per
    rank, every result bitwise equal to the blocking allreduce's; (b)
    every i-collective at 1 MiB per rank (``nbc_sm_max_bytes``' default,
    the largest state-machine payload), bitwise against the blocking call
    and against the same program with ``device="cpu"``; (c) ``iallreduce``
    at 256 MiB per rank (the segmented thread path) overlapping bf16
    [8192, 8192] products, as many as make the computation alone about as
    long as the allreduce alone: t_comm, t_comp, t_both and overlap =
    (t_comm + t_comp - t_both) / min(t_comm, t_comp); (d) ``allreduce_init``
    at 1 MiB, 20 rounds refilled in place on the card, each bitwise equal
    to the blocking call, ``persistent_starts`` 20 per rank, ms per round
    beside ``iallreduce``'s ms per call;
17. host-ft-local: 8 local ranks on the card with fault tolerance
    (``fault_detect_timeout_s`` 2.0, heartbeat 0.2 s): rank 5 dies by
    ``FaultyTransport(kill_after_n=448)`` (half-way through the
    reduce-scatter) inside a 256 MiB ring allreduce;
    every survivor raises ``ProcFailedError`` with ``failed == (5,)``,
    collective ``allreduce`` and a segment, within 3 x 2.0 + 8 s of the
    death; then ``failure_ack`` and an agreement among the survivors (so
    each has its diagnosis before anyone revokes), revoke, shrink to 7
    ranks (epoch 1), ``agree(True)``, and
    a 256 MiB ring allreduce on the shrunk world, bitwise across ranks and
    against the same 7-rank program on the CPU;
18. host-ft-socket: ``examples/host_ft.py`` — 4 socket rank processes on
    the card with ``MPI_TPU_FT=1`` and ``MPI_TPU_PROGRESS=thread``: rank 1
    ``os._exit(42)``s while rank 0 is inside a 256 MiB ring allreduce;
    rank 0 raises ``ProcFailedError``, ranks 2-3 ``RevokedError``, within
    the bound; shrink, agree, the survivors' allreduce; ``accept_rejoin``
    and a fresh process's ``membership.rejoin`` into slot 1 at epoch 1; the
    full world's 256 MiB allreduce bitwise across ranks and against a
    float64 sum; detection, shrink and rejoin seconds and the launcher's
    per-rank exit summary;
19. host-verify-local: the runtime verifier and the flight recorder on 8
    local rank threads on the card.  (a) the off-mode contract: a 256 MiB
    float32 ring allreduce per rank run off, with ``verify=True`` and with
    ``trace=True`` in turns (1 warm-up and 1 timed call each, the ms and
    the two overhead factors printed), then 200 calls of a 1 KiB allreduce
    by the default algorithm the same three ways; off, every ``verify_*`` pvar and ``trace_events`` read 0; in all
    three ``bytes_pickled_sent`` is 0, ``payload_copies`` is the same, and
    the results are bitwise equal.  (b) the seeded bugs of
    ``tests/test_verify.py`` with tensors on the card, at
    ``verify_stall_timeout_s`` = 1.0, each caught on every rank and timed
    (under the reference test's 20 s): the head-to-head ``recv`` cycle and
    a wait on an exited rank (``DeadlockError``), a 256 MiB ``allreduce``
    against a ``bcast`` (``CollectiveMismatchError`` on all 8 ranks, with
    ``bytes_sent`` moving by far less than one payload: only signatures
    travel), float32 against bfloat16 reduce geometry, concurrent against
    ordered wildcard senders (one race line, none), a leaked ``irecv`` and
    overlapping ``irecv(buf=)`` slices of one CUDA tensor (report lines),
    and an ``allreduce_init`` round result held across two starts
    (``BufferPinnedError``).  (c) no false positive from device work: rank
    0 runs more than 3 s of bfloat16 products before a 16 MiB ring
    allreduce its peers already wait in; the sum is right and
    ``verify_deadlocks_detected`` reads 0;
20. host-verify-socket: ``python -m mpi_tpu_torch.launcher -n 4 --verify
    mpi_tpu_torch/examples/host_verify.py``: a 256 MiB ring clean under the
    verifier (no payload byte pickled), the wildcard race named across
    processes, (c)'s products on socket ranks, and a receive cycle through
    all 4 processes diagnosed on every side through the rendezvous
    directory's pending files;
21. host-trace: ``python -m mpi_tpu_torch.launcher -n 4 --trace-dir ...
    mpi_tpu_torch/examples/host_trace.py``: a 256 MiB ring allreduce, then
    each other host collective once at 1 MiB, exit through ``finalize``; one
    Chrome trace per rank, merged by ``mpi_tpu_torch.tools.tracecat`` with
    no negative-latency frame after alignment, every allreduce span
    ``algorithm="ring"`` with 268435456 bytes; ``coll_latency_s`` p50/p99,
    events, drops, ``profiling.comm_stats()``, and each span's host ms
    beside the wall of the same call with a synchronize;
22. host-compress-tune, on 8 local rank threads on the card: (a)
    ``compressed:bf16``, ``compressed:int8`` and ``compressed:topk``
    allreduce and bf16 / int8 ``reduce_scatter`` at 64 MiB of float32 per
    rank that differs by rank (top-k on inputs with distinct magnitudes),
    each rank bitwise against the same program with ``device="cpu"``,
    across ranks bf16 once rounded to bf16 (the reference's ring leaves
    each chunk's owner its float32 fold and its peers the wire encoding,
    and top-k folds in ring-hop order from each rank's own pair; the
    largest difference between ranks is printed), each within the reference test's bound of a float64
    sum (``tests/test_compress.py``), ``bytes_compressed_saved`` printed;
    an int64 payload and a MAX top-k request decline on every rank
    (``compress_fallbacks``); (b) 5 top-k steps with error feedback, after
    each the cumulative output plus every rank's residual equals the
    cumulative input within rtol 1e-6; (c) the int8 encode of 16 MiB on
    the card byte for byte against the CPU's, with half the entries on a
    rounding tie (x / scale = k + 0.5), a random segment and a non-finite
    one; (d) ``python -m mpi_tpu_torch.tools.tune`` over local and shm, 2-4
    ranks and three payload bands (under 20 s; its parts printed first:
    each local leg, the shm world's import, which runs beside the local
    leg, each rank's fork, CUDA context and ``init()``, each band, the
    teardown), its ``--check``, and
    ``run(..., tuning_table=)`` serving from the table
    (``tuned_table_hits``, ``last_decision()`` naming the row), within
    rtol 1e-5 of the seed policy; each leg's ms per call;
23. host-shm: ``python -m mpi_tpu_torch.launcher -n 4 --backend shm
    mpi_tpu_torch/examples/host_shm.py``: a 256 MiB float32 ring allreduce
    over the native rings (bitwise across ranks, float64-checked, no byte
    pickled; its ms beside phase 14's socket ring), every arena collective
    at 1 KiB, 32 KiB and 1 MiB, a 16 MiB decline on all ranks,
    ``compressed:bf16`` through the arena, a ``SharedWindow`` and a
    ``P2PWindow`` over a CUDA tensor, and a steered receive: rank 1 posts
    ``irecv(source=0, buf=<a 256 MiB float32 card tensor>)`` before rank 0
    sends, and the shm drain lands the frame in it through pinned staging
    (bitwise, the same ``data_ptr``, ``recv_user_inplace`` +1,
    ``recv_user_fallbacks`` +0; its ms beside the same receive with the
    ``recv_steering`` cvar off); then the same example under
    ``--verify`` at 64 MiB (clean: only signature bytes pickled); the
    launcher's exit summary, and no ``mtt_*`` segment left in /dev/shm;
24. host-restart: ``python -m mpi_tpu_torch.launcher -n 2 --restarts 2
    mpi_tpu_torch/examples/host_restart.py`` on shm and on socket (the two
    launches side by side), each rank's state 256 MiB of float32 on its
    card: rank 1 exits (41) on
    attempt 0 right after the save of step 1, the launcher relaunches the
    world, which loads generation 1 onto the card (``cuda:`` checked),
    finishes step 4 and holds its state bitwise against the crash-free
    replay; save and load seconds, bytes per rank and the committed
    generation printed.  Then ``checkpoint.save(..., agree=True)`` on 3
    local rank threads on the card (64 MiB each) with rank 1 killed
    before the commit: every survivor raises and no manifest is swung;
    after ``shrink`` the survivors' save commits and loads on the card;
    phase 26's three launches start just before 24's two and run beside
    them (all start-up bound); phase 26 is read after 24;
25. host-flat: ``python -m mpi_tpu_torch.launcher -n 4 --backend shm
    --tuning-table T mpi_tpu_torch/examples/host_flat.py``, 64 MiB of
    float32 per rank on the card: ``HierarchicalComm`` with 2 nodes of 2
    (allreduce, bcast, reduce, allgather, each bitwise against the same
    call on the inputs as CPU tensors, which travel to each receiving
    rank's card as every payload does, the allreduce within rtol 1e-5,
    atol 1e-5 of a float64 sum, ``tuned_table_hits`` / ``tuned_table_fallbacks`` per
    tier and call; T pins the leaders' 2-rank allreduce, so each leader
    hits once) and the three-level form; ``master_worker`` (40 tasks,
    within atol 1e-12 of the serial computation); an intercommunicator
    allreduce across the two halves; a partitioned send of 8 partitions
    readied by 4 producer threads, each refilled right after its
    ``pready``; 10 ``MPI_Allreduce_init`` rounds, each bitwise against the
    same rounds on CPU inputs; each leg's slowest-rank ms;
26. host-dynamic: ``python -m mpi_tpu_torch.launcher -n 4 --backend socket
    mpi_tpu_torch/examples/host_dynamic.py --require cuda`` (every rank on
    the card): (a) MPI-IO, 256 MiB of float32 a rank (1 GiB in all, the
    independent branch) by ``write_at_all`` and ``read_at_all`` back to
    the card, bitwise, write and read seconds per rank; ``parallel_io``'s
    column-block subarray view at 1024 x 1024 float32 (4 MiB, the two-phase
    aggregated branch) against a numpy oracle; shared-pointer appends and
    ``write_ordered`` lines, order and content; an ``external32`` round
    trip; (b) the steered socket receive of phase 23's leg, rank 0 to rank
    1 through the socket reader's pinned staging, beside its copy path;
    (c) the 4 ranks ``comm_spawn`` 2 children of
    ``examples/spawn_workers.py``, which report ``cuda``, and the reduced
    counts equal the float64 oracle; (d) beside it, two 1-rank launchers
    of ``coupled_models.py ocean`` / ``atmosphere`` meet through a
    name-service directory under ``chiprun_out/host_dynamic/`` and hold
    their boundaries bitwise against the numpy replay on the card.  Any
    non-zero exit, leg not ok or device not ``cuda`` raises;
27. host-serve, in a thread started beside phase 24's launches and
    joined after phase 26: the resident world server with every worker on
    the card.  (a) a socket pool of 4 (``serve.WorldServer``, detection
    2.0 s) runs 200 sequential 2-rank leases of ``job_allreduce(comm,
    256)``, each exactly 3.0: worlds/s, ``lease_acquire`` p50/p99 from
    ``stats()`` and the same gauges from a scrape of the pool's
    ``/metrics``; (b) one 4-rank lease of ``examples/host_serve.py``'s
    ``job_allreduce_checked``, 256 MiB of float32 a rank, every element
    exactly 10.0 on every worker, its ms, and rank 0's card tensor of the
    first results handed to the client on the CPU; (c) a shm pool of 4 runs
    ``job_allreduce_arena`` twice: ``coll_sm_hits`` above 0 both times on
    the same single pooled arena; (d) ``job_kill_rank`` on the socket
    pool surfaces ``ProcFailedError`` (``MPI_ERR_PROC_FAILED``) within 3 x
    2.0 + 8 s, the pool heals (timed), the epoch grows, the workers (the
    replacement too) report ``cuda`` and the next 4-rank allreduce is
    right; (e) ``job_allreduce_link_chaos`` with 2 resets is right and
    the workers' ``link_reconnects`` rises; (f) ``python -m
    mpi_tpu_torch.launcher serve --pool-size 2 --backend shm --addr-file
    ... --metrics-port 0``, reached by ``examples/host_serve.py`` through
    the address file (one checked lease on the card, then ``--shutdown``):
    the server exits 0.  The card's memory in use is printed with the
    pools up and after the phase;
28. host-federation, in two threads started at the beginning of phase 25
    and joined after it: server federation with every pool's workers on
    the card.  (a)-(c), (e): ``examples/host_federation.py --kill-leader``
    starts two ``python -m mpi_tpu_torch.launcher serve --pool-size 2
    --backend socket --federation <dir> --server-id f<i>
    --fed-lease-timeout 2.0 --detect-timeout 2.0 --addr-file ...
    --metrics-port 0`` processes (no ``--device``), waits for both
    endpoint records and a leader, and ``connect(<dir>)`` runs one 2-rank
    ``job_allreduce_checked`` lease at 64 MiB of float32 a rank, exact on
    the workers, which report ``cuda``; (b) the leader's server process is
    SIGKILLed, the same ``FederatedClient`` leases on the survivor (the
    seconds from the kill printed), the dead server's pool is owned by the
    survivor, whose ``stats()`` shows ``pools_adopted`` 1 and
    ``orphans_reregistered`` 2 (the seconds from the kill printed), the
    orphans kept their pids and their card, a 2-rank lease on the adopted
    pool is exact and ``assert_no_leader_overlap`` finds no overlap; (c)
    the survivor's ``/metrics`` gives ``mpi_tpu_fed_*`` gauges equal to
    its ``stats()["federation"]``; (e) the survivor's shutdown stops the
    adopted workers too: no ``mtt_serve_*`` directory and no ``/mtt_*``
    segment of the phase is left.  (d) Beside it, three in-process
    ``serve.WorldServer(pool_size=1, federation="raft:<i>@a0,a1,a2")``
    each embed a store node; a partition isolating the store leader's
    node makes that server's ``acquire`` raise ``NoQuorumError``
    (``no_quorum_rejected`` rises) while a ``FederatedClient`` over the
    client spec leases on a majority server, its worker on the card;
    healed, the isolated server admits again; ``store_partition_dropped``
    is above 0 and ``store_elections`` at least 1.  The raft servers'
    lease bound is 10 s, so the partition's few seconds test the fence,
    not a takeover;
29. worlds across processes, in a thread started at the beginning of
    phase 19 and joined after phase 21: ``mpi_tpu_torch.gpu.multihost
    .launch_sim_hosts(2, [examples/multihost_world.py ...],
    devices_per_host=4)``, two processes on ``cuda:0``, each holding 4 of
    one world's 8 ranks.  In each: (a) the reference's multi-host program
    (``tests/test_multihost.py:17-64``) on ``global_mesh()``: the fused
    allreduce of the rank is 28, the ring allreduce of ``zeros(8) + r``
    sums to 224, the wrapped ``shift`` and the even/odd ``split_by`` are
    exact, every result on ``cuda``; (b) the ring kernel across processes
    at the north-star size (256 MiB of float32 a rank; every process makes
    all 8 ranks' inputs from the seed on the card): allreduce,
    reduce_scatter and allgather (SUM) and a 64 MiB bfloat16 MAX
    allreduce through ``run_spmd(..., comm=mesh.comm("world"))`` with
    ``algorithm="pallas_ring"``, launch counters zeroed just before and
    read just after (every peer-pointer mode must launch); each process's
    rows equal, bitwise, the one-process ``run_spmd`` over the 8 ranks on
    the card and the plain version (the gathered world through the plain
    ring); then per mode (median of 5) the call's wall with its barriers,
    the kernel alone by CUDA events (both processes launching), the
    staging copy's bytes, the plain version, the bytes bound, and on
    process 0 the one-process kernel over the whole world; (c)
    ``hybrid_mesh((1, 4), (2, 1), ("dcn", "ici"))``: placement as
    ``tests/test_multihost.py:114-120`` asserts it, and a fused allreduce
    over ``dcn`` equal to the column sums; (d) a host world of 8 socket
    ranks (4 rank threads a process): ``multihost_node_key`` gives
    ``[0]*4 + [1]*4`` and ``split_hierarchical`` intra groups of 4 and a
    leaders communicator of 2; a fused SUM's gradient and a ring-attention
    forward across the processes equal to one process; (e) after
    ``multihost.shutdown()`` no IPC mapping is open, and no child process
    of the phase is left.  The ``kernels`` line gains the peer-pointer
    entry points as K1 rows (``ring_*_ptrs``) with their launches on this
    path;
30. evidence: the evidence writer (``mpi_tpu_torch/tools/gpu_evidence.py``,
    the counterpart of ``tools/tpu_evidence.py``) called with this run's
    record, after phase 29 is joined and the launches are summed: the
    card read in process (its ``nvidia-smi`` line must be phase 1's),
    ``mpi_tpu_torch.entry.entry()`` run on the card (its result on
    ``cuda`` and finite), the traces for the card of the reference's
    export cases on fake tensors, (a) the 1-D ``pallas_ring`` allreduce
    (a ``ring_fold`` node), (b) the ring-attention forward at 64 and 8192
    rows a rank (``attn_fwd`` nodes) and (c) the value and gradient of a
    causal attention loss at 32 and 2048 rows a rank (``attn_fwd``,
    ``attn_bwd_dq`` and ``attn_bwd_dkv`` nodes, no matrix product of the
    plain version), (d) phase 6b's record, and the ``kernels`` and
    ``launches_by_path`` records copied; nothing runs at full size.  The
    card tier reads ``skipped`` (it runs after this script; the tool run
    alone with ``--tier-log`` fills it in).  Every other section must be
    ok.  The record goes to ``chiprun_out/gpu_evidence.json``;
31. one ``{"kernels": [...]}`` JSON line, then the ok line; the forms
    above d = 256 are entries of their own (``attention_*_wide``, bfloat16
    at the wide serving shape).  Each kernel's
    ``launches`` is the sum over the main paths (phases 3, 5, 6, 6b, 9,
    10, 12a, 29), each read right after it ran (``launches_by_path``).  The
    host layer (phases 13-28) launches none of the kernels: its folds are
    in-place torch ops.

Every phase prints its wall time, and their sum is printed after phase
30 (phase 29 runs beside 19-21).  The full record also goes to
``chiprun_out/chip_smoke.json``.
"""

import gc
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12       # H100 SXM datasheet
F32_FLOPS = 67e12               # H100 SXM float32 outside the tensor cores
F32_SPLIT_TF32_FLOPS = 495e12 / 3   # float32 products as three TF32 products
BF16_FLOPS = 989e12             # H100 SXM dense bf16 tensor cores
BF16_ROUNDING = 2.0 ** -7       # one bfloat16 ulp of x is at most 2^-7 |x|
P = 8
NORTH_STAR_ELEMS = (256 << 20) // 4     # 256 MiB of float32 per rank
REPLACES = "mpi_tpu/tpu/pallas_ring.py:434"
SOURCE = "mpi_tpu_torch/csrc/ring.cu"
ATTN_SOURCE = {"fwd": "mpi_tpu_torch/csrc/attention.cu",
               "bwd_dq": "mpi_tpu_torch/csrc/attention_bwd.cu",
               "bwd_dkv": "mpi_tpu_torch/csrc/attention_bwd.cu"}
ATTN_REPLACES = {"fwd": "mpi_tpu/tpu/pallas_attention.py:1059",
                 "bwd_dq": "mpi_tpu/tpu/pallas_attention.py:1130",
                 "bwd_dkv": "mpi_tpu/tpu/pallas_attention.py:1130"}
WIDE_SOURCE = {"fwd": "mpi_tpu_torch/csrc/attention_wide.cu",
               "bwd_dq": "mpi_tpu_torch/csrc/attention_bwd_wide.cu",
               "bwd_dkv": "mpi_tpu_torch/csrc/attention_bwd_wide.cu"}
# the serving leg: Llama-3-8B attention (meta-llama/Meta-Llama-3-8B config.json:
# num_attention_heads 32, num_key_value_heads 8, head dim 4096/32 = 128),
# 8 ranks x 4096 rows = a causal sequence of 32 768
SERVE = dict(seq_per_rank=4096, d=128, heads=32, kv_heads=8)
# the wide-head serving leg: Llama-3-8B's attention width (Hq d = 4096, GQA
# groups of 4) at d = 512, the same causal sequence: the operations bounds
# are the serving leg's
WIDE_SERVE = dict(seq_per_rank=4096, d=512, heads=8, kv_heads=2)
WIDE_TRAIN_D = 512              # the wide training step: d = 512, 8 x 4096 rows
TRAIN_SEQ_PER_RANK = 4096       # the training leg: 8 x 4096 rows, d = 128
# flops per unmasked score entry and head dim (bench.py:198-233): forward
# QK^T and PV; backward QK^T, dO V^T, dS K, dS^T Q, P^T dO (dq alone needs
# the first three, dk/dv the first two and the last two)
FLOPS_PER_ENTRY = {"fwd": 4, "bwd": 10, "bwd_dq": 6, "bwd_dkv": 8}
# what the kernels' design multiplies per entry and head dim
# (csrc/attention.cu, csrc/attention_bwd.cu): each backward kernel
# recomputes QK^T and dO V^T; bf16 inputs: a product with P or dS is two
# bf16 products (hi and lo), so the forward 2 + 2 x 2 = 6, dq 2 + 2 x 2 = 8,
# dk/dv 4 + 2 x 4 = 12; float32 inputs: every product is three TF32
# products, the forward 3 x 4, dq 3 x 6, dk/dv 3 x 8 (at the TF32 peak)
FLOOR_FLOPS_PER_ENTRY = {
    "bf16": {"fwd": 6, "bwd": 20, "bwd_dq": 8, "bwd_dkv": 12},
    "f32": {"fwd": 12, "bwd": 42, "bwd_dq": 18, "bwd_dkv": 24}}
# the forms above d = 256 (csrc/attention_wide.cu, attention_bwd_wide.cu)
# run in clusters and form Q K^T (and dO V^T) once a pass of their clusters
# (m passes, ``attention.wide_cluster``): a m + b flops per entry and head
# dim for (a, b) below, the forward's (2m + 4) in bf16 (P V split hi/lo)
# and 3 (2m + 2) in float32, the backward's (4m + 6) and (4m + 12) in bf16
# (the products with P and dS split in three bf16 terms) and 3 (4m + 2)
# and 3 (4m + 4) in float32, three TF32 products a product
WIDE_CLUSTER_FLOOR = {("bf16", "fwd"): (2, 4), ("f32", "fwd"): (6, 6),
                      ("bf16", "bwd_dq"): (4, 6), ("bf16", "bwd_dkv"): (4, 12),
                      ("f32", "bwd_dq"): (12, 6), ("f32", "bwd_dkv"): (12, 12)}


def wide_floor_flops(key, kind, d):
    """Flops per unmasked entry and head dim of a form above d = 256."""
    from mpi_tpu_torch.gpu import attention

    a, b = WIDE_CLUSTER_FLOOR[(key, kind)]
    return a * attention.wide_cluster(d)[1] + b


TF32_FLOPS = 495e12             # H100 SXM dense TF32 tensor cores
# K1's parity groupings: the whole world, two contiguous groups of four, and
# the dp groups of the 2 x 4 layout of the multi-parallel step (stride 4)
DP_GROUPS = [[0, 4], [1, 5], [2, 6], [3, 7]]
RING_GROUPINGS = {"world": None, "2x4": [[0, 1, 2, 3], [4, 5, 6, 7]],
                  "4x2 stride 4": DP_GROUPS}
# the full-width step: Llama-3-8B's MLP (meta-llama/Meta-Llama-3-8B
# config.json: hidden_size 4096, intermediate_size 14336) on the 2 x 4
# layout, 2048 rows per dp shard, float32
STEP = dict(dp=2, mp=4, rows_per_shard=2048, d=4096, hidden=14336)


def log(msg):
    print(msg, flush=True)


def ptxas_table(reports):
    """Registers and spills of every kernel instance, from ``nvcc -Xptxas
    -v`` output by source."""
    rows = []
    for source, text in reports.items():
        cur = None
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                cur = {"source": source, "function": m.group(1)}
                k = re.search(r"\d(attn_[a-z_]+_kernel)I(13__nv_bfloat16|f)Li(\d+)E", m.group(1))
                if k:
                    cur["kernel"] = (f"{k.group(1)}<{'float32' if k.group(2) == 'f' else 'bf16'}, "
                                     f"{k.group(3)}>")
                k = re.search(r"\d(attn_(?:fwd|bwd_d[a-z]+))_bf16_kernelILi(\d+)E", m.group(1))
                if k:
                    cur["kernel"] = f"{k.group(1)}_bf16_kernel<bf16, {k.group(2)}>"
                k = re.search(r"\d(attn_[a-z_]+_wide)_(bf16|f32)E", m.group(1))
                if k:
                    cur["kernel"] = (f"{k.group(1)}<{'float32' if k.group(2) == 'f32' else 'bf16'}, "
                                     f"d > 256>")
                rows.append(cur)
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m and cur is not None:
                cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m and cur is not None:
                cur["registers"] = int(m.group(1))
    return rows


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def nan_equal(torch, a, b):
    return torch.equal(a.isnan(), b.isnan()) and \
        torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0))


def spread_data(torch, gen, shape, device):
    """Random signs and magnitudes from 1e-4 to 1e8: the fold order shows."""
    mag = torch.pow(10.0, torch.empty(shape, device=device).uniform_(-4, 8, generator=gen))
    return torch.randn(shape, device=device, generator=gen) * mag


_LAP = [time.perf_counter()]
_T_START = _LAP[0]


def lap(name):
    """Print the wall time since the previous phase ended."""
    now = time.perf_counter()
    log(f"[phase {name}: {now - _LAP[0]:.2f} s wall]")
    _LAP[0] = now


def time_ms(torch, fn, reps=10, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
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


def time_once(torch, fn):
    """(fn's result, its ms by CUDA events): one call, whose result the
    caller checks"""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    res = fn()
    end.record()
    end.synchronize()
    return res, start.elapsed_time(end)


def time_b2b(torch, fn, launches=20, reps=5):
    """Median ms per launch over ``reps`` timings of ``launches``
    back-to-back launches between two CUDA events: the host enqueues a
    launch while the card runs the one before, so this is the card's time."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def world_to_sequence(t):
    """``[P, H, Sb, d]`` rank blocks -> ``[1, H, P*Sb, d]`` whole sequence."""
    P, H, sb, d = t.shape
    return t.transpose(0, 1).reshape(1, H, P * sb, d).contiguous()


def causal_entries(shape):
    """Unmasked score entries of causal attention over the whole sequence."""
    P, hq, hkv, sb, d = shape
    S = P * sb
    return hq * S * (S + 1) / 2


def attention_bound(kind, dtype_bytes, peak, shape, reads, writes):
    """(bound_ms, bound_by) at the serving shape for one function:
    operations over the unmasked causal entries, bytes = each input read
    once and each output written once."""
    P, hq, hkv, sb, d = shape
    entries = causal_entries(shape)
    op_ms = FLOPS_PER_ENTRY[kind] * d * entries / peak * 1e3
    q_elems, kv_elems, row_elems = P * hq * sb * d, P * hkv * sb * d, P * hq * sb
    sizes = {"q": q_elems * dtype_bytes, "kv": kv_elems * dtype_bytes,
             "rows": row_elems * 4}
    nbytes = sum(sizes[n] * c for n, c in reads.items()) + \
        sum(sizes[n] * c for n, c in writes.items())
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return max(op_ms, byte_ms), ("operations" if op_ms >= byte_ms else "bytes"), nbytes


# the largest share of its allowance that any comparison used, by kind
ALLOWANCE_USED = {}
# the narrow bf16 backward's split check: (P, query heads, K/V heads, Sb) at
# d = 128, causal, inputs drawn by numpy's RandomState(seed) as
# tests/test_torch_attention_split.py draws them (SPLIT_SHAPES there)
SPLIT_SEEDS = range(101, 107)
SPLIT_SHAPES = ((4, 8, 1, 64), (8, 4, 1, 32), (4, 4, 2, 64))


def parity_grid(f32):
    """Phase 11's cases of one dtype (float32 if ``f32``, else bf16), in the
    order they draw their inputs: (d, Sb, query heads, K/V heads, causal,
    groups).  Sb = 8 (float32 only: bf16 blocks are multiples of 16) is the
    dry run's [8, 128] block; above d = 256, Sb 16 and 112, and at d = 640
    (clusters of 5) and 1152 (3 blocks of 3 passes) 112 alone, several
    streamed tiles ending in a partial one.  d = 640 and 1152 come last, so
    the cases held before they were added draw the inputs they drew then."""
    for dh in (128, 256, 384, 512, 1024, 640, 1152):
        wide = dh > 256
        sbs = ((112,) if dh in (640, 1152) else (16, 112) if wide else
               (8, 16, 48, 112, 128) if f32 else (16, 48, 112, 128))
        for sb in sbs:
            for hq, hkv in ((4, 2), (4, 1)) if wide else ((4, 4), (4, 2), (4, 1)):
                for causal in (False, True):
                    for groups in (None, [[0, 1, 2, 3], [4, 5, 6, 7]]):
                        yield dh, sb, hq, hkv, causal, groups


def allowance_share(torch, name, got, want, dtype, normwise=False):
    """``check_close``'s measure: (max abs error, largest share of the
    allowance used, its key in ``ALLOWANCE_USED``)."""
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        raise RuntimeError(f"{name}: non-finite values")
    if name.endswith(("out", "lse")):
        kind, allow = name[-3:], torch.full_like(w, 1e-5)
    elif normwise:
        kind, allow = "grad_normwise", torch.full_like(w, 1e-4 * float(w.abs().max()))
    else:
        kind, allow = "grad", 1e-5 + 1e-4 * w.abs()
    if dtype == torch.bfloat16:
        allow = allow + BF16_ROUNDING * w.abs()
    diff = (g - w).abs()
    return float(diff.max()), float((diff / allow).max()), f"{str(dtype).split('.')[-1]} {kind}"


def check_close(torch, name, got, want, dtype, normwise=False):
    """Hold a kernel's result against its plain version's; both are float32
    sums in different orders, rounded once to their output type.

    float32 allowance per element: out and lse 1e-5; gradients
    1e-5 + 1e-4 |plain|, or with ``normwise`` (the serving shape, where
    one dK/dV element sums up to 131 072 products in another order than
    the plain version) 1e-4 * max |plain|.  bfloat16: the float32
    allowance plus 2^-7 |plain|, since each side rounds a float32 value to
    bfloat16 once and two such roundings of values that agree within the
    float32 allowance differ by at most that allowance and one bfloat16
    ulp.  Returns the max abs error."""
    err, used, key = allowance_share(torch, name, got, want, dtype, normwise)
    ALLOWANCE_USED[key] = max(ALLOWANCE_USED.get(key, 0.0), used)
    if used > 1.0:
        raise RuntimeError(f"{name}: kernel disagrees with the plain version "
                           f"(max abs {err}, {used:.3g} of the allowance)")
    return err


def serving_program(comm, dtype, geometry=SERVE):
    """One rank of a serving leg: Q/K/V from the rank's own generator,
    then causal ring attention at the geometry's heads (Llama-3-8B's by
    default, ``WIDE_SERVE`` for the wide-head leg)."""
    import mpi_tpu_torch
    from mpi_tpu_torch.gpu.attention import ring_attention

    sb, d = geometry["seq_per_rank"], geometry["d"]
    q = mpi_tpu_torch.rank_normal((geometry["heads"], sb, d), 7).to(dtype)
    k, v = (mpi_tpu_torch.rank_normal((geometry["kv_heads"], sb, d), seed).to(dtype)
            for seed in (8, 9))
    return ring_attention(q, k, v, comm, causal=True), q, k, v


def attention_launches(attention):
    """The launches of every attention form, the wide ones (d above 256)
    named ``attention_<kind>_wide``."""
    return {**{f"attention_{k}": c for k, c in attention.LAUNCHES.items()},
            **{f"attention_{k}_wide": c for k, c in attention.WIDE_LAUNCHES.items()}}


def ring_launches(ring):
    return {f"ring_{m}": c for m, c in ring.LAUNCHES.items()}


def attention_phases(torch, dev, gen, record, paths):
    """Phases 9-12a; returns the six attention entries of the kernels line
    and adds the serving and training legs' launches to ``paths``."""
    import numpy as np
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    import mpi_tpu_torch
    from mpi_tpu_torch import _build
    from mpi_tpu_torch.examples import long_context_training as lct
    from mpi_tpu_torch.gpu import attention

    errs = {}

    # 9. serving leg at full width ---------------------------------------------
    serve = {}
    for dtype in (torch.bfloat16, torch.float32):
        tag = str(dtype).split(".")[-1]
        attention.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, q, k, v = mpi_tpu_torch.run(serving_program, dtype, nranks=P)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = dict(attention.LAUNCHES)
        if launches["fwd"] == 0:
            raise RuntimeError(f"serving leg ({tag}) never launched the forward kernel")
        paths[f"serving leg {tag}"] = attention_launches(attention)
        if tuple(out.shape) != (P, SERVE["heads"], SERVE["seq_per_rank"], SERVE["d"]) \
                or out.dtype != dtype:
            raise RuntimeError(f"serving leg output {tuple(out.shape)} {out.dtype}")
        want = attention.ring_attention_plain(q, k, v, causal=True)
        err = check_close(torch, f"serving {tag} out", out, want, dtype)
        errs[("fwd", dtype)] = err
        serve[dtype] = (q, k, v)
        record[f"serving_{tag}"] = {"run_s": run_s, "launches": launches,
                                    "max_abs_err_vs_plain": err,
                                    "shape": list(out.shape)}
        log(f"serving leg {tag}: run {run_s:.3f} s, launches {launches}, "
            f"max abs err vs plain {err:.3g}")
        del out, want
    lap("attention serving leg")

    # 10. training leg at the example's width ------------------------------------
    d, S = 128, P * TRAIN_SEQ_PER_RANK
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(S, d).astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.randn(S, d).astype(np.float32)).to(dev)
    block = lct.block_from_numpy(lct.init_params(d, 2 * d), dev)
    params = {n: p.detach() for n, p in block.named_parameters()}
    attention.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss_s, grads_s = mpi_tpu_torch.run(lct.sharded_program, block, params, x, y,
                                        nranks=P)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    launches = dict(attention.LAUNCHES)
    missing = [k for k, c in launches.items() if c == 0]
    if missing:
        raise RuntimeError(f"training leg never launched {missing}")
    paths["training leg"] = attention_launches(attention)
    torch.cuda.synchronize()
    t0 = time.perf_counter()  # a second step: the first pays first-call costs
    mpi_tpu_torch.run(lct.sharded_program, block, params, x, y, nranks=P)
    torch.cuda.synchronize()
    step2_s = time.perf_counter() - t0
    loss_d, grads_d = lct.dense_train_step(block)(params, x, y)
    torch.cuda.synchronize()
    if not (torch.isfinite(loss_s).all() and
            torch.allclose(loss_s[0], loss_d, rtol=1e-5, atol=1e-6)):
        raise RuntimeError(f"training loss {float(loss_s[0])} != dense {float(loss_d)}")
    grad_err = {}
    for name, g in grads_d.items():
        if not torch.allclose(grads_s[name][0], g, rtol=5e-4, atol=5e-5):
            raise RuntimeError(f"training gradient {name} disagrees with the dense step")
        grad_err[name] = float((grads_s[name][0] - g).abs().max())
    record["training"] = {"step_s": step_s, "second_step_s": step2_s,
                          "launches": launches,
                          "loss": float(loss_s[0]), "dense_loss": float(loss_d),
                          "grad_max_abs_err_vs_dense": grad_err,
                          "seq": S, "d": d, "nranks": P}
    log(f"training leg: step {step_s:.3f} s (second {step2_s:.3f} s), "
        f"launches {launches}, loss "
        f"{float(loss_s[0]):.6f} vs dense {float(loss_d):.6f}")
    del x, y, block, params, loss_s, grads_s, loss_d, grads_d
    torch.cuda.empty_cache()
    lap("attention training leg")

    # 11. kernel vs plain grid --------------------------------------------------
    n_cases, n_wide = 0, 0
    t_wide = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for dh, sb, hq, hkv, causal, groups in parity_grid(dtype == torch.float32):
            wide = dh > 256  # csrc/attention_wide.cu, attention_bwd_wide.cu
            t_case = time.perf_counter()
            q, k, v, do = (torch.randn(
                (P, h, sb, dh), device=dev, generator=gen).to(dtype)
                for h in (hq, hkv, hkv, hq))
            out, lse = attention.ring_attention_world(
                q, k, v, groups, causal=causal, with_lse=True)
            pout, plse = attention.ring_attention_plain(
                q, k, v, groups, causal=causal, with_lse=True)
            grads = attention.ring_attention_bwd_world(
                q, k, v, pout, plse, do, groups, causal=causal)
            pgrads = attention.ring_attention_bwd_plain(
                q, k, v, pout, plse, do, groups, causal=causal)
            torch.cuda.synchronize()
            case = f"{dtype} d={dh} sb={sb} {hq}/{hkv} causal={causal} groups={groups is not None}"
            check_close(torch, f"{case} out", out, pout, dtype)
            check_close(torch, f"{case} lse", lse, plse, torch.float32)
            for nm, a, b in zip(("dq", "dk", "dv"), grads, pgrads):
                check_close(torch, f"{case} {nm}", a, b, dtype)
            n_cases += 2
            n_wide += 2 * wide
            if wide:
                t_wide += time.perf_counter() - t_case
    # contiguous bf16 views 8 bytes past a 16-byte boundary: the kernels stage
    # 16-byte chunks, so the wrapper must hand them an aligned copy
    views = [torch.randn(P * 4 * 48 * 128 + 4, device=dev, generator=gen)
             .to(torch.bfloat16)[4:].view(P, 4, 48, 128) for _ in range(3)]
    if any(t.data_ptr() % 16 != 8 for t in views):
        raise RuntimeError("the misaligned views are not 8 bytes past a boundary")
    out, lse = attention.ring_attention_world(*views, causal=True, with_lse=True)
    aout, alse = attention.ring_attention_world(*(t.clone() for t in views), causal=True,
                                                with_lse=True)
    torch.cuda.synchronize()
    if not (torch.equal(out, aout) and torch.equal(lse, alse)):
        raise RuntimeError("forward on views off 16 bytes != forward on aligned copies")
    check_close(torch, "bf16 views off 16 bytes: out", out,
                attention.ring_attention_plain(*views, causal=True), torch.bfloat16)
    record["attention_misaligned_view_forward"] = "bitwise equal to the aligned copies"
    # the narrow bf16 backward on the split check's seeds (P and dS as two
    # bf16 terms), held by the same allowance
    split_used = 0.0
    for seed in SPLIT_SEEDS:
        rs = np.random.RandomState(seed)
        for n, hq, hkv, sb in SPLIT_SHAPES:
            q, k, v, do = (torch.from_numpy(rs.randn(n, h, sb, 128).astype(np.float32))
                           .to(dev).to(torch.bfloat16) for h in (hq, hkv, hkv, hq))
            pout, plse = attention.ring_attention_plain(q, k, v, causal=True, with_lse=True)
            grads = attention.ring_attention_bwd_world(q, k, v, pout, plse, do, causal=True)
            pgrads = attention.ring_attention_bwd_plain(q, k, v, pout, plse, do, causal=True)
            for nm, a, b in zip(("dq", "dk", "dv"), grads, pgrads):
                case = f"seed {seed} {n}x{hq}/{hkv}x{sb} {nm}"
                split_used = max(split_used, allowance_share(torch, case, a, b, torch.bfloat16)[1])
                check_close(torch, case, a, b, torch.bfloat16)
    record["attention_split_seeds"] = {"seeds": list(SPLIT_SEEDS), "shapes": SPLIT_SHAPES,
                                       "largest_share": split_used}
    log(f"narrow bf16 backward on seeds {SPLIT_SEEDS.start}-{SPLIT_SEEDS.stop - 1}: largest "
        f"share of the allowance {split_used:.4f}")
    record["attention_parity_cases"] = n_cases
    record["attention_parity_wide"] = {"cases": n_wide, "s": t_wide}
    log(f"attention parity: {n_cases} cases (forward and backward) within tolerance, "
        f"{n_wide} of them at d in (384, 512, 640, 1024, 1152) in {t_wide:.2f} s")
    lap("attention parity")

    # 12. timing at the serving shape --------------------------------------------
    shape = (P, SERVE["heads"], SERVE["kv_heads"], SERVE["seq_per_rank"], SERVE["d"])
    rep = SERVE["heads"] // SERVE["kv_heads"]
    entries = []
    timing = {}
    for dtype in (torch.bfloat16, torch.float32):
        tag = str(dtype).split(".")[-1]
        q, k, v = serve.pop(dtype)
        esz = q.element_size()
        peak = BF16_FLOPS if dtype == torch.bfloat16 else F32_SPLIT_TF32_FLOPS
        do = torch.randn(q.shape, device=dev, generator=gen).to(dtype)
        fwd = lambda: attention.ring_attention_world(q, k, v, causal=True, with_lse=True)
        (out, lse), fwd_ms = time_once(torch, fwd)
        (out2, lse2), fwd2_ms = time_once(torch, fwd)
        if not (torch.equal(out, out2) and torch.equal(lse, lse2)):
            raise RuntimeError(f"{tag} forward: two launches differ (not deterministic)")
        log(f"{tag} forward at the serving shape: two launches bitwise equal")
        record.setdefault("deterministic_forward", {})[tag] = True
        del out2, lse2
        (pout, plse), plain_fwd_ms = time_once(torch, lambda: attention.ring_attention_plain(
            q, k, v, causal=True, with_lse=True))
        errs[("fwd", dtype)] = max(errs[("fwd", dtype)], check_close(
            torch, f"{tag} forward at the serving shape: out", out, pout, dtype))
        lse_err = check_close(torch, f"{tag} forward at the serving shape: lse", lse, plse,
                              torch.float32)
        record.setdefault("serving_shape_forward_max_abs_err", {})[tag] = {
            "out": errs[("fwd", dtype)], "lse": lse_err}
        log(f"{tag} forward at the serving shape: max abs err out "
            f"{errs[('fwd', dtype)]:.3g}, lse {lse_err:.3g}")
        del pout, plse
        ops = attention.bwd_operands(q, k, v, out, lse, do, causal=True)
        bwd = lambda: attention.ring_attention_bwd_world(q, k, v, out, lse, do, causal=True)
        got, bwd_ms = time_once(torch, bwd)
        want, plain_bwd_ms = time_once(torch, lambda: attention.ring_attention_bwd_plain(
            q, k, v, out, lse, do, causal=True))
        errs[("bwd_dq", dtype)] = check_close(torch, f"{tag} dq", got[0], want[0],
                                              dtype, normwise=True)
        errs[("bwd_dkv", dtype)] = max(
            check_close(torch, f"{tag} dk", got[1], want[1], dtype, normwise=True),
            check_close(torch, f"{tag} dv", got[2], want[2], dtype, normwise=True))
        log(f"{tag} backward at the serving shape: max abs err dq "
            f"{errs[('bwd_dq', dtype)]:.3g}, dk/dv {errs[('bwd_dkv', dtype)]:.3g}; "
            f"max |plain| dq {float(want[0].float().abs().max()):.4g}, dk "
            f"{float(want[1].float().abs().max()):.4g}, dv "
            f"{float(want[2].float().abs().max()):.4g}")
        again, bwd2_ms = time_once(torch, bwd)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise RuntimeError(f"{tag} backward: two launches differ (not deterministic)")
        log(f"{tag} backward at the serving shape: two launches bitwise equal")
        record.setdefault("deterministic", {})[tag] = True
        del got, want, again
        # medians of 3 launches, the checks' launches among them (they were
        # the warm-up); the plain versions once, the checks' runs
        t = {
            "fwd": statistics.median([fwd_ms, fwd2_ms, time_once(torch, fwd)[1]]),
            "bwd": statistics.median([bwd_ms, bwd2_ms, time_once(torch, bwd)[1]]),
            "bwd_dq": time_ms(torch, lambda: attention.launch_bwd("bwd_dq", ops),
                              reps=3, warmup=0),
            "bwd_dkv": time_ms(torch, lambda: attention.launch_bwd("bwd_dkv", ops),
                               reps=3, warmup=0),
            "plain_fwd": plain_fwd_ms, "plain_bwd": plain_bwd_ms,
        }
        # the yardstick: one library call over the whole sequence
        ql, kl, vl, dol = (world_to_sequence(a) for a in (q, k, v, do))
        gqa = dtype == torch.bfloat16
        if not gqa:  # the float32 kernels take expanded heads
            kl, vl = kl.repeat_interleave(rep, 1), vl.repeat_interleave(rep, 1)
        ql.requires_grad_(True)
        kl.requires_grad_(True)
        vl.requires_grad_(True)
        backends = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION]

        def sdpa():
            with sdpa_kernel(backends):
                return F.scaled_dot_product_attention(ql, kl, vl, is_causal=True,
                                                      enable_gqa=gqa)

        def sdpa_fwd_bwd():
            o = sdpa()
            return torch.autograd.grad(o, (ql, kl, vl), dol)

        with torch.no_grad():
            t["library_fwd"] = time_ms(torch, sdpa, reps=3, warmup=1)
        o_lib = sdpa()  # the backward alone, from this forward's saved outputs
        t["library_bwd"] = time_ms(torch, lambda: torch.autograd.grad(
            o_lib, (ql, kl, vl), dol, retain_graph=True), reps=3, warmup=1)
        t["library_fwd_bwd"] = time_ms(torch, sdpa_fwd_bwd, reps=3, warmup=0)
        t["library_variant"] = "enable_gqa" if gqa else "K/V heads repeated"
        del o_lib, ql, kl, vl, dol
        io = {"fwd": ({"q": 1, "kv": 2}, {"q": 1, "rows": 1}),
              "bwd": ({"q": 3, "kv": 2, "rows": 1}, {"q": 1, "kv": 2}),
              "bwd_dq": ({"q": 2, "kv": 2, "rows": 2}, {"q": 1}),
              "bwd_dkv": ({"q": 2, "kv": 2, "rows": 2}, {"kv": 2})}
        for kind, (reads, writes) in io.items():
            bound, by, nbytes = attention_bound(kind, esz, peak, shape, reads, writes)
            t[f"{kind}_bound_ms"], t[f"{kind}_bound_by"] = bound, by
            t[f"{kind}_bytes"] = nbytes
            t[f"{kind}_pct_of_bound"] = 100.0 * bound / t[kind]
            t[f"{kind}_tflops"] = (FLOPS_PER_ENTRY[kind] * shape[4] * causal_entries(shape)
                                   / (t[kind] * 1e-3) / 1e12)
            key, rate = ("bf16", BF16_FLOPS) if dtype == torch.bfloat16 else ("f32", TF32_FLOPS)
            t[f"{kind}_design_floor_ms"] = (FLOOR_FLOPS_PER_ENTRY[key][kind] * shape[4]
                                            * causal_entries(shape) / rate * 1e3)
        if dtype == torch.bfloat16:
            # the narrow bf16 forward against SDPA's forward, the backward's
            # pair against SDPA's backward, and their kernels' registers and
            # spills (ptxas)
            t["fwd_over_library"] = t["fwd"] / t["library_fwd"]
            t["bwd_pair_over_library"] = (t["bwd_dq"] + t["bwd_dkv"]) / t["library_bwd"]
            built = [row for row in ptxas_table(_build.PTXAS_REPORT)
                     if "_bf16_kernel<" in row.get("kernel", "")]
            for kind, prefix in (("fwd", "attn_fwd"), ("bwd", "attn_bwd")):
                t[f"{kind}_ptxas"] = {row["kernel"]: (row.get("registers"), row.get("spill_stores"),
                                                      row.get("spill_loads"))
                                      for row in built if row["kernel"].startswith(prefix)}
        timing[tag] = t
        log(f"attention timing {tag}: " + ", ".join(
            f"{key} {val:.3f}" if isinstance(val, float) else f"{key} {val}"
            for key, val in t.items() if not key.endswith("_bytes")))
        del q, k, v, do, out, lse, ops
        torch.cuda.empty_cache()
    record["attention_timing"] = timing
    record["allowance_used"] = dict(ALLOWANCE_USED)
    log(f"largest share of the allowance used: {ALLOWANCE_USED}")
    lap("attention timing")

    bt = timing["bfloat16"]
    for kind in ("fwd", "bwd_dq", "bwd_dkv"):
        entries.append({
            "name": f"attention_{kind}", "route": "cuda", "source": ATTN_SOURCE[kind],
            "replaces": ATTN_REPLACES[kind],
            "max_abs_err": errs[(kind, torch.bfloat16)], "ms": bt[kind],
            "plain_ms": bt["plain_fwd"] if kind == "fwd" else bt["plain_bwd"],
            "bound_ms": bt[f"{kind}_bound_ms"], "bound_by": bt[f"{kind}_bound_by"],
            # SDPA's backward computes dq, dk and dv in one call
            "library_ms": bt["library_fwd"] if kind == "fwd" else bt["library_bwd"],
            "library_call": "SDPA forward" if kind == "fwd" else
            "SDPA backward (dq, dk and dv together)",
            "library_fwd_bwd_ms": bt["library_fwd_bwd"],
            "pct_of_bound": bt[f"{kind}_pct_of_bound"], "tflops": bt[f"{kind}_tflops"],
            "design_floor_ms": bt[f"{kind}_design_floor_ms"], "dtype": "bfloat16",
        })
    entries += wide_attention_phase(torch, dev, gen, record, paths)
    return entries


def wide_attention_phase(torch, dev, gen, record, paths):
    """Phase 12a: the forms above d = 256 on their main paths and at the
    wide serving shape; returns their three entries of the kernels line
    (bf16) and adds the paths' launches to ``paths``."""
    import numpy as np
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    import mpi_tpu_torch
    from mpi_tpu_torch.examples import long_context_training as lct
    from mpi_tpu_torch.gpu import attention

    g = WIDE_SERVE
    shape = (P, g["heads"], g["kv_heads"], g["seq_per_rank"], g["d"])
    rep = g["heads"] // g["kv_heads"]
    kinds = ("fwd", "bwd_dq", "bwd_dkv")
    info = {"shape": list(shape)}
    errs, timing = {}, {}
    # the cluster forms' clusters at this d, and their kernels' registers
    from mpi_tpu_torch import _build
    clusters, passes = attention.wide_cluster(g["d"])
    built = {row.get("kernel"): row for row in ptxas_table(_build.PTXAS_REPORT)}
    info["cluster_kernels"] = {}
    for kind in kinds:
        for tag in ("bf16", "float32"):
            row = built.get(f"attn_{kind}_wide<{tag}, d > 256>", {})
            info["cluster_kernels"][f"{kind} {tag}"] = {
                "cluster": clusters, "passes": passes, "registers": row.get("registers"),
                "spill_stores": row.get("spill_stores"), "spill_loads": row.get("spill_loads")}
            log(f"wide {tag} {kind} at d = {g['d']}: clusters of {clusters} blocks, {passes} "
                f"pass(es); {row.get('registers')} registers, spill stores "
                f"{row.get('spill_stores')} / loads {row.get('spill_loads')} bytes")

    def only_wide(name, launches):
        """the launches of a path, which must have run the wide forms only"""
        narrow = {k: c for k, c in launches.items() if c and not k.endswith("_wide")}
        if narrow:
            raise RuntimeError(f"{name} launched a d <= 256 form: {narrow}")
        return launches

    for dtype in (torch.bfloat16, torch.float32):
        tag = str(dtype).split(".")[-1]
        key, rate = ("bf16", BF16_FLOPS) if dtype == torch.bfloat16 else ("f32", TF32_FLOPS)
        peak = BF16_FLOPS if dtype == torch.bfloat16 else F32_SPLIT_TF32_FLOPS
        # the wide-head serving leg through run(), then the plain version once
        attention.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, q, k, v = mpi_tpu_torch.run(serving_program, dtype, g, nranks=P)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = only_wide(f"wide serving leg {tag}", attention_launches(attention))
        if not launches["attention_fwd_wide"]:
            raise RuntimeError(f"wide serving leg ({tag}) never launched the wide forward")
        paths[f"wide serving leg {tag}"] = launches
        if tuple(out.shape) != (P, g["heads"], g["seq_per_rank"], g["d"]) or out.dtype != dtype:
            raise RuntimeError(f"wide serving leg output {tuple(out.shape)} {out.dtype}")
        (pout, plse), plain_fwd = time_once(torch, lambda: attention.ring_attention_plain(
            q, k, v, causal=True, with_lse=True))
        errs[("fwd", dtype)] = check_close(torch, f"wide serving {tag} out", out, pout, dtype)
        del pout, plse
        # the forward with its lse (timed), bitwise the serving leg's, and the
        # backward's kernels (timed), against the plain version; in bf16 twice
        # each, bitwise equal (the float32 forms' two launches are the
        # training step's two steps)
        (o1, lse), f1 = time_once(torch, lambda: attention.ring_attention_world(
            q, k, v, causal=True, with_lse=True))
        if not torch.equal(o1, out):
            raise RuntimeError(f"wide {tag} forward: two launches differ (not deterministic)")
        del out
        do = torch.randn(q.shape, device=dev, generator=gen).to(dtype)
        ops = attention.bwd_operands(q, k, v, o1, lse, do, causal=True)
        (dq1,), b1 = time_once(torch, lambda: attention.launch_bwd("bwd_dq", ops))
        (dk1, dv1), c1 = time_once(torch, lambda: attention.launch_bwd("bwd_dkv", ops))
        bs, cs_ = [b1], [c1]
        if dtype == torch.bfloat16:
            (dq2,), b2 = time_once(torch, lambda: attention.launch_bwd("bwd_dq", ops))
            (dk2, dv2), c2 = time_once(torch, lambda: attention.launch_bwd("bwd_dkv", ops))
            if not (torch.equal(dq1, dq2) and torch.equal(dk1, dk2) and torch.equal(dv1, dv2)):
                raise RuntimeError(f"wide {tag} backward: two launches differ "
                                   f"(not deterministic)")
            bs.append(b2)
            cs_.append(c2)
            del dq2, dk2, dv2
        want, plain_bwd = time_once(torch, lambda: attention.ring_attention_bwd_plain(
            q, k, v, o1, lse, do, causal=True))
        errs[("bwd_dq", dtype)] = check_close(torch, f"wide {tag} dq", dq1, want[0], dtype,
                                              normwise=True)
        errs[("bwd_dkv", dtype)] = max(
            check_close(torch, f"wide {tag} dk", dk1, want[1], dtype, normwise=True),
            check_close(torch, f"wide {tag} dv", dv1, want[2], dtype, normwise=True))
        log(f"wide serving leg {tag}: run {run_s:.3f} s, launches {launches}; max abs err "
            f"vs plain out {errs[('fwd', dtype)]:.3g}, dq {errs[('bwd_dq', dtype)]:.3g}, "
            f"dk/dv {errs[('bwd_dkv', dtype)]:.3g}; the forward's two launches bitwise equal"
            + ("; the backward's too" if len(bs) == 2 else ""))
        del want, dq1, dk1, dv1, ops
        t = {"fwd": f1, "bwd_dq": statistics.median(bs), "bwd_dkv": statistics.median(cs_),
             "bwd_dq_ms_runs": bs, "bwd_dkv_ms_runs": cs_,
             "plain_fwd": plain_fwd, "plain_bwd": plain_bwd, "run_s": run_s}
        # the yardstick: SDPA's memory-efficient backend (flash and cuDNN stop
        # at d = 256; it takes no GQA, so K/V heads are repeated)
        ql, kl, vl, dol = (world_to_sequence(a) for a in (q, k, v, do))
        kl, vl = kl.repeat_interleave(rep, 1), vl.repeat_interleave(rep, 1)
        for a in (ql, kl, vl):
            a.requires_grad_(True)

        def sdpa():
            with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
                return F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)

        t["library_backend"] = "EFFICIENT_ATTENTION, K/V heads repeated"
        try:
            with torch.no_grad():
                t["library_fwd"] = time_ms(torch, sdpa, reps=1, warmup=1)
            o_lib = sdpa()
            t["library_bwd"] = time_ms(torch, lambda: torch.autograd.grad(
                o_lib, (ql, kl, vl), dol, retain_graph=True), reps=1, warmup=0)
            del o_lib
        except RuntimeError as e:  # the backend refuses: no time, its error kept
            t["library_fwd"] = t["library_bwd"] = None
            t["library_error"] = f"{type(e).__name__}: {e}"
        del ql, kl, vl, dol
        for kind in kinds:
            io = {"fwd": ({"q": 1, "kv": 2}, {"q": 1, "rows": 1}),
                  "bwd_dq": ({"q": 2, "kv": 2, "rows": 2}, {"q": 1}),
                  "bwd_dkv": ({"q": 2, "kv": 2, "rows": 2}, {"kv": 2})}[kind]
            bound, by, nbytes = attention_bound(kind, q.element_size(), peak, shape, *io)
            entries = causal_entries(shape)
            t.update({f"{kind}_bound_ms": bound, f"{kind}_bound_by": by,
                      f"{kind}_bytes": nbytes, f"{kind}_pct_of_bound": 100.0 * bound / t[kind],
                      f"{kind}_tflops": FLOPS_PER_ENTRY[kind] * g["d"] * entries
                      / (t[kind] * 1e-3) / 1e12,
                      f"{kind}_design_floor_ms": wide_floor_flops(key, kind, g["d"]) * g["d"]
                      * entries / rate * 1e3})
        timing[tag] = t
        log(f"wide attention timing {tag}: " + ", ".join(
            f"{k_} {v_:.3f}" if isinstance(v_, float) else f"{k_} {v_}"
            for k_, v_ in t.items() if not k_.endswith("_bytes")))
        del q, k, v, do, o1, lse
        torch.cuda.empty_cache()
    info["timing"] = timing
    lap("wide attention serving leg and timing")

    # the training step at d = 512: K2 and K3's wide forms under autograd
    d, S = WIDE_TRAIN_D, P * TRAIN_SEQ_PER_RANK
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(S, d).astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.randn(S, d).astype(np.float32)).to(dev)
    block = lct.block_from_numpy(lct.init_params(d, 2 * d), dev)
    params = {n: p.detach() for n, p in block.named_parameters()}
    attention.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss_s, grads_s = mpi_tpu_torch.run(lct.sharded_program, block, params, x, y, nranks=P)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    launches = only_wide("wide training step", attention_launches(attention))
    missing = [k for k in (f"attention_{kind}_wide" for kind in kinds) if not launches[k]]
    if missing:
        raise RuntimeError(f"wide training step never launched {missing}")
    paths[f"training step d={d}"] = launches
    loss2, grads2 = mpi_tpu_torch.run(lct.sharded_program, block, params, x, y, nranks=P)
    if not (torch.equal(loss_s, loss2) and
            all(torch.equal(grads_s[n], grads2[n]) for n in grads_s)):
        raise RuntimeError("wide training step: two steps on the same inputs differ")
    del loss2, grads2
    loss_d, grads_d = lct.dense_train_step(block)(params, x, y)
    torch.cuda.synchronize()
    if not (torch.isfinite(loss_s).all() and
            torch.allclose(loss_s[0], loss_d, rtol=1e-5, atol=1e-6)):
        raise RuntimeError(f"wide training loss {float(loss_s[0])} != dense {float(loss_d)}")
    grad_err = {}
    for name, gd in grads_d.items():
        if not torch.allclose(grads_s[name][0], gd, rtol=5e-4, atol=5e-5):
            raise RuntimeError(f"wide training gradient {name} disagrees with the dense step")
        grad_err[name] = float((grads_s[name][0] - gd).abs().max())
    info["training"] = {"step_s": step_s, "launches": launches, "loss": float(loss_s[0]),
                        "dense_loss": float(loss_d), "grad_max_abs_err_vs_dense": grad_err,
                        "seq": S, "d": d, "nranks": P, "deterministic": True}
    log(f"wide training step (d = {d}): {step_s:.3f} s, launches {launches}, loss "
        f"{float(loss_s[0]):.6f} vs dense {float(loss_d):.6f}; a second step bitwise equal")
    del x, y, block, params, loss_s, grads_s, loss_d, grads_d
    torch.cuda.empty_cache()
    record["wide_attention"] = info
    record["allowance_used"] = dict(ALLOWANCE_USED)
    lap("wide attention training step")

    bt = timing["bfloat16"]
    return [{
        "name": f"attention_{kind}_wide", "route": "cuda", "source": WIDE_SOURCE[kind],
        "replaces": ATTN_REPLACES[kind],
        "max_abs_err": errs[(kind, torch.bfloat16)], "ms": bt[kind],
        "plain_ms": bt["plain_fwd"] if kind == "fwd" else bt["plain_bwd"],
        "bound_ms": bt[f"{kind}_bound_ms"], "bound_by": bt[f"{kind}_bound_by"],
        "library_ms": bt["library_fwd"] if kind == "fwd" else bt["library_bwd"],
        "library_call": ("SDPA forward" if kind == "fwd" else
                         "SDPA backward (dq, dk and dv together)") + ", " + bt["library_backend"],
        "pct_of_bound": bt[f"{kind}_pct_of_bound"], "tflops": bt[f"{kind}_tflops"],
        "design_floor_ms": bt[f"{kind}_design_floor_ms"], "dtype": "bfloat16",
        "head_dim": WIDE_SERVE["d"]} for kind in kinds]


def agree(torch, name, got, want, rtol, atol, record):
    """``got`` (card) within ``atol + rtol |want|`` of ``want``; records
    the max abs error and the largest share of the allowance used."""
    g, w = got.detach().double().cpu(), want.detach().double().cpu()
    if g.shape != w.shape or not torch.isfinite(g).all():
        raise RuntimeError(f"{name}: shape {tuple(g.shape)} vs {tuple(w.shape)} "
                           f"or non-finite values")
    diff = (g - w).abs()
    share = float((diff / (atol + rtol * w.abs())).max()) if diff.numel() else 0.0
    record[name] = {"max_abs_err": float(diff.max()) if diff.numel() else 0.0,
                    "allowance_share": share, "rtol": rtol, "atol": atol}
    if share > 1.0:
        raise RuntimeError(f"{name}: max abs error {float(diff.max())} exceeds "
                           f"rtol {rtol} atol {atol} ({share:.3g} of the allowance)")
    return record[name]["max_abs_err"]


def agree_update(torch, name, got, want, before, tol, record):
    """The update ``got - before`` within ``tol`` of ``want - before`` in
    relative 2-norm: ||got - want|| <= tol ||want - before||."""
    g, w, b = (t.detach().double() for t in (got, want, before))
    err = float(torch.linalg.vector_norm(g - w) / torch.linalg.vector_norm(w - b))
    record[name] = {"relative_update_err": err, "allowance_share": err / tol, "tol": tol,
                    "max_abs_err": float((g - w).abs().max())}
    if not err <= tol:
        raise RuntimeError(f"{name}: update off by {err:.3g} of its norm (tolerance {tol})")
    return err


def dryrun_phase(torch, paths, record):
    """Phase 5: ``entry.dryrun_multichip(8)`` on the card, the reference's
    shapes; the attention kernels (forward and both backward) must have
    launched."""
    import contextlib
    import io

    from mpi_tpu_torch import entry
    from mpi_tpu_torch.gpu import attention, ring

    ring.reset_launches()
    attention.reset_launches()
    out = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        entry.dryrun_multichip(P)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {**ring_launches(ring), **attention_launches(attention)}
    missing = [k for k in ("attention_fwd", "attention_bwd_dq", "attention_bwd_dkv")
               if launches[k] == 0]
    if missing:
        raise RuntimeError(f"dry run never launched {missing}")
    paths["dry run"] = launches
    line = out.getvalue().strip().splitlines()[-1]
    if not line.startswith("dryrun_multichip OK: mesh=(2x4)") or "cuda_kernels(" not in line:
        raise RuntimeError(f"dry run printed {line!r}")
    record["dry_run"] = {"line": line, "run_s": run_s, "launches": launches}
    log(f"{line} ({run_s:.3f} s, launches {launches})")


def step_phase(torch, dev, paths, record):
    """Phase 6: one step of ``entry._build_step(2, 4, ...)`` at Llama-3-8B's
    MLP widths, as "ring" and as "pallas_ring" (K1 on the dp groups); the
    two agree, and both agree with a float64 dense step on the card; a
    second step takes the first one's outputs; then timing (CUDA events,
    median of 5 after 1 warm-up, and ``profiling.timeit``), K1 alone on
    the step's gradient, the fused SUM backward's cost, and a breakdown of
    one pallas_ring step read back from the trace ``profiling.trace``
    wrote.  Returns the two steps and their inputs."""
    from mpi_tpu_torch import entry, profiling
    from mpi_tpu_torch.gpu import attention, ring

    dp, mp, rows, d, hidden = (STEP[k] for k in ("dp", "mp", "rows_per_shard", "d",
                                                 "hidden"))
    gen = torch.Generator(device=dev).manual_seed(5)
    # the reference's init: x, y ~ N(0, 1), w1, w2 ~ 0.1 N(0, 1)
    x, y = (torch.randn((dp * rows, d), device=dev, generator=gen) for _ in range(2))
    w1 = torch.randn((d, hidden), device=dev, generator=gen) * 0.1
    w2 = torch.randn((hidden, d), device=dev, generator=gen) * 0.1
    info = {"shapes": {"x": list(x.shape), "w1": list(w1.shape), "w2": list(w2.shape)}}
    outs, steps = {}, {}
    fold_calls = []
    fold = ring.allreduce_world

    def spy(world, groups=None, *args, **kwargs):  # records what K1 folds
        fold_calls.append((groups, list(world.shape)))
        return fold(world, groups, *args, **kwargs)

    for alg in ("ring", "pallas_ring"):
        step = steps[alg] = entry._build_step(dp, mp, dp_algorithm=alg)
        ring.reset_launches()
        attention.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ring.allreduce_world = spy
        try:
            out = step(x, y, w1, w2)
        finally:
            ring.allreduce_world = fold
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        paths[f"full-width step ({alg})"] = {**ring_launches(ring),
                                             **attention_launches(attention)}
        info[alg] = {"first_step_s": first_s, "launches": paths[f"full-width step ({alg})"],
                     "peak_bytes": torch.cuda.max_memory_allocated(),
                     "loss": float(out[2])}
        again = step(x, y, out[0], out[1])  # the step takes its own outputs
        if not all(bool(torch.isfinite(t).all()) for t in (*out, *again)):
            raise RuntimeError(f"full-width step ({alg}) produced non-finite values")
        info[alg]["second_loss"] = float(again[2])
        outs[alg] = out
        del again
    k1 = paths["full-width step (pallas_ring)"]["ring_allreduce"]
    if k1 == 0 or paths["full-width step (ring)"]["ring_allreduce"] != 0:
        raise RuntimeError("K1 must launch in the pallas_ring step and only there")
    if [g for g, _ in fold_calls] != [DP_GROUPS] * k1:
        raise RuntimeError(f"K1 folded groups {fold_calls}, not {DP_GROUPS}")
    info["k1_fold_calls"] = fold_calls
    for name, a, b in zip(("w1", "w2", "loss", "aux"), outs["ring"], outs["pallas_ring"]):
        agree(torch, f"step {name}: pallas_ring vs ring", b, a, 1e-5, 1e-6, info)

    # the float64 dense step on one device: one SGD step (lr 0.1) on the sum
    # over the dp shards of their mean squared errors, the reference's step.
    # The loss is held elementwise (rtol 1e-5); the weights by their update
    # in relative 2-norm (1e-2): float32 rounding of x @ w1 (error about
    # 2.4e-5 on values of spread 6.4, K = 4096) flips about 200 of the 58.7M
    # relu mask entries, each moving a column of the w1 gradient by about
    # 8e-5 times a row of x: an expected 2-3e-3 of the update's norm, and
    # up to 3e-5 on single elements of w1 (measured on an H100)
    X, Y, W1, W2 = (t.double() for t in (x, y, w1, w2))
    xs, ys = X.view(dp, rows, d), Y.view(dp, rows, d)

    def total_loss(a, b):
        return ((torch.relu(xs @ a) @ b - ys) ** 2).mean(dim=(1, 2)).sum()

    g1, g2 = torch.func.grad(total_loss, argnums=(0, 1))(W1, W2)
    dense = (W1 - 0.1 * g1, W2 - 0.1 * g2, total_loss(W1, W2))
    for alg in ("ring", "pallas_ring"):
        for name, got, want, before in zip(("w1", "w2"), outs[alg], dense, (w1, w2)):
            agree_update(torch, f"step {name} update ({alg}) vs float64 dense", got, want,
                         before, 1e-2, info)
        agree(torch, f"step loss ({alg}) vs float64 dense", outs[alg][2], dense[2], 1e-5,
              0.0, info)
    del X, Y, W1, W2, xs, ys, g1, g2, dense, outs
    torch.cuda.empty_cache()

    # timing: the step by both spellings, K1 alone on the step's operand
    for alg, step in steps.items():
        info[alg]["step_ms"] = time_ms(torch, lambda: step(x, y, w1, w2), reps=5, warmup=1)
    g_world = torch.randn((P, d, hidden // mp), device=dev, generator=gen)
    info["k1_ms"] = time_ms(torch, lambda: ring.allreduce_world(g_world, DP_GROUPS),
                            reps=5, warmup=1)
    info["k1_share_of_pallas_ring_step"] = info["k1_ms"] / info["pallas_ring"]["step_ms"]
    del g_world
    info["pallas_ring"]["step_timeit_ms"] = profiling.timeit(
        lambda: steps["pallas_ring"](x, y, w1, w2), iters=5, warmup=1).p50_s * 1e3
    sum_backward_cost(torch, dev, steps["pallas_ring"], (x, y, w1, w2), info)
    torch.cuda.synchronize()
    trace_dir = os.path.join("chiprun_out", "step_trace")
    with profiling.trace(trace_dir):
        t0 = time.perf_counter()
        steps["pallas_ring"](x, y, w1, w2)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # read back from the Chrome trace profiling.trace wrote: the device's
    # kernels, copies and fills (busy time), kernel launches counted apart
    summary = profiling.trace_summary(os.path.join(trace_dir, profiling.TRACE_FILE))
    busy = summary["busy_ms"]
    info["profile"] = {"wall_ms": wall_ms, "device_busy_ms": busy,
                       "device_span_ms": summary["span_ms"],
                       "idle_share": (1.0 - busy / wall_ms) if busy else None,
                       "device_op_names": len(summary["by_name"]),
                       "kernel_launches": summary["kernel_launches"],
                       "copies_and_fills": summary["copies_and_fills"],
                       "source": os.path.join(trace_dir, profiling.TRACE_FILE),
                       "top": [{"op": k, "device_ms": t, "count": c}
                               for k, t, c in summary["by_name"][:15]]}
    record["full_width_step"] = info
    log(f"full-width step (D={d}, H={hidden}, {rows} rows per dp shard, 2 x 4): "
        f"first step ring {info['ring']['first_step_s']:.3f} s / pallas_ring "
        f"{info['pallas_ring']['first_step_s']:.3f} s; step ring "
        f"{info['ring']['step_ms']:.3f} ms, pallas_ring {info['pallas_ring']['step_ms']:.3f} ms; "
        f"(timeit {info['pallas_ring']['step_timeit_ms']:.3f} ms); "
        f"K1 alone {info['k1_ms']:.4f} ms ({100 * info['k1_share_of_pallas_ring_step']:.2f}% "
        f"of the pallas_ring step); peak {info['pallas_ring']['peak_bytes'] / 2**30:.2f} GiB; "
        f"profiled step (profiling.trace): wall {wall_ms:.3f} ms, device busy "
        f"{busy:.3f} ms in {info['profile']['kernel_launches']} kernel launches and "
        f"{info['profile']['copies_and_fills']} copies and fills; SUM backward "
        f"{info['sum_backward']['rule_ms']:.4f} ms alone, step with the old rule "
        f"{info['sum_backward']['step_old_rule_ms']:.3f} ms vs "
        f"{info['sum_backward']['step_new_rule_ms']:.3f} ms")
    for row in info["profile"]["top"][:8]:
        log(f"  {row['device_ms']:9.3f} ms  x{row['count']:<4d} {row['op'][:90]}")
    log("  allowance shares: " + ", ".join(
        f"{k}: {v['allowance_share']:.3g}" for k, v in info.items()
        if isinstance(v, dict) and "allowance_share" in v))
    return steps, (x, y, w1, w2)


def sum_backward_cost(torch, dev, step, args, info):
    """What the fused SUM backward's rule costs in the full-width step: the
    rule alone on a cotangent of the tp allreduce's shape (``[P, rows,
    d]``, groups of the mp axis), and the step with it against the step
    with the rule it replaced (each cotangent passed through unchanged),
    timed in turns (new, old, old, new; CUDA events, median of 5 each)."""
    from mpi_tpu_torch.gpu import primitives

    dp, mp, rows, d = (STEP[k] for k in ("dp", "mp", "rows_per_shard", "d"))
    groups = list(range(P))  # the mp groups [[0, 1, 2, 3], [4, 5, 6, 7]], flattened
    gen = torch.Generator(device=dev).manual_seed(11)
    # as in the step, each mp group's cotangents are equal (else it raises)
    cot = torch.randn((P // mp, rows, d), device=dev, generator=gen).repeat_interleave(mp, 0)

    rule_ms = time_ms(torch, lambda: primitives.group_cotangent_world(cot, groups, mp),
                      reps=5, warmup=1)
    del cot
    new_backward = primitives._GroupReduce.backward

    def old_backward(ctx, grad):
        return grad, None, None, None, None

    turns = {"new": [], "old": []}
    for side in ("new", "old", "old", "new"):
        if side == "old":
            primitives._GroupReduce.backward = staticmethod(old_backward)
        try:
            turns[side].append(time_ms(torch, lambda: step(*args), reps=5, warmup=1))
        finally:
            primitives._GroupReduce.backward = staticmethod(new_backward)
    info["sum_backward"] = {
        "rule_ms": rule_ms, "cotangent_shape": [P, rows, d],
        "step_new_rule_ms": statistics.median(turns["new"]),
        "step_old_rule_ms": statistics.median(turns["old"]), "turns": turns}


def checkpoint_phase(torch, dev, steps, args, record):
    """The full-width step's state after step 1 (w1 and w2, laid out as
    the reference's out_specs P(None, "mp") and P("mp", None) over the 2 x
    4 mesh) through ``checkpoint.save_sharded`` under chiprun_out/ and
    ``load_sharded`` onto the card into a template; step 2 from the loaded
    state must equal step 2 from the state in memory, bitwise."""
    import shutil

    from mpi_tpu_torch.checkpoint import Layout, Sharded, load_sharded, save_sharded

    x, y, w1, w2 = args
    step = steps["pallas_ring"]
    w1n, w2n, _, _ = step(x, y, w1, w2)
    mesh = {"dp": STEP["dp"], "mp": STEP["mp"]}
    layouts = {"w1": Layout(mesh, (None, "mp")), "w2": Layout(mesh, ("mp", None))}
    state = {"w1": Sharded(w1n, layouts["w1"]), "w2": Sharded(w2n, layouts["w2"])}
    path = os.path.join("chiprun_out", "checkpoint")
    shutil.rmtree(path, ignore_errors=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nbytes = save_sharded(path, state)
    save_s = time.perf_counter() - t0
    files = sum(len(f) for _, _, f in os.walk(path))
    template = {k: Sharded(torch.empty_like(v.tensor), layouts[k]) for k, v in state.items()}
    t0 = time.perf_counter()
    loaded = load_sharded(path, template)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    shutil.rmtree(path)
    for k, v in state.items():
        got = loaded[k].tensor
        if got.device != dev or not torch.equal(got, v.tensor):
            raise RuntimeError(f"checkpoint: {k} came back different (on {got.device})")
    want = step(x, y, w1n, w2n)
    got = step(x, y, loaded["w1"].tensor, loaded["w2"].tensor)
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise RuntimeError("checkpoint: step 2 from the loaded state differs")
    record["checkpoint"] = {"bytes": nbytes, "files": files, "save_s": save_s,
                            "load_s": load_s,
                            "step2_from_loaded_state": "bitwise equal"}
    log(f"checkpoint: {nbytes} bytes in {files} files (shards and manifest), save "
        f"{save_s:.3f} s, load {load_s:.3f} s; step 2 from the loaded state bitwise "
        f"equal")


def aot_phase(torch, dev, steps, args, paths, record):
    """``entry.lower_multichip(8)`` at the reference's shapes on fake
    tensors (device memory allocated must not change; the pallas_ring
    graph must hold one ``ring_fold`` node and ``attn_fwd`` nodes), then
    ``entry.export_multichip(8, "pallas_ring")`` at full width through
    ``torch.export.save`` / ``load``: the loaded program's outputs must
    equal the eager step's bitwise, and running it must launch K1 and K2
    (counters zeroed before, read after); both timed with CUDA events
    (median of 5 after 1 warm-up)."""
    from mpi_tpu_torch import aot, entry
    from mpi_tpu_torch.gpu import attention, ring

    info = {}
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    graph = entry.lower_multichip(P)
    info["lower_s"] = time.perf_counter() - t0
    graph_k = entry.lower_multichip(P, "pallas_ring")
    info["lower_allocated_bytes"] = torch.cuda.memory_allocated() - before
    info["lower_nodes"] = len(graph.graph.nodes)
    info["lower_kernel_nodes"] = {"ring": aot.kernel_nodes(graph),
                                  "pallas_ring": aot.kernel_nodes(graph_k)}
    if info["lower_allocated_bytes"] != 0:
        raise RuntimeError(f"lower_multichip allocated {info['lower_allocated_bytes']} bytes")
    nodes = info["lower_kernel_nodes"]["pallas_ring"]
    if nodes.get("ring_fold") != 1 or not nodes.get("attn_fwd"):
        raise RuntimeError(f"the lowered pallas_ring step holds kernel nodes {nodes}")
    del graph, graph_k

    shapes = tuple(tuple(t.shape) for t in args)
    t0 = time.perf_counter()
    program = entry.export_multichip(P, "pallas_ring", shapes=shapes)
    info["export_s"] = time.perf_counter() - t0
    info["export_kernel_nodes"] = aot.kernel_nodes(program.graph_module)
    nodes = info["export_kernel_nodes"]
    if nodes.get("ring_fold") != 1 or not nodes.get("attn_fwd"):
        raise RuntimeError(f"the exported step holds kernel nodes {nodes}")
    path = os.path.join("chiprun_out", "full_width_step.pt2")
    t0 = time.perf_counter()
    torch.export.save(program, path)
    loaded = torch.export.load(path).module()
    info["save_load_s"] = time.perf_counter() - t0
    info["pt2_bytes"] = os.path.getsize(path)
    os.remove(path)
    eager = steps["pallas_ring"](*args)
    ring.reset_launches()
    attention.reset_launches()
    torch.cuda.synchronize()
    out = loaded(*args)
    torch.cuda.synchronize()
    launches = {**ring_launches(ring), **attention_launches(attention)}
    if not launches["ring_allreduce"] or not launches["attention_fwd"]:
        raise RuntimeError(f"the exported step launched {launches}")
    paths["exported full-width step"] = launches
    info["launches"] = launches
    if not all(torch.equal(a, b) for a, b in zip(out, eager)):
        raise RuntimeError("the exported step's outputs differ from the eager step's")
    del out, eager
    info["exported_step_ms"] = time_ms(torch, lambda: loaded(*args), reps=5, warmup=1)
    info["eager_step_ms"] = time_ms(torch, lambda: steps["pallas_ring"](*args), reps=5,
                                    warmup=1)
    record["aot"] = info
    log(f"AOT: lower_multichip(8) {info['lower_s']:.3f} s, {info['lower_nodes']} nodes, "
        f"kernel nodes {info['lower_kernel_nodes']}, {info['lower_allocated_bytes']} bytes "
        f"allocated; export at full width {info['export_s']:.3f} s, kernel nodes "
        f"{nodes}, .pt2 {info['pt2_bytes']} bytes; loaded program bitwise equal to the "
        f"eager step, launches {launches}; step {info['exported_step_ms']:.3f} ms "
        f"exported vs {info['eager_step_ms']:.3f} ms eager")


def gradient_phase(torch, record):
    """The fused SUM's gradient on the card against the CPU, 8 ranks, numpy
    inputs (rtol 1e-5, atol 1e-6): the mixed program (the reduced value,
    marked by ``comm.localize``, times a rank-varying y: each rank's
    gradient is x_r times the sum of y), the residual block (h1 + the
    allreduce of localize(h1) times a rank-varying u) and the replicated
    one (the reduced value squared).  The mixed program without the mark
    must raise, naming ``comm.localize``, on the card as on the CPU."""
    import numpy as np

    import mpi_tpu_torch

    rng = np.random.RandomState(0)
    x, w, y = (rng.randn(P, 3).astype(np.float32) for _ in range(3))

    def mixed(comm, x, w, y, mark=True):
        def loss(v):
            r = comm.allreduce(x[comm.rank] * v, algorithm="fused")
            return torch.sum((comm.localize(r) if mark else r) * y[comm.rank])
        return torch.func.grad(loss)(w[comm.rank])

    def residual(comm, x, w, u):
        def loss(v):
            h1 = comm.allreduce(x[comm.rank] * v, algorithm="fused")
            h2 = h1 + comm.allreduce(comm.localize(h1) * u[comm.rank], algorithm="fused")
            return torch.sum(h2 ** 2)
        return torch.func.grad(loss)(w[comm.rank])

    def replicated(comm, x, w, y):
        return torch.func.grad(lambda v: torch.sum(comm.allreduce(
            x[comm.rank] * v, algorithm="fused") ** 2))(w[comm.rank])

    info = {}
    for name, prog in (("mixed", mixed), ("residual", residual),
                       ("replicated", replicated)):
        card = mpi_tpu_torch.run(prog, x, w, y, nranks=P)
        cpu = mpi_tpu_torch.run(prog, x, w, y, nranks=P, device="cpu")
        agree(torch, f"gradient {name}: card vs cpu", card, cpu, 1e-5, 1e-6, info)
        if name == "mixed":  # JAX's result: x_r times the sum of y
            agree(torch, "gradient mixed: card vs x * sum(y)", card,
                  torch.from_numpy(x * y.sum(0)), 1e-5, 1e-6, info)
    for dev in (None, "cpu"):
        try:
            mpi_tpu_torch.run(lambda c, *a: mixed(c, *a, mark=False), x, w, y,
                              nranks=P, device=dev)
        except RuntimeError as e:
            if "comm.localize" not in str(e):
                raise
        else:
            raise RuntimeError(f"the unmarked mixed program ran on {dev or 'the card'}")
    info["unmarked_mixed_raises"] = True
    record["gradient"] = info
    log("gradient programs on the card vs the CPU: " + ", ".join(
        f"{k} {v['max_abs_err']:.3g}" for k, v in info.items() if isinstance(v, dict))
        + "; the unmarked mixed program raises naming comm.localize on both")


def examples_phase(torch, record):
    """Phase 7: jacobi2d, pipeline, moe, ulysses and data_parallel through
    ``run(..., nranks=8)`` on the card at their default sizes, each against
    the same program on the CPU (the random ones on the card's draws,
    carried across) and moe / pipeline against their numpy oracles."""
    import mpi_tpu_torch
    from mpi_tpu_torch.examples import data_parallel as dpx
    from mpi_tpu_torch.examples import jacobi2d, moe, pipeline
    from mpi_tpu_torch.examples import ulysses_attention as ul

    run = mpi_tpu_torch.run
    info = {}

    def on_cpu(fn, *args):
        return run(fn, *(a.cpu() if isinstance(a, torch.Tensor) else
                         {k: v.cpu() for k, v in a.items()} for a in args),
                   nranks=P, device="cpu")

    tile, res = run(jacobi2d.jacobi2d_program, nranks=P)
    tile_c, res_c = run(jacobi2d.jacobi2d_program, nranks=P, device="cpu")
    agree(torch, "jacobi2d tiles vs cpu", tile, tile_c, 0.0, 1e-6, info)
    agree(torch, "jacobi2d residual vs cpu", res, res_c, 0.0, 1e-6, info)

    out = run(pipeline.pipeline_program, nranks=P)
    mx, w, b = run(pipeline.pipeline_inputs, nranks=P)
    agree(torch, "pipeline vs cpu", out, on_cpu(
        lambda c, mx, w, b: pipeline.pipeline_forward(c, mx[c.rank], w[c.rank], b[c.rank]),
        mx, w, b), 1e-5, 1e-6, info)
    agree(torch, "pipeline vs numpy oracle", out[-1], torch.from_numpy(
        pipeline.pipeline_oracle(*(t.cpu().numpy() for t in (mx[0], w, b)))), 0.0, 1e-5, info)

    out = run(moe.moe_program, nranks=P)
    xs, wr, wi, wo = run(moe.moe_inputs, nranks=P)
    agree(torch, "moe vs cpu", out, on_cpu(
        lambda c, x, wr, wi, wo: moe.moe_layer(c, x[c.rank], wr[c.rank], wi[c.rank],
                                               wo[c.rank], 8), xs, wr, wi, wo),
          1e-5, 1e-6, info)
    agree(torch, "moe vs numpy oracle", out, torch.from_numpy(moe.moe_oracle(
        *(t.cpu().numpy() for t in (xs, wr[0], wi, wo)), 8)), 0.0, 1e-5, info)

    out, q, k, v = run(ul.ulysses_program, nranks=P)
    agree(torch, "ulysses vs cpu", out, on_cpu(
        lambda c, q, k, v: ul.ulysses_attention(c, q[c.rank], k[c.rank], v[c.rank]),
        q, k, v), 1e-5, 1e-6, info)

    loss, ck = run(dpx.dp_train_program, nranks=P)
    params, x, y = run(dpx.dp_inputs, nranks=P)
    loss_c, ck_c = on_cpu(lambda c, p, x, y: dpx.dp_train(c, p, x[c.rank], y[c.rank]),
                          {n: t[0] for n, t in params.items()}, x, y)
    agree(torch, "data_parallel loss vs cpu", loss, loss_c, 1e-5, 0.0, info)
    agree(torch, "data_parallel checksum vs cpu", ck, ck_c, 1e-5, 0.0, info)
    info["data_parallel_loss"] = float(loss[0])
    record["examples"] = info
    log("examples on the card vs the CPU and the oracles: " + ", ".join(
        f"{k} {v['max_abs_err']:.3g} ({v['allowance_share']:.3g} of allowance)"
        for k, v in info.items() if isinstance(v, dict)))


HOST_SEED = 7
# timed calls of each phase-13 collective and of phase 19a's 256 MiB ring
# (cut from 3 and 2 to keep the script under 600 s with phases 22-23)
HOST_LOCAL_REPS = 2
VERIFY_RING_REPS = 1
# phase 13's collectives other than the north-star ring allreduce run at
# 32 MiB per rank (256 MiB until phases 24-25 needed the seconds, 64 MiB
# until phase 27's worker start-ups slowed phase 24's launches)
HOST_LOCAL_SMALL_ELEMS = NORTH_STAR_ELEMS // 8


def _timed_program(torch, call, reps=3):
    """A rank program: 1 warm-up and ``reps`` timed calls of ``call(comm,
    xs)`` (a barrier and a synchronize before each, a synchronize before the
    clock stops); returns the last result and the rank's seconds."""
    def prog(comm, xs):
        call(comm, xs)
        secs, out = [], None
        for _ in range(reps):
            comm.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = call(comm, xs)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        return out, secs
    return prog


def host_local_phase(torch, record):
    """Phase 13: the local backend's collectives on the card, the ring
    allreduce at 256 MiB per rank and the others at 32 MiB, against the
    CPU and a float64 sum, timed."""
    import mpi_tpu_torch
    from mpi_tpu_torch import profiling
    from mpi_tpu_torch.examples.host_allreduce import rank_input

    dev = torch.device("cuda", 0)
    card = card_line()
    n, numel = P, NORTH_STAR_ELEMS
    nbytes = numel * 4
    xs = [rank_input(r, numel, HOST_SEED, dev) for r in range(n)]
    xs_cpu = [x.cpu() for x in xs]
    want = torch.zeros(numel, dtype=torch.float64, device=dev)
    for x in xs:
        want += x.double()
    small = HOST_LOCAL_SMALL_ELEMS
    # name -> (call, elements per rank, its bus factor); the small ones
    # read the first HOST_LOCAL_SMALL_ELEMS of each rank's input
    colls = {f"allreduce {a}": (lambda c, xs, a=a: c.allreduce(xs[c.rank], algorithm=a),
                                numel if a == "ring" else small, 2 * (n - 1) / n)
             for a in ("ring", "recursive_halving", "rabenseifner", "reduce_bcast")}
    colls["reduce_scatter"] = (lambda c, xs: c.reduce_scatter(xs[c.rank].view(n, -1)),
                               small, (n - 1) / n)
    for a in ("ring", "doubling"):
        colls[f"allgather {a}"] = (
            lambda c, xs, a=a: c.allgather(xs[c.rank][:xs[c.rank].numel() // n],
                                           algorithm=a),
            small, (n - 1) / n)
    colls["bcast tree"] = (lambda c, xs: c.bcast(xs[0] if c.rank == 0 else None, root=0),
                           small, 1.0)
    # the blocks as one [P, N/P] tensor: the result comes back stacked
    colls["alltoall"] = (lambda c, xs: c.alltoall(xs[c.rank].view(n, -1)),
                         small, (n - 1) / n)

    def expect(name, r, got, xs, want):
        """The check of rank r's result beyond card == CPU: copies must be
        the inputs exactly; reductions agree across ranks bitwise and with
        the float64 sum."""
        if name.startswith("allreduce"):
            return (torch.equal(got, results[0]) and torch.allclose(
                got.double(), want, rtol=1e-5, atol=1e-5))
        if name == "reduce_scatter":
            return torch.allclose(got.double(), want.view(n, -1)[r], rtol=1e-5, atol=1e-5)
        if name.startswith("allgather"):
            shard = xs[0].numel() // n
            return torch.equal(got, torch.stack([x[:shard] for x in xs]))
        if name == "bcast tree":
            return torch.equal(got, xs[0])
        return torch.equal(got, torch.stack([x.view(n, -1)[r] for x in xs]))

    info = {"card": card, "ranks": n, "bytes_per_rank": nbytes,
            "small_bytes_per_rank": small * 4}
    for name, (call, m, factor) in colls.items():
        nb = m * 4
        ins, ins_cpu = [x[:m] for x in xs], [x[:m] for x in xs_cpu]
        outs = mpi_tpu_torch.run(_timed_program(torch, call, HOST_LOCAL_REPS), ins,
                                 backend="local", nranks=n)
        results = [o for o, _ in outs]
        secs = [max(ts[i] for _, ts in outs) for i in range(HOST_LOCAL_REPS)]
        bad = [r for r, got in enumerate(results)
               if not expect(name, r, got, ins, want[:m])]
        if bad:
            raise RuntimeError(f"host-local {name}: ranks {bad} fail their check")
        cpu = mpi_tpu_torch.run(lambda c, xs: call(c, xs), ins_cpu, backend="local",
                                nranks=n, device="cpu")
        if not all(torch.equal(results[r].cpu(), cpu[r]) for r in range(n)):
            raise RuntimeError(f"host-local {name}: the card differs from the CPU")
        med = statistics.median(secs)
        err = (float((results[0].double() - want[:m]).abs().max())
               if name.startswith("allreduce") else 0.0)
        info[name] = {"s": secs, "median_ms": med * 1e3, "bytes_per_rank": nb,
                      "algbw_GBps": nb / med / 1e9, "busbw_GBps": factor * nb / med / 1e9,
                      "bus_factor": factor, "max_abs_err_vs_f64": err}
        log(f"host-local {name} ({nb >> 20} MiB per rank): median {med * 1e3:.1f} ms "
            f"({', '.join(f'{t * 1e3:.1f}' for t in secs)}), "
            f"bus bandwidth {factor:.3f} N/t = {factor * nb / med / 1e9:.2f} GB/s; "
            f"bitwise across ranks and vs the CPU [{card}]")
        del outs, results, cpu
    # the card's busy share over one ring allreduce, from a profiler trace
    trace_dir = os.path.join("chiprun_out", "host_local_trace")
    torch.cuda.synchronize()
    with profiling.trace(trace_dir):
        t0 = time.perf_counter()
        mpi_tpu_torch.run(lambda c, xs: c.allreduce(xs[c.rank], algorithm="ring"), xs,
                          backend="local", nranks=n)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    path = os.path.join(trace_dir, profiling.TRACE_FILE)
    summary = profiling.trace_summary(path)
    os.remove(path)  # tens of MB of events; the summary is what is kept
    info["profile_ring"] = {"wall_ms": wall_ms, "device_busy_ms": summary["busy_ms"],
                            "busy_share": summary["busy_ms"] / wall_ms,
                            "kernel_launches": summary["kernel_launches"],
                            "copies_and_fills": summary["copies_and_fills"],
                            "top": summary["by_name"][:6]}
    log(f"host-local ring allreduce traced: wall {wall_ms:.1f} ms, card busy "
        f"{summary['busy_ms']:.1f} ms ({100 * summary['busy_ms'] / wall_ms:.1f}%), "
        f"{summary['kernel_launches']} kernel launches, "
        f"{summary['copies_and_fills']} copies and fills [{card}]")
    record["host_local"] = info
    del xs, xs_cpu, want
    torch.cuda.empty_cache()


def host_socket_phase(torch, record):
    """Phases 14 and 15: the launcher's socket ranks on the card, and the
    examples under the local backend and as socket ranks against SPMD."""
    import mpi_tpu_torch
    from mpi_tpu_torch.examples.jacobi import jacobi_program
    from mpi_tpu_torch.examples.pi import pi_program

    card = card_line()
    nr = 4
    out_dir = os.path.abspath(os.path.join("chiprun_out", "host_socket"))
    if os.path.isdir(out_dir):
        for f in os.listdir(out_dir):
            os.remove(os.path.join(out_dir, f))
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "mpi_tpu_torch.launcher", "-n", str(nr), "--timeout", "400",
         os.path.join("mpi_tpu_torch", "examples", "host_allreduce.py"),
         "--out", out_dir, "--mib", str(NORTH_STAR_ELEMS * 4 >> 20), "--seed", str(HOST_SEED)],
        cwd=root, capture_output=True, text=True, timeout=450)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f"host-socket ranks failed (rc {res.returncode}):\n"
                           f"{res.stdout[-3000:]}\n{res.stderr[-6000:]}")
    ranks = []
    for r in range(nr):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    if not all(d["device"].startswith("cuda") for d in ranks):
        raise RuntimeError(f"socket ranks not on the card: {[d['device'] for d in ranks]}")
    info = {"card": card, "ranks": nr, "launcher_wall_s": wall,
            "bytes_per_rank": ranks[0]["bytes_per_rank"]}
    nb = ranks[0]["bytes_per_rank"]
    for algo in ("ring", "rabenseifner"):
        d = ranks[0][algo]
        med = d["median_ms"] / 1e3
        info[f"allreduce {algo}"] = dict(
            d, busbw_GBps=2 * (nr - 1) / nr * nb / med / 1e9,
            pickled_bytes_all_ranks=[x[algo]["pickled_bytes"] for x in ranks])
        log(f"host-socket allreduce {algo}: median {d['median_ms']:.1f} ms "
            f"({', '.join(f'{t * 1e3:.1f}' for t in d['s'])}), bus bandwidth 2(P-1)/P N/t "
            f"= {info[f'allreduce {algo}']['busbw_GBps']:.2f} GB/s, pickled bytes "
            f"{info[f'allreduce {algo}']['pickled_bytes_all_ranks']}, float64 error "
            f"{d['max_abs_err_vs_f64']:.3g} [{card}]")
    small = ranks[0]["allreduce_1KiB_2ranks"]
    info["allreduce_1KiB_2ranks"] = small
    log(f"host-socket allreduce 1 KiB float32, 2 ranks: median {small['median_ms']:.3f} ms "
        f"({', '.join(f'{t * 1e3:.3f}' for t in small['s'])}) [{card}]")
    log(f"host-socket: launcher wall {wall:.1f} s for {nr} ranks")
    record["host_socket"] = info

    # 15. the examples, unmodified, against their SPMD results on the card
    pi_spmd = mpi_tpu_torch.run(pi_program, nranks=nr)
    pi_local = mpi_tpu_torch.run(pi_program, backend="local", nranks=nr)
    blocks, resid = mpi_tpu_torch.run(jacobi_program, nranks=nr)
    jac_local = mpi_tpu_torch.run(jacobi_program, backend="local", nranks=nr)
    for r in range(nr):
        if not (torch.equal(pi_local[r], pi_spmd[r]) and float(pi_spmd[r]) == ranks[r]["pi"]):
            raise RuntimeError(f"pi rank {r}: local {float(pi_local[r])}, socket "
                               f"{ranks[r]['pi']}, SPMD {float(pi_spmd[r])}")
        sock_block = torch.tensor(ranks[r]["jacobi"]["block"], dtype=torch.float32)
        if not (torch.equal(jac_local[r][0], blocks[r]) and torch.equal(jac_local[r][1], resid[r])
                and torch.equal(sock_block, blocks[r].cpu())
                and ranks[r]["jacobi"]["residual"] == float(resid[r])):
            raise RuntimeError(f"jacobi rank {r}: local or socket differs from SPMD")
    record["host_examples"] = {"pi": float(pi_spmd[0]), "jacobi_residual": float(resid[0]),
                               "ranks": nr}
    log(f"examples pi ({float(pi_spmd[0]):.6f}) and jacobi (residual {float(resid[0]):.3e}): "
        f"local backend and socket ranks on the card bitwise equal to SPMD")


NBC_SM_BYTES = 1 << 20          # nbc_sm_max_bytes' default: the largest SM payload


def _pvar_deltas(mpit, names, fn):
    base = {k: mpit.pvar_read(k) for k in names}
    out = fn()
    return out, {k: mpit.pvar_read(k) - base[k] for k in names}


def host_nbc_phase(torch, record):
    """Phase 16: the nonblocking engine on 8 local rank threads on the card
    with the progress engine: 1000 concurrent iallreduces (state machines,
    no thread), every i-collective at 1 MiB against the blocking calls and
    the CPU, iallreduce at 256 MiB overlapping bf16 products, and a
    persistent allreduce refilled in place."""
    import mpi_tpu_torch
    from mpi_tpu_torch import mpit
    from mpi_tpu_torch.examples.host_allreduce import rank_input

    card = card_line()
    n = P
    info = {"card": card, "ranks": n}

    # (a) 1000 concurrent 1 KiB iallreduces per rank, then waitall; the
    # blocking results come from a world of their own (no engine)
    def inputs(comm):
        return [rank_input(comm.rank, 256, HOST_SEED + i, comm.device) for i in range(1000)]

    def many(comm):
        xs = inputs(comm)
        comm.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reqs = [comm.iallreduce(x) for x in xs]
        outs = [r.wait() for r in reqs]
        torch.cuda.synchronize()
        return time.perf_counter() - t0, outs

    names = ("nbc_threads_spawned", "nbc_state_machines")
    # the cyclic collector off while 8000 machines are alive, as timeit
    # runs: its full passes over the growing heap would be timed instead
    gc.disable()
    try:
        res, d = _pvar_deltas(mpit, names, lambda: mpi_tpu_torch.run(
            many, backend="local", nranks=n, progress="thread"))
        blocking = mpi_tpu_torch.run(lambda c: [c.allreduce(x) for x in inputs(c)],
                                     backend="local", nranks=n)
    finally:
        gc.enable()
    if d != {"nbc_threads_spawned": 0, "nbc_state_machines": 1000 * n}:
        raise RuntimeError(f"host-nbc 1000 iallreduce: pvars {d}")
    if not all(torch.equal(a, b) for r in range(n) for a, b in zip(res[r][1], blocking[r])):
        raise RuntimeError("host-nbc 1000 iallreduce: a result differs from the blocking call")
    secs = max(s for s, _ in res)
    info["iallreduce_1000x1KiB"] = {"s": secs, "ms_per_call": secs, "pvars": d}
    log(f"host-nbc (a) 1000 concurrent iallreduce of 1 KiB on {n} ranks: {secs:.3f} s "
        f"({secs:.3f} ms per call), pvars {d}, bitwise vs blocking [{card}]")
    del res, blocking

    # (b) every i-collective at 1 MiB per rank, vs blocking and vs the CPU
    numel = NBC_SM_BYTES // 4

    dev = torch.device("cuda", 0)
    xs = [rank_input(r, numel, HOST_SEED, dev) for r in range(n)]
    roots = [rank_input(100 + d, numel, HOST_SEED, dev) for d in range(n)]

    def family(comm, xs, roots, nonblocking):
        x = xs[comm.rank]
        blocks = x.view(n, -1)
        scat = roots if comm.rank == 0 else None
        if nonblocking:
            return [comm.iallreduce(x).wait(), comm.ireduce(x, root=3).wait(),
                    comm.ibcast(x if comm.rank == 2 else None, root=2).wait(),
                    comm.iallgather(x).wait(), comm.ialltoall(blocks).wait(),
                    comm.ibarrier().wait(), comm.iscatter(scat, root=0).wait(),
                    comm.igather(x, root=1).wait()]
        return [comm.allreduce(x), comm.reduce(x, root=3),
                comm.bcast(x if comm.rank == 2 else None, root=2),
                comm.allgather(x), comm.alltoall(blocks), comm.barrier(),
                comm.scatter(scat, root=0), comm.gather(x, root=1)]

    kinds = ["iallreduce", "ireduce", "ibcast", "iallgather", "ialltoall",
             "ibarrier", "iscatter", "igather"]

    def same(a, b):
        if isinstance(a, (list, tuple)):
            return isinstance(b, (list, tuple)) and len(a) == len(b) and \
                all(same(x, y) for x, y in zip(a, b))
        if isinstance(a, torch.Tensor):
            return isinstance(b, torch.Tensor) and torch.equal(a.cpu(), b.cpu())
        return a == b

    t0 = time.perf_counter()
    (nb, d) = _pvar_deltas(mpit, ("nbc_threads_spawned",), lambda: mpi_tpu_torch.run(
        family, xs, roots, True, backend="local", nranks=n, progress="thread"))
    t_nb = time.perf_counter() - t0
    bl = mpi_tpu_torch.run(family, xs, roots, False, backend="local", nranks=n)
    cpu = mpi_tpu_torch.run(family, [x.cpu() for x in xs], [x.cpu() for x in roots],
                            True, backend="local", nranks=n, progress="thread",
                            device="cpu")
    if d["nbc_threads_spawned"]:
        raise RuntimeError(f"host-nbc (b): {d['nbc_threads_spawned']} threads spawned")
    for r in range(n):
        for k, kind in enumerate(kinds):
            if not same(nb[r][k], bl[r][k]):
                raise RuntimeError(f"host-nbc (b) {kind} rank {r}: differs from blocking")
            if not same(nb[r][k], cpu[r][k]):
                raise RuntimeError(f"host-nbc (b) {kind} rank {r}: the card differs from the CPU")
    info["family_1MiB"] = {"kinds": kinds, "s": t_nb}
    log(f"host-nbc (b) every i-collective at 1 MiB per rank: {t_nb:.3f} s, bitwise vs "
        f"blocking and vs the CPU, 0 threads [{card}]")
    del nb, bl, cpu, xs, roots

    # (c) iallreduce at 256 MiB (thread path) overlapping bf16 products
    big = NORTH_STAR_ELEMS

    def overlap(comm):
        x = rank_input(comm.rank, big, HOST_SEED, comm.device)
        g = torch.Generator(device=comm.device).manual_seed(comm.rank)
        a = torch.randn(8192, 8192, device=comm.device, generator=g).to(torch.bfloat16)
        b = torch.randn(8192, 8192, device=comm.device, generator=g).to(torch.bfloat16)
        c = torch.empty_like(a)

        def timed(fn):
            comm.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            return out, max(comm.allgather(time.perf_counter() - t0))

        def products(k):
            for _ in range(k):
                torch.matmul(a, b, out=c)

        ref, t_comm = timed(lambda: comm.iallreduce(x).wait())
        timed(lambda: products(2))  # warm-up: the library's first calls
        _, t_cal = timed(lambda: products(8))
        k = max(1, round(t_comm / (t_cal / 8)))
        _, t_comp = timed(lambda: products(k))

        def both():
            req = comm.iallreduce(x)
            products(k)
            return req.wait()

        out, t_both = timed(both)
        return t_comm, t_comp, t_both, k, torch.equal(out, ref)

    names = ("nbc_threads_spawned", "nbc_state_machines")
    res, d = _pvar_deltas(mpit, names, lambda: mpi_tpu_torch.run(
        overlap, backend="local", nranks=n, progress="thread"))
    t_comm, t_comp, t_both, k, _ = res[0]
    if not all(r[4] for r in res):
        raise RuntimeError("host-nbc (c): the overlapped iallreduce differs from the alone one")
    if d["nbc_state_machines"] or d["nbc_threads_spawned"] != 2 * n:
        raise RuntimeError(f"host-nbc (c): 256 MiB must take the thread path: {d}")
    ov = (t_comm + t_comp - t_both) / min(t_comm, t_comp)
    info["overlap_256MiB"] = {"t_comm_s": t_comm, "t_comp_s": t_comp, "t_both_s": t_both,
                              "products_per_rank": k, "overlap": ov, "pvars": d}
    log(f"host-nbc (c) iallreduce 256 MiB x {n} with {k} bf16 [8192, 8192] products per "
        f"rank: t_comm {t_comm:.3f} s, t_comp {t_comp:.3f} s, t_both {t_both:.3f} s, "
        f"overlap {ov:.3f} [{card}]")

    # (d) allreduce_init at 1 MiB, 20 rounds refilled in place on the card
    def persistent(comm):
        x = torch.empty(numel, device=comm.device)
        h = comm.allreduce_init(x)
        same, secs = True, []
        for rd in range(20):
            x.copy_(rank_input(comm.rank, numel, HOST_SEED + rd, comm.device))
            comm.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = h.start().wait()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            same = same and torch.equal(got, comm.allreduce(x))
        isecs = []
        for rd in range(20):
            comm.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            comm.iallreduce(x).wait()
            torch.cuda.synchronize()
            isecs.append(time.perf_counter() - t0)
        return same, secs, isecs

    res, d = _pvar_deltas(mpit, ("persistent_starts", "nbc_threads_spawned"),
                          lambda: mpi_tpu_torch.run(persistent, backend="local",
                                                    nranks=n, progress="thread"))
    if not all(r[0] for r in res):
        raise RuntimeError("host-nbc (d): a persistent round differs from the blocking call")
    if d != {"persistent_starts": 20 * n, "nbc_threads_spawned": 0}:
        raise RuntimeError(f"host-nbc (d): pvars {d}")
    round_ms = statistics.median(max(r[1][i] for r in res) for i in range(20)) * 1e3
    i_ms = statistics.median(max(r[2][i] for r in res) for i in range(20)) * 1e3
    info["persistent_1MiB"] = {"ms_per_round": round_ms, "iallreduce_ms_per_call": i_ms,
                               "pvars": d}
    log(f"host-nbc (d) allreduce_init 1 MiB, 20 rounds refilled in place: {round_ms:.3f} ms "
        f"per round (median, slowest rank), iallreduce {i_ms:.3f} ms per call, pvars {d} "
        f"[{card}]")
    record["host_nbc"] = info
    torch.cuda.empty_cache()


FT_DETECT_S = 2.0
FT_HEARTBEAT_S = 0.2


def host_ft_local_phase(torch, record):
    """Phase 17: rank 5 of 8 local ranks on the card dies inside a 256 MiB
    ring allreduce; the survivors diagnose, revoke, shrink, agree, and the
    shrunk world's allreduce is checked against the CPU."""
    import mpi_tpu_torch
    from mpi_tpu_torch import mpit
    from mpi_tpu_torch.errors import ProcFailedError, RevokedError
    from mpi_tpu_torch.examples.host_allreduce import rank_input
    from mpi_tpu_torch.transport.faulty import FaultyTransport
    from mpi_tpu_torch.transport.local import KILLED

    card = card_line()
    n, dead, numel = P, 5, NORTH_STAR_ELEMS
    dev = torch.device("cuda", 0)
    xs = [rank_input(r, numel, HOST_SEED, dev) for r in range(n)]
    died = []
    # half-way through the reduce-scatter: its P-1 steps send a chunk each,
    # in segments of the local transport's 256 KiB
    segs = -(-(numel // n * 4) // (256 << 10))
    kill_after = max(2, (n - 1) * segs // 2)

    class Killer(FaultyTransport):
        def _die(self, why):
            if not self.killed:
                died.append(time.monotonic())
            super()._die(why)

    def prog(comm, xs):
        t0 = time.monotonic()
        try:
            comm.allreduce(xs[comm.rank], algorithm="ring")
            raise RuntimeError(f"rank {comm.rank}: completed impossibly")
        except ProcFailedError as e:
            t = time.monotonic()
            diag = (e.failed, e.collective, e.segment)
        # every survivor has its own diagnosis before anyone revokes: the
        # fault-tolerant agreement holds them together (the death acked)
        comm.failure_ack()
        comm.agree(True)
        comm.revoke()
        t1 = time.monotonic()
        new = comm.shrink()
        t2 = time.monotonic()
        agreed = new.agree(True)
        t3 = time.monotonic()
        out = new.allreduce(xs[comm.rank], algorithm="ring")
        torch.cuda.synchronize()
        return dict(diag=diag, detect_from_start_s=t - t0, detected_at=t,
                    shrink_ms=(t2 - t1) * 1e3, agree_ms=(t3 - t2) * 1e3, agreed=agreed,
                    size=new.size, epoch=comm.membership_epoch, out=out,
                    allreduce_s=time.monotonic() - t3)

    old = {k: mpit.cvar_read(k) for k in ("fault_detect_timeout_s",
                                          "fault_heartbeat_interval_s")}
    mpit.cvar_write("fault_detect_timeout_s", FT_DETECT_S)
    mpit.cvar_write("fault_heartbeat_interval_s", FT_HEARTBEAT_S)
    try:
        res = mpi_tpu_torch.run(
            prog, xs, backend="local", nranks=n, fault_tolerance=True,
            transport_wrapper=lambda t: Killer(t, kill_after_n=kill_after)
            if t.world_rank == dead else t)
    finally:
        for k, v in old.items():
            mpit.cvar_write(k, v)
    bound = 3 * FT_DETECT_S + 8.0
    if res[dead] is not KILLED or not died:
        raise RuntimeError(f"host-ft-local: rank {dead} did not die by injection")
    survivors = [r for r in range(n) if r != dead]
    detect = {}
    for r in survivors:
        s = res[r]
        if s["diag"][:2] != ((dead,), "allreduce") or s["diag"][2] is None:
            raise RuntimeError(f"host-ft-local rank {r}: diagnosis {s['diag']}")
        detect[r] = s["detected_at"] - died[0]
        if detect[r] > bound or s["size"] != n - 1 or s["epoch"] != 1 or not s["agreed"]:
            raise RuntimeError(f"host-ft-local rank {r}: detect {detect[r]:.2f} s "
                               f"(bound {bound}), size {s['size']}, epoch {s['epoch']}")
    outs = [res[r]["out"] for r in survivors]
    if not all(torch.equal(o, outs[0]) for o in outs):
        raise RuntimeError("host-ft-local: the shrunk allreduce differs across ranks")
    xs_cpu = [xs[r].cpu() for r in survivors]
    cpu = mpi_tpu_torch.run(lambda c, xs: c.allreduce(xs[c.rank], algorithm="ring"),
                            xs_cpu, backend="local", nranks=n - 1, device="cpu")
    if not all(torch.equal(outs[i].cpu(), cpu[i]) for i in range(n - 1)):
        raise RuntimeError("host-ft-local: the shrunk allreduce on the card differs from the CPU")
    info = {"card": card, "ranks": n, "dead": dead, "bound_s": bound,
            "detect_after_death_s": detect,
            "detect_from_allreduce_start_s": {r: res[r]["detect_from_start_s"]
                                              for r in survivors},
            "segments": {r: res[r]["diag"][2] for r in survivors},
            "shrink_ms": {r: res[r]["shrink_ms"] for r in survivors},
            "agree_ms": {r: res[r]["agree_ms"] for r in survivors},
            "shrunk_allreduce_s": max(res[r]["allreduce_s"] for r in survivors)}
    record["host_ft_local"] = info
    log(f"host-ft-local: rank {dead} killed in a 256 MiB ring allreduce on {n} ranks; "
        f"detection after the death {min(detect.values()):.2f}-{max(detect.values()):.2f} s "
        f"(bound {bound:.0f} s), segments {sorted(set(info['segments'].values()))}, shrink "
        f"{max(info['shrink_ms'].values()):.1f} ms, agree {max(info['agree_ms'].values()):.1f} "
        f"ms, shrunk 256 MiB ring {info['shrunk_allreduce_s']:.3f} s, bitwise across ranks "
        f"and vs the CPU [{card}]")
    del xs, res, outs, cpu
    torch.cuda.empty_cache()


def host_ft_socket_phase(torch, record):
    """Phase 18: 4 socket rank processes on the card with MPI_TPU_FT=1 and
    a progress engine each: a death, detection, revoke, shrink, and a fresh
    process's rejoin at 256 MiB per rank (``examples/host_ft.py``)."""
    from mpi_tpu_torch.examples import host_ft

    card = card_line()
    out_dir = os.path.abspath(os.path.join("chiprun_out", "host_ft"))
    res = host_ft.drive(out_dir, ranks=4, mib=NORTH_STAR_ELEMS * 4 >> 20, seed=HOST_SEED,
                        detect=FT_DETECT_S, heartbeat=FT_HEARTBEAT_S, timeout=300.0)
    recs = res["records"]
    if not all(recs[r]["device"].startswith("cuda") for r in (0, 2, 3)):
        raise RuntimeError(f"host-ft-socket ranks not on the card: {recs}")
    if recs[0]["outcome"] != "ProcFailedError" or recs[0]["failed"] != [host_ft.DEAD]:
        raise RuntimeError(f"host-ft-socket rank 0: {recs[0]}")
    if any(recs[r]["outcome"] != "RevokedError" for r in (2, 3)):
        raise RuntimeError(f"host-ft-socket ranks 2-3: {[recs[r] for r in (2, 3)]}")
    info = {"card": card, "ranks": 4, "wall_s": res["wall_s"],
            "exit_summary": res["exit_summary"], "records": recs}
    record["host_ft_socket"] = info
    for line in res["exit_summary"].splitlines():
        log(line)
    log(f"host-ft-socket: detection {', '.join(f'{recs[r]['detect_s']:.2f}' for r in (0, 2, 3))} s "
        f"(bound {recs[0]['bound_s']:.0f} s), shrink "
        f"{max(recs[r]['shrink_s'] for r in (0, 2, 3)) * 1e3:.1f} ms, agree "
        f"{max(recs[r]['agree_s'] for r in (0, 2, 3)) * 1e3:.1f} ms, accept_rejoin "
        f"{max(recs[r]['accept_rejoin_s'] for r in (0, 2, 3)):.2f} s, joiner's rejoin "
        f"{recs['joiner']['rejoin_wait_s']:.2f} s after its start, 256 MiB ring: shrunk "
        f"{max(recs[r]['shrunk_allreduce_s'] for r in (0, 2, 3)):.3f} s, full "
        f"{recs['joiner']['full_allreduce_s']:.3f} s; bitwise across ranks, float64 error "
        f"{recs['joiner']['full_err_vs_f64']:.3g}; {res['wall_s']:.1f} s wall [{card}]")


VERIFY_STALL_S = 1.0            # verify_stall_timeout_s of phases 19b-c and 20


def _ring_program(torch, reps):
    """A rank program: 1 warm-up and ``reps`` timed 256 MiB ring allreduces
    (a barrier and a synchronize before each, a synchronize before the
    clock stops)."""
    return _timed_program(torch, lambda c, xs: c.allreduce(xs[c.rank], algorithm="ring"),
                          reps)


def _seeded_bug(mpi_tpu_torch, prog, n, **kw):
    """Run ``prog`` on ``n`` verified local ranks on the card; each rank
    returns what it caught.  Returns (results, seconds, report)."""
    import gc

    from mpi_tpu_torch import verify

    verify.finalize_report()
    t0 = time.perf_counter()
    res = mpi_tpu_torch.run(prog, backend="local", nranks=n, verify=True, **kw)
    secs = time.perf_counter() - t0
    report = verify.finalize_report()
    gc.collect()
    return res, secs, report + verify.take_report()


def host_verify_local_phase(torch, record):
    """Phase 19: the runtime verifier and the flight recorder on 8 local
    rank threads on the card — the off-mode contract at 256 MiB and 1 KiB,
    the seeded bugs, and device work that must not read as a deadlock."""
    import mpi_tpu_torch
    from mpi_tpu_torch import mpit, telemetry
    from mpi_tpu_torch.errors import (BufferPinnedError, CollectiveMismatchError,
                                      DeadlockError)
    from mpi_tpu_torch.examples.host_allreduce import rank_input
    from mpi_tpu_torch.examples.host_verify import busy_products

    dev = torch.device("cuda", 0)
    card = card_line()
    n, numel = P, NORTH_STAR_ELEMS
    info = {"card": card, "ranks": n}
    events = [v for v in mpit.pvar_list() if v.startswith("verify_")] + ["trace_events"]
    wire = ["bytes_pickled_sent", "payload_copies"]
    ways = {"off": {}, "verify": {"verify": True}, "trace": {"trace": True}}

    # (a) the off-mode contract, at the north-star size and at 1 KiB
    def latency_program(comm, xs):
        """1 warm-up call, then 200 timed allreduces of 1 KiB by the
        default algorithm (``BASELINE.json``'s latency config)."""
        comm.allreduce(xs[comm.rank])
        comm.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            out = comm.allreduce(xs[comm.rank])
        torch.cuda.synchronize()
        return out, [time.perf_counter() - t0]

    for label, count, prog in (("256MiB", numel, _ring_program(torch, VERIFY_RING_REPS)),
                               ("1KiB", 256, latency_program)):
        xs = [rank_input(r, count, HOST_SEED, dev) for r in range(n)]
        got = {}
        for way, kw in ways.items():
            (outs, deltas) = _pvar_deltas(mpit, events + wire, lambda: mpi_tpu_torch.run(
                prog, xs, backend="local", nranks=n, **kw))
            telemetry.disable()
            secs = [max(ts[i] for _, ts in outs) for i in range(len(outs[0][1]))]
            got[way] = {"s": secs, "ms": statistics.median(secs) * 1e3,
                        "pvars": deltas, "out": outs[0][0]}
            if not all(torch.equal(o, outs[0][0]) for o, _ in outs):
                raise RuntimeError(f"host-verify {label} {way}: ranks differ")
        if any(got["off"]["pvars"][v] for v in events):
            raise RuntimeError(f"host-verify {label}: events with everything off: "
                               f"{got['off']['pvars']}")
        if any(g["pvars"]["bytes_pickled_sent"] for g in got.values()) or len(
                {g["pvars"]["payload_copies"] for g in got.values()}) != 1:
            raise RuntimeError(f"host-verify {label}: wire accounting moved: "
                               f"{ {w: g['pvars'] for w, g in got.items()} }")
        if not all(torch.equal(g["out"], got["off"]["out"]) for g in got.values()):
            raise RuntimeError(f"host-verify {label}: results differ between the ways")
        per_call = 200 if label == "1KiB" else 1
        entry = {w: {"s": g["s"], "ms_per_call": g["ms"] / per_call,
                     "pvars": {k: v for k, v in g["pvars"].items() if v}}
                 for w, g in got.items()}
        entry["verify_overhead"] = got["verify"]["ms"] / got["off"]["ms"]
        entry["trace_overhead"] = got["trace"]["ms"] / got["off"]["ms"]
        info[f"ring_{label}"] = entry
        log(f"host-verify-local allreduce {label} x {n} ranks, ms per call: off "
            f"{entry['off']['ms_per_call']:.3f}, verify {entry['verify']['ms_per_call']:.3f} "
            f"(x{entry['verify_overhead']:.3f}), trace {entry['trace']['ms_per_call']:.3f} "
            f"(x{entry['trace_overhead']:.3f}); off: every verify_* and trace_events 0; "
            f"0 pickled bytes and {got['off']['pvars']['payload_copies']} payload copies in all "
            f"three, results bitwise equal [{card}]")
        del xs, got
    torch.cuda.empty_cache()

    # (b) the seeded bugs, each caught on every implicated rank
    old_stall = mpit.cvar_read("verify_stall_timeout_s")
    mpit.cvar_write("verify_stall_timeout_s", VERIFY_STALL_S)
    bugs = {}
    try:
        def cycle(comm):
            try:
                comm.recv(source=1 - comm.rank, tag=7)  # mpilint: ok (the bug)
            except DeadlockError as e:
                return type(e).__name__, e.ranks, str(e)
            return "completed", (), ""

        def exited(comm):
            if comm.rank == 1:
                return "exited", (), ""
            return cycle(comm)

        big = [torch.full((numel,), 1.0, device=dev) for _ in range(n)]

        def order(comm):
            try:
                if comm.rank == 0:
                    comm.bcast(big[0], root=0)  # mpilint: ok (the bug)
                else:
                    comm.allreduce(big[comm.rank])  # mpilint: ok
            except CollectiveMismatchError as e:
                return type(e).__name__, e.ranks, str(e)
            return "completed", (), ""

        def geometry(comm):
            x = torch.ones(1 << 20, device=dev,
                           dtype=torch.float32 if comm.rank == 0 else torch.bfloat16)
            try:
                comm.allreduce(x)
            except CollectiveMismatchError as e:
                return type(e).__name__, e.ranks, str(e)
            return "completed", (), ""

        def race(ordered):
            def prog(comm):
                if comm.rank == 0:
                    if not ordered:
                        while not (comm.iprobe(source=1, tag=7)
                                   and comm.iprobe(source=2, tag=7)):
                            time.sleep(0.001)
                    got = sorted(float(comm.recv(source=-1, tag=7)[0])  # mpilint: ok
                                 for _ in range(2))
                    return "received", (), str(got)
                if ordered and comm.rank == 2:
                    comm.recv(source=1, tag=1)  # happens-before edge
                comm.send(torch.full((4,), float(comm.rank), device=dev), 0, tag=7)
                if ordered and comm.rank == 1:
                    comm.send(None, 2, tag=1)
                return "sent", (), ""
            return prog

        def lints(comm):
            buf = torch.zeros(1 << 20, device=dev)
            peer = 1 - comm.rank
            comm.irecv(source=peer, tag=3)  # mpilint: ok (leaked, the bug)
            r1 = comm.irecv(source=peer, tag=4, buf=buf[0:1 << 19])
            r2 = comm.irecv(source=peer, tag=4, buf=buf[1 << 18:3 << 18])
            comm.send(torch.ones(1 << 19, device=dev), peer, tag=4)
            comm.send(torch.ones(1 << 19, device=dev), peer, tag=4)
            r1.wait()
            r2.wait()
            return "completed", (), ""

        def pinned(comm):
            h = comm.allreduce_init(torch.ones(1 << 16, device=dev))  # engine path
            r0 = h.start().wait()  # round 0 result, held
            h.start().wait()
            try:
                h.start().wait()
            except BufferPinnedError as e:
                return type(e).__name__, (comm.rank,), f"{str(e)[:60]} r0[0]={float(r0[0])}"
            return "missed", (), ""

        cases = [("recv cycle", cycle, 2, {}, "DeadlockError", [0, 1]),
                 ("wait on an exited rank", exited, 2, {}, "DeadlockError", [0, 1]),
                 ("allreduce vs bcast 256 MiB", order, n, {}, "CollectiveMismatchError",
                  [0, 1]),
                 ("float32 vs bfloat16 geometry", geometry, 2, {},
                  "CollectiveMismatchError", [0, 1]),
                 ("concurrent wildcard senders", race(False), 3, {}, None, None),
                 ("ordered wildcard senders", race(True), 3, {}, None, None),
                 ("leaked irecv, overlapping irecv(buf=)", lints, 2, {}, None, None),
                 ("allreduce_init result pinned", pinned, 2, {"progress": "thread"},
                  "BufferPinnedError", None)]
        for name, prog, nr, kw, cls, ranks in cases:
            base_sent = mpit.pvar_read("bytes_sent")
            res, secs, report = _seeded_bug(mpi_tpu_torch, prog, nr, **kw)
            sent = mpit.pvar_read("bytes_sent") - base_sent
            kinds = sorted({ln.split(":")[0].split(" (")[0] for ln in report})
            races = [ln for ln in report if "wildcard race" in ln]
            entry = {"s": secs, "ranks": nr, "outcomes": [r[0] for r in res],
                     "report_kinds": kinds, "bytes_sent": sent}
            if cls is not None:
                implicated = [r for r in range(nr) if res[r][0] != "exited"]
                if any(res[r][0] != cls for r in implicated):
                    raise RuntimeError(f"host-verify {name}: {[r[0] for r in res]}")
                if ranks is not None and any(sorted(res[r][1]) != ranks
                                             for r in implicated):
                    raise RuntimeError(f"host-verify {name}: ranks {[r[1] for r in res]}")
                entry["message"] = res[implicated[0]][2]
                if cls != "BufferPinnedError" and "chip_smoke.py" not in entry["message"]:
                    raise RuntimeError(f"host-verify {name}: no call site: {entry['message']}")
            if name.startswith("allreduce vs bcast") and sent >= numel * 4 // 16:
                raise RuntimeError(f"host-verify {name}: {sent} bytes moved before the "
                                   f"mismatch was raised")
            if name == "concurrent wildcard senders" and (
                    len(races) != 1 or "rank 1" not in races[0]
                    or "rank 2" not in races[0]):
                raise RuntimeError(f"host-verify {name}: {report}")
            if name == "ordered wildcard senders" and races:
                raise RuntimeError(f"host-verify {name}: a race on ordered senders: {races}")
            if name.startswith("leaked") and (
                    sum("leaked request" in ln for ln in report) != 2
                    or sum("overlapping live buffers" in ln and f"on {dev}" in ln
                           for ln in report) != 2):
                raise RuntimeError(f"host-verify {name}: {report}")
            if secs >= 20.0:
                raise RuntimeError(f"host-verify {name}: diagnosed after {secs:.1f} s")
            bugs[name] = entry
            log(f"host-verify-local {name}: {[r[0] for r in res]} in {secs:.2f} s; report "
                f"{kinds}; bytes_sent {sent} [{card}]")
        del big
        info["seeded_bugs"] = bugs

        # (c) no false positive from device work
        small = (16 << 20) // 4
        xs = [torch.full((small,), float(r + 1), device=dev) for r in range(n)]

        def products_first(comm):
            spent = busy_products(dev, 3.5 * VERIFY_STALL_S) if comm.rank == 0 else None
            return comm.allreduce(xs[comm.rank], algorithm="ring"), spent

        (res, deltas) = _pvar_deltas(mpit, events, lambda: mpi_tpu_torch.run(
            products_first, backend="local", nranks=n, verify=True))
    finally:
        mpit.cvar_write("verify_stall_timeout_s", old_stall)
    want = float(n * (n + 1) // 2)
    products, spent = res[0][1]
    if spent <= 3 * VERIFY_STALL_S or any(
            not torch.equal(o, torch.full_like(o, want)) for o, _ in res) or any(
            deltas[v] for v in events if v != "verify_clock_bytes"):
        raise RuntimeError(f"host-verify products first: {spent} s, {deltas}")
    info["products_first"] = {"products": products, "products_s": spent,
                              "allreduce_bytes_per_rank": small * 4}
    log(f"host-verify-local: rank 0's {products} bf16 [8192, 8192] products "
        f"({spent:.2f} s > 3 x {VERIFY_STALL_S} s) before a 16 MiB ring its peers wait in: "
        f"completed with the right sum, verify_deadlocks_detected 0 [{card}]")
    record["host_verify_local"] = info
    del xs
    torch.cuda.empty_cache()


def host_verify_socket_phase(torch, record):
    """Phase 20: 4 socket rank processes on the card under ``--verify``
    (``examples/host_verify.py``)."""
    card = card_line()
    out_dir = os.path.abspath(os.path.join("chiprun_out", "host_verify"))
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "mpi_tpu_torch.launcher", "-n", "4", "--verify",
         "--timeout", "300", os.path.join("mpi_tpu_torch", "examples", "host_verify.py"),
         "--out", out_dir, "--mib", str(NORTH_STAR_ELEMS * 4 >> 20), "--small-mib", "16",
         "--stall", str(VERIFY_STALL_S), "--seed", str(HOST_SEED)],
        cwd=root, capture_output=True, text=True, timeout=360)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f"host-verify-socket ranks failed (rc {res.returncode}):\n"
                           f"{res.stdout[-3000:]}\n{res.stderr[-6000:]}")
    recs = []
    for r in range(4):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            recs.append(json.load(f))
    if not all(d["device"].startswith("cuda") for d in recs):
        raise RuntimeError(f"host-verify-socket ranks not on the card: {recs}")
    info = {"card": card, "ranks": 4, "launcher_wall_s": wall, "records": recs}
    record["host_verify_socket"] = info
    clean = [d["clean_ring"] for d in recs]
    log(f"host-verify-socket 256 MiB ring under --verify: "
        f"{max(c['s'] for c in clean) * 1e3:.1f} ms, pickled bytes "
        f"{[c['wire']['bytes_pickled_sent'] for c in clean]} (1 KiB ring: "
        f"{[c['wire_1KiB']['bytes_pickled_sent'] for c in clean]}), float64 error "
        f"{clean[0]['max_abs_err_vs_f64']:.3g}; race named: {recs[0]['wildcard_race']['line'][:90]}; "
        f"rank 0's products {recs[0]['products_s']:.2f} s then a 16 MiB ring: no deadlock; "
        f"receive cycle diagnosed on ranks {[d['deadlock']['ranks'] == [0, 1, 2, 3] for d in recs]} "
        f"in {', '.join(f'{d['deadlock']['s']:.2f}' for d in recs)} s; {wall:.1f} s wall [{card}]")


def host_trace_phase(torch, record):
    """Phase 21: 4 socket rank processes on the card under ``--trace-dir``
    (``examples/host_trace.py``), their traces merged by the port's
    ``tracecat``."""
    from mpi_tpu_torch.tools import tracecat

    card = card_line()
    base = os.path.abspath(os.path.join("chiprun_out", "host_trace"))
    traces = os.path.join(base, "traces")
    for d in (base, traces):
        if os.path.isdir(d):
            for f in os.listdir(d):
                if os.path.isfile(os.path.join(d, f)):
                    os.remove(os.path.join(d, f))
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "mpi_tpu_torch.launcher", "-n", "4", "--trace-dir", traces,
         "--timeout", "300", os.path.join("mpi_tpu_torch", "examples", "host_trace.py"),
         "--out", base, "--mib", str(NORTH_STAR_ELEMS * 4 >> 20), "--small-mib", "1",
         "--seed", str(HOST_SEED)],
        cwd=root, capture_output=True, text=True, timeout=360)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f"host-trace ranks failed (rc {res.returncode}):\n"
                           f"{res.stdout[-3000:]}\n{res.stderr[-6000:]}")
    recs = []
    for r in range(4):
        with open(os.path.join(base, f"rank{r}.json")) as f:
            recs.append(json.load(f))
    docs = tracecat.load_traces([traces])
    if sorted(d["mpi_tpu"]["rank"] for d in docs) != [0, 1, 2, 3]:
        raise RuntimeError(f"host-trace: traces of ranks {[d['mpi_tpu']['rank'] for d in docs]}")
    offsets = tracecat.estimate_offsets(docs)
    negative = tracecat.negative_latency_frames(docs, offsets)
    spans = [e for d in docs for e in d["traceEvents"]
             if e.get("cat") == "coll" and e["name"] == "allreduce"]
    if negative or len(spans) != 4 or any(
            e["args"] != {"algorithm": "ring", "nbytes": NORTH_STAR_ELEMS * 4} for e in spans):
        raise RuntimeError(f"host-trace: {negative} negative-latency frames, allreduce "
                           f"spans {[e['args'] for e in spans]}")
    merged = tracecat.merge(tracecat.load_traces([traces]))
    info = {"card": card, "ranks": 4, "launcher_wall_s": wall, "offsets_us": offsets,
            "negative_latency_frames": negative,
            "merged_events": len(merged["traceEvents"]), "records": recs}
    record["host_trace"] = info
    for d in recs:
        small = ", ".join(f"{k} {v['span_ms']:.2f}/{v['wall_sync_ms']:.2f}"
                          for k, v in d["small"]["calls"].items())
        log(f"host-trace rank {d['rank']}: 256 MiB ring span {d['allreduce']['span_ms']:.1f} ms "
            f"(wall with synchronize {d['allreduce']['wall_sync_ms']:.1f} ms); 1 MiB span/wall "
            f"ms: {small}; coll_latency_s p50 {d['coll_latency_s']['p50'] * 1e3:.3f} ms p99 "
            f"{d['coll_latency_s']['p99'] * 1e3:.3f} ms; {d['events']} events, {d['dropped']} "
            f"dropped; comm_stats ops {d['comm_stats']['ops']} [{card}]")
    log(f"host-trace: 4 traces merged ({len(merged['traceEvents'])} events), offsets "
        f"{ {k: round(v, 1) for k, v in offsets.items()} } us, 0 negative-latency frames, "
        f"every allreduce span ring with {NORTH_STAR_ELEMS * 4} bytes; {wall:.1f} s wall [{card}]")


# -- 22-23. the same-host data plane and its dispatch ----------------------------

COMPRESS_ELEMS = (64 << 20) // 4    # phase 22a: 64 MiB of float32 per rank
TOPK_STEPS = 5


def _distinct_magnitudes(torch, rank, numel, device):
    """A rank's input whose magnitudes are all distinct (a unique top-k set
    on the card and on the CPU): a seeded permutation of 1..numel over 8,
    with seeded signs, rank-varying."""
    gen = torch.Generator(device=device).manual_seed(HOST_SEED * 1_000_003 + rank)
    mags = (torch.randperm(numel, generator=gen, device=device) + 1).to(torch.float32) / 8.0
    signs = torch.where(torch.rand(numel, generator=gen, device=device) < 0.5, -1.0, 1.0)
    return mags * signs


def _int8_ties(torch, n, gen):
    """``n`` float32 inputs whose int8 encode puts every entry but the last
    (the max-abs, 127 * 3.3) on a rounding tie.  The scale is 3.3 in
    float32, whose reciprocal is inexact, so ``x * (1 / scale)`` (what a
    CUDA divide by a CPU scalar computes) and ``x / scale`` round apart at
    some ties; each ``x = (k + 0.5) * scale`` is kept only where
    ``float32(x / scale)`` is exactly ``k + 0.5``."""
    amax = torch.tensor([127 * 3.3], dtype=torch.float32)
    scale = torch.tensor([float(amax) / 127.0], dtype=torch.float32)
    parts, have = [], 0
    while have < n - 1:
        k = torch.randint(-126, 126, (n,), generator=gen).to(torch.float32) + 0.5
        x = k * scale
        parts.append(x[x / scale == k])
        have += parts[-1].numel()
    return torch.cat([torch.cat(parts)[:n - 1], amax])


def host_compress_tune_phase(torch, record):
    """Phase 22: compressed collectives on 8 local rank threads on the card
    against the CPU and a float64 sum, top-k error feedback, the int8
    encode's rounding ties card against CPU, and a tuned-dispatch sweep
    whose table then serves ``run(..., tuning_table=)``."""
    import mpi_tpu_torch
    from mpi_tpu_torch import compress, mpit, tuning
    from mpi_tpu_torch.examples.host_allreduce import rank_input
    from mpi_tpu_torch.tools import tune

    dev = torch.device("cuda", 0)
    card = card_line()
    n, numel = P, COMPRESS_ELEMS
    info = {"card": card, "ranks": n, "bytes_per_rank": numel * 4}
    xs = [rank_input(r, numel, HOST_SEED + 22, dev) for r in range(n)]
    tops = [_distinct_magnitudes(torch, r, numel, dev) for r in range(n)]
    x64 = [x.double() for x in xs]
    want = sum(x64)
    absmax = [float(x.abs().max()) for x in xs]
    # the reference tests' bounds (tests/test_compress.py): one bf16
    # rounding per ring hop; one int8 step of the partial sums' max-abs
    prefix_amax = max(float(sum(x64[:i + 1]).abs().max()) for i in range(n))
    bounds = {"bf16": (n + 1) * 2.0 ** -8 * float(want.abs().max()),
              "int8": (n + 1) * prefix_amax / 127.0}
    rs_bounds = {"bf16": (n + 1) * 2.0 ** -8 * sum(absmax),
                 "int8": (n + 1) * sum(absmax) / 127.0}
    legs = {
        "allreduce compressed:bf16": (lambda c, v: c.allreduce(
            v[c.rank], algorithm="compressed:bf16"), xs),
        "allreduce compressed:int8": (lambda c, v: c.allreduce(
            v[c.rank], algorithm="compressed:int8"), xs),
        "allreduce compressed:topk": (lambda c, v: c.allreduce(
            v[c.rank], algorithm="compressed:topk"), tops),
        "reduce_scatter compressed:bf16": (lambda c, v: c.reduce_scatter(
            v[c.rank].view(n, -1), algorithm="compressed:bf16"), xs),
        "reduce_scatter compressed:int8": (lambda c, v: c.reduce_scatter(
            v[c.rank].view(n, -1), algorithm="compressed:int8"), xs),
    }

    def timed_once(call):
        def prog(comm, v):
            comm.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = call(comm, v)
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0
        return prog

    saved = mpit.pvar_read("bytes_compressed_saved")
    for name, (call, inputs) in legs.items():
        outs = mpi_tpu_torch.run(timed_once(call), inputs, backend="local", nranks=n)
        got = [o for o, _ in outs]
        secs = max(s for _, s in outs)
        cpu_in = [v.cpu() for v in inputs]
        t_cpu = time.perf_counter()
        threads = torch.get_num_threads()
        torch.set_num_threads(1)  # 8 rank threads: one core each, no oversubscription
        try:
            cpu = mpi_tpu_torch.run(lambda c, v: call(c, v), cpu_in, backend="local",
                                    nranks=n, device="cpu")
        finally:
            torch.set_num_threads(threads)
        cpu_s = time.perf_counter() - t_cpu
        if not all(torch.equal(got[r].cpu(), cpu[r]) for r in range(n)):
            raise RuntimeError(f"host-compress {name}: the card differs from the CPU")
        kind = name.split(":")[1]
        # the reference's compressed ring leaves each chunk's owner with its
        # float32 fold and its peers with the wire encoding of it (bf16
        # results agree across ranks once rounded to bf16), and top-k folds
        # the pairs in ring-hop order from each rank's own, so ranks differ
        # where three or more contributions round; every rank is held
        # bitwise against the CPU above
        if name.startswith("allreduce"):
            spread = max(float((g - got[0]).abs().max()) for g in got)
            if kind == "bf16" and not all(torch.equal(g.to(torch.bfloat16),
                                                      got[0].to(torch.bfloat16))
                                          for g in got):
                raise RuntimeError(f"host-compress {name}: ranks differ beyond the wire")
        else:
            spread = 0.0
        if name.startswith("allreduce") and kind != "topk":
            err = float((got[0].double() - want).abs().max())
            ok = err <= bounds[kind]
            bound = bounds[kind]
        elif kind == "topk":
            # the reference test's bound: every sent entry is exact, the
            # rest is the unsent mass
            top64 = [t.double() for t in tops]
            diff = (got[0].double() - sum(top64)).abs()
            slack = sum(t.abs() for t in top64)
            ok = bool((diff <= slack * (1 + 1e-6) + 1e-6).all())
            del top64, diff, slack
            # and the output is the sum of each rank's k largest magnitudes
            # (unique: the magnitudes are distinct), picked here by a full
            # sort: zero where no rank sent, the sent value itself where one
            # rank did, within a float32 fold of <= P terms elsewhere
            k = compress.topk_k(numel)
            senders = torch.zeros(numel, dtype=torch.int32, device=dev)
            sent = torch.zeros(numel, dtype=torch.float64, device=dev)
            mass = torch.zeros_like(sent)
            for t in tops:
                idx = torch.sort(t.abs(), descending=True, stable=True).indices[:k]
                senders[idx] += 1
                sent[idx] += t[idx].double()
                mass[idx] += t[idx].abs().double()
            fold = n * 2.0 ** -24 * mass
            none, one = senders == 0, senders == 1
            err = 0.0
            for g in got:
                d = (g.double() - sent).abs()
                ok = ok and bool((g[none] == 0).all()) and torch.equal(
                    g[one].double(), sent[one]) and bool((d <= fold).all())
                err = max(err, float(d.max()))
            bound = float(fold.max())
            info["topk_senders"] = {"k": k, "entries_sent_by_one": int(one.sum()),
                                    "by_several": int((senders > 1).sum())}
            del senders, sent, mass, fold, none, one, d
        else:
            err = max(float((got[r].double() - want.view(n, -1)[r]).abs().max())
                      for r in range(n))
            ok = err <= rs_bounds[kind]
            bound = rs_bounds[kind]
        if not ok:
            raise RuntimeError(f"host-compress {name}: error {err} beyond {bound}")
        info[name] = {"ms": secs * 1e3, "cpu_ms": cpu_s * 1e3, "max_abs_err_vs_f64": err,
                      "bound": bound, "cross_rank_max_diff": spread}
        log(f"host-compress {name}: {secs * 1e3:.1f} ms per call (the CPU's "
            f"{cpu_s * 1e3:.1f} ms), error vs float64 "
            f"{err:.4g} (bound {bound:.4g}), largest difference between ranks {spread:.4g}; "
            f"every rank bitwise equal to the CPU [{card}]")
        del outs, got, cpu, cpu_in
    info["bytes_compressed_saved"] = mpit.pvar_read("bytes_compressed_saved") - saved
    log(f"host-compress: bytes_compressed_saved {info['bytes_compressed_saved']}")

    # declines: a non-float payload and a MAX top-k request (a float64
    # payload does not decline in either package: it folds in float64)
    def declines(comm):
        a = comm.allreduce(torch.arange(8, device=comm.device) * (comm.rank + 1),
                           algorithm="compressed")
        b = comm.allreduce(torch.full((8,), float(comm.rank), device=comm.device),
                           mpi_tpu_torch.ops.MAX, algorithm="compressed:topk")
        return a, b

    f0 = mpit.pvar_read("compress_fallbacks")
    outs = mpi_tpu_torch.run(declines, backend="local", nranks=n)
    fb = mpit.pvar_read("compress_fallbacks") - f0
    if fb != 2 * n or not all(
            torch.equal(a, torch.arange(8, device=dev) * (n * (n + 1) // 2))
            and torch.equal(b, torch.full((8,), n - 1.0, device=dev)) for a, b in outs):
        raise RuntimeError(f"host-compress declines: {fb} fallbacks, {outs[0]}")
    info["compress_fallbacks"] = fb
    log(f"host-compress: an int64 payload and a MAX top-k request declined on every rank "
        f"(compress_fallbacks {fb}) and reduced exactly")

    # (b) top-k error feedback: cumulative outputs + the ranks' residuals
    # equal the cumulative inputs
    def feedback(comm, v):
        outs = []
        for _ in range(TOPK_STEPS):
            outs.append(comm.allreduce(v[comm.rank], algorithm="compressed:topk"))
            res = next(iter(comm.__dict__["_compress_residuals"].values()))
            outs.append(res.clone())
        return outs

    t0 = time.perf_counter()
    steps = mpi_tpu_torch.run(feedback, tops, backend="local", nranks=n)
    fb_s = time.perf_counter() - t0
    total_in = sum(t.double() for t in tops)
    cum = torch.zeros_like(total_in)
    worst = 0.0
    for s in range(TOPK_STEPS):
        cum += steps[0][2 * s].double()
        resid = sum(steps[r][2 * s + 1].double() for r in range(n))
        lhs, rhs = cum + resid, total_in * (s + 1)
        rel = float(((lhs - rhs).abs() / rhs.abs().max()).max())
        worst = max(worst, rel)
        if not torch.allclose(lhs, rhs, rtol=1e-6, atol=1e-6 * float(rhs.abs().max())):
            raise RuntimeError(f"top-k step {s}: outputs + residuals off the inputs by {rel}")
    info["topk_feedback"] = {"steps": TOPK_STEPS, "worst_rel_err": worst,
                             "ms_per_step": fb_s * 1e3 / TOPK_STEPS}
    log(f"host-compress top-k error feedback, {TOPK_STEPS} steps: cumulative output + "
        f"residuals = cumulative inputs within {worst:.3g} relative "
        f"({fb_s * 1e3 / TOPK_STEPS:.1f} ms per step) [{card}]")
    del steps, tops, total_in, cum, xs, x64, want

    # (c) the int8 encode on the card against the CPU, rounding ties included
    ne = (16 << 20) // 4
    gen = torch.Generator(device="cpu").manual_seed(HOST_SEED + 23)
    cases = {"ties": _int8_ties(torch, ne, gen),
             "random": torch.randn(ne, generator=gen) * 3.0,
             "non_finite": torch.tensor([1.0, float("inf"), float("nan"), -2.0])}
    info["int8_encode"] = {}
    for cname, x in cases.items():
        t_cpu = compress.INT8.encode_segs(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t_card = compress.INT8.encode_segs(x.to(dev))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        same = all(a.dtype == b.dtype and torch.equal(
            a.cpu().view(torch.uint8), b.view(torch.uint8))
            for a, b in zip(t_card, t_cpu))
        if not same:
            raise RuntimeError(f"int8 encode of {cname}: the card differs from the CPU")
        n_ties, caught = 0, None
        if cname == "ties":
            n_ties = int(((x / t_cpu[0]) % 1.0 == 0.5).sum())
            # the leg sees the fault it is there for: the same encode that
            # divides by the scale as a Python float differs on the card
            wrong = torch.round(x.to(dev) / float(t_cpu[0][0])).clamp_(-127, 127)
            caught = int((wrong.to(torch.int8).cpu() != t_cpu[1]).sum())
            if n_ties != x.numel() - 1 or caught == 0:
                raise RuntimeError(f"int8 ties: {n_ties} ties of {x.numel()}, a divide by "
                                   f"a Python float differs at {caught}")
        info["int8_encode"][cname] = {"elems": x.numel(), "ms": ms, "ties": n_ties,
                                      "scale": float(t_cpu[0][0]),
                                      "python_float_divide_mismatches": caught}
        log(f"host-compress int8 encode {cname} ({x.numel()} elements, {n_ties} rounding "
            f"ties): the card's bytes equal the CPU's, {ms:.2f} ms"
            + (f"; dividing by the scale as a Python float would differ at {caught}"
               if caught is not None else "") + f" [{card}]")

    # (d) a tuning sweep, then the table serving run(..., tuning_table=)
    table = os.path.abspath(os.path.join("chiprun_out", "tuning", "table.json"))
    t0 = time.perf_counter()
    if tune.main(["--transports", "local,shm", "--ranks", "2,3,4", "--sizes",
                  "1024,65536,1048576", "--iters", "3", "--out", table]) != 0:
        raise RuntimeError("tune sweep failed")
    sweep_s = time.perf_counter() - t0
    with open(table) as f:
        doc = json.load(f)
    parts = doc["generated"]["parts_s"]
    shm = parts["shm"]
    log(f"host-tune sweep parts: local leg (rank threads) " + ", ".join(
        f"{p} ranks {s:.3f} s" for p, s in parts["local"].items()) + f" [{card}]")
    log(f"host-tune sweep parts: shm world (one launched process that imports torch while "
        f"the local leg runs, then forks the 4 ranks) launch to imports {shm['imports']:.3f} "
        f"s, let go at {shm['go']:.3f} s; per rank fork / CUDA context / init() " + ", ".join(
            f"{r['fork']:.3f} / {r['cuda']:.3f} / {r['init']:.3f}" for r in shm["ranks"])
        + " s; bands " + ", ".join(f"{p} ranks {s:.3f} s" for p, s in shm["bands"].items())
        + f"; teardown {shm['teardown']:.3f} s [{card}]")
    if sweep_s > 20.0:
        raise RuntimeError(f"tune sweep took {sweep_s:.1f} s (over 20 s)")
    if tune.main(["--check", table]) != 0:
        raise RuntimeError("tune --check refused the table")

    def served(comm, v):
        return [comm.allreduce(v[comm.rank][:k]) for k in (256, 16384, 262144)]

    ins = [rank_input(r, 262144, HOST_SEED + 24, dev) for r in range(4)]
    h0 = mpit.pvar_read("tuned_table_hits")
    tuned = mpi_tpu_torch.run(served, ins, backend="local", nranks=4, tuning_table=table)
    hits = mpit.pvar_read("tuned_table_hits") - h0
    last = tuning.last_decision()
    seed = mpi_tpu_torch.run(served, ins, backend="local", nranks=4)
    row = [r for r in doc["rows"] if r["transport"] == "local" and r["nranks"] == 4
           and r["collective"] == "allreduce" and r["lo_bytes"] <= last["nbytes"]
           and (r["hi_bytes"] is None or last["nbytes"] < r["hi_bytes"])]
    if hits <= 0 or not last or not last["source"].startswith("table") or \
            not row or row[0]["algorithm"] != last["algorithm"]:
        raise RuntimeError(f"tuned dispatch: hits {hits}, last {last}, row {row}")
    if not all(torch.allclose(a, b, rtol=1e-5, atol=1e-5)
               for t, s in zip(tuned, seed) for a, b in zip(t, s)):
        raise RuntimeError("tuned dispatch disagrees with the seed policy")
    info["tune"] = {"sweep_s": sweep_s, "parts_s": parts, "rows": len(doc["rows"]),
                    "trusted": sum(r["trusted"] for r in doc["rows"]),
                    "tuned_table_hits": hits, "last_decision": last,
                    "picked": sorted({(r["collective"], r["algorithm"]) for r in doc["rows"]})}
    record["host_compress_tune"] = info
    log(f"host-tune: sweep of local (rank threads) and shm (one launched world of 4 rank "
        f"processes, 2 and 3 on its splits), 3 bands in {sweep_s:.1f} s "
        f"({len(doc['rows'])} rows, {info['tune']['trusted']} trusted), --check OK; "
        f"run(tuning_table=) served {hits} decisions (last: {last['algorithm']} from "
        f"{last['source']}), within rtol 1e-5 of the seed policy [{card}]")


def host_shm_phase(torch, record):
    """Phase 23: 4 shm rank processes on the card through the launcher
    (``examples/host_shm.py``, with its steered receive of a 256 MiB card
    tensor), then the same example under --verify; no segment of either
    world left in /dev/shm."""
    from mpi_tpu_torch.transport.shm import shm_prefix

    card = card_line()
    root = os.path.dirname(os.path.abspath(__file__))
    info = {"card": card, "ranks": 4}
    for tag, extra, mib, iters in (("plain", [], NORTH_STAR_ELEMS * 4 >> 20, 2),
                                   ("verify", ["--verify"], 64, 1)):
        out_dir = os.path.abspath(os.path.join("chiprun_out", f"host_shm_{tag}"))
        if os.path.isdir(out_dir):
            for f in os.listdir(out_dir):
                os.remove(os.path.join(out_dir, f))
        t0 = time.perf_counter()
        t0_wall = time.time()
        res = subprocess.run(
            [sys.executable, "-m", "mpi_tpu_torch.launcher", "-n", "4", "--backend", "shm",
             "--timeout", "300", *extra, os.path.join("mpi_tpu_torch", "examples", "host_shm.py"),
             "--out", out_dir, "--mib", str(mib), "--iters", str(iters),
             "--seed", str(HOST_SEED)],
            cwd=root, capture_output=True, text=True, timeout=360)
        wall = time.perf_counter() - t0
        if res.returncode != 0:
            raise RuntimeError(f"host-shm ({tag}) failed (rc {res.returncode}):\n"
                               f"{res.stdout[-3000:]}\n{res.stderr[-6000:]}")
        ranks = []
        for r in range(4):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        if not all(d["device"].startswith("cuda") and d["ring"]["device"].startswith("cuda")
                   and d["windows"]["p2p_device"].startswith("cuda") for d in ranks):
            raise RuntimeError(f"host-shm ({tag}) not on the card: {ranks[0]}")
        ring = ranks[0]["ring"]
        pickled = [d["ring"]["pickled_bytes"] for d in ranks]
        if tag == "plain" and any(pickled):
            raise RuntimeError(f"host-shm ring pickled {pickled} bytes")
        if tag == "verify" and (any(p > 4096 for p in pickled)
                                or any(d["verify_problems"] for d in ranks)):
            raise RuntimeError(f"host-shm under --verify: pickled {pickled}, "
                               f"{[d['verify_problems'] for d in ranks]}")
        marks = {k: max(d["marks"][k] for d in ranks) - t0_wall
                 for k in ranks[0]["marks"]}
        info[tag] = {"launcher_wall_s": wall, "marks_s": marks, "ranks": ranks}
        log(f"host-shm ({tag}) seconds after the launch, slowest rank: "
            + ", ".join(f"{k} {v:.2f}" for k, v in marks.items()))
        socket_ms = record.get("host_socket", {}).get("allreduce ring", {}).get("median_ms")
        log(f"host-shm ({tag}): {ring['bytes_per_rank'] >> 20} MiB ring allreduce median "
            f"{ring['median_ms']:.1f} ms ({', '.join(f'{s * 1e3:.1f}' for s in ring['s'])}; "
            f"phase 14's socket ring: {socket_ms if socket_ms is None else round(socket_ms, 1)} ms "
            f"at 256 MiB), pickled bytes {pickled}, float64 error "
            f"{ring['max_abs_err_vs_f64']:.3g}; launcher wall {wall:.1f} s [{card}]")
        for size, d in ranks[0]["arena"].items():
            log(f"host-shm ({tag}) arena {size} B, 8 collectives with algorithm='sm': "
                f"coll_sm_hits {d['coll_sm_hits']}, coll_sm_bytes {d['coll_sm_bytes']}, "
                f"fallbacks {d['coll_sm_fallbacks']}, {d['wall_ms']:.2f} ms")
        steer = ranks[1]["steer"]
        if not (steer["steered"]["ok"] and steer["steered"]["in_place"]
                and all((t["recv_user_inplace"], t["recv_user_fallbacks"]) == (1, 0)
                        for t in steer["steered"]["turns"])
                and steer["copy_path"]["ok"]):
            raise RuntimeError(f"host-shm steered receive: {steer}")
        info["steer"] = steer
        log(f"host-shm ({tag}) steered receive of {mib} MiB into rank 1's card "
            f"tensor: {steer['steered']['ms']:.1f} ms (turns "
            f"{', '.join(f'{v:.1f}' for v in steer['steered']['ms_turns'])}), bitwise, "
            f"same data_ptr, recv_user_inplace +1, recv_user_fallbacks +0 each; the copy "
            f"path (recv_steering off) {steer['copy_path']['ms']:.1f} ms (turns "
            f"{', '.join(f'{v:.1f}' for v in steer['copy_path']['ms_turns'])}), after an "
            f"untimed first steered receive (the staging's first use) of "
            f"{steer['warmup']['ms']:.1f} ms [{card}]")
        log(f"host-shm ({tag}): 16 MiB declined on every rank "
            f"({[d['decline_16MiB']['coll_sm_fallbacks'] for d in ranks]}), compressed:bf16 "
            f"through the arena (hits {ranks[0]['compressed_bf16_arena']['coll_sm_hits']}), "
            f"shared and device windows {ranks[0]['windows']}")
        # this launch's segments only: another world's may live beside it
        prefix = shm_prefix(ranks[0]["session"])
        left = [f for f in os.listdir("/dev/shm") if f.startswith(prefix)]
        left += [d["windows"]["shared_path"] for d in ranks[:1]
                 if os.path.exists(d["windows"]["shared_path"])]
        if left:
            raise RuntimeError(f"host-shm ({tag}) left segments in /dev/shm: {left}")
        log(f"host-shm ({tag}): no {prefix}* segment and no shared window left "
            f"in /dev/shm after exit")
    info["segments_left"] = 0
    record["host_shm"] = info


RESTART_MIB = 256               # phase 24: each rank's state, the north-star size
DYNAMIC_MIB = 256               # phase 26: each rank's file block and steered receive
AGREE_ELEMS = (64 << 20) // 4   # phase 24's agree=True leg: 64 MiB per rank
FLAT_MIB = 64                   # phase 25: each rank's input


def host_restart_phase(torch, record):
    """Phase 24: the launcher's ``--restarts`` resuming a world from its
    last committed checkpoint on shm and on socket, with each rank's state
    on the card; then an ``agree=True`` save withheld by a death."""
    import mpi_tpu_torch
    from mpi_tpu_torch import checkpoint, mpit
    from mpi_tpu_torch.errors import ProcFailedError
    from mpi_tpu_torch.transport.faulty import FaultyTransport, KilledRankError

    card = card_line()
    root = os.path.dirname(os.path.abspath(__file__))
    info = {"card": card, "ranks": 2, "mib_per_rank": RESTART_MIB}
    # the two backends' worlds run side by side (independent launches: the
    # rank start-ups, most of the wall, overlap)
    outs = {b: tempfile.mkdtemp(prefix=f"mtt_restart_{b}_") for b in ("shm", "socket")}
    procs = {}
    try:
        t0 = time.perf_counter()
        for backend, out in outs.items():
            procs[backend] = subprocess.Popen(
                [sys.executable, "-m", "mpi_tpu_torch.launcher", "-n", "2",
                 "--restarts", "2", "--backend", backend, "--timeout", "240",
                 os.path.join("mpi_tpu_torch", "examples", "host_restart.py"),
                 "--out", out, "--mib", str(RESTART_MIB), "--steps", "4",
                 "--crash-step", "1", "--seed", str(HOST_SEED)],
                cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        done = {}
        for backend, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=600)
            done[backend] = (proc.returncode, stdout, stderr, time.perf_counter() - t0)
        for backend, (rc, stdout, stderr, wall) in done.items():
            if rc != 0:
                raise RuntimeError(f"host-restart ({backend}) failed (rc {rc}):\n"
                                   f"{stdout[-3000:]}\n{stderr[-6000:]}")
            if "exit code 41" not in stderr:
                raise RuntimeError(f"host-restart ({backend}): attempt 0 did not crash:\n"
                                   f"{stderr[-3000:]}")
            ranks = []
            for r in range(2):
                with open(os.path.join(outs[backend], f"rank{r}.json")) as f:
                    ranks.append(json.load(f))
            for d in ranks:
                if not (d["attempt"] == 1 and d["resumed_from_gen"] == 1
                        and d["resumed_at_step"] == 2 and d["committed_gen"] == 3
                        and d["bitwise_equal_to_crash_free"]
                        and d["device"].startswith("cuda")
                        and all(v.startswith("cuda") for v in d["loaded_devices"])):
                    raise RuntimeError(f"host-restart ({backend}) rank {d['rank']}: {d}")
            info[backend] = {"launcher_wall_s": wall, "ranks": ranks}
            d = ranks[0]
            saves = ", ".join(f"{max(x['save_s'][i] for x in ranks):.3f}"
                              for i in range(len(d["save_s"])))
            log(f"host-restart ({backend}): rank 1 exited 41 on attempt 0 after the save of "
                f"step 1; attempt 1 resumed from generation {d['resumed_from_gen']} at step "
                f"{d['resumed_at_step']} with the state on {d['loaded_devices']}, committed "
                f"generation {d['committed_gen']}, bitwise equal to the crash-free run on both "
                f"ranks; {d['bytes_per_rank'] >> 20} MiB per rank, save {saves} s, "
                f"load {max(x['load_s'] for x in ranks):.3f} s (slowest rank); "
                f"launcher wall {wall:.1f} s for both attempts, beside the other "
                f"backend's [{card}]")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for out in outs.values():
            shutil.rmtree(out, ignore_errors=True)

    # agree=True: a member killed before the commit withholds it
    path = tempfile.mkdtemp(prefix="mtt_agree_")
    saved = {k: mpit.cvar_read(k) for k in ("fault_detect_timeout_s",
                                             "fault_heartbeat_interval_s")}
    mpit.cvar_write("fault_detect_timeout_s", 1.0)
    mpit.cvar_write("fault_heartbeat_interval_s", 0.05)

    def agree_prog(comm):
        w = torch.full((AGREE_ELEMS,), float(comm.rank), device=comm.device)
        raised = None
        try:
            checkpoint.save(path, {"w": w}, comm, agree=True)
        except (ProcFailedError, KilledRankError) as e:
            raised = e
        if raised is None:
            raise RuntimeError("agree=True save committed despite the death")
        if comm.rank == 1:
            return None
        withheld = not checkpoint.exists(path)
        new = comm.shrink()
        checkpoint.save(path, {"w": w, "rank": new.rank}, new, agree=True)
        back = checkpoint.load(path, new)
        return {"withheld": withheld, "committed_after_shrink": checkpoint.exists(path),
                "device": str(back["w"].device),
                "bitwise": bool(torch.equal(back["w"], w)) and back["rank"] == new.rank}

    try:
        t0 = time.perf_counter()
        res = mpi_tpu_torch.run(
            agree_prog, backend="local", nranks=3, fault_tolerance=True,
            transport_wrapper=lambda t: (FaultyTransport(t, crash_on_send_to=0)
                                         if t.world_rank == 1 else t))
        wall = time.perf_counter() - t0
    finally:
        for k, v in saved.items():
            mpit.cvar_write(k, v)
        shutil.rmtree(path, ignore_errors=True)
    for r in (0, 2):
        d = res[r]
        if not (d["withheld"] and d["committed_after_shrink"] and d["bitwise"]
                and d["device"].startswith("cuda")):
            raise RuntimeError(f"agree=True checkpoint rank {r}: {d}")
    info["agree"] = {"wall_s": wall, "bytes_per_rank": AGREE_ELEMS * 4, "survivors": res}
    log(f"host-restart agree=True: rank 1 killed before the commit, both survivors "
        f"raised and no manifest was swung; after shrink the survivors' save committed "
        f"and loaded on {res[0]['device']}, bitwise ({AGREE_ELEMS * 4 >> 20} MiB per rank, "
        f"{wall:.2f} s) [{card}]")
    record["host_restart"] = info


def host_flat_phase(torch, record):
    """Phase 25: hierarchical dispatch and the flat MPI layer in one
    launched shm world of 4 rank processes on the card."""
    from mpi_tpu_torch.tuning.table import Row, new_doc

    card = card_line()
    root = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.abspath(os.path.join("chiprun_out", "host_flat"))
    os.makedirs(out_dir, exist_ok=True)
    for f in os.listdir(out_dir):
        os.remove(os.path.join(out_dir, f))
    table = os.path.join(out_dir, "table.json")
    with open(table, "w") as f:  # pins the leaders' 2-rank allreduce
        json.dump(new_doc([Row("shm", 2, "allreduce", 0, None, "ring", True)], ["shm"]), f)
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "mpi_tpu_torch.launcher", "-n", "4", "--backend", "shm",
         "--timeout", "300", "--tuning-table", table,
         os.path.join("mpi_tpu_torch", "examples", "host_flat.py"),
         "--out", out_dir, "--mib", str(FLAT_MIB), "--seed", str(HOST_SEED)],
        cwd=root, capture_output=True, text=True, timeout=360)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f"host-flat failed (rc {res.returncode}):\n"
                           f"{res.stdout[-3000:]}\n{res.stderr[-6000:]}")
    ranks = []
    for r in range(4):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    if not all(d["device"].startswith("cuda") for d in ranks):
        raise RuntimeError(f"host-flat ranks not on the card: {[d['device'] for d in ranks]}")
    legs = list(ranks[0]["legs"])
    bad = [(d["rank"], k) for d in ranks for k in legs if not d["legs"][k]["ok"]]
    if bad:
        raise RuntimeError(f"host-flat legs failed: {bad}")
    hits = [ranks[r]["legs"]["hier allreduce"]["consults"]["leaders"][0] for r in (0, 2)]
    if hits != [1, 1]:
        raise RuntimeError(f"host-flat: the leaders' allreduce did not hit the table: {hits}")
    info = {"card": card, "ranks": 4, "bytes_per_rank": ranks[0]["bytes_per_rank"],
            "launcher_wall_s": wall, "ranks_detail": ranks,
            "slowest_ms": {k: max(d["legs"][k]["ms"] for d in ranks) for k in legs}}
    for k in legs:
        extra = ""
        if k.startswith("hier ") and "consults" in ranks[0]["legs"][k]:
            extra = "; [hits, fallbacks] by tier on ranks 0-3: " + ", ".join(
                str(d["legs"][k]["consults"]) for d in ranks)
        if "max_abs_err_vs_f64" in ranks[0]["legs"][k]:
            extra += f"; float64 error {ranks[0]['legs'][k]['max_abs_err_vs_f64']:.3g}"
        log(f"host-flat {k}: {info['slowest_ms'][k]:.1f} ms (slowest rank), check ok{extra}")
    log(f"host-flat: {ranks[0]['bytes_per_rank'] >> 20} MiB per rank, 4 shm rank processes, "
        f"launcher wall {wall:.1f} s [{card}]")
    record["host_flat"] = info


def host_dynamic_start():
    """Phase 26, started beside phase 24's launches (both start-up bound):
    one 4-rank socket world of ``examples/host_dynamic.py`` on the card and
    the two 1-rank ``coupled_models.py`` jobs sharing a name-service
    directory under ``chiprun_out/host_dynamic/``.  Returns the started
    launches for :func:`host_dynamic_phase` to wait on."""
    root = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.abspath(os.path.join("chiprun_out", "host_dynamic"))
    shutil.rmtree(out_dir, ignore_errors=True)
    names = os.path.join(out_dir, "names")
    os.makedirs(names, mode=0o700)
    env = dict(os.environ, MPI_TPU_NAMESERVICE=names)
    script = lambda name: os.path.join("mpi_tpu_torch", "examples", name)
    launcher = [sys.executable, "-m", "mpi_tpu_torch.launcher"]
    cmds = {
        "host_dynamic": launcher + [
            "-n", "4", "--backend", "socket", "--timeout", "300",
            script("host_dynamic.py"), "--out", out_dir, "--mib", str(DYNAMIC_MIB),
            "--seed", str(HOST_SEED), "--require", "cuda"],
        "ocean": launcher + ["-n", "1", "--timeout", "300", script("coupled_models.py"),
                             "ocean", "--out", out_dir],
        "atmosphere": launcher + ["-n", "1", "--timeout", "300",
                                  script("coupled_models.py"), "atmosphere",
                                  "--out", out_dir],
    }
    t0 = time.perf_counter()
    procs = {k: subprocess.Popen(c, cwd=root, env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for k, c in cmds.items()}
    return {"t0": t0, "procs": procs, "out_dir": out_dir}


def host_dynamic_phase(torch, record, started):
    """Phase 26: MPI-IO at 256 MiB a rank, the steered socket receive,
    spawn and the coupled models (started by :func:`host_dynamic_start`);
    every launch must exit 0, every rank and child be on the card and every
    leg pass its check.  Nothing here is caught."""
    card = card_line()
    out_dir = started["out_dir"]
    done = {}
    try:
        for k, proc in started["procs"].items():
            stdout, stderr = proc.communicate(timeout=600)
            done[k] = (proc.returncode, stdout, stderr,
                       time.perf_counter() - started["t0"])
    finally:
        for proc in started["procs"].values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for k, (rc, stdout, stderr, _) in done.items():
        if rc != 0:
            raise RuntimeError(f"host-dynamic {k} failed (rc {rc}):\n"
                               f"{stdout[-3000:]}\n{stderr[-6000:]}")
    ranks = []
    for r in range(4):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    if not all(d["device"].startswith("cuda") for d in ranks):
        raise RuntimeError(f"host-dynamic ranks not on the card: {[d['device'] for d in ranks]}")
    legs = list(ranks[0]["legs"])
    bad = [(d["rank"], k) for d in ranks for k in legs if not d["legs"][k]["ok"]]
    if bad:
        raise RuntimeError(f"host-dynamic legs failed: {bad}")
    spawned = ranks[0]["legs"]["spawn"]
    if spawned["devices"] != ["cuda"] * spawned["children"]:
        raise RuntimeError(f"host-dynamic: spawned children not on the card: {spawned}")
    steered, copied = ranks[1]["legs"]["steered recv"], ranks[1]["legs"]["copy-path recv"]
    if not (steered["in_place"] and all(
            (t["recv_user_inplace"], t["recv_user_fallbacks"]) == (1, 0)
            for t in steered["turns"])):
        raise RuntimeError(f"host-dynamic steered receive: {steered}")
    coupled = {}
    for role in ("ocean", "atmosphere"):
        with open(os.path.join(out_dir, f"{role}_rank0.json")) as f:
            coupled[role] = json.load(f)
        if not (coupled[role]["ok"] and coupled[role]["device"].startswith("cuda")):
            raise RuntimeError(f"host-dynamic coupled {role}: {coupled[role]}")
    write_s = [d["legs"]["io write_at_all"]["seconds"] for d in ranks]
    read_s = [d["legs"]["io read_at_all"]["seconds"] for d in ranks]
    info = {"card": card, "ranks": 4, "bytes_per_rank": ranks[0]["bytes_per_rank"],
            "launcher_wall_s": {k: v[3] for k, v in done.items()},
            "io_write_s": write_s, "io_read_s": read_s,
            "steered_ms": steered["ms"], "copy_path_ms": copied["ms"],
            "steer_warmup_ms": ranks[1]["steer_warmup"]["ms"],
            "spawn": spawned, "coupled": coupled, "ranks_detail": ranks,
            "slowest_ms": {k: max(d["legs"][k]["ms"] for d in ranks) for k in legs}}
    mib = ranks[0]["bytes_per_rank"] >> 20
    log(f"host-dynamic io: write_at_all of {mib} MiB a rank ({4 * mib} MiB in all, "
        f"{ranks[0]['legs']['io write_at_all']['branch']} branch) "
        f"{', '.join(f'{v:.3f}' for v in write_s)} s, read_at_all back to the card "
        f"{', '.join(f'{v:.3f}' for v in read_s)} s (ranks 0-3), bitwise; subarray view "
        f"{info['slowest_ms']['io subarray view']:.1f} ms, shared and ordered "
        f"{info['slowest_ms']['io shared and ordered']:.1f} ms, external32 "
        f"{info['slowest_ms']['io external32']:.1f} ms (slowest rank), checks ok; "
        f"beside phase 24's launches [{card}]")
    log(f"host-dynamic steered socket receive of {mib} MiB into rank 1's card tensor: "
        f"{steered['ms']:.1f} ms (turns {', '.join(f'{v:.1f}' for v in steered['ms_turns'])}), "
        f"same data_ptr, recv_user_inplace +1, recv_user_fallbacks +0 each; the copy path "
        f"{copied['ms']:.1f} ms (turns {', '.join(f'{v:.1f}' for v in copied['ms_turns'])}), "
        f"after an untimed first steered receive of {ranks[1]['steer_warmup']['ms']:.1f} ms "
        f"[{card}]")
    log(f"host-dynamic spawn: {spawned['children']} children on {spawned['devices']}, "
        f"pi ~= {spawned['pi']:.6f} equal to the float64 oracle, "
        f"{info['slowest_ms']['spawn']:.1f} ms; coupled models: ocean "
        f"{coupled['ocean']['final'][0]:.3f}, atmosphere "
        f"{coupled['atmosphere']['final'][0]:.3f} on "
        f"{coupled['ocean']['device']}, bitwise the numpy replay; launcher walls "
        + ", ".join(f"{k} {v[3]:.1f} s" for k, v in done.items()) + f" [{card}]")
    record["host_dynamic"] = info


SERVE_LEASES = 200      # phase 27 (a): sequential 2-rank leases
SERVE_MIB = 256         # phase 27 (b): float32 MiB a rank of the checked lease
SERVE_DETECT_S = 2.0    # phase 27: the pools' detection bound


def _scrape(addr):
    """The ``/metrics`` text of a server's endpoint, as a dict of the
    unlabelled samples (``name -> float``)."""
    import urllib.request

    text = urllib.request.urlopen(f"http://{addr}/metrics", timeout=10).read().decode()
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#") and "{" not in line:
            name, value = line.rsplit(" ", 1)
            out[name] = float(value)
    return out


def _card_memory():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.used,memory.total", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()


def _host_serve_legs(out_dir):
    """Phase 27's legs (a)-(f); every failure raises.  Returns the record."""
    import mpi_tpu_torch
    from mpi_tpu_torch import serve
    from mpi_tpu_torch.errors import MPI_ERR_PROC_FAILED, ProcFailedError, error_class
    from mpi_tpu_torch.examples import host_serve

    root = os.path.dirname(os.path.abspath(__file__))
    info = {"detect_timeout_s": SERVE_DETECT_S}
    t0 = time.perf_counter()
    # (f)'s server process starts first: its two workers come up beside the
    # in-process pools' eight
    addr_file = os.path.join(out_dir, "serve.addr")
    with open(os.path.join(out_dir, "launcher_serve.out"), "w") as fo, \
            open(os.path.join(out_dir, "launcher_serve.err"), "w") as fe:
        launched = subprocess.Popen(
            [sys.executable, "-m", "mpi_tpu_torch.launcher", "serve", "--pool-size", "2",
             "--backend", "shm", "--addr-file", addr_file, "--metrics-port", "0",
             "--detect-timeout", str(SERVE_DETECT_S)],
            cwd=root, stdout=fo, stderr=fe)
    kw = dict(pool_size=4, detect_timeout_s=SERVE_DETECT_S, heartbeat_s=0.25)
    sock = serve.WorldServer(backend="socket", metrics_port=0, **kw)
    shm = serve.WorldServer(backend="shm", **kw)
    try:
        for srv in (sock, shm):
            srv.start(wait_ready=False)
        for srv in (sock, shm):
            srv._wait_ready(180.0)
        info["pools_ready_s"] = time.perf_counter() - t0
        client = mpi_tpu_torch.connect(sock)
        try:
            devices = client.run(host_serve.job_devices, nranks=4, timeout=120.0)
            if [d.split(":")[0] for d in devices] != ["cuda"] * 4:
                raise RuntimeError(f"host-serve socket pool not on the card: {devices}")
            info["socket_devices"] = devices
            # (a) sequential 2-rank leases
            t1 = time.perf_counter()
            for i in range(SERVE_LEASES):
                got = client.run(serve.job_allreduce, 256, nranks=2, timeout=60.0)
                if got != 3.0:
                    raise RuntimeError(f"host-serve lease {i}: {got}, not 3.0")
            wall = time.perf_counter() - t1
            st = client.stats()
            scraped = _scrape(sock.metrics_addr)
            info["a"] = {"leases": SERVE_LEASES, "wall_s": wall,
                         "worlds_per_s": SERVE_LEASES / wall,
                         "stats_worlds_per_s": st["worlds_per_s"],
                         "acquire_p50_ms": st["lease_acquire_p50_ms"],
                         "acquire_p99_ms": st["lease_acquire_p99_ms"],
                         "scrape": {k: scraped.get(f"mpi_tpu_serve_{k}") for k in (
                             "worlds_per_s", "lease_acquire_p50_seconds",
                             "lease_acquire_p99_seconds", "jobs_ok_total", "epoch")}}
            if (st["jobs_ok"] != SERVE_LEASES + 1
                    or info["a"]["scrape"]["jobs_ok_total"] != SERVE_LEASES + 1
                    or info["a"]["scrape"]["lease_acquire_p99_seconds"] is None):
                raise RuntimeError(f"host-serve (a) counts: {st}, scrape {scraped}")
            # (b) the example's checked 256 MiB-a-rank lease on 4 workers
            big = client.run(host_serve.job_allreduce_checked, SERVE_MIB, nranks=4,
                             timeout=120.0)
            head = big.pop("head")  # rank 0's card tensor, handed over on the CPU
            big["head"] = head.tolist()
            if not (all(big["ok"]) and head.device.type == "cpu"
                    and big["head"] == [10.0] * 4
                    and [d.split(":")[0] for d in big["devices"]] == ["cuda"] * 4):
                raise RuntimeError(f"host-serve (b): {big}, head on {head.device}")
            info["b"] = big
            # (c) the shm pool's pooled arena, twice over the same workers
            with mpi_tpu_torch.connect(shm) as sc:
                devices = sc.run(host_serve.job_devices, nranks=4, timeout=120.0)
                if [d.split(":")[0] for d in devices] != ["cuda"] * 4:
                    raise RuntimeError(f"host-serve shm pool not on the card: {devices}")
                runs = []
                for _ in range(2):
                    t1 = time.perf_counter()
                    val, hits, names = sc.run(serve.job_allreduce_arena, 1024, nranks=4,
                                              timeout=60.0)
                    runs.append({"value": val, "coll_sm_hits": hits, "arenas": names,
                                 "ms": (time.perf_counter() - t1) * 1e3})
                if not (all(r["value"] == 10.0 and r["coll_sm_hits"] > 0 for r in runs)
                        and len(runs[0]["arenas"]) == 1
                        and runs[0]["arenas"] == runs[1]["arenas"]):
                    raise RuntimeError(f"host-serve (c) pooled arena: {runs}")
                info["c"] = {"devices": devices, "runs": runs}
            # (d) a kill mid-lease on the socket pool, then the heal
            epoch0 = client.stats()["epoch"]
            bound = 3 * SERVE_DETECT_S + 8.0
            lease = client.acquire(2, timeout=60.0)
            t1 = time.perf_counter()
            try:
                lease.run(serve.job_kill_rank, 1, 4096, timeout=bound)
            except ProcFailedError as e:
                detect_s = time.perf_counter() - t1
                if error_class(e) != MPI_ERR_PROC_FAILED:
                    raise RuntimeError(f"host-serve (d): class {error_class(e)}") from e
                diagnosis = str(e)
            else:
                raise RuntimeError("host-serve (d): the kill raised no ProcFailedError")
            lease.release()
            if detect_s >= bound:
                raise RuntimeError(f"host-serve (d): diagnosed in {detect_s:.2f} s "
                                   f"(bound {bound} s)")
            t1 = time.perf_counter()
            while True:
                st = client.stats()
                if st["idle"] == 4 and not st["healing"]:
                    break
                if time.perf_counter() - t1 > 120.0:
                    raise RuntimeError(f"host-serve (d): no heal in 120 s: {st}")
                time.sleep(0.05)
            heal_s = time.perf_counter() - t1
            devices = client.run(host_serve.job_devices, nranks=4, timeout=120.0)
            after = client.run(serve.job_allreduce, 256, nranks=4, timeout=60.0)
            if not (st["epoch"] > epoch0 and after == 10.0
                    and [d.split(":")[0] for d in devices] == ["cuda"] * 4):
                raise RuntimeError(f"host-serve (d) after the heal: epoch {st['epoch']} "
                                   f"(was {epoch0}), devices {devices}, allreduce {after}")
            info["d"] = {"detect_s": detect_s, "bound_s": bound, "heal_s": heal_s,
                         "epoch": [epoch0, st["epoch"]], "devices": devices,
                         "diagnosis": diagnosis, "workers_lost": st["workers_lost"],
                         "heals_completed": st["heals_completed"]}
            # (e) a lease riding healed links
            before = client.stats()["worker_pvars"].get("link_reconnects", 0)
            chaos = client.run(serve.job_allreduce_link_chaos, 1024, 2, nranks=2,
                               timeout=60.0)
            reconnects = client.stats()["worker_pvars"].get("link_reconnects", 0)
            if chaos != 3.0 or reconnects <= before:
                raise RuntimeError(f"host-serve (e): {chaos}, link_reconnects "
                                   f"{before} -> {reconnects}")
            info["e"] = {"value": chaos, "link_reconnects": [before, reconnects]}
            info["socket_stats"] = client.stats()
            info["memory_used_pools_up"] = _card_memory()
        finally:
            client.close()
        # (f) the launched server, through its address file and the example
        t1 = time.perf_counter()
        while not os.path.exists(addr_file):
            if launched.poll() is not None or time.perf_counter() - t1 > 180.0:
                with open(os.path.join(out_dir, "launcher_serve.err")) as f:
                    err = f.read()[-4000:]
                raise RuntimeError(f"host-serve (f): the launched server published no "
                                   f"address (rc {launched.poll()}):\n{err}")
            time.sleep(0.1)
        rc = host_serve.main(["--addr-file", addr_file, "--nranks", "2", "--mib", "16",
                              "--require", "cuda", "--shutdown",
                              "--out", os.path.join(out_dir, "host_serve.json")])
        server_rc = launched.wait(timeout=60)
        with open(os.path.join(out_dir, "host_serve.json")) as f:
            info["f"] = json.load(f)
        info["f"].update({"rc": rc, "server_rc": server_rc,
                          "client_s": time.perf_counter() - t1})
        if rc != 0 or server_rc != 0:
            with open(os.path.join(out_dir, "launcher_serve.err")) as f:
                err = f.read()[-4000:]
            raise RuntimeError(f"host-serve (f): client rc {rc}, server rc {server_rc}:\n{err}")
    finally:
        sock.stop()
        shm.stop()
        if launched.poll() is None:
            launched.kill()
            launched.wait()
    info["memory_used_after"] = _card_memory()
    info["wall_s"] = time.perf_counter() - t0
    return info


def host_serve_start():
    """Phase 27, started in a background thread beside phase 24's launches
    (both start-up bound): the resident world server's legs (a)-(f).
    Returns the handle :func:`host_serve_phase` joins."""
    import threading

    out_dir = os.path.abspath(os.path.join("chiprun_out", "host_serve"))
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    started = {"t0": time.perf_counter()}

    def body():
        try:
            started["info"] = _host_serve_legs(out_dir)
        except BaseException as e:  # re-raised by host_serve_phase
            started["error"] = e

    th = threading.Thread(target=body, name="phase-27-host-serve", daemon=True)
    th.start()
    started["thread"] = th
    return started


def host_serve_phase(torch, record, started):
    """Phase 27: join the legs started by :func:`host_serve_start`; a
    failure in any leg raises here.  Prints each leg's numbers."""
    card = card_line()
    th = started["thread"]
    th.join(timeout=600)
    if th.is_alive():
        raise RuntimeError("host-serve: the legs did not finish within 600 s")
    if "error" in started:
        raise RuntimeError(f"host-serve failed: {started['error']!r}") from started["error"]
    info = started["info"]
    info["card"] = card
    a, b, d = info["a"], info["b"], info["d"]
    log(f"host-serve (a): {a['leases']} sequential 2-rank leases of job_allreduce(256) on a "
        f"socket pool of 4 card workers in {a['wall_s']:.3f} s: {a['worlds_per_s']:.1f} "
        f"worlds/s (the stats gauge {a['stats_worlds_per_s']}), lease_acquire p50/p99 "
        f"{a['acquire_p50_ms']}/{a['acquire_p99_ms']} ms; /metrics scrape: "
        f"worlds_per_s {a['scrape']['worlds_per_s']}, p50/p99 "
        f"{a['scrape']['lease_acquire_p50_seconds']}/{a['scrape']['lease_acquire_p99_seconds']} s, "
        f"jobs_ok_total {a['scrape']['jobs_ok_total']}; pools ready "
        f"{info['pools_ready_s']:.1f} s after the start [{card}]")
    log(f"host-serve (b): one 4-rank lease, ring allreduce of {b['bytes_per_rank'] >> 20} MiB "
        f"float32 a rank on {b['devices']}, every element {b['want']} on every worker; "
        f"{max(b['ms']):.1f} ms (slowest rank; ranks {', '.join(f'{v:.1f}' for v in b['ms'])}); "
        f"rank 0's card tensor {b['head']} reached the client on the CPU [{card}]")
    log(f"host-serve (c): shm pool of 4 on {info['c']['devices']}: job_allreduce_arena "
        + "; ".join(f"{r['value']} with coll_sm_hits {r['coll_sm_hits']} on {r['arenas']} "
                    f"in {r['ms']:.1f} ms" for r in info["c"]["runs"]) + f" [{card}]")
    log(f"host-serve (d): kill mid-lease diagnosed as ProcFailedError in {d['detect_s']:.3f} s "
        f"(bound {d['bound_s']} s; {d['diagnosis'][:120]}), healed in {d['heal_s']:.2f} s, "
        f"epoch {d['epoch'][0]} -> {d['epoch'][1]}, workers after {d['devices']}, next lease "
        f"correct [{card}]")
    log(f"host-serve (e): job_allreduce_link_chaos(resets=2) = {info['e']['value']}, "
        f"link_reconnects {info['e']['link_reconnects'][0]} -> {info['e']['link_reconnects'][1]}")
    f = info["f"]
    log(f"host-serve (f): launcher serve --backend shm --pool-size 2, examples/host_serve.py "
        f"through the address file: ok {f['ok']} on {f['allreduce']['devices']}, "
        f"acquire {f['acquire_ms']:.2f} ms, server exit {f['server_rc']}; card memory in use "
        f"(used, total) with the pools up {info['memory_used_pools_up']}, after phase 27 "
        f"{info['memory_used_after']}; legs' wall {info['wall_s']:.1f} s [{card}]")
    record["host_serve"] = info


FED_MIB = 64            # phase 28 (a): float32 MiB a rank of the checked lease
RAFT_LEASE_S = 10.0     # phase 28 (d): the raft servers' leader-lease bound


def _until(cond, timeout, what):
    deadline = time.monotonic() + timeout
    while True:
        got = cond()
        if got:
            return got
        if time.monotonic() > deadline:
            raise RuntimeError(f"timed out ({timeout} s) waiting for {what}")
        time.sleep(0.05)


def _host_federation_file_legs(out_dir):
    """Phase 28's legs (a)-(c) and (e): the example on a file namespace."""
    from mpi_tpu_torch.examples import host_federation

    out = os.path.join(out_dir, "host_federation.json")
    t0 = time.perf_counter()
    rc = host_federation.main([
        "--ns", os.path.join(out_dir, "ns"), "--servers", "2", "--pool-size", "2",
        "--nranks", "2", "--mib", str(FED_MIB), "--require", "cuda", "--kill-leader",
        "--out", out])
    if rc != 0:
        raise RuntimeError(f"host-federation (a)-(c), (e): examples/host_federation.py "
                           f"exited {rc} (its stderr above)")
    with open(out) as f:
        info = json.load(f)
    info["wall_s"] = time.perf_counter() - t0
    return info


def _host_federation_raft_leg():
    """Phase 28's leg (d): three in-process servers on a raft namespace, a
    partition that isolates the store leader's node, and the heal."""
    import socket

    from mpi_tpu_torch import connect, federation, federation_store, mpit, serve
    from mpi_tpu_torch.errors import NoQuorumError
    from mpi_tpu_torch.examples import host_serve

    t0 = time.perf_counter()
    socks = [socket.socket() for _ in range(3)]
    for sk in socks:
        sk.bind(("127.0.0.1", 0))
    addrs = ["127.0.0.1:%d" % sk.getsockname()[1] for sk in socks]
    for sk in socks:
        sk.close()
    spec = "raft:" + ",".join(addrs)
    servers = [serve.WorldServer(pool_size=1, federation=f"raft:{i}@{','.join(addrs)}",
                                 server_id=f"r{i}", detect_timeout_s=SERVE_DETECT_S,
                                 fed_lease_timeout_s=RAFT_LEASE_S) for i in range(3)]
    info = {"addrs": addrs}
    try:
        for srv in servers:
            srv.start(wait_ready=False)
        for srv in servers:
            srv._wait_ready(180.0)
        _until(lambda: all(srv._fed.healthy() for srv in servers)
               and federation.read_leader(spec), 60.0, "a healthy raft namespace's leader")
        info["up_s"] = time.perf_counter() - t0
        iso = next(i for i, srv in enumerate(servers)
                   if srv._fed.store.node.role == "leader")
        minority = servers[iso]
        t1 = time.perf_counter()
        federation_store.install_store_partition({i: int(i == iso) for i in range(3)})
        _until(lambda: not minority._fed.healthy(), 30.0, "the isolated node's verdict")
        info["unhealthy_after_s"] = time.perf_counter() - t1
        rejected0 = minority.stats()["no_quorum_rejected"]
        with connect(minority) as c:
            try:
                c.acquire(1, timeout=30.0)
            except NoQuorumError as e:
                info["refusal"] = str(e)
            else:
                raise RuntimeError("host-federation (d): the minority server granted a lease")
        info["no_quorum_rejected"] = [rejected0, minority.stats()["no_quorum_rejected"]]
        if info["no_quorum_rejected"][1] <= rejected0:
            raise RuntimeError(f"host-federation (d): no_quorum_rejected "
                               f"{info['no_quorum_rejected']}")
        with connect(spec) as fc:
            if not isinstance(fc, federation.FederatedClient):
                raise RuntimeError(f"host-federation (d): connect({spec!r}) gave {fc!r}")
            devices = fc.run(host_serve.job_devices, nranks=1, timeout=120.0)
            info["majority_server"], info["majority_devices"] = fc.addr, devices
            info["failovers"] = fc.failovers
        if info["majority_server"] == minority.addr or devices[0].split(":")[0] != "cuda":
            raise RuntimeError(f"host-federation (d): the federated lease ran on "
                               f"{info['majority_server']} ({devices}); the minority is "
                               f"{minority.addr}")
        info["partitioned_s"] = time.perf_counter() - t1
        federation_store.install_store_partition(None)
        t2 = time.perf_counter()
        _until(minority._fed.healthy, 30.0, "the healed node's quorum")
        info["healthy_after_heal_s"] = time.perf_counter() - t2
        with connect(minority) as c:
            healed = c.run(serve.job_allreduce, 256, nranks=1, timeout=60.0)
        if healed != 1.0:
            raise RuntimeError(f"host-federation (d): the healed server's lease gave {healed}")
        info["pvars"] = {p: mpit.pvar_read(p) for p in (
            "store_elections", "store_entries_truncated", "store_partition_dropped",
            "store_term", "store_commit_index")}
        if not (info["pvars"]["store_partition_dropped"] > 0
                and info["pvars"]["store_elections"] >= 1):
            raise RuntimeError(f"host-federation (d): store pvars {info['pvars']}")
        federation.assert_no_leader_overlap(spec)
    finally:
        for srv in servers:
            srv.stop()
    left = [srv.rdv for srv in servers if os.path.exists(srv.rdv)]
    if left:
        raise RuntimeError(f"host-federation (d): rendezvous dirs left {left}")
    info["wall_s"] = time.perf_counter() - t0
    return info


def host_federation_start():
    """Phase 28, started in two background threads at the beginning of phase
    25: the file-namespace legs (a)-(c), (e) and the raft leg (d).  Returns
    the handle :func:`host_federation_phase` joins."""
    import threading

    out_dir = os.path.abspath(os.path.join("chiprun_out", "host_federation"))
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    started = {"t0": time.perf_counter(), "threads": []}

    def leg(name, fn, *args):
        def body():
            try:
                started[name] = fn(*args)
            except BaseException as e:  # re-raised by host_federation_phase
                started.setdefault("errors", []).append((name, e))
        th = threading.Thread(target=body, name=f"phase-28-{name}", daemon=True)
        th.start()
        started["threads"].append(th)

    leg("file", _host_federation_file_legs, out_dir)
    leg("raft", _host_federation_raft_leg)
    return started


def host_federation_phase(torch, record, started):
    """Phase 28: join the legs started by :func:`host_federation_start`; a
    failure in any leg raises here.  Prints each leg's numbers."""
    card = card_line()
    for th in started["threads"]:
        th.join(timeout=600)
        if th.is_alive():
            raise RuntimeError(f"host-federation: {th.name} did not finish within 600 s")
    if started.get("errors"):
        name, e = started["errors"][0]
        raise RuntimeError(f"host-federation {name} leg failed: {e!r}") from e
    f, r = started["file"], started["raft"]
    k = f["kill"]
    log(f"host-federation (a): 2 federated launcher serve processes, 2 card workers each, "
        f"up in {f['fabric_up_s']:.2f} s; connect(<dir>) leased 2 ranks on "
        f"{f['lease']['devices']}: {f['lease']['bytes_per_rank'] >> 20} MiB float32 a rank, "
        f"every element {f['lease']['want']}, {max(f['lease']['ms']):.1f} ms (slowest rank) "
        f"[{card}]")
    log(f"host-federation (b): SIGKILL of leader {k['leader']}: the same client leased on "
        f"{k['survivor']} {k['kill_to_lease_s']:.3f} s after the kill ({k['failovers']} "
        f"failover(s)); pool {k['adopted_pools']} adopted {k['kill_to_adoption_s']:.3f} s "
        f"after it (pools_adopted {k['pools_adopted']}, orphans_reregistered "
        f"{k['orphans_reregistered']}); orphans {k['orphans_after']} kept their pids "
        f"(before {k['orphans_before']}); the adopted pool's lease exact "
        f"{all(k['adopted_lease']['ok'])}; {k['authority_intervals']} authority "
        f"intervals, no overlap; leader term {k['leader_term']} [{card}]")
    log(f"host-federation (c): the survivor's /metrics mpi_tpu_fed_* = stats()['federation'] "
        f"= {k['metrics']['federation']}")
    log(f"host-federation (d): 3 raft-namespace servers up in {r['up_s']:.2f} s; the store "
        f"leader's node isolated: unhealthy after {r['unhealthy_after_s']:.3f} s, acquire "
        f"refused with NoQuorumError (no_quorum_rejected {r['no_quorum_rejected'][0]} -> "
        f"{r['no_quorum_rejected'][1]}), the FederatedClient leased on "
        f"{r['majority_server']} ({r['majority_devices']}, {r['failovers']} failover(s)); "
        f"healed: quorum back after {r['healthy_after_heal_s']:.3f} s and the server admits "
        f"again; store pvars {r['pvars']}; leg wall {r['wall_s']:.1f} s [{card}]")
    log(f"host-federation (e): server exit codes {f['server_rcs']} (the killed leader -9), "
        f"rendezvous dirs and segments left {f['rdv_left']}; legs' wall {f['wall_s']:.1f} s")
    record["host_federation"] = {"file": f, "raft": r, "card": card}


def host_multihost_start():
    """Phase 29, started in a background thread at the beginning of phase
    19: two simulated hosts of 4 ranks on the card.  Returns the handle
    :func:`host_multihost_phase` joins."""
    import threading

    from mpi_tpu_torch.gpu import multihost

    out_dir = os.path.abspath(os.path.join("chiprun_out", "multihost"))
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    rdv = tempfile.mkdtemp(prefix="mpi_tpu_torch_mh_rdv_")
    argv = [os.path.join(os.path.dirname(os.path.abspath(__file__)), "mpi_tpu_torch",
                         "examples", "multihost_world.py"),
            "--out", out_dir, "--mib", str(NORTH_STAR_ELEMS * 4 / (1 << 20)),
            "--half-mib", "64", "--rdv", rdv, "--reps", "5"]
    started = {"t0": time.perf_counter(), "out": out_dir, "rdv": rdv}

    def body():
        try:
            started["rc"] = multihost.launch_sim_hosts(2, argv, devices_per_host=4,
                                                       timeout=600)
        except BaseException as e:  # re-raised by host_multihost_phase
            started["error"] = e
        started["wall_s"] = time.perf_counter() - started["t0"]

    started["thread"] = threading.Thread(target=body, name="phase-29", daemon=True)
    started["thread"].start()
    return started


def _children_running(marker):
    """Processes whose parent is this one and whose command line holds
    ``marker``."""
    left = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:
            continue
        if ppid == os.getpid() and marker in cmd:
            left.append(int(pid))
    return left


def host_multihost_phase(torch, record, started, paths):
    """Phase 29: join the two simulated hosts started by
    :func:`host_multihost_start`, check what each wrote and return the
    ``kernels`` rows of the peer-pointer entry points."""
    card = card_line()
    started["thread"].join(timeout=700)
    if started["thread"].is_alive():
        raise RuntimeError("worlds across processes: the hosts did not finish in 700 s")
    shutil.rmtree(started["rdv"], ignore_errors=True)
    if "error" in started:
        raise RuntimeError(f"worlds across processes: {started['error']!r}") from \
            started["error"]
    if started["rc"] != 0:
        raise RuntimeError(f"worlds across processes: a host exited {started['rc']}")
    left = _children_running("multihost_world.py")
    if left:
        raise RuntimeError(f"worlds across processes left processes {left}")
    recs = [json.load(open(os.path.join(started["out"], f"proc{q}.json")))
            for q in range(2)]
    for q, r in enumerate(recs):
        w = r["worker"]
        ok = (r["device"].startswith("cuda") and r["first"] == 4 * q
              and w["total"] == [28] * 4 and w["ring_sum"] == [224.0] * 4
              and r["node_key"] == [0] * 4 + [1] * 4
              and r["hybrid"]["process_index"] == [[0] * 4, [1] * 4]
              and r["open_mappings_after"] == 0)
        if not ok:
            raise RuntimeError(f"worlds across processes: process {q}'s record {r}")
    launches = {k: sum(r["launches"][k] for r in recs) for k in recs[0]["launches"]}
    if not all(launches.values()):
        raise RuntimeError(f"the cross-process path never launched {launches}")
    paths["worlds across processes"] = launches
    rows = []
    for mode in ("allreduce", "reduce_scatter", "allgather"):
        k0, k1 = (r["k1"][mode] for r in recs)
        rows.append({
            "name": f"ring_{mode}_ptrs", "route": "cuda", "source": SOURCE,
            "replaces": REPLACES,
            "max_abs_err": max(k0["max_abs_err"], k1["max_abs_err"]),
            "ms": k0["kernel_ms"], "plain_ms": k0["plain_ms"],
            "bound_ms": k0["bound_ms"], "bound_by": "bytes", "library_ms": None,
            "pct_of_bound": k0["pct_of_bound"], "bytes": k0["bytes"],
            "ms_by_process": [k0["kernel_ms"], k1["kernel_ms"]],
            "wall_ms": [k0["wall_ms"], k1["wall_ms"]],
            "staging_bytes": k0["staging_bytes"],
            "one_process_ms": k0["one_process_ms"]})
    for mode in ("allreduce", "reduce_scatter", "allgather", "allreduce_bf16_max"):
        k0, k1 = (r["k1"][mode] for r in recs)
        log(f"worlds across processes, {mode} {k0['shape']} {k0['dtype']} a process: "
            f"kernel {k0['kernel_ms']:.3f}/{k1['kernel_ms']:.3f} ms (process 0/1, CUDA "
            f"events), wall with barriers {k0['wall_ms']:.3f}/{k1['wall_ms']:.3f} ms, "
            f"staging {k0['staging_bytes'] >> 20} MiB a process, bound "
            f"{k0['bound_ms']:.3f} ms ({k0['pct_of_bound']:.1f}%), plain "
            f"{k0['plain_ms']:.1f} ms, one process over 8 ranks {k0['one_process_ms']:.3f} "
            f"ms; bitwise the one-process kernel and the plain version [{card}]")
    r0 = recs[0]
    log(f"worlds across processes: 2 processes x 4 ranks on cuda:0 in "
        f"{started['wall_s']:.1f} s (process 0: init {r0['init_s']:.1f} s, inputs "
        f"{r0['inputs_s']:.1f} s, main path {r0['main_path_s']:.2f} s, all "
        f"{r0['seconds']:.1f} s); launches {launches}; the reference's program exact; "
        f"hybrid {r0['hybrid']['ranks']}, dcn allreduce {r0['hybrid']['dcn_allreduce']}; "
        f"node key {r0['node_key']}; exchange {r0['stats']}; no IPC mapping or child "
        f"process left")
    record["multihost"] = {"processes": recs, "wall_s": started["wall_s"],
                           "launches": launches, "card": card}
    return rows


def evidence_phase(torch, record):
    """The evidence writer on this run's record (phase 30 of the module
    docstring): every section but the card tier must be ok."""
    from mpi_tpu_torch.tools import gpu_evidence

    ev = gpu_evidence.collect(record, tier_skip="the card tier runs after chip_smoke.py",
                              in_process=True, command="python3 chip_smoke.py (phase 30)")
    path = gpu_evidence.write(ev, os.path.join("chiprun_out", "gpu_evidence.json"))
    sections = gpu_evidence.summary(ev)
    failed = [k for k, ok in sections.items() if k != "gpu_tests" and ok is False]
    if failed:
        raise RuntimeError(f"evidence sections failed: {failed}: "
                           f"{json.dumps({k: ev[k] for k in failed})[:4000]}")
    if ev["card"].get("nvidia_smi") != record["card"]:
        raise RuntimeError(f"the evidence's card {ev['card']} is not phase 1's")
    entry_rec = ev["entry_on_card"]  # ok: its result on cuda and finite
    export = {k: v.get("kernel_nodes") for k, v in ev["export"].items()
              if isinstance(v, dict)}
    record["evidence"] = {
        "path": path, "sections": sections, "entry_on_card": entry_rec,
        "export_kernel_nodes": export,
        "export_seconds": {k: v.get("seconds") for k, v in ev["export"].items()
                           if isinstance(v, dict)},
        "section_seconds": {k: ev[k]["seconds"] for k in
                            ("gpu_tests", "entry_on_card", "export")}}
    log(f"evidence: {path}, sections {sections}, entry() {entry_rec}, "
        f"kernel nodes {export}")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this test runs on the card only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import mpi_tpu_torch
    from mpi_tpu_torch import _build
    from mpi_tpu_torch.examples.jacobi import jacobi_program
    from mpi_tpu_torch.gpu import ring

    dev = torch.device("cuda", 0)
    record = {"card": card_line(), "device": torch.cuda.get_device_name(0),
              "torch": torch.__version__, "cuda": torch.version.cuda}
    log(f"card: {record['card']}")
    # a float32 product must stay float32 (TF32 would leave the tolerances)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lap("card")

    # 1. build -------------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build()
    record["build_s"] = {k: round(v, 2) for k, v in built.items()}
    log(f"build: {record['build_s']} (wall {time.perf_counter() - t0:.2f} s)")
    record["ptxas"] = ptxas_table(_build.PTXAS_REPORT)
    for row in record["ptxas"]:
        log(f"  ptxas {row['source']}: {row.get('kernel', row['function'])}: "
            f"{row.get('registers')} registers, spill stores {row.get('spill_stores')} "
            f"bytes, loads {row.get('spill_loads')} bytes")
    lap("build")

    # 2. Jacobi on the card vs the CPU ------------------------------------------
    jk = dict(rows_per_rank=128, cols=1024, iters=50)
    blk_g, res_g = mpi_tpu_torch.run(jacobi_program, nranks=P, **jk)
    blk_c, res_c = mpi_tpu_torch.run(jacobi_program, nranks=P, device="cpu", **jk)
    jerr = float((blk_g.cpu() - blk_c).abs().max())
    if not (torch.isfinite(blk_g).all() and jerr <= 1e-6 and
            abs(float(res_g[0]) - float(res_c[0])) <= 1e-6):
        raise RuntimeError(f"jacobi on the card disagrees with the CPU: {jerr}")
    record["jacobi"] = {"shape": list(blk_g.shape), "max_abs_err_vs_cpu": jerr,
                        "residual": float(res_g[0])}
    log(f"jacobi: {record['jacobi']}")
    lap("jacobi")

    # 3. the main path: north-star data-parallel step -----------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    base = torch.randn(NORTH_STAR_ELEMS, device=dev, generator=gen)

    def train_step(comm, base):
        grad = base * (1.0 + 0.125 * comm.rank.to(torch.float32))
        avg = comm.allreduce(grad, algorithm="pallas_ring")
        shard = comm.reduce_scatter(grad.view(comm.size, -1), algorithm="pallas_ring")
        params = comm.allgather(shard, algorithm="pallas_ring")
        return avg, shard, params

    ring.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    avg, shard, params = mpi_tpu_torch.run(train_step, base, nranks=P)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    launches = dict(ring.LAUNCHES)
    log(f"main path: step {step_s:.3f} s, launches {launches}")
    missing = [m for m, c in launches.items() if c == 0]
    if missing:
        raise RuntimeError(f"main path never launched the ring kernel for {missing}")
    # each main path's launches, read right after the path ran
    paths = {"north-star data-parallel step": ring_launches(ring)}

    scale = 1.0 + 0.125 * torch.arange(P, device=dev, dtype=torch.float32)
    grad_w = base[None] * scale[:, None]
    errs = {}
    checks = (("allreduce", avg, lambda: ring.allreduce_plain(grad_w)),
              ("reduce_scatter", shard,
               lambda: ring.reduce_scatter_plain(grad_w.view(P, P, -1))),
              ("allgather", params, lambda: ring.allgather_plain(shard)))
    for mode, got, plain in checks:
        want = plain()
        if not torch.equal(got, want):
            raise RuntimeError(f"main path {mode} differs from the plain version")
        errs[mode] = float((got - want).abs().max())
        del want
    head = grad_w[:, :1 << 20].double().sum(0)
    if not (torch.isfinite(avg).all() and
            torch.allclose(avg[0, :1 << 20].double(), head, rtol=1e-5, atol=1e-5) and
            torch.equal(avg[0], avg[-1])):
        raise RuntimeError("north-star allreduce disagrees with the float64 sum")
    record["main_path"] = {"step_s": step_s, "launches": launches,
                           "bytes_per_rank": NORTH_STAR_ELEMS * 4}
    del avg, shard, params, grad_w, base
    lap("data-parallel step")

    # 4. kernel vs plain, every mode x dtype x op x grouping --------------------
    n_cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        for gname, groups in RING_GROUPINGS.items():
            g = P if groups is None else len(groups[0])
            for op in ("sum", "max", "min"):
                for n in (1001, 600_001, 600_064):
                    x = spread_data(torch, gen, (P, n), dev)
                    if op != "sum":
                        x[1, 5] = float("nan")
                    x = x.to(dtype)
                    b = n // g
                    xs = x[:, :g * b].reshape(P, g, b).contiguous()
                    xb = x[:, :b].contiguous()
                    for mode, got, want in (
                            ("allreduce", ring.allreduce_world(x, groups, op),
                             ring.allreduce_plain(x, groups, op)),
                            ("reduce_scatter", ring.reduce_scatter_world(xs, groups, op),
                             ring.reduce_scatter_plain(xs, groups, op)),
                            ("allgather", ring.allgather_world(xb, groups),
                             ring.allgather_plain(xb, groups))):
                        torch.cuda.synchronize()
                        if not nan_equal(torch, got, want):
                            raise RuntimeError(
                                f"kernel != plain: {mode} {dtype} {op} {gname} n={n}")
                        n_cases += 1
    record["parity_cases"] = n_cases
    log(f"parity: {n_cases} cases bitwise equal")
    lap("ring parity")

    # 5-7. the multi-parallel dry run, the full-width step, the examples -------
    dryrun_phase(torch, paths, record)
    lap("dry run")
    steps, step_args = step_phase(torch, dev, paths, record)
    lap("full-width step")
    checkpoint_phase(torch, dev, steps, step_args, record)
    lap("checkpoint")
    aot_phase(torch, dev, steps, step_args, paths, record)
    lap("AOT")
    del steps, step_args
    torch.cuda.empty_cache()
    gradient_phase(torch, record)
    lap("gradient")
    examples_phase(torch, record)
    lap("examples")

    # 8. timing at the north-star sizes -------------------------------------------
    itemsize = 4
    block = NORTH_STAR_ELEMS // P
    timing = {}
    x = spread_data(torch, gen, (P, NORTH_STAR_ELEMS), dev)
    out = torch.empty_like(x)
    copy_ms = time_ms(torch, lambda: out.copy_(x))
    copy_gbps = 2 * x.numel() * itemsize / (copy_ms * 1e-3) / 1e9
    record["d2d_copy"] = {"bytes": x.numel() * itemsize, "ms": copy_ms, "GBps": copy_gbps}
    log(f"d2d copy: {copy_ms:.3f} ms, {copy_gbps:.1f} GB/s (read+write)")

    xs = x.view(P, P, block)
    xb = x[:, :block].contiguous()

    def lib_allreduce():
        out.copy_(torch.sum(x, 0).expand_as(x))

    modes = {
        "allreduce": dict(
            kernel=lambda: ring.allreduce_world(x), plain=lambda: ring.allreduce_plain(x),
            library=lib_allreduce, nbytes=2 * P * NORTH_STAR_ELEMS * itemsize,
            ops=(P - 1) * NORTH_STAR_ELEMS),
        # the rank axis of [P(ranks), P(blocks), block] is dim 0
        "reduce_scatter": dict(
            kernel=lambda: ring.reduce_scatter_world(xs),
            plain=lambda: ring.reduce_scatter_plain(xs),
            library=lambda: torch.sum(xs, 0),
            nbytes=(P * P * block + P * block) * itemsize,
            ops=(P - 1) * P * block),
        "allgather": dict(
            kernel=lambda: ring.allgather_world(xb),
            plain=lambda: ring.allgather_plain(xb),
            library=lambda: xb.repeat(P, 1, 1),
            nbytes=(P * block + P * P * block) * itemsize, ops=0),
    }
    kernels = []
    for mode, m in modes.items():
        got, want = m["kernel"](), m["plain"]()
        if not torch.equal(got, want):
            raise RuntimeError(f"{mode} kernel != plain at the north-star size")
        del got, want
        turns = {"kernel": [], "library": []}  # (one at a time, back to back)
        for _ in range(2):  # in turns: kernel, library, library, kernel
            for side in ("kernel", "library", "library", "kernel"):
                turns[side].append((time_ms(torch, m[side]), time_b2b(torch, m[side])))
        (k_ms, k_b2b), (l_ms, l_b2b) = (
            tuple(statistics.median(t[j] for t in turns[side]) for j in (0, 1))
            for side in ("kernel", "library"))
        p_ms = time_ms(torch, m["plain"])
        byte_ms = m["nbytes"] / HBM_BYTES_PER_S * 1e3
        op_ms = m["ops"] / F32_FLOPS * 1e3
        bound_ms = max(byte_ms, op_ms)
        entry = {
            "name": f"ring_{mode}", "route": "cuda", "source": SOURCE,
            "replaces": REPLACES,
            "max_abs_err": errs[mode], "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bound_ms, "bound_by": "bytes" if byte_ms >= op_ms else "operations",
            "library_ms": l_ms,
            "bytes": m["nbytes"], "GBps": m["nbytes"] / (k_ms * 1e-3) / 1e9,
            "pct_of_bound": 100.0 * bound_ms / k_ms,
            "ms_b2b": k_b2b, "library_ms_b2b": l_b2b,
            "pct_of_bound_b2b": 100.0 * bound_ms / k_b2b,
            "ms_turns": turns["kernel"], "library_ms_turns": turns["library"],
        }
        kernels.append(entry)
        fmt = lambda ts: ", ".join(f"{a:.4f}/{b:.4f}" for a, b in ts)
        log(f"{mode} (one at a time/back to back): kernel {k_ms:.4f}/{k_b2b:.4f} ms "
            f"({fmt(turns['kernel'])}), library {l_ms:.4f}/{l_b2b:.4f} ms "
            f"({fmt(turns['library'])}), plain {p_ms:.3f} ms, bound {bound_ms:.4f} ms "
            f"({entry['pct_of_bound']:.1f}/{entry['pct_of_bound_b2b']:.1f}% of bound, "
            f"{entry['GBps']:.1f} GB/s one at a time)")
    del x, out, xs, xb
    lap("ring timing")

    # 9-12a. ring attention ----------------------------------------------------
    kernels += attention_phases(torch, dev, gen, record, paths)
    torch.cuda.empty_cache()

    # 13-15. the host layer -------------------------------------------------------
    host_local_phase(torch, record)
    lap("host-local")
    host_socket_phase(torch, record)
    lap("host-socket and examples")

    # 16-18. the host layer's nonblocking engine and fault tolerance -------------
    host_nbc_phase(torch, record)
    lap("host-nbc")
    host_ft_local_phase(torch, record)
    lap("host-ft-local")
    host_ft_socket_phase(torch, record)
    lap("host-ft-socket")

    # 19-21. the host layer's correctness and observability tooling, with
    # 29 (worlds across processes) in a thread beside them ------------------------
    t_tools = time.perf_counter()
    multihost = host_multihost_start()
    host_verify_local_phase(torch, record)
    lap("host-verify-local")
    host_verify_socket_phase(torch, record)
    lap("host-verify-socket")
    host_trace_phase(torch, record)
    lap("host-trace")
    kernels += host_multihost_phase(torch, record, multihost, paths)
    lap("worlds across processes")
    record["tooling_phases_s"] = time.perf_counter() - t_tools
    log(f"phases 19-21 and 29: {record['tooling_phases_s']:.1f} s")

    # 22-23. the same-host data plane and its dispatch -----------------------------
    t_shm = time.perf_counter()
    host_compress_tune_phase(torch, record)
    lap("host-compress-tune")
    host_shm_phase(torch, record)
    lap("host-shm")
    record["data_plane_phases_s"] = time.perf_counter() - t_shm
    log(f"phases 22-23: {record['data_plane_phases_s']:.1f} s")

    # 24-28. process checkpoints, dynamic processes and files, the resident
    # world server (26 and 27 started beside 24's launches, 27 in a thread),
    # hierarchical dispatch and the flat layer, and server federation (28,
    # in threads beside 25) ------------------------------------------------
    t_flat = time.perf_counter()
    serving = host_serve_start()
    dynamic = host_dynamic_start()
    host_restart_phase(torch, record)
    lap("host-restart")
    host_dynamic_phase(torch, record, dynamic)
    lap("host-dynamic")
    host_serve_phase(torch, record, serving)
    lap("host-serve")
    federating = host_federation_start()
    host_flat_phase(torch, record)
    lap("host-flat")
    host_federation_phase(torch, record, federating)
    lap("host-federation")
    record["flat_layer_phases_s"] = time.perf_counter() - t_flat
    log(f"phases 24-28: {record['flat_layer_phases_s']:.1f} s")
    for k in kernels:  # launches: every main path's, summed
        k["launches_by_path"] = {p: c[k["name"]] for p, c in paths.items()
                                 if c.get(k["name"])}
        k["launches"] = sum(k["launches_by_path"].values())
    record["launches_by_path"] = paths
    record["kernels"] = kernels

    # 30. the evidence writer, on this run's record -------------------------------
    t_ev = time.perf_counter()
    evidence_phase(torch, record)
    record["evidence"]["phase_s"] = time.perf_counter() - t_ev
    lap("evidence")
    record["phases_s"] = time.perf_counter() - _T_START
    log(f"phases 1-30: {record['phases_s']:.2f} s (the sum of the phase walls)")

    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)
    print(record["card"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
