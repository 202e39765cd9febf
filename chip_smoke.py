#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (torchft_tpu_torch) on one GPU.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. device: the card's name and power limit, then the build of the CUDA
   kernels from torchft_tpu_torch/csrc, with ptxas's registers and spills
   per kernel and, for the flash kernels, per head_dim instantiation; a
   spill in any flash instantiation or in either codec kernel, or a ptxas
   note that it serialized ``wgmma`` instructions (C7515), fails the run.
2. kernels: each hand-written kernel against its plain PyTorch version on
   the card. The flash kernels at every head_dim they take, at the
   attention shape of the model that reaches it and at one with work
   enough to time (``FLASH_SHAPES``: "tiny" (8, 128, 4, 16) and (8, 1024,
   12, 16); (1, 128, 2, 32) and (8, 1024, 12, 32); "125m" (8, 1024, 12,
   64) and its pipeline microbatch (2, 1024, 12, 64); "1b" (1, 2048, 16,
   128)), in bf16, causal and non-causal, through
   ``flash_attention`` forward + backward and through
   ``flash_block_attention_bwd`` with external lse/Delta, within
   ``flash.KERNEL_TOL`` (each element within one bf16 ulp plus 1e-4, the
   difference's relative norm at most 1e-3, lse within 1e-5). The int8
   codec kernels (``quant_int8``, ``dequant_acc_int8``) at the 125m
   gradient size (2 rows of every parameter, f32, on the 1 MiB chunk grid,
   with a short tail chunk, an all-zero chunk and chunks holding NaN and
   Inf) bitwise: tolerance 0, NaN bit patterns included; ``quant_int8``
   also at every bucket shape of both phases of the int8 drill, and, on
   grids of 1 MiB, 4 MiB and 1000 f32, at rows of x and q that start
   unaligned, at n = 1, step - 1, step and step + 1, and with a NaN in the
   last CTA's slice of a chunk; ``dequant_acc_int8`` also at
   ``dequant_cases`` (chunk and shard boundaries and ``valid`` inside its
   16-element runs, rows off 16-byte alignment, the bucket shapes of both
   phases). Kernel, plain and
   library times (device time of a replayed CUDA graph), each wrapper's
   host time per call, and the least time the card could take (bound), at
   each timed flash shape (the ``per_head_dim`` rows); beside the two
   backward flash kernels, PyTorch's fused attention backward (dq, dk and
   dv in one call, ``library_pair_ms``); beside the codec kernels,
   their time summed over one wire step of the int8 drill at each DDP
   bucket's own size (``step_ms`` over ``step_launches`` launches) beside
   that step's bound (``step_bound_ms``). On a machine with several
   cards, every card but ``cuda:0`` then takes both codec kernels at the
   125m gradient (launched while ``cuda:0`` is current, so each wrapper
   must follow its tensor's card) and the flash kernels at "125m"'s shape,
   once each against their plain versions as above, and each kernel's
   device time there (``ms_by_card``).
3. train: the main path at the full width of the "125m" config over the
   TCP gradient wire: two replica groups under an in-process lighthouse, a
   few committed steps, a failure injected into group 1, its restart from a
   poisoned init, a heal from group 0, more commits, on a fixed schedule of
   steps. The healed parameters must equal the donor's bitwise, the losses
   must be finite, and every flash kernel must have launched once per layer
   per forward/backward pass. Then ``commit_raise``, on a line of its own:
   "125m" at full width and depth, batch 8, two solo groups under real
   Managers whose barrier RPC is held until the update dispatched, so
   ``OptimizerWrapper.step`` takes the overlapped arm (``classic_metrics``
   records dispatch before barrier); one group's ``capturable`` AdamW
   updates its first parameter group and raises
   ``torch.cuda.OutOfMemoryError``. Every parameter and AdamW state tensor
   must be bitwise restored at its address, the decision read, and the
   retried step bitwise equal to the other group's, whose update never
   raised; every flash kernel launched once per layer per pass (5 passes).
4. train_multijob: the multi-tenant control plane at "125m", full width
   and depth, batch 8, over TCP at codec none, on one lighthouse granting 2
   s epoch leases with ``fleet_capacity`` 5 (``run_multijob_drill``). Job
   "a" (priority 5): DDP groups a0 and a1 and an observer
   (``data_plane=False``) running a forward-only probe; job "b" (priority
   0, group budget 1): DDP groups b0 and b1 on the lease's fast path, step
   for step with a0. a1 fails after step 3, a0 commits 4 alone, a1
   restarts from a poisoned init and heals at 5, both commit 6-7; then hi0
   joins job "hi" (priority 10) one group over capacity, the lighthouse
   evicts b1 in its quorum answer, b0 commits 8-9 alone and hi0 2 steps.
   The native lighthouse counts every heartbeating group toward the
   capacity, the observer included, so the capacity is the five groups
   before hi0. Checks: a0 and a1 bitwise equal at every step both commit;
   a0's participants and wire world 2, and 1 alone and at the heal, never
   3; the observer in every barrier, never participating, healed or on a
   wire of more than itself, its parameters unchanged; b0 and b1 bitwise
   equal, 0 control RPCs at steps 3-6 and job b's ``membership_epoch``,
   ``quorum_compute_count`` and ``lease_breaks`` flat across them; b1
   evicted within 5 s with a ``job_preempted`` event and its parameters
   as committed, ``jobs.b`` one preemption naming b1; every flash kernel
   launched 12 x (training passes + observer passes (forward only) +
   capture warm-up passes), none of the codec kernels. It first checks the
   device memory (``multijob_device_bytes``; hi0 runs at "tiny" if it
   does not fit) and the host's (``multijob_host_bytes``); it runs before
   the phases that keep the card plane's buffers, with six models to hold.
5. train_sharded: the reference example's two remaining arms at "125m"'s
   full width, its depth cut from 12 to ``CUT_LAYERS`` = 6 to keep the
   script under 900 s, batch 8. (b) ``SHARDED=1``: three groups over TCP
   at codec none through ``ShardedOptimizerWrapper`` (reduce-scatter, a
   1/3 update with optax-order ``adamw(3e-4)``, weight decay 1e-4, a
   params allgather); g0 is killed after step 3, g1 and g2 commit 4 on a
   wire of 2 after a reshard (its ``reinit_leaves`` reported), g0 restarts
   from a poisoned init and heals at 5, its optimizer shard through
   ``fetch_opt_shard``, and the three reshard back and commit 5-7. Every
   committed step's parameters must be bitwise equal across the live
   groups, every reshard and the heal must move exactly their lower bound
   (``redist_moved_bytes == redist_lower_bound_bytes``), and steps 1-3
   must equal, bitwise, the same steps of the wrapper's replicated arm
   (``sharded=False``). (a) DDP's streamed pipeline against its lock-step
   arm: two groups on the card's int8 psum plane with error feedback, the
   same seeds and batches, 2 steps each (``SHARDED_AB_STEPS``, cut from 3
   to keep the script under 900 s); the averaged gradients and the
   residuals must be bitwise equal after every step. (c) the sharded arm on
   the same plane, two groups, 2 steps: the groups bitwise equal, and each
   codec kernel launched once per reduce_scatter (the native scatter of
   the two owned shard buckets). Every flash kernel launched 12 x the
   passes of all runs. It checks the device memory first
   (``sharded_device_bytes``) and runs before the phases that keep the
   card plane's buffers.
6. train_cuda_int8: the same drill, all 12 layers, with the gradient wire
   swapped for the on-device plane running the quantized psum
   (``comm_backend="cuda"``, ``{"algorithm": "psum", "compression":
   "int8"}``) with error feedback. Besides the checks of 3, each codec
   kernel must have launched exactly twice per gradient bucket per
   allreduce with a peer on the wire. Then the plane on the card is held
   bitwise against the plane on the CPU at each of the drill's bucket
   sizes. The phase lays itself over the visible cards, cycled (group g
   on card g mod the cards, one ``DevicePool`` over them): over two cards
   or more each rank's row is quantized on its own card, the int8 rows
   move to each owner's card and the result back to every card, so each
   codec kernel launches world + cards times per bucket op
   (``codec_launches``), and the plane over the cards is also held bitwise
   against the plane on one card at each bucket size.
7. train_tiny: the drill of 3 over TCP at "tiny" (head_dim 16), full width
   and depth, batch 8: the example's default config, on the card.
8. gpt_1b: one forward/backward of "1b" (24 layers, d_model 2048, 16 heads
   of 128, seq 2048, activation checkpointing on) at batch 1, at full width
   and depth. The checkpointing recomputes each block's forward in the
   backward: 48 forward, 24 dQ and 24 dK/dV launches. The loss must lie
   within ``LOSS_TOL`` and a sample of gradients within ``GRAD_REL_NORM``
   of the same model whose attention runs ``reference_attention`` on the
   card.

9. train_diloco: BASELINE config 4's shape, the DiLoCo example
   (``run_diloco_drill``) at "125m", full width and depth, batch 8: two
   groups over TCP at codec none, ``sync_every=8``, 2 streaming fragments,
   outer ``sgd(0.7, momentum=0.9, nesterov=True)``, inner AdamW (3e-4,
   weight decay 0.1, betas 0.9/0.95) as one CUDA graph a step. Both commit
   rounds 1-2; group 1 is killed at inner step 4 of round 3, which group 0
   commits alone; group 1 restarts from a poisoned init and heals at round
   4's fence; both commit rounds 4-5. After every round both commit, their
   parameters and outer states must be bitwise equal (the healed group
   equal to its donor), the losses finite, and every flash kernel launched
   12 x (inner steps + capture warm-up passes) times. It prints the outer
   sync's phase p50s and gauges, the round times and the heal.
10. train_localsgd_int8: BASELINE config 3's shape, LocalSGD at "125m"'s
   full width, its depth cut to ``CUT_LAYERS`` = 6 to keep the script
   under 900 s, batch 8, four groups on the on-device plane
   (``comm_backend="cuda"``, psum, int8, error feedback on),
   ``sync_every=8``, 2 fragments. Every group commits round 1; in round 2
   group 3's second fragment op fails after its collective ran (its round
   aborts and every fragment returns bitwise to its backup; the others
   commit it); group 3 heals at round 3's quorum and all four commit it.
   After every round, the groups that commit it must be bitwise equal, and
   each codec kernel must have launched exactly twice per fragment op with
   a peer. Round 1's fragment averages on the card must equal the same
   plane on the CPU bitwise. It first checks the host's free memory
   (``localsgd_host_bytes``). The four groups lie over the visible cards,
   cycled, as in train_cuda_int8.
11. train_hier_int8: the hierarchical data plane at "125m"'s full width,
   its depth cut to ``CUT_LAYERS`` = 6 to keep the script under 900 s,
   batch 8: four groups in two domains (``HIER_DOMAINS``: rack0 =
   {g0, g1}, rack1 = {g2, g3}) over ``TcpCommContext(algorithm="star",
   compression="int8", topology="hier")``, 4 lanes, 1 MiB chunks, DDP with
   error feedback, each group's domain resolved through a
   ``DomainTopology`` over the drill's domain tree. Steps 1-3 joint; group
   2, rack1's egress, is killed; steps 4-5 commit with rack1 = {g3} (its
   egress, no intra tier); g2 restarts from a poisoned init, heals at 6;
   7-8 joint. All live groups must be bitwise equal at every committed
   step; each life's ``comm_inter_bytes`` must be non-zero only on its
   egress steps and equal ``codec_wire_nbytes`` of its contribution,
   ``comm_intra_bytes`` zero in a singleton domain, ``comm_hops`` 4 per
   op in a two-member domain and 2 in a singleton; ``ddp_ef`` only on the
   compensable roles (rack1's egress); step 2's bucket ops of every group
   bitwise equal to the port's ``_host_hier_allreduce`` of the recorded
   contributions. Then, at each distinct bucket size, the card plane's
   hier arms in the same 2x2 layout: ``CudaCommContext(topology="hier",
   compression="int8")`` with "star" bitwise equal to the TCP hier path and
   to ``DevicePool("cpu")``, with "psum" identical on every rank and within
   ``HIER_PSUM_TOL`` x absmax of the f64 sum; the codec kernels must have
   launched 3 times each per distinct size (star 2, psum 1). It first
   checks the host's free memory (``hier_host_bytes``).
12. train_durable: the reference training loop whole, at "125m"'s full
   width, its depth cut to ``CUT_LAYERS`` = 6 to keep the script under
   900 s (the fused-vs-eager check after it stays at full depth), batch
   8, over TCP under a lighthouse granting 2 s epoch
   leases (``run_resume_drill``): group 0 commits 3 steps alone, each a
   fused step replaying one CUDA graph; group 1 starts from a poisoned
   init and heals; both commit 4 steps together, the steady ones on the
   lease's fast path (0 control RPCs; a GET /telemetry/metrics during one
   must show the lease live and 0 RPCs); every group writes an
   ``AsyncCheckpointWriter(keep=2)`` checkpoint every 2 steps; both are
   killed once the last write persisted, restart from a poisoned init and
   resume from their newest checkpoint, which the resumed step,
   parameters, AdamW state and sampler position must equal bitwise; both
   commit 2 more steps. The healed and resumed groups must be bitwise
   equal at every step both commit, the losses finite, and every flash
   kernel launched once per layer per pass, graph replays (the capture's
   tally) and the capture's warm-up passes included. It first checks the
   disk (``durable_disk_bytes``, 6.7 GB at 6 layers) and fails if short.
   Then the fused step against the same step run eagerly, bitwise after 3
   steps, and the device time of each.

13. train_moe (it runs after train_sharded, before the phases that keep
   the card plane's buffers): the reference's ``examples/train_moe.py`` at
   "moe-8x125m" at full width, its depth cut from 12 to ``CUT_LAYERS`` =
   6 to keep the script under 900 s (192,714,240 parameters; 6 layers of
   the 125m backbone, 8 top-2 experts with capacity factor 1.25 on every
   other layer, activation checkpointing on), batch 8 x 1024,
   over TCP at codec none, AdamW (3e-4, weight decay 1e-4):
   ``run_moe_drill``, two replica groups of two ranks each, every rank
   holding the whole model (the reference's expert axis of width 1).
   Group 0 commits step 1 alone; group 1 joins and heals at 2; both commit
   2-3; group 1's two ranks fail, group 0 commits 4 alone; they restart
   from a poisoned init and each heals at 5 through
   ``recv_checkpoint_sharded`` from group 0's rank of its number, the
   stripes spread over both of group 0's ranks (peers from the group
   store); both commit 5-6 (cut from 5-7 to keep the script under 900
   s). Every live rank's parameters and AdamW state
   must be bitwise equal at every committed step, both donor ranks must
   have served bytes of the second heal, the losses must be finite, and
   the flash kernels must have launched per layer per pass twice forward
   (the checkpointing's recompute) and once each backward. It prints each
   healer rank's ``heal_wall_ms``, ``heal_bytes_per_s``, wire bytes and
   upload p50, the bytes each donor rank served, the state's size and the
   step phases' p50s. It first checks the device memory
   (``moe_device_bytes``) and the host's (``moe_host_bytes``).

14. train_diloco_sharded (it runs after train_diloco): DiLoCo's outer
   update sharded by fragment (``sharded_outer=True``) at "125m"'s full
   width, its depth cut from 12 to ``CUT_LAYERS`` = 6 layers to
   keep the script under 900 s (93,605,376 parameters), batch 8 x 1024:
   three groups as threads over loopback
   TCP at codec none, group 2's wire in a ``SubprocessCommContext`` child
   (``check_comm_child`` first shows such a child holds no CUDA context),
   ``sync_every=8``, 3 fragments, outer ``sgd(0.7, momentum=0.9,
   nesterov=True)``, a wire timeout of ``DILOCO_WIRE_TIMEOUT``. First the
   replicated arm (``sharded_outer=False``) for rounds 1-2 on the same
   seeds. Then the schedule: rounds 1-2 all three, each group holding
   exactly fragment ``f % 3 == rank``, bitwise equal to the replicated
   arm; group 2 killed at inner step 4 of round 3 (its child gone with
   it), groups 0 and 1 commit round 3 at world 2 after a reshard that
   reinitializes f2 on its new owner only; group 2 restarts from a
   poisoned init with a new child, heals at round 4's quorum, and the
   fence's exchange gives it f2's momentum bitwise as its holder
   committed it (every reshard moving exactly its lower bound, no
   reinit); at round 5's fence group 2's child is SIGSTOPped with a
   fragment op in flight, every group's round aborts and rolls back
   (parameters at the backup, outer states as the fence left them),
   every group reconfigures and the stopped child is SIGKILLed and
   replaced; all three commit the retried round and round 6. After every
   committed round the live groups hold each fragment's momentum exactly
   once; every flash kernel launched 6 x the passes of both arms. It
   prints the five checks, per group and life the p50s of ``outer_d2h``,
   ``outer_wire``, ``outer_land`` and ``reshard``, the ``reshard``
   events, round seconds, the heal's wall and GB/s, the drill's seconds
   and the device memory peak. It first checks the host's memory
   (``diloco_sharded_host_bytes``) and the device's
   (``diloco_sharded_device_bytes``).

15. train_llama_ring (it runs after gpt_1b): the reference's
   ``examples/train_llama_ring.py`` at "llama_120m" (125,848,320
   parameters; 12 layers, d_model 768, 12 query heads of 64 over 4 K/V
   heads, d_ff 2048, vocab 32768, activation checkpointing on), full width
   and depth, ``max_seq_len`` 4,096, the loss over 8 vocab chunks, batch
   2, its attention the causal flash-block ring (``parallel/ring.py``)
   over a ``seq`` axis of 4 virtual shards on the card, so each (q, kv)
   pair is (2, 1024, 12, 64). First the three flash kernels
   at that shape against their plain versions, causal and full, and each
   timed per call in each mode. Then one forward/backward of one model
   and batch through the flash ring, the einsum ring and the unsharded
   model (``causal_attention``): each ring's loss within ``LOSS_TOL`` and
   a sample of gradients (``llama_grad_sample``) within ``GRAD_REL_NORM``
   of the unsharded one's. At random init any attention gives a loss near
   ln(32768), so the loss is a sanity check and the gradient sample (the
   first layer's q and k projections among it) the check of the ring.
   Then a second pass of each, one thread alone on the card, timed, and
   one more of the flash ring and of the unsharded model under
   ``torch.profiler`` (``profile_pass``): the device's busy ms (its
   kernels and copies) beside the pass's wall, and the host ops that
   take the most time.
   Then ``run_llama_ring_drill``, with the launch counts set to 0 just
   before it: two groups over TCP at codec none, AdamW (3e-4) in optax's
   order; group 1 fails after step 3, group 0 commits 4 alone, group 1
   restarts from a poisoned init and heals at 5, both commit 5-7. Both
   groups' parameters and AdamW state must be bitwise equal at every step
   both commit, the losses finite, each flash kernel launched exactly as
   the ring schedule says (per layer per pass n(n+1)/2 = 10 pairs at n =
   4, 4 causal and 6 full; each backward kernel once a pair, the forward
   twice under remat) and no codec kernel. It prints the step p50s
   (``quorum``, ``forward_backward``, ``ddp_wire``), committed tokens/s,
   the heal's wall and rate, the launches per pass and their summed
   device time beside ``forward_backward``, the device memory peak and
   the phase's seconds. It first checks the host's memory
   (``llama_ring_host_bytes``) and the device's
   (``llama_ring_device_bytes``). The shards share the card, so no
   transfer overlaps compute: the ring's schedule, launches and numerics
   are measured, its link is not.

16. train_hsdp (it runs after train_llama_ring): the reference's
   ``examples/train_hsdp.py`` at "1b"'s full width, its depth cut from 24
   to ``CUT_LAYERS`` = 6 layers to keep the script under 900 s
   (440,455,168 parameters; d_model 2048, 16 heads of 128, d_ff 8192,
   vocab 32768, seq 2048, activation checkpointing on, the loss over 8
   vocab chunks a shard), batch 8, each replica group's GPT
   sharded over a virtual mesh ``{"fsdp": 2, "tensor": 2}`` of the card
   (``models.transformer.ShardedGPT``: the batch over fsdp, fsdp gathers
   inside the remat region, Megatron's column and row splits, the
   vocab-parallel loss), so each position calls the flash kernels at (4,
   2048, 8, 128). First the three kernels at that shape against their
   plain versions and timed, beside their bound and SDPA. Then a parity
   pass: one forward/backward of the same weights and batch through the
   sharded model and the unsharded GPT; the loss within ``LOSS_TOL`` and
   ``GRAD_SAMPLE`` within ``GRAD_REL_NORM``. Then ``run_hsdp_drill``, with
   the launch counts set to 0 just before it: two groups over TCP at codec
   none, AdamW (3e-4) in optax's order stepped on the pieces; group 1
   fails after its 2nd commit, group 0 commits 3 alone, group 1 restarts
   from a poisoned init (its model, optimizer and staged state released
   first) and heals into its sharded template at 4, fetching only its
   pieces' bounds; both commit 4-5 (cut from 7 steps to keep the script
   under 900 s). Every piece (parameters and both
   moments) of each group must equal the other's bitwise at every step
   both commit, every healed leaf must carry the healer's sharding, the
   heal's wire bytes must equal its state's (no region fetched twice),
   the losses finite, the flash kernels launched per pass 2 x 24 forward
   and 24 of each backward (6 layers x 4 positions, remat) and no codec
   kernel. It prints the step p50s (``quorum``, ``forward_backward``,
   ``ddp_wire``), committed steps and tokens/s, the heal's wall and rate,
   the bytes of pieces per position, the flash kernels' device ms per
   pass beside ``forward_backward``, and the device memory peak. It first
   checks the host's memory (``hsdp_host_bytes``) and the device's
   (``hsdp_device_bytes``).

17. train_moe_expert (it runs after train_hsdp): the reference's
   ``examples/train_moe.py`` with its expert axis, at "moe-8x125m" at full
   width, its depth cut from 12 to ``CUT_LAYERS`` = 6 to keep the script
   under 900 s (192,714,240 parameters; remat on, 8 experts, capacity
   factor 1.25), batch 8 x 1024, each replica group's model a
   ``ShardedMoETransformer`` over a virtual mesh ``MOE_EXPERT_AXES`` =
   ``{"expert": 4, "data": 2}`` of the card (the reference test's mesh):
   the experts' ``up``/``down`` split 2 a position by ``moe_rules()``, the
   router whole, the batch split over data x expert (one sequence a
   position, so the flash kernels run at (1, 1024, 12, 64)), the routing
   global, the tokens dispatched to their experts' positions and combined
   back. First the three flash kernels at that shape against their plain
   versions and timed, beside their bound and SDPA. Then a parity pass:
   one forward/backward of the same weights and batch through the sharded
   model and the width-1 ``MoETransformer``; the loss within ``LOSS_TOL``
   and ``MOE_GRAD_SAMPLE`` within ``GRAD_REL_NORM``, each timed warm alone.
   Then ``run_moe_drill(axes=MOE_EXPERT_AXES)``, with the launch counts
   set to 0 just before it: two groups of one rank over TCP at codec none,
   AdamW (3e-4) in optax's order stepped on the pieces; group 1 fails
   after its 2nd commit, group 0 commits 3 alone, group 1 restarts from a
   poisoned init and heals into its expert-sharded template at 4; both
   commit 4-5 (cut from 7 steps to keep the script under 900 s). Every
   piece of both groups bitwise at every step both
   commit, every healed leaf in the healer's sharding, the heal's wire
   bytes the state's, finite losses, the flash kernels launched per pass 2
   x 96 forward and 96 of each backward (12 layers x 8 positions, remat),
   no codec kernel. It prints what train_hsdp prints. It first checks the
   host's memory (``hsdp_host_bytes``) and the device's
   (``moe_expert_device_bytes``).

18. train_resnet: BASELINE config 2, the twin of the reference's
   ResNet-18 kill-and-heal test (``run_resnet_drill``) at full width
   (11,173,962 parameters), 32x32x3 synthetic batches of 64 drawn from the
   seed, two groups over TCP at codec none, SGD (0.05, momentum 0.9),
   ``cudnn.deterministic`` on, ``cudnn.benchmark`` and TF32 off: group 1
   fails after step 2, group 0 commits 3 alone, group 1 restarts from a
   poisoned init (seed 99) and heals at 4, re-running its forward on the
   healed state before the update, as the reference; both commit 4-6.
   The parameters, running statistics and momentum buffers of both groups
   must be bitwise equal at every step both commit, the heal's wire bytes
   the state's, the losses finite, and no flash or codec kernel launched.
   It prints the heal's wall and rate, the step p50s and the drill's
   seconds.

19. train_pp (it runs after train_moe_expert): the twin of the
   reference's tests/test_integration_pp.py at "125m" (136,091,136
   parameters; 12 layers, heads of 64, seq 1024, no activation
   checkpointing), full width and depth, batch 8: each replica group's
   GPT (``pipelined_gpt``) pipelined over a virtual ``PP_AXES`` =
   ``{"stage": 4}`` mesh of the card, stage s running layers 3s..3s+2
   through ``models.transformer._block`` from stage-stacked leaves split
   on dim 0 over "stage", the batch in ``PP_MICROBATCHES`` = 4 GPipe
   microbatches of 2 sequences (``parallel.make_pipeline``; the flash
   kernels at (2, 1024, 12, 64)), the embeddings, ln_f and the head
   replicated outside the pipeline. First a parity pass: one
   forward/backward of the same weights and batch through the pipelined
   and the unpipelined GPT, the loss within ``LOSS_TOL`` and the gradient
   sample within ``GRAD_REL_NORM``, each timed warm alone. Then
   ``run_pp_drill`` with the launch counts set to 0 just before it: two
   groups of one rank over TCP at codec none, AdamW (3e-4) in optax's
   order on the pieces; group 1 fails after its 3rd commit, group 0
   commits 4 alone, group 1 restarts from a poisoned init and heals into
   its stage-split template at 5; both commit 5-7. Every piece and AdamW
   moment of both groups bitwise at every step both commit, every healed
   leaf in the healer's sharding (the stage leaves split over "stage",
   each piece on its position), the heal's wire bytes the state's,
   finite losses, each flash kernel launched M x 12 = 48 times a pass
   (only the schedule's filled slots run a stage), no codec kernel. Then,
   at the drill's initial weights, ``make_pipeline_1f1b`` and
   ``make_pipeline_interleaved_1f1b`` (V = 3, one layer a virtual stage)
   against GPipe with autograd, the embedding's output fed in detached:
   every stage gradient within ``PP_SCHEDULE_TOL``, 1F1B's peak stored
   inputs equal to ``peak_inflight_activations``. It prints what
   train_hsdp prints and checks the memory first (``pp_device_bytes``,
   ``hsdp_host_bytes``).

20. pipeline_plane: the port's MPMD stage plane (``pipeline.Pipeline``)
   on the card at ``PLANE``: 4 stages x 2 replicas, 8 microbatches of
   1,024 rows (a "125m" sequence's tokens), ``layer_dims`` (768,) * 13
   (three layers a stage; an f32 activation frame is 3 MiB), the stage
   compute as torch ops on the card. The reference's own oracles: for
   each codec in none, bf16 and int8 with error feedback, streaming 1F1B
   against stage-serial GPipe, sha256-equal at every step; the schedule
   rebuilt from each replica's events (``reconstruct_pipe_schedule``)
   equal to its lane's projection of ``expected_stage_sequence`` at every
   step; a kill of stage 1's second replica two actions into a step under
   ``on_kill="heal"`` (0 drained steps, a replay wave, the heal's
   ``redist_moved_bytes`` = ``redist_lower_bound_bytes`` = the stage's
   bytes) and under ``"drain"`` (the full tree moved); one ``rebalance``,
   bitwise against a control that never rebalanced. It prints step
   seconds per arm, frame bytes a step, the heal's ms and bytes; no
   flash or codec kernel may launch.

21. fused_step (it runs after pipeline_plane): the fused HSDP step
   (``fused.FusedStepEngine``) at "125m" (136,091,136 parameters as one
   flat f32 vector, ``fused.module_loss_fn`` over the GPT) on
   ``FUSED_MESH`` = 2x2 (replicas x model shards) laid over the visible
   cards, cycled (position d on ``cuda:{d % cards}``; it prints its layout
   first): on one card a virtual mesh, on several one position a card,
   each program one CUDA graph spanning the cards: q_len
   34,022,784, p_len 68,045,568, each position a microbatch of 2
   sequences of 1,024 (a row of 2,048 f32 token ids, targets rolled),
   AdamW (3e-4, weight decay 1e-4), the 16,384-element chunk grid. First
   the unsharded GPT's gradient of step 1's 8 sequences; then, with the
   launch counts set to 0, for each codec in none, bf16 and int8 + EF a
   fused engine (one CUDA graph a step) and a staged one (four graphs, 6
   host hops: 4.35 GB a step) from the same state, 3 steps each: every
   state bitwise equal after every step, 1 dispatch and 0 hops a fused
   step, 4 and 6 a staged one, 5 programs and 1 + 4 captures at first
   sight and none after. Codec none: ``h`` at the staged arm's host hop,
   assembled in (m, r) order, against the unsharded gradient
   (``GRAD_REL_NORM``), the loss within ``LOSS_TOL``; then 2 steps of
   each arm in one ``StepProfiler`` window, the device's busy share per
   arm. Int8: step 2's ``h`` and residual bitwise the host codec on the
   same ``gm``; then both engines churn 2x2 -> 4x1 -> 2x2 -> 4x1, a step
   each, bitwise, ``verify_replicas``, no program or capture at a seen
   shape. Over several cards, then, for each codec 3 fused steps on the
   virtual 2x2 of cuda:0 from the same state and batches, whose digest
   must equal the cards' digest after their 3 steps. Each flash kernel
   launches once per layer per position per run of the grad stage (a
   replay or the warm-up before a capture), each int8 exchange one
   ``quant_int8`` and two ``dequant_acc_int8`` a card holding positions
   (``fused_launches``). It prints device ms (CUDA events) and wall ms per
   step of each arm, the bytes a step moves between cards
   (``fused_cross_card_bytes``), the peak memory of the fullest card
   beside its reckoning (``fused_device_bytes``), each with the card's
   name and power limit.

22. serve_deploy (it runs after train_resnet): the train-to-serve plane
   (``serve.py``) fed by the 125m trainer, full width and depth, batch 8
   (``run_serve_drill``). One lighthouse holds two jobs: "train", one
   group of the ``train`` phase's model, and "serve", a
   ``ServeCohort(SERVE_MEMBERS, replication=2)`` whose members hold their
   shards on the card (125 units, one a parameter: 544,364,544 bytes). A
   seeded closed-loop request stream runs through ``cohort.answer`` for
   the whole drill. The trainer commits 6 steps; ``Manager.set_commit_hook``
   records each committed step, and at steps 2, 4 and 6 it publishes its
   parameters after the update (``DeployPublisher``: one D2H host copy,
   staged at ``step == version``). Deploy v2; kill member 1 and let the
   trainer commit 3-4 through it (the serve job's ``membership_epoch``
   must move); deploy v4 to the survivors under traffic; ``rejoin_member
   (1)`` from serve peers; ``grow()`` to 5; deploy v6, the union
   transition. Checks: every adoption moves exactly its lower bound; v2
   moves 2 x the model, v4 2 x the model less member 1's shard, which the
   rejoin moves from peers alone (``deploy_train_bytes`` flat); every live
   member's per-unit digests, read back from the card, equal the
   publication's; ``serve_dropped`` 0, ``serve_stale_reads`` 0 summed over
   the members, ``serve_reroutes`` > 0; every answer within
   ``SERVE_ANSWER_TOL`` x sum |unit| x |x| of the float64 sum of the
   published leaf; the router's and members' ``/telemetry`` counters equal
   their ``Metrics``; each flash kernel launched once per layer per
   trainer pass, no codec kernel. It prints, per deploy, the wall time,
   the moved bytes and their lower bound, the answers per second, the peak
   device memory and the card.

23. train_proc (it runs before train_durable): replica groups as real OS
   processes (``examples.train_ddp.run_process_drill``) at "125m"'s full
   width, its depth cut to ``CUT_LAYERS`` = 6 to make room for
   train_churn, batch 8, over TCP at codec none: two groups, each
   spawned (never forked: this process holds a CUDA context) with the
   environment ``launcher.hsdp_spec`` writes for it (manager ports 29600
   + i, store ports 29700 + i, when free), under a lighthouse in this
   process. Both commit 1-3; group 0 begins step 4 and is SIGKILLed (its
   manager server, store, checkpoint server, sockets and CUDA context
   together); group 1 latches, commits 4-5 alone and waits in its commit
   hook for the relaunch; group 0 relaunches as a fresh process from a
   poisoned init on the same ports, heals from group 1 over HTTP at 6,
   and both commit 6-9. Group 0 (both lives) commits by
   ``OptimizerWrapper``'s decide-first arm (``donate_update=True``),
   group 1 by the default overlapped one (the update beside the barrier
   behind a backup). Checks: the parameter digests equal at every step
   two lives commit (so the two arms bitwise, across the kill and the
   heal); the relaunch's first commit after step 3 and healed;
   no two-participant commit of group 1 in the dead window; finite
   losses; each life's flash launches (counted in the child) 6 x its
   passes, none in this process; the card's free memory back within 1
   GiB once the victim is reaped (of its value before the groups less
   the survivor's share) and after the drill; each child's peak within
   ``proc_child_bytes`` (one parameters + gradients + AdamW footprint, its
   activations and graph pools) and at rest after every commit at most
   one footprint; each classic commit's update rise (the most allocated
   in the update's window beyond its start) under 8 bytes a parameter in
   the decide-first lives, and the survivor's largest at least 12 (its
   backup); and the kill-to-heal lifecycle read from the flight
   recordings alone, which the survivor and the relaunch each fetch over
   HTTP from their own ``/telemetry/events`` and ``/telemetry/metrics``
   (found through the group store's ``checkpoint_addr_0``) before their
   managers go down (``train_ddp.check_lifecycle``): on the survivor a
   two-wire quorum, then ``member_dead`` naming group 0's first life (its
   replica id from its "started" message) at a higher epoch, a later
   quorum, commits after the death and a two-wire quorum again; on the
   relaunch ``heal_start`` before ``heal_done`` at an epoch no lower than
   the death's, then a commit beyond step 3, every event stamped with its
   replica id and rank 0; the survivor's ``steps_committed`` at least 9
   and a finite ``allreduce_p50_ms``; the two recordings one valid Chrome
   trace. It prints the kill-to-heal timeline (reap, survivor
   latch, member_dead, solo commits, the relaunch's spawn, CUDA init,
   kernel load and model build, the heal's bytes and seconds, the first
   joint commit), the lifecycle (the epochs, heal start and done, the
   first resumed commit, the event counts, the trace), the memory
   readings and each life's figures. It first checks the
   device memory (``train_proc_device_bytes``) and the host's
   (``proc_host_bytes``).
24. dryrun_multichip: ``graft_entry.dryrun_multichip(8)`` on 8 positions
   (the count ``__graft_entry__.py`` runs), virtual on one card and laid
   over the visible cards, cycled, where there are several: the dp x fsdp x
   tp step of ``ShardedGPT`` at "tiny" and the vocab-parallel cross
   entropy, the flash ring over seq 8 (shards of 64 tokens), the
   expert-parallel MoE block and the MoE transformer over tensor 2 x
   expert 4, GPipe, 1F1B and interleaved 1F1B over 8 stages, each within
   ``graft_entry.DRYRUN_TOL`` of its unsharded counterpart, and the FT
   loop (2 groups of 2 ranks of 2 positions, a spare, an observer, a kill
   and a sharded heal); each segment's flash launches as
   ``dryrun_launches`` says. Then ``graft_entry.entry()`` at "125m": its
   logits against the same model with ``reference_attention`` (the loss
   within ``LOSS_TOL``, the logits within ``GRAD_REL_NORM``) and the
   forward's time.
25. train_churn (it runs after train_localsgd_int8, before
   train_hier_int8): repeated kills while the job commits
   (``examples.train_ddp.run_churn_drill``, the twin of the reference's
   churn test) at "125m", full width and depth, batch 8. (a) Five groups,
   one thread each, over TCP at codec none under a lighthouse with
   ``min_replicas`` 3 until every group has committed 10 steps; group 1
   is killed after step 2 and again after step 6, group 3 after step 4;
   each restarts from a poisoned init once the survivors have committed a
   step without it and heals from a live peer in the next quorum. (b) Two
   groups on the card plane (``INT8_OPTIONS``, a wire timeout of
   ``CHURN_WIRE_TIMEOUT``), 6 steps: group 0 latches its own wire at the
   start of step 4 with the membership unchanged, both discard that step,
   the latched group bumps its ``comm_epoch`` and both wires reconfigure.
   Checks (``train_ddp.check_churn``): each kill fired once; at every step
   two lives commit, their parameter digests equal; finite losses; a
   group never killed commits at least 6 of 10 steps and a killed one at
   least 3; each restarted life heals in its first commit; every dead
   life's parameters are freed once its group restarts, and the device
   memory allocated after each heal, read with every group between
   steps, is at most its value at the kill's last commit plus one model's
   parameters; in (b) 3 commits of each group after the latch and the
   latched group's ``comm_epoch`` at least 1. Each flash kernel launched
   12 x the passes of every life of both arms, each codec kernel
   ``codec_launches`` per DDP bucket per committed step of (b). It prints
   each kill's timeline (the survivors' first commit without the dead
   group, the restart, its heal's start and end, its first commit), the
   heal's bytes and GB/s, the memory, each group's commits, the committed
   tokens/s before the first kill and over the run (the gated drill's
   pace, its meetings and holds included), and the latched group's
   epochs. It first checks the device memory
   (``churn_device_bytes``) and the host's. Over several cards group g
   lies on card g mod cards in both arms.

Each of train_cuda_int8, train_localsgd_int8 and dryrun_multichip first
prints its layout: the cards it uses, the positions on each, and the
``nvidia-smi topo -m`` link between them (with CUDA's peer access, which
the copies between cards take).

After the phases it prints each phase's wall seconds (from its header to
the next's; the kernels' build under "device"), then a ``kernels`` JSON
line before the last line, and ends with
``{"ok": true, "device": {...}}``. It needs one card and no network; on
a machine with several it lays the phases above over them.
"""

from __future__ import annotations

import argparse
import functools
import gc
import json
import math
import os
import subprocess
import sys
import time

# Published H100 SXM peaks (NVIDIA data sheet, dense): the bound column.
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12

_TPU_KERNELS = {
    "flash_fwd": "torchft_tpu/ops/flash.py:54 _flash_kernel, "
                 "torchft_tpu/ops/flash.py:104 _flash_streamed_kernel",
    "flash_bwd_dq": "torchft_tpu/ops/flash.py:277 _flash_bwd_dq_kernel, "
                    "torchft_tpu/ops/flash.py:352 _flash_bwd_dq_streamed_kernel",
    "flash_bwd_dkv": "torchft_tpu/ops/flash.py:311 _flash_bwd_dkv_kernel, "
                     "torchft_tpu/ops/flash.py:391 _flash_bwd_dkv_streamed_kernel",
    "quant_int8": "torchft_tpu/comm/xla_backend.py:592 _pallas_quant_kernel",
    # no TPU kernel: the reference leaves the owner-side decode to XLA
    "dequant_acc_int8": "none (XLA ops in torchft_tpu/comm/xla_backend.py:727 "
                        "reduce_int8)",
}
_SOURCES = {
    "flash_fwd": "torchft_tpu_torch/csrc/flash_fwd.cu",
    "flash_bwd_dq": "torchft_tpu_torch/csrc/flash_bwd_dq.cu",
    "flash_bwd_dkv": "torchft_tpu_torch/csrc/flash_bwd_dkv.cu",
    "quant_int8": "torchft_tpu_torch/csrc/quant_int8.cu",
    "dequant_acc_int8": "torchft_tpu_torch/csrc/quant_int8.cu",
}
CHUNK_BYTES = 1 << 20  # the gradient plane's chunk grid (1 MiB of f32)
INT8_OPTIONS = {"algorithm": "psum", "compression": "int8"}


def log(msg: str) -> None:
    print(msg, flush=True)


# each phase run so far and its start on the script's clock, in order
PHASE_STARTS: list = []


def begin_phase(name: str) -> None:
    """Print the phase's header and mark its start: the script closes with
    each phase's seconds (``phase_seconds``)."""
    PHASE_STARTS.append((name, time.perf_counter()))
    log(f"phase {name}")


def phase_seconds(starts: list, end: float) -> dict:
    """Each phase's wall seconds, from its start to the next phase's (the
    last to ``end``), the kernels' build in "device"."""
    ends = [t for _, t in starts[1:]] + [end]
    return {name: e - t for (name, t), e in zip(starts, ends)}


# the depth of the phases cut to keep the script under 900 s at full
# width: train_sharded, train_moe, train_hsdp, train_moe_expert,
# train_diloco_sharded, train_localsgd_int8, train_hier_int8,
# train_durable and, to make room for train_churn, train_proc
CUT_LAYERS = 6


def cut_depth(cfg, layers: int = CUT_LAYERS):
    """``cfg`` with at most ``layers`` layers: a phase's depth cut, which
    leaves a config already that shallow (the CPU tests' "tiny") as it
    is."""
    import dataclasses

    return dataclasses.replace(cfg, n_layers=min(cfg.n_layers, layers))


# How every time of the kernels line was taken; each row carries it.
TIMED_BY = ("ms, plain_ms, library_ms, library_pair_ms, step_ms: device time "
            "by CUDA events around the replay of a CUDA graph of the calls "
            "(host work per call left out); host_us: the host's clock per "
            "call issued back to back")


def cuda_ms(fn, iters: int = 100, warmup: int = 10, repeats: int = 3) -> float:
    """Device ms per call of ``fn``: after ``warmup`` calls, ``iters`` calls
    are captured once into a CUDA graph, and CUDA events around each of
    ``repeats`` replays give a mean; the median of those. The replay leaves
    out the host's work per call, so the shared host's speed does not enter
    (``host_us`` measures that part). A capture failure raises."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    # captured on a stream of the current card: torch's default capture
    # stream is made once, on the card current at its first use
    with torch.cuda.graph(graph, stream=torch.cuda.Stream()):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    means = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        means.append(start.elapsed_time(end) / iters)
    del graph
    torch.cuda.empty_cache()
    return sorted(means)[len(means) // 2]


def host_us(fn, iters: int = 100, repeats: int = 3) -> float:
    """Host microseconds per call of ``fn``: the host's clock around
    ``iters`` calls issued back to back (their launches queue on the card
    without a wait), the median of ``repeats`` such means."""
    import torch

    fn()
    means = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        means.append((time.perf_counter() - t0) / iters * 1e6)
    torch.cuda.synchronize()
    return sorted(means)[len(means) // 2]


def attention_bound_ms(b: int, s: int, h: int, d: int, causal: bool,
                       products: int, n_bf16_io: int, n_f32_rows: int):
    """(bound ms, "bytes" or "operations") of an attention function with
    ``products`` S x S x D matrix products over the attended (q, k) pairs,
    ``n_bf16_io`` [B, S, H, D] bf16 tensors read or written once and
    ``n_f32_rows`` [B, H, S] f32 vectors."""
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = products * 2.0 * d * pairs * b * h
    nbytes = n_bf16_io * b * s * h * d * 2 + n_f32_rows * b * h * s * 4
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


# ptxas names the kernels by their mangled symbols
_KERNEL_SYMBOLS = {
    "flash_fwd": "flash_fwd_kernel",
    "flash_bwd_dq": "flash_bwd_dq_kernel",
    "flash_bwd_dkv": "flash_bwd_dkv_kernel",
    "quant_int8": "quant_int8_kernel",
    "dequant_acc_int8": "dequant_acc_int8_kernel",
}
FLASH_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
HEAD_DIMS = (16, 32, 64, 128)  # the flash kernels' instantiations
# every instantiation of the Hopper-redesigned kernels
_NO_SPILL = tuple(f"{n}/d{d}" for n in FLASH_KERNELS for d in HEAD_DIMS) + (
    "quant_int8", "dequant_acc_int8")


def _report_key(symbol: str):
    """The report's key for a mangled kernel symbol: the kernel's name,
    with ``/d<D>`` for an instantiation at head size D (``...ILi64E...``),
    or None for a symbol of no kernel here."""
    import re

    for name, sym in _KERNEL_SYMBOLS.items():
        i = symbol.find(sym)
        if i >= 0:
            m = re.match(r"ILi(\d+)E", symbol[i + len(sym):])
            return f"{name}/d{m.group(1)}" if m else name
    return None


def ptxas_report(build_log: str):
    """{kernel: {"registers", "spill_stores", "spill_loads"}} from the
    ptxas lines of the build, one entry per instantiation of a templated
    kernel (``flash_fwd/d64``), plus its warnings and performance notes (a
    wgmma serialized by the compiler is one)."""
    import re

    report, warnings, current = {}, [], None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            current = _report_key(m.group(1))
            continue
        if "warning" in line.lower() or "Performance Loss" in line:
            warnings.append(line.strip())
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            report.setdefault(current, {}).update(
                spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            report.setdefault(current, {})["registers"] = int(m.group(1))
    return report, warnings


def spill_failures(report):
    """The kernels (instantiations) of _NO_SPILL that spill, or that ptxas
    did not report."""
    return [n for n in _NO_SPILL
            if report.get(n, {}).get("spill_stores", 1)
            or report.get(n, {}).get("spill_loads", 1)]


def serialized_notes(notes):
    """The ptxas notes that it serialized wgmma instructions (C7515): a
    wgmma in a branch it cannot prove warpgroup-uniform, math drifting past
    ``wgmma.fence``, or a group in flight across a loop's back-edge."""
    return [n for n in notes if "C7515" in n]


def card() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()


def visible_cards() -> list:
    """``cuda:0`` .. ``cuda:n-1``, the cards this process sees."""
    import torch

    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def cycled(cards: list, positions: int) -> list:
    """Position p on ``cards[p % len(cards)]``."""
    return [cards[p % len(cards)] for p in range(positions)]


def topo_links(text: str) -> dict:
    """{(i, j): link} between GPU i and GPU j from ``nvidia-smi topo -m``'s
    matrix (``NV18``, ``SYS``, ``PIX``, ...): its first GPU row is the
    header, each later one a card's links; {} when it holds none."""
    header, links = None, {}
    for line in text.splitlines():
        cols = line.split()
        if not cols or not cols[0].startswith("GPU") \
                or not cols[0][3:].isdigit():
            continue
        if header is None:
            header = [int(c[3:]) for c in cols
                      if c.startswith("GPU") and c[3:].isdigit()]
            continue
        for j, link in zip(header, cols[1:]):
            links[(int(cols[0][3:]), j)] = link
    return links


def layout_line(positions: list) -> str:
    """The cards a phase uses, the positions on each and the link between
    every two of them: ``nvidia-smi topo -m``'s, or what it said when it
    could not read the matrix, beside CUDA's peer access."""
    import torch

    cards = sorted({d.index for d in positions})
    count = {i: sum(d.index == i for d in positions) for i in cards}
    line = (f"layout: {len(positions)} positions over {len(cards)} "
            f"card(s): " + ", ".join(f"cuda:{i} x{count[i]}" for i in cards))
    if len(cards) < 2:
        return line + "; no link crossed"
    topo = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True,
                          text=True)
    links = topo_links(topo.stdout) if topo.returncode == 0 else {}
    said = (topo.stdout + topo.stderr).strip().splitlines()
    pairs = []
    for a in cards:
        for b in cards:
            if a < b:
                peer = torch.cuda.can_device_access_peer(a, b)
                pairs.append(f"cuda:{a}-cuda:{b} "
                             f"{links.get((a, b), 'unknown')} "
                             f"(peer access {'yes' if peer else 'no'})")
    note = "" if links else (f"; nvidia-smi topo -m: "
                             f"{said[0] if said else topo.returncode}")
    return line + "; links " + ", ".join(pairs) + note


def codec_launches(world: int, positions: list) -> int:
    """Launches of each codec kernel per int8 quantized psum op of a wire
    of ``world`` ranks whose rank r lies on ``positions[r]``: 2 on one card
    (phase 1 over all rows, phase 2 over all shards); over several cards
    one a card and one a shard (quant_int8: each card's rows, each owner's
    shard; dequant_acc_int8: each owner's sum, each card's final decode)."""
    cards = len({d.index for d in positions[:world]})
    return 2 if cards == 1 else world + cards


def phase_device():
    import torch

    smi = card()
    log(f"nvidia-smi: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    from torchft_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load_kernels()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s")
    report, warnings = ptxas_report(_build.build_log)
    for name in sorted(report):
        log(f"  ptxas {name:18s} {report[name]}")
    for w in warnings:
        log(f"  ptxas {w}")
    spilled = spill_failures(report)
    if spilled:
        raise AssertionError(f"ptxas: {spilled} spill or were not reported: "
                             f"{report}")
    serialized = serialized_notes(warnings)
    if serialized:
        raise AssertionError(f"ptxas serialized wgmma: {serialized}")
    return smi, report


def _check(name: str, got, want, what: str, failed: list) -> float:
    """Hold a kernel's result against its plain version's under
    flash.KERNEL_TOL; note a failure and return the max abs error."""
    from torchft_tpu_torch.ops import flash

    e = flash.kernel_error(got, want)
    log(f"  {name:14s} {what:28s} max_abs_err {e['max_abs_err']:.3e} "
        f"worst/tol {e['worst']:.3f} rel_norm {e['rel_norm']:.3e} "
        f"{'ok' if e['ok'] else 'FAIL'}")
    if not e["ok"]:
        failed.append(f"{name} {what}")
    return e["max_abs_err"]


FLASH_SHAPE = (8, 1024, 12, 64)  # "125m": batch 8, seq 1024, 12 heads of 64
# (what, [B, S, H, D], timed): the flash kernels at each head_dim they
# take, at the attention shape of the model that reaches it and at one
# with work enough to time; a head_dim's first timed shape fills its
# per_head_dim row, a later one goes to the row's "also_timed"
FLASH_SHAPES = (
    ("tiny", (8, 128, 4, 16), False),
    ("head_dim 16", (8, 1024, 12, 16), True),
    ("head_dim 32", (1, 128, 2, 32), False),
    ("head_dim 32", (8, 1024, 12, 32), True),
    ("125m", FLASH_SHAPE, True),
    ("125m pipeline microbatch", (2, 1024, 12, 64), True),
    ("1b", (1, 2048, 16, 128), True),
)


def flash_inputs(seed: int, shape=FLASH_SHAPE):
    """q, k, v and dO: bf16 [B, S, H, D] on the card at ``shape``."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn(shape, generator=gen, device="cuda",
                             dtype=torch.float32).to(torch.bfloat16)
                 for _ in range(4))


def check_flash(q, k, v, do) -> dict:
    """Hold the three flash kernels against their plain versions on q, k,
    v, dO, causal and non-causal: through ``flash_attention`` forward +
    backward, ``flash_attention_with_lse`` and ``flash_block_attention_bwd``
    with external lse/Delta, under ``flash.KERNEL_TOL``. Returns each
    kernel's max abs error; raises if any result disagrees."""
    import torch

    from torchft_tpu_torch.ops import flash

    scale = 1.0 / q.shape[-1] ** 0.5
    errs = {n: 0.0 for n in flash.LAUNCHES}
    failed = []

    def check(name, got, want, what):
        errs[name] = max(errs[name], _check(name, got, want, what, failed))

    log(f"  tolerance: {flash.KERNEL_TOL}")
    for causal in (True, False):
        tag = "causal" if causal else "full"
        # plain reference: forward, Delta, backward on the same inputs
        p_out, p_lse = flash.flash_fwd_plain(q, k, v, causal, scale, 128, 128)
        p_delta = (do.float() * p_out.float()).sum(-1).transpose(1, 2)
        p_delta = p_delta.contiguous()
        p_dq = flash.flash_bwd_dq_plain(q, k, v, do, p_lse, p_delta, causal,
                                        scale, 128, 128)
        p_dk, p_dv = flash.flash_bwd_dkv_plain(q, k, v, do, p_lse, p_delta,
                                               causal, scale, 128, 128)
        # the kernels through flash_attention forward + backward
        qg, kg, vg = (x.clone().requires_grad_(True) for x in (q, k, v))
        out = flash.flash_attention(qg, kg, vg, causal=causal)
        out.backward(do)
        _, k_lse = flash.flash_attention_with_lse(q, k, v, causal=causal)
        torch.cuda.synchronize()
        check("flash_fwd", out, p_out, f"{tag} out")
        check("flash_fwd", k_lse, p_lse, f"{tag} lse")
        # autograd's backward kernels took the forward kernel's lse and its
        # out's Delta: the plain backward gets the same inputs
        a_delta = (do.float() * out.float()).sum(-1).transpose(1, 2)
        a_delta = a_delta.contiguous()
        a_dq = flash.flash_bwd_dq_plain(q, k, v, do, k_lse, a_delta, causal,
                                        scale, 128, 128)
        a_dk, a_dv = flash.flash_bwd_dkv_plain(q, k, v, do, k_lse, a_delta,
                                               causal, scale, 128, 128)
        check("flash_bwd_dq", qg.grad, a_dq, f"{tag} autograd dq")
        check("flash_bwd_dkv", kg.grad, a_dk, f"{tag} autograd dk")
        check("flash_bwd_dkv", vg.grad, a_dv, f"{tag} autograd dv")
        # the backward kernels with external lse / Delta
        dq, dk, dv = flash.flash_block_attention_bwd(
            q, k, v, do, p_lse, p_delta, causal)
        torch.cuda.synchronize()
        check("flash_bwd_dq", dq, p_dq, f"{tag} external-stats dq")
        check("flash_bwd_dkv", dk, p_dk, f"{tag} external-stats dk")
        check("flash_bwd_dkv", dv, p_dv, f"{tag} external-stats dv")
    if failed:
        raise AssertionError(f"kernels disagree with their plain versions: "
                             f"{failed}")
    return errs


def flash_calls(q, k, v, do) -> dict:
    """{kernel: its wrapper's call as the main path makes it}: causal, the
    backward kernels with the forward kernel's lse and its out's Delta."""
    from torchft_tpu_torch.ops import flash

    scale = 1.0 / q.shape[-1] ** 0.5
    out, lse = flash.flash_fwd(q, k, v, True, scale)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    return {
        "flash_fwd": lambda: flash.flash_fwd(q, k, v, True, scale),
        "flash_bwd_dq": lambda: flash.flash_bwd_dq(q, k, v, do, lse, delta,
                                                   True, scale),
        "flash_bwd_dkv": lambda: flash.flash_bwd_dkv(q, k, v, do, lse, delta,
                                                     True, scale),
    }


def time_flash(q, k, v, do) -> dict:
    """{kernel: times} of the three flash kernels at q's shape, called as
    the main path calls them (causal; the backward kernels with the
    forward kernel's lse and its out's Delta): device ms, host µs per call,
    the plain version's ms, the bound, PyTorch's
    ``scaled_dot_product_attention`` forward beside the forward kernel
    (``library_ms``) and its fused backward (dq, dk and dv in one call)
    beside the two backward kernels (``library_pair_ms``)."""
    import torch
    import torch.nn.functional as F

    from torchft_tpu_torch.ops import flash

    b, s, h, d = q.shape
    scale = 1.0 / d ** 0.5
    calls = flash_calls(q, k, v, do)
    out, lse = calls["flash_fwd"]()
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    timing = {
        "flash_fwd": (
            lambda: flash.flash_fwd_plain(q, k, v, True, scale, 128, 128),
            lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True),
            attention_bound_ms(b, s, h, d, True, 2, 4, 1),
        ),
        "flash_bwd_dq": (
            lambda: flash.flash_bwd_dq_plain(q, k, v, do, lse, delta, True,
                                             scale, 128, 128),
            None,
            attention_bound_ms(b, s, h, d, True, 3, 5, 2),
        ),
        "flash_bwd_dkv": (
            lambda: flash.flash_bwd_dkv_plain(q, k, v, do, lse, delta, True,
                                              scale, 128, 128),
            None,
            attention_bound_ms(b, s, h, d, True, 4, 6, 2),
        ),
    }
    rows = {}
    for name, (plain, lib, (bound, bound_by)) in timing.items():
        ms = cuda_ms(calls[name])
        us = host_us(calls[name])
        plain_ms = cuda_ms(plain, iters=3, warmup=1, repeats=1)
        lib_ms = cuda_ms(lib) if lib is not None else None
        rows[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                      "bound_by": bound_by, "library_ms": lib_ms,
                      "host_us": us}
        log(f"  {name:14s} kernel {ms:.4f} ms  host {us:.1f} us/call  "
            f"plain {plain_ms:.4f} ms  library "
            f"{lib_ms if lib_ms is None else round(lib_ms, 4)} ms  "
            f"bound {bound:.4f} ms ({bound_by})")
    # yardstick beside the two backward kernels: the fused backward of
    # PyTorch's own flash attention (dq, dk and dv in one call), against
    # which the pair's sum compares. Autograd replays into a CUDA graph only
    # with its forward inside the capture, so the backward is timed as
    # forward + backward less the forward.
    qr, kr, vr = (x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v))
    dot = do.transpose(1, 2)
    both_ms = cuda_ms(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(qr, kr, vr, is_causal=True),
        (qr, kr, vr), dot))
    bwd_ms = both_ms - rows["flash_fwd"]["library_ms"]
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        rows[name]["library_pair_ms"] = bwd_ms
    log(f"  yardstick: scaled_dot_product_attention backward (dq, dk, dv) "
        f"{bwd_ms:.4f} ms (forward + backward in one graph, less the "
        f"forward) against flash_bwd_dq + flash_bwd_dkv "
        f"{rows['flash_bwd_dq']['ms'] + rows['flash_bwd_dkv']['ms']:.4f} ms")
    return rows


def phase_kernels(seed: int, ptxas: dict):
    """The flash kernels checked at every shape of FLASH_SHAPES and timed
    at the timed ones: a row per kernel with the "125m" shape's times and
    a ``per_head_dim`` row per instantiation (its checked shapes, largest
    error, times at its timed shape, ptxas report and, filled in by the
    training phases, its launches on the main path)."""
    import torch

    per_d = {n: {} for n in FLASH_KERNELS}
    top = {}
    for what, shape, timed in FLASH_SHAPES:
        d = shape[3]
        log(f"  flash kernels at {what} {shape}")
        q, k, v, do = flash_inputs(seed, shape)
        errs = check_flash(q, k, v, do)
        for name in FLASH_KERNELS:
            row = per_d[name].setdefault(d, {
                "head_dim": d, "checked": [], "max_abs_err": 0.0,
                "launches": 0, "ptxas": ptxas.get(f"{name}/d{d}")})
            row["checked"].append(list(shape))
            row["max_abs_err"] = max(row["max_abs_err"], errs[name])
        if timed:
            times = time_flash(q, k, v, do)
            for name in FLASH_KERNELS:
                row = per_d[name][d]
                if "shape" in row:
                    row.setdefault("also_timed", []).append(
                        {"what": what, "shape": list(shape), **times[name]})
                else:
                    row.update(shape=list(shape), **times[name])
            if shape == FLASH_SHAPE:
                top = times
        del q, k, v, do
        torch.cuda.empty_cache()
    return {name: {
        "name": name, "route": "cuda", "source": _SOURCES[name],
        "replaces": _TPU_KERNELS[name], "launches": 0,
        "max_abs_err": max(r["max_abs_err"] for r in per_d[name].values()),
        "shape": list(FLASH_SHAPE), **top[name], "timed_by": TIMED_BY,
        "ptxas": ptxas.get(f"{name}/d{FLASH_SHAPE[3]}"),
        "per_head_dim": [per_d[name][d] for d in HEAD_DIMS],
    } for name in FLASH_KERNELS}


def _bits(t):
    import torch

    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _max_abs_err(got, want) -> float:
    """Largest |got - want| over the elements finite in both (0 when the
    two agree bit for bit)."""
    import torch

    g, w = got.double(), want.double()
    ok = torch.isfinite(g) & torch.isfinite(w)
    return float((g - w).abs()[ok].max()) if bool(ok.any()) else 0.0


CHUNK_STEP = CHUNK_BYTES // 4  # f32 elements of a chunk


class Bitwise:
    """Bitwise checks of codec results: logs each, keeps every kernel's
    largest finite difference, and raises from ``raise_failed`` if any
    check failed."""

    def __init__(self):
        self.errs = {"quant_int8": 0.0, "dequant_acc_int8": 0.0}
        self.failed = []

    def __call__(self, name, what, got, want) -> None:
        import torch

        same = torch.equal(_bits(got), _bits(want))
        self.errs[name] = max(self.errs[name], _max_abs_err(got, want))
        log(f"  {name:16s} {what:36s} bitwise {'ok' if same else 'FAIL'}")
        if not same:
            self.failed.append(f"{name} {what}")

    def raise_failed(self) -> None:
        if self.failed:
            raise AssertionError(f"codec kernels disagree with their plain "
                                 f"versions: {self.failed}")


def quant_cases(step: int, seed: int, device: str, sizes=()):
    """[(what, x, q, s)]: inputs of ``quant_int8`` at the shapes its kernel
    must handle, with the output views to quantize them into. Rows of x
    with a stride of 1 mod 4 elements (rows start off 16-byte alignment)
    and q a column slice of a wider int8 buffer (rows start on odd bytes);
    n = 1, step - 1, step and step + 1; a NaN in the last eighth of a chunk
    (the last CTA's slice) beside a clean chunk; and, per DDP bucket size
    in ``sizes``, the quantized psum's two calls over two groups: phase 1
    on [2, size] into q[:, :size] of a [2, 2 L] buffer, phase 2 on the
    reduced shards, a [2, L] view of a flat vector."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(rows, n):
        return torch.randn((rows, n), generator=gen, device=device) * 1e-3

    def outs(rows, n, q=None):
        if q is None:
            q = torch.zeros((rows, n), dtype=torch.int8, device=device)
        return q, torch.empty((rows, -(-n // step)), device=device)

    n = 4 * step + 37
    x = randn(3, n + (1 - n) % 4 + 4)[:, :n]  # row stride = 1 mod 4
    wide = torch.zeros((3, n + 3), dtype=torch.int8, device=device)
    cases = [("unaligned rows of x and q", x,
              *outs(3, n, wide[:, 1:1 + n]))]
    for n in sorted({1, max(1, step - 1), step, step + 1}):
        cases.append((f"n = {n}", randn(2, n), *outs(2, n)))
    x = randn(2, 2 * step + 5)
    x[1, 2 * step - 3] = float("nan")  # near chunk 1's end
    cases.append(("NaN in a chunk's last slice", x, *outs(2, 2 * step + 5)))
    for size in sorted(set(sizes)):
        L = -(-size // 2)
        q = torch.zeros((2, 2 * L), dtype=torch.int8, device=device)
        cases.append((f"bucket {size} phase 1", randn(2, size),
                      *outs(2, size, q[:, :size])))
        cases.append((f"bucket {size} phase 2", randn(1, 2 * L).view(2, L),
                      *outs(2, L)))
    return cases


def dequant_cases(step: int, seed: int, device: str, sizes=()):
    """[(what, q, scales, kwargs)]: inputs of ``dequant_acc_int8`` (and its
    keyword arguments) where its 16-element runs meet a boundary: a grid
    whose step is no multiple of 16 (chunk boundaries inside runs),
    per-shard grids whose shard length is no multiple of 16 (segment
    boundaries inside runs), ``valid`` inside a run, rows of q that start
    off 16-byte alignment (a view at byte 3 of a wider buffer, rows of
    another phase than row 0's), fewer elements than a run; and, per DDP
    bucket size in ``sizes``, the quantized psum's two decodes over two
    groups (phase 1: the [2, 2 L] padded rows, AVG; phase 2: the reduced
    shards as one row on per-shard grids) and phase 1 with its rows
    starting at byte 1."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)

    def q_rows(rows, n, offset=0, pad=0):
        buf = torch.randint(-127, 128, (rows * (n + pad) + offset,),
                            generator=gen, device=device,
                            dtype=torch.int32).to(torch.int8)
        return buf[offset:].view(rows, n + pad)[:, :n]

    def scales(rows, chunks):
        return torch.rand((rows, chunks), generator=gen, device=device) * 1e-2

    n = 3 * step + 37
    L = step + 21  # a shard length no multiple of 16
    cps = -(-L // step)
    cases = [
        ("step inside runs, AVG", q_rows(2, n), scales(2, -(-n // step)),
         dict(valid=n, divisor=2)),
        ("rows off 16-byte alignment, valid inside a run",
         q_rows(3, n, offset=3, pad=5), scales(3, -(-n // step)),
         dict(valid=n - 7, divisor=3)),
        ("shard grid, seg inside runs", q_rows(1, 3 * L),
         scales(1, 3 * cps), dict(valid=3 * L - 10, seg=L, cps=cps)),
        ("fewer elements than a run", q_rows(1, 9, offset=5), scales(1, 1),
         dict(valid=9)),
    ]
    for size in sorted(set(sizes)):
        L = -(-size // 2)
        c1, c2 = -(-size // step), -(-L // step)
        cases += [
            (f"bucket {size} phase 1", q_rows(2, 2 * L), scales(2, c1),
             dict(valid=size, divisor=2)),
            (f"bucket {size} phase 2", q_rows(1, 2 * L), scales(1, 2 * c2),
             dict(valid=size, seg=L, cps=c2)),
            (f"bucket {size} phase 1, rows at byte 1",
             q_rows(2, 2 * L, offset=1), scales(2, c1),
             dict(valid=size, divisor=2)),
        ]
    return cases


def codec_inputs(seed: int):
    """The 125m gradient of two groups, x f32 [2, n_params] on the card,
    with an all-zero chunk, a NaN chunk and an Inf chunk on the 1 MiB
    grid; and the drill's DDP bucket sizes."""
    import torch

    from torchft_tpu_torch.models import CONFIGS, GPT
    from torchft_tpu_torch.ops import quant

    params = list(GPT(CONFIGS["125m"], device="meta").parameters())
    n_params = sum(p.numel() for p in params)
    sizes = bucket_sizes(params)
    rows, step = 2, CHUNK_STEP
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((rows, n_params), generator=gen, device="cuda") * 1e-3
    x[0, step:2 * step] = 0.0             # an all-zero chunk: scale 1
    x[0, 2 * step + 5] = float("nan")     # poisons its own chunk only
    x[1, 3 * step + 17] = float("inf")
    chunks = quant.n_chunks(n_params, step)
    log(f"  codec input: {rows} x {n_params} f32 (the 125m gradient), "
        f"{chunks} chunks of {step} per row, tail "
        f"{n_params - (chunks - 1) * step}")
    return x, sizes


def codec_calls(x) -> dict:
    """{kernel: its wrapper's call at the 125m gradient x as the int8 plane
    makes it}: the phase-1 quantize of both rows into the first columns of
    a padded [2, 2 L] buffer, and the owner decode-accumulate of both
    sources."""
    import torch

    from torchft_tpu_torch.ops import quant

    rows, n = x.shape
    step = CHUNK_STEP
    L = -(-n // rows)
    q = torch.zeros((rows, rows * L), dtype=torch.int8, device="cuda")
    s = torch.empty((rows, quant.n_chunks(n, step)), device="cuda")
    acc = torch.empty(rows * L, device="cuda")
    quant.quant_int8(x, step, out=(q[:, :n], s))
    return {
        "quant_int8": lambda: quant.quant_int8(x, step, out=(q[:, :n], s)),
        "dequant_acc_int8": lambda: quant.dequant_acc_int8(
            q, s, step, valid=n, out=acc),
    }


def check_codec(x, sizes, seed: int, check) -> None:
    """Both codec kernels against their plain versions at the 125m
    gradient x through the quantized psum's four calls, the special
    chunks' scales, then quant_int8 at every shape of quant_cases on the
    1 MiB grid, on a grid of 1000 (chunks starting off alignment) and on a
    4 MiB grid (chunks longer than a cluster holds), and dequant_acc_int8
    at every shape of dequant_cases on the 1 MiB grid and on a grid of
    1000."""
    import torch

    from torchft_tpu_torch.ops import quant

    rows, n = x.shape
    step = CHUNK_STEP
    L = -(-n // rows)
    q = torch.zeros((rows, rows * L), dtype=torch.int8, device="cuda")
    s = torch.empty((rows, quant.n_chunks(n, step)), device="cuda")
    quant.quant_int8(x, step, out=(q[:, :n], s))
    pq, ps = quant.quant_int8_plain(x, step)
    torch.cuda.synchronize()
    check("quant_int8", "phase-1 q", q[:, :n], pq)
    check("quant_int8", "phase-1 scales", s, ps)
    if not (s[0, 1] == 1.0 and torch.isnan(s[0, 2]) and torch.isnan(s[1, 3])
            and bool(torch.isfinite(s[1, :3]).all())):
        check.failed.append("quant_int8 special chunks (zero, NaN, Inf)")
    del pq, ps
    acc = quant.dequant_acc_int8(q, s, step, valid=n)
    p_acc = quant.dequant_acc_int8_plain(q, s, step, valid=n)
    torch.cuda.synchronize()
    check("dequant_acc_int8", "owner sums (2 sources)", acc, p_acc)
    del p_acc
    c2 = quant.n_chunks(L, step)
    q2, s2 = quant.quant_int8(acc.view(rows, L), step)
    pq2, ps2 = quant.quant_int8_plain(acc.view(rows, L), step)
    out = quant.dequant_acc_int8(q2.view(1, -1), s2.view(1, -1), step,
                                 valid=n, seg=L, cps=c2)
    p_out = quant.dequant_acc_int8_plain(q2.view(1, -1), s2.view(1, -1),
                                         step, valid=n, seg=L, cps=c2)
    torch.cuda.synchronize()
    check("quant_int8", "phase-2 q (shard grid)", q2, pq2)
    check("quant_int8", "phase-2 scales", s2, ps2)
    check("dequant_acc_int8", "final decode (shard grid)", out, p_out)
    del q, s, acc, q2, s2, out, pq2, ps2, p_out
    for grid, sz in ((step, sizes), (1000, ()), (4 * step, ())):
        for what, xc, qc, sc in quant_cases(grid, seed, "cuda", sz):
            quant.quant_int8(xc, grid, out=(qc, sc))
            pq, ps = quant.quant_int8_plain(xc, grid)
            torch.cuda.synchronize()
            check("quant_int8", f"step {grid}, {what}: q", qc, pq)
            check("quant_int8", f"step {grid}, {what}: scales", sc, ps)
    for grid, sz in ((step, sizes), (1000, ())):
        for what, qc, sc, kw in dequant_cases(grid, seed, "cuda", sz):
            got = quant.dequant_acc_int8(qc, sc, grid, **kw)
            want = quant.dequant_acc_int8_plain(qc, sc, grid, **kw)
            torch.cuda.synchronize()
            check("dequant_acc_int8", f"step {grid}, {what}", got, want)
    torch.cuda.empty_cache()


def check_other_cards(seed: int, cards: list) -> dict:
    """Every card but ``cuda:0``, once each: both codec kernels at the 125m
    gradient, launched with ``cuda:0`` current (each wrapper follows its
    tensor's card), bitwise against their plain versions there; the flash
    kernels at "125m"'s shape (``check_flash``); and each kernel's device
    time on that card (``cuda_ms`` at the calls of ``codec_calls`` and
    ``flash_calls``). Returns {card: {kernel: ms}}."""
    import torch

    from torchft_tpu_torch.ops import quant

    out = {}
    for dev in cards[1:]:
        log(f"  kernels on {dev} ({torch.cuda.get_device_name(dev)})")
        check = Bitwise()
        with torch.cuda.device(0):
            gen = torch.Generator(device=dev).manual_seed(seed)
            n = sum(p.numel() for p in _gpt_125m_params())
            x = torch.randn((2, n), generator=gen, device=dev) * 1e-3
            q, s = quant.quant_int8(x, CHUNK_STEP)
            pq, ps = quant.quant_int8_plain(x, CHUNK_STEP)
            acc = quant.dequant_acc_int8(q, s, CHUNK_STEP)
            p_acc = quant.dequant_acc_int8_plain(q, s, CHUNK_STEP)
            torch.cuda.synchronize(dev)
            check("quant_int8", "q", q, pq)
            check("quant_int8", "scales", s, ps)
            check("dequant_acc_int8", "owner sums (2 sources)", acc, p_acc)
            del q, s, pq, ps, acc, p_acc
        check.raise_failed()
        with torch.cuda.device(dev):
            times = {name: cuda_ms(fn) for name, fn in codec_calls(x).items()}
            del x
            q4 = flash_inputs(seed, FLASH_SHAPE)
            check_flash(*q4)
            times.update({name: cuda_ms(fn)
                          for name, fn in flash_calls(*q4).items()})
            del q4
            torch.cuda.empty_cache()
        log(f"  {dev}: " + ", ".join(f"{k} {v:.4f} ms"
                                      for k, v in times.items()))
        out[str(dev)] = times
    return out


def _gpt_125m_params() -> list:
    from torchft_tpu_torch.models import CONFIGS, GPT

    return list(GPT(CONFIGS["125m"], device="meta").parameters())


def phase_quant_kernels(seed: int):
    """The int8 codec kernels bitwise against their plain versions (see
    check_codec), then timed at the 125m gradient and per wire step."""
    import torch

    from torchft_tpu_torch.ops import quant

    x, sizes = codec_inputs(seed)
    check = Bitwise()
    check_codec(x, sizes, seed, check)
    check.raise_failed()

    # times at the main path's shapes: the phase-1 quantize of both rows
    # and the owner decode-accumulate of both sources
    rows, n_params = x.shape
    step = CHUNK_STEP
    chunks = quant.n_chunks(n_params, step)
    L = -(-n_params // rows)
    n_el = rows * n_params
    q_bytes = n_el * 4 + n_el * 1 + rows * chunks * 4
    d_bytes = rows * rows * L * 1 + rows * chunks * 4 + rows * L * 4
    calls = codec_calls(x)
    q = torch.zeros((rows, rows * L), dtype=torch.int8, device="cuda")
    s = torch.empty((rows, chunks), device="cuda")
    quant.quant_int8(x, step, out=(q[:, :n_params], s))
    timing = {  # yardsticks: PyTorch calls that move the same bytes
        "quant_int8": (
            lambda: quant.quant_int8_plain(x, step),
            lambda: q[:, :n_params].copy_(x),
            "q.copy_(x) (f32 -> int8)", q_bytes),
        "dequant_acc_int8": (
            lambda: quant.dequant_acc_int8_plain(q, s, step,
                                                 valid=n_params),
            lambda: torch.sum(q, 0, dtype=torch.float32),
            "torch.sum(q, 0, dtype=float32)", d_bytes),
    }
    out_rows = {}
    for name, (plain, yard, yard_what, nbytes) in timing.items():
        ms = cuda_ms(calls[name])
        us = host_us(calls[name], iters=20)
        plain_ms = cuda_ms(plain, iters=3, warmup=1, repeats=1)
        yard_ms = cuda_ms(yard)
        bound = nbytes / PEAK_BYTES_PER_S * 1e3
        out_rows[name] = {
            "name": name, "route": "cuda", "source": _SOURCES[name],
            "replaces": _TPU_KERNELS[name], "launches": 0,
            "max_abs_err": check.errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": "bytes", "library_ms": None,
            "host_us": us, "timed_by": TIMED_BY,
        }
        log(f"  {name:16s} kernel {ms:.4f} ms  host {us:.1f} us/call  "
            f"plain {plain_ms:.4f} ms  "
            f"bound {bound:.4f} ms (bytes, {nbytes / 1e6:.1f} MB)  "
            f"yardstick {yard_what} {yard_ms:.4f} ms")
    del x, q, s, calls
    torch.cuda.empty_cache()
    bounds = codec_step_bound_ms(sizes)
    for name, (ms, launches) in codec_step_ms(sizes, seed, check).items():
        out_rows[name].update(step_ms=ms, step_launches=launches,
                              step_bound_ms=bounds[name])
        log(f"  {name:16s} per wire step {ms:.4f} ms, bound "
            f"{bounds[name]:.4f} ms (bytes)")
    check.raise_failed()
    return out_rows


def bucket_sizes(params):
    """Element counts of the DDP buckets the drill's gradients fill."""
    from torchft_tpu_torch.ddp import _DEFAULT_BUCKET_BYTES, _BucketPlan

    plan = _BucketPlan(params, _DEFAULT_BUCKET_BYTES)
    return [sum(plan.sizes[i] for i in b) for b in plan.buckets]


def codec_step_bound_ms(sizes, n: int = 2):
    """{kernel: ms}: the least time the card could take for each codec
    kernel's launches in one wire step of the int8 drill (n groups): the
    bytes they must move over the card's memory rate, summed at each DDP
    bucket's own shapes. quant_int8 reads 4 B and writes 1 B an element in
    both phases (the n x size gradients, then the n x L reduced shards),
    plus 4 B a chunk; dequant_acc_int8 reads n B and writes 4 B an element
    of the n L padded sums in phase 1, reads 1 B and writes 4 B in phase
    2, plus the scales it reads."""
    step = CHUNK_STEP
    nbytes = {"quant_int8": 0, "dequant_acc_int8": 0}
    for size in sizes:
        L = -(-size // n)
        c1, c2 = -(-size // step), -(-L // step)
        nbytes["quant_int8"] += n * size * 5 + n * L * 5 + n * (c1 + c2) * 4
        nbytes["dequant_acc_int8"] += (n * L * (n + 4) + n * L * 5
                                       + n * (c1 + c2) * 4)
    return {k: b / PEAK_BYTES_PER_S * 1e3 for k, b in nbytes.items()}


def codec_step_ms(sizes, seed: int, check):
    """{kernel: (ms, launches)}: each codec kernel's time summed over one
    step of the int8 drill with a wire peer, two groups, at the shapes its
    launches have there: per DDP bucket (``sizes``) one phase-1 launch over
    both groups' rows and one phase-2 launch over the reduced shards (the
    quantized psum of comm/cuda_backend.py), at each bucket's own size.
    Each bucket's four calls are first held bitwise against the plain
    versions through ``check`` (a Bitwise)."""
    import torch

    from torchft_tpu_torch.ops import quant

    n, step = 2, CHUNK_STEP
    gen = torch.Generator(device="cuda").manual_seed(seed)
    total = {"quant_int8": 0.0, "dequant_acc_int8": 0.0}
    for size in sorted(set(sizes)):
        count = sizes.count(size)
        L = -(-size // n)
        c1, c2 = quant.n_chunks(size, step), quant.n_chunks(L, step)
        x = torch.randn((n, size), generator=gen, device="cuda") * 1e-3
        q = torch.zeros((n, n * L), dtype=torch.int8, device="cuda")
        s = torch.empty((n, c1), device="cuda")
        acc = torch.empty(n * L, device="cuda")
        q2 = torch.empty((n, L), dtype=torch.int8, device="cuda")
        s2 = torch.empty((n, c2), device="cuda")
        out = torch.empty(n * L, device="cuda")
        calls = {  # phase 1, phase 2
            "quant_int8": (
                lambda: quant.quant_int8(x, step, out=(q[:, :size], s)),
                lambda: quant.quant_int8(acc.view(n, L), step, out=(q2, s2))),
            "dequant_acc_int8": (
                lambda: quant.dequant_acc_int8(q, s, step, valid=size,
                                               divisor=n, out=acc),
                lambda: quant.dequant_acc_int8(
                    q2.view(1, n * L), s2.view(1, n * c2), step, valid=size,
                    seg=L, cps=c2, out=out)),
        }
        tag = f"bucket {size}"
        calls["quant_int8"][0]()
        pq, ps = quant.quant_int8_plain(x, step)
        check("quant_int8", f"{tag} phase-1 q", q[:, :size], pq)
        check("quant_int8", f"{tag} phase-1 scales", s, ps)
        calls["dequant_acc_int8"][0]()
        check("dequant_acc_int8", f"{tag} phase-1 sums", acc,
              quant.dequant_acc_int8_plain(q, s, step, valid=size,
                                           divisor=n))
        calls["quant_int8"][1]()
        pq, ps = quant.quant_int8_plain(acc.view(n, L), step)
        check("quant_int8", f"{tag} phase-2 q", q2, pq)
        check("quant_int8", f"{tag} phase-2 scales", s2, ps)
        calls["dequant_acc_int8"][1]()
        check("dequant_acc_int8", f"{tag} phase-2 decode", out,
              quant.dequant_acc_int8_plain(
                  q2.view(1, n * L), s2.view(1, n * c2), step, valid=size,
                  seg=L, cps=c2))
        del pq, ps
        times = {name: cuda_ms(fns[0]) + cuda_ms(fns[1])
                 for name, fns in calls.items()}
        for name, ms in times.items():
            total[name] += count * ms
        log(f"  codec at a bucket of {size} f32 (x{count} per step): "
            f"quant_int8 {times['quant_int8']:.4f} ms, dequant_acc_int8 "
            f"{times['dequant_acc_int8']:.4f} ms (phase 1 + phase 2)")
        del x, q, s, acc, q2, s2, out, calls
    torch.cuda.empty_cache()
    log(f"  codec per wire step ({len(sizes)} buckets, 2 launches each): "
        f"quant_int8 {total['quant_int8']:.4f} ms, dequant_acc_int8 "
        f"{total['dequant_acc_int8']:.4f} ms")
    return {name: (ms, 2 * len(sizes)) for name, ms in total.items()}


def phase_train(config: str, steps: int, layers, seed: int, card: str,
                comm_backend: str = "host", comm_options=None,
                devices=None):
    """Run the drill at CONFIGS[config] on the card (or group g on
    ``devices[g % len(devices)]``); return the flash kernels' launches (one
    per layer per forward/backward pass) and the result."""
    import dataclasses

    from torchft_tpu_torch.examples.train_ddp import run_kill_and_heal
    from torchft_tpu_torch.models import CONFIGS

    cfg = CONFIGS[config]
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    batch = 8
    log(f"  {config}: vocab {cfg.vocab_size} d_model {cfg.d_model} layers "
        f"{cfg.n_layers} heads {cfg.n_heads} (head_dim {cfg.head_dim}) d_ff "
        f"{cfg.d_ff} seq {cfg.max_seq_len} xent_chunks {cfg.xent_chunks}, "
        f"batch {batch}, gradient wire {comm_backend} {comm_options or ''}")
    t0 = time.perf_counter()
    place = dict(device="cuda") if devices is None else dict(devices=devices)
    result = run_kill_and_heal(cfg, kill_step=steps, steps_after=steps - 1,
                               batch_size=batch, seed=seed, **place,
                               timeout=120.0, log=lambda m: log("  " + m),
                               comm_backend=comm_backend,
                               comm_options=comm_options)
    wall = time.perf_counter() - t0
    runs, heal = result["runs"], result["heal_step"]
    log(f"  group 1 healed at step {heal}; parameters bitwise equal to "
        f"group 0 at steps {result['checked_steps']}; {wall:.1f} s")
    for g, run in runs.items():
        times = ", ".join(f"{s}: {t * 1e3:.1f}"
                          for s, t in sorted(run.step_seconds.items()))
        log(f"  group {g} step ms {{{times}}}")
    phases = ("quorum", "forward_backward", "ddp_d2h", "ddp_ef",
              "ddp_wire", "ddp_h2d", "commit_barrier", "comm_wire_reduce")
    for g, run in runs.items():
        p50 = {p: round(run.metrics[f"{p}_p50_ms"], 1) for p in phases
               if f"{p}_p50_ms" in run.metrics}
        log(f"  group {g} phase p50 ms {p50}")
    heal_ms = runs[1].metrics.get("heal_wall_ms")
    heal_rate = runs[1].metrics.get("heal_bytes_per_s")
    log(f"  heal: wall {heal_ms:.1f} ms, wire {heal_rate / 1e9:.3f} GB/s")
    after = [s for s in result["checked_steps"] if s > heal]
    tokens = 2 * batch * cfg.max_seq_len
    rates = [tokens / max(runs[0].step_seconds[s], runs[1].step_seconds[s])
             for s in after]
    log(f"  tokens/s, two groups sharing the card, steps after the heal: "
        f"{[round(r) for r in rates]} ({card})")
    log(f"  forward/backward passes of both groups: {result['passes']}")
    return result["passes"] * cfg.n_layers, result


def commit_raise(seed: int, card: str, config: str = "125m", batch: int = 8,
                 device: str = "cuda") -> int:
    """An update that raises part way through the overlapped commit: two
    solo groups, each under a real Manager and lighthouse, the barrier RPC
    held until the update was dispatched, so ``OptimizerWrapper.step``
    takes the overlapped arm (read from ``classic_metrics``: dispatch, then
    barrier). Both commit one step; at the second, group A's AdamW updates
    its first parameter group and raises ``torch.cuda.OutOfMemoryError``.
    Every parameter and AdamW state tensor must then be bitwise what it was
    before the step, at the same address, and the decision must have been
    read; A's retry of the step commits bitwise equal to the same step of
    group B, whose update never raised. Returns the forward/backward
    passes (5)."""
    import threading

    import torch

    from torchft_tpu_torch.comm.store import StoreServer
    from torchft_tpu_torch.comm.transport import TcpCommContext
    from torchft_tpu_torch.control import Lighthouse
    from torchft_tpu_torch.manager import Manager
    from torchft_tpu_torch.models import CONFIGS, GPT
    from torchft_tpu_torch.optim import OptimizerWrapper, init_adam_state

    cfg = CONFIGS[config]
    on_card = device != "cpu"
    t0 = time.perf_counter()
    fault = torch.cuda.OutOfMemoryError("injected: the update ran out of "
                                        "memory part way")

    class RaisingAdamW(torch.optim.AdamW):
        """Once ``fail`` is set, its next step updates the first parameter
        group and then raises it; every step opens the held barrier."""

        fail = None
        dispatched = None  # a threading.Event a group's barrier waits on

        def step(self, closure=None):
            try:
                if self.fail is None:
                    return super().step(closure)
                exc, self.fail = self.fail, None
                groups = self.param_groups
                self.param_groups = groups[:1]
                try:
                    super().step(closure)
                finally:
                    self.param_groups = groups
                raise exc
            finally:
                self.dispatched.set()

    lighthouses, stores, groups = [], [], {}
    try:
        for name in ("A", "B"):
            lighthouses.append(Lighthouse(min_replicas=1, join_timeout_ms=100))
            stores.append(StoreServer())
            manager = Manager(
                comm=TcpCommContext(timeout=60.0), min_replica_size=1, rank=0,
                world_size=1, store_addr=stores[-1].addr,
                lighthouse_addr=lighthouses[-1].address(),
                replica_id=f"commit_raise_{name}", timeout=60.0,
                quorum_timeout=60.0, connect_timeout=60.0)
            model = GPT(cfg, device=device, seed=seed)
            params = list(model.parameters())
            half = len(params) // 2
            adamw = RaisingAdamW(
                [{"params": params[:half]}, {"params": params[half:]}],
                lr=3e-4, weight_decay=1e-4, capturable=on_card)
            adamw.dispatched = threading.Event()
            init_adam_state(adamw)
            rpc = manager._client.should_commit

            def held(*a, _opt=adamw, _rpc=rpc, **kw):
                # the decision stays in flight until the update dispatched
                if not _opt.dispatched.wait(60.0):
                    raise TimeoutError("the update never dispatched")
                _opt.dispatched.clear()
                return _rpc(*a, **kw)

            manager._client.should_commit = held
            opt = OptimizerWrapper(manager, adamw)
            order = []
            observe = opt.classic_metrics.observe
            opt.classic_metrics.observe = (
                lambda n, s, _o=order, _f=observe: (_o.append(n), _f(n, s)))
            groups[name] = (manager, model, adamw, opt, order)

        gen = torch.Generator(device=device).manual_seed(seed + 1)
        batches = []
        for _ in range(2):
            tokens = torch.randint(0, cfg.vocab_size, (batch, cfg.max_seq_len),
                                   generator=gen, device=device)
            batches.append((tokens, torch.roll(tokens, -1, dims=1)))

        def tensors(model, adamw):
            params = list(model.parameters())
            return [p.detach() for p in params] + [
                v for p in params for _, v in sorted(adamw.state[p].items())]

        def forward_backward(name, tokens, targets):
            _, model, _, opt, _ = groups[name]
            opt.begin_step()
            model.loss(tokens, targets).backward()

        for name in ("A", "B"):
            forward_backward(name, *batches[0])
            _require(groups[name][3].step(), f"group {name} commits step 1")
        manager, model, adamw, opt, order = groups["A"]
        forward_backward("A", *batches[1])
        before = [(t.clone(), t.data_ptr()) for t in tensors(model, adamw)]
        step_before = manager.current_step()
        order.clear()
        adamw.fail = fault
        t_raise = time.perf_counter()
        try:
            opt.step()
        except torch.cuda.OutOfMemoryError as e:
            _require(e is fault, "the update's own exception reaches the "
                                 "caller")
        else:
            raise AssertionError("the raising update did not raise")
        if on_card:
            torch.cuda.synchronize()
        raise_ms = (time.perf_counter() - t_raise) * 1e3
        _require(order[:3] == ["prologue", "dispatch", "barrier"],
                 f"the overlapped arm: dispatch, then barrier ({order})")
        _require(manager.current_step() == step_before + 1,
                 "the decision was read (it committed the manager's step)")
        now = tensors(model, adamw)
        _require(len(now) == len(before) and all(
            torch.equal(t, b) and t.data_ptr() == ptr
            for t, (b, ptr) in zip(now, before)),
            "every parameter and AdamW state tensor bitwise restored at "
            "its address")
        del before
        for name in ("A", "B"):
            forward_backward(name, *batches[1])
            _require(groups[name][3].step(), f"group {name} commits step 2")
        a, b = (tensors(*groups[n][1:3]) for n in ("A", "B"))
        _require(all(torch.equal(x, y) for x, y in zip(a, b)),
                 "the retried step bitwise equal to the twin's")
        log(f"  commit_raise: {config} ({cfg.n_layers} layers, d_model "
            f"{cfg.d_model}), batch {batch}: the overlapped arm (order "
            f"{order[:3]}), the update raised {type(fault).__name__} after "
            f"group 1 of 2, restored bitwise at the same addresses, decision "
            f"read, in {raise_ms:.1f} ms; the retry bitwise equal to the "
            f"twin's step; {time.perf_counter() - t0:.1f} s ({card})")
        return 5
    finally:
        for manager, *_ in groups.values():
            manager.shutdown(wait=False)
        for s in stores:
            s.shutdown()
        for lh in lighthouses:
            lh.shutdown()
        groups.clear()
        if on_card:
            torch.cuda.empty_cache()


def check_plane_at_buckets(sizes, seed: int, cards=None) -> None:
    """The int8 plane on the card against the same plane on the CPU (the
    codec kernels' plain versions), bitwise, at each distinct size of the
    drill's DDP buckets: two groups decode the same bytes, so the drill's
    own checks cannot see a kernel that is wrong but deterministic at the
    main path's shapes (phase-1 rows, phase-2 shards, their tail chunks).
    With ``cards`` (two or more) the plane over them (rank r on
    ``cards[r]``) is held bitwise against both as well."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from torchft_tpu_torch.comm.context import ReduceOp
    from torchft_tpu_torch.comm.cuda_backend import CudaCommContext, DevicePool

    world = 2
    pools = {"cuda": DevicePool("cuda"), "cpu": DevicePool("cpu")}
    if cards is not None and len(cards) > 1:
        pools["cards"] = DevicePool(devices=cards[:world])
    rng = np.random.default_rng(seed)
    for size in sorted(set(sizes)):
        grads = [(rng.standard_normal(size) * 1e-3).astype(np.float32)
                 for _ in range(world)]
        out = {}
        for device, pool in pools.items():
            ctxs = [CudaCommContext(timeout=120.0, **INT8_OPTIONS,
                                    chunk_bytes=CHUNK_BYTES, device_pool=pool)
                    for _ in range(world)]

            def worker(r):
                ctxs[r].configure(f"smoke://bucket{size}/{device}", r, world)
                w = ctxs[r].allreduce([grads[r].copy()], ReduceOp.SUM)
                return w.future().result(timeout=120)[0]

            try:
                with ThreadPoolExecutor(world) as ex:
                    out[device] = [f.result(180) for f in
                                   [ex.submit(worker, r) for r in range(world)]]
            finally:
                for c in ctxs:
                    c.shutdown()
        for arm in pools:
            if arm == "cpu":
                continue
            same = all(c.tobytes() == h.tobytes() == o.tobytes()
                       for c, h, o in zip(out[arm], out["cpu"], out["cuda"]))
            what = ("plane over the cards" if arm == "cards"
                    else "card plane")
            log(f"  bucket of {size} f32: {what} vs CPU plane bitwise "
                f"{'ok' if same else 'FAIL'}"
                + (" (and vs the plane on one card)" if arm == "cards"
                   else ""))
            if not same:
                raise AssertionError(f"int8 {what} differs from the CPU "
                                     f"plane at a bucket of {size}")


# the loss of the 1b GPT with the kernels against the same model with
# reference_attention on the card, whose P is rounded to bf16 before P V
# (tests/test_torch_cuda.py's LOSS_TOL)
LOSS_TOL = 2e-2
# a sample of its gradients, relative norm of the difference: the
# reference rounds P (and, in its backward, dP) to bf16 where the kernels
# keep f32; on the CPU the plain flash path against reference_attention
# differs by 0.5-1.4% at 4 and 8 layers of that shape, growing slowly with
# depth, and a wrong kernel moves a gradient by O(1)
GRAD_REL_NORM = 5e-2
GRAD_SAMPLE = ("wte.embedding", "layers_0.attn.q_proj.kernel",
               "layers_12.mlp.up_proj.kernel", "layers_23.attn.o_proj.kernel",
               "lm_head.kernel")


def phase_gpt_1b(seed: int):
    """One forward/backward of the 1b GPT at full width and depth, batch
    1, through the kernels; then the same model, its attention swapped for
    reference_attention, on the same tokens. Returns the flash launches
    and checks the loss and GRAD_SAMPLE against the reference."""
    import torch

    from torchft_tpu_torch.models import CONFIGS, GPT, transformer
    from torchft_tpu_torch.ops import attention, flash

    cfg = CONFIGS["1b"]
    t0 = time.perf_counter()
    model = GPT(cfg, device="cuda", seed=seed)
    n_params = sum(p.numel() for p in model.parameters())
    gen = torch.Generator(device="cuda").manual_seed(seed)
    tok = torch.randint(0, cfg.vocab_size, (1, cfg.max_seq_len),
                        generator=gen, device="cuda")
    tgt = torch.roll(tok, -1, dims=1)
    log(f"  1b: {n_params} parameters, vocab {cfg.vocab_size} d_model "
        f"{cfg.d_model} layers {cfg.n_layers} heads {cfg.n_heads} (head_dim "
        f"{cfg.head_dim}) d_ff {cfg.d_ff} seq {cfg.max_seq_len} remat "
        f"{cfg.remat}, batch 1")

    def loss_and_grads():
        model.zero_grad(set_to_none=True)
        loss = model.loss(tok, tgt)
        loss.backward()
        torch.cuda.synchronize()
        named = dict(model.named_parameters())
        return loss.item(), {n: named[n].grad.detach().clone()
                             for n in GRAD_SAMPLE}

    flash.reset_launch_counts()
    t1 = time.perf_counter()
    loss, grads = loss_and_grads()
    t2 = time.perf_counter()
    counts = dict(flash.LAUNCHES)
    kernel_attention = transformer.causal_attention
    transformer.causal_attention = attention.reference_attention
    try:
        ref_loss, ref_grads = loss_and_grads()
    finally:
        transformer.causal_attention = kernel_attention
    if dict(flash.LAUNCHES) != counts:
        raise AssertionError("the reference model launched a flash kernel")
    log(f"  loss {loss:.6f} with the kernels, {ref_loss:.6f} with "
        f"reference_attention (|diff| {abs(loss - ref_loss):.3e}, tolerance "
        f"{LOSS_TOL}); model built in {t1 - t0:.1f} s, forward/backward "
        f"{t2 - t1:.2f} s with the kernels ({torch.cuda.get_device_name(0)}, "
        f"first call)")
    failed = []
    if not (abs(loss - ref_loss) <= LOSS_TOL and loss == loss):
        failed.append(f"loss {loss} against {ref_loss}")
    for n in GRAD_SAMPLE:
        g, r = grads[n].double(), ref_grads[n].double()
        rel = float((g - r).norm() / r.norm().clamp_min(1e-30))
        ok = bool(torch.isfinite(g).all()) and rel <= GRAD_REL_NORM
        log(f"  grad {n:32s} relative norm of the difference {rel:.3e} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(f"grad {n}: {rel}")
    del model, grads, ref_grads
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"1b with the kernels against the reference: "
                             f"{failed}")
    return counts, cfg.n_layers


# train_llama_ring: the Llama family on the sequence axis, its attention a
# causal flash-block ring over virtual shards of the card
LLAMA_RING_SHARDS = 4   # the seq axis: 4 shards of the one card
LLAMA_RING_SEQ = 4096   # tokens a sequence, 1,024 a shard
LLAMA_RING_BATCH = 2
LLAMA_RING_SCHEDULE = dict(kill_step=3, steps_alone=1, steps_after=2)
LLAMA_RING_PHASES = ("quorum", "forward_backward", "ddp_wire")


def llama_grad_sample(layers: int) -> tuple:
    """The gradients the parity pass compares: the embedding, the first
    layer's q and (GQA) k projections, a middle layer's gate, the last
    layer's output projection and the lm head."""
    return ("tok_embed.embedding", "layers.0.attn.q_proj.kernel",
            "layers.0.attn.k_proj.kernel",
            f"layers.{layers // 2}.mlp.gate_proj.kernel",
            f"layers.{layers - 1}.attn.o_proj.kernel", "lm_head.kernel")


def llama_ring_config():
    """"llama_120m" at full width and depth, ``max_seq_len`` 4,096 (the
    example's ``SEQ_LEN``), the loss over 8 vocab chunks."""
    import dataclasses

    from torchft_tpu_torch.models import LLAMA_CONFIGS

    return dataclasses.replace(LLAMA_CONFIGS["llama_120m"],
                               max_seq_len=LLAMA_RING_SEQ, xent_chunks=8)


def llama_ring_launches(passes: int, layers: int,
                        shards: int = LLAMA_RING_SHARDS,
                        remat: bool = True) -> dict:
    """Each flash kernel's launches in ``passes`` forward/backward passes
    of a model of ``layers`` causal ring attentions over ``shards``
    (``parallel.ring.ring_launches``, the schedule the ring runs)."""
    from torchft_tpu_torch.parallel import ring_launches

    return {n: passes * layers * c
            for n, c in ring_launches(shards, True, remat).items()}


def llama_activation_bytes(cfg, batch: int, ring: str = "flash",
                           shards: int = LLAMA_RING_SHARDS) -> int:
    """A reckoning of one forward/backward's live activations with
    activation checkpointing: every layer's bf16 input kept, one layer
    recomputed at a time (about 18 f32 tensors of tokens x its widest
    row, the flash ring's f32 accumulators among them), the chunked loss's
    logits with their gradient (one chunk, f32), and, for the einsum ring,
    the recomputed layer's saved scores (about 6 f32 [B, H, S/n, S/n] a
    pair, n^2 pairs)."""
    n = batch * cfg.max_seq_len
    keep = 2 * n * cfg.d_model * cfg.n_layers
    block = 4 * 18 * n * max(cfg.d_model, cfg.d_ff)
    logits = 2 * 4 * n * cfg.vocab_size // max(1, cfg.xent_chunks)
    s_local = cfg.max_seq_len // shards
    scores = 6 * 4 * batch * cfg.n_heads * s_local * s_local * shards ** 2
    return keep + block + logits + (scores if ring == "einsum" else 0)


def llama_ring_device_bytes(n_params: int, cfg, batch: int,
                            groups: int = 2) -> int:
    """Device memory train_llama_ring may hold at once, the larger of its
    two parts: the parity pass (one model's parameters and gradients, the
    einsum ring's activations) and the drill (per group its f32
    parameters, gradients and two AdamW moments, 16 bytes a parameter,
    the optimizer stepping them in place; the drill's kept copies of
    parameters and moments for two steps in flight, 24; every group's
    flash-ring activations)."""
    parity = 8 * n_params + llama_activation_bytes(cfg, batch, "einsum")
    drill = ((16 * groups + 24) * n_params
             + groups * llama_activation_bytes(cfg, batch, "flash"))
    return max(parity, drill)


def llama_ring_host_bytes(n_params: int, groups: int = 2) -> int:
    """Host memory train_llama_ring may hold at once, in f32 copies of the
    parameters: per group DDP's two staging arenas and the wire's buffers
    (4); the heal's staged state on both ends (parameters and AdamW's
    moments, 6)."""
    return (groups * 4 + 6) * 4 * n_params


def ring_pass_ms(times: dict, layers: int, shards: int = LLAMA_RING_SHARDS,
                 remat: bool = True) -> dict:
    """Device ms of the flash kernels in one forward/backward pass of the
    causal ring model, from each kernel's ms per call by mode (``times[
    (kernel, "causal" | "full")]``) and the ring's schedule; the forward
    counted twice under remat. Returns ms per kernel and ``total``."""
    from torchft_tpu_torch.parallel import ring_schedule

    out = {"flash_fwd": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    for *_, kind in ring_schedule(shards, True):
        if kind == "skip":
            continue
        out["flash_fwd"] += (2 if remat else 1) * times[("flash_fwd", kind)]
        for name in ("flash_bwd_dq", "flash_bwd_dkv"):
            out[name] += times[(name, kind)]
    out = {n: ms * layers for n, ms in out.items()}
    out["total"] = sum(out.values())
    return out


def llama_ring_pair_times(seed: int, cfg, batch: int = LLAMA_RING_BATCH,
                          shards: int = LLAMA_RING_SHARDS):
    """The three flash kernels at the ring's pair shape (B, S/n, H, D)
    against their plain versions, causal and full (``check_flash``), then
    each kernel's device ms per call in each mode, called as the ring
    calls it (the backward with external lse and Delta). Returns
    ``{(kernel, mode): ms}``; raises if a kernel disagrees."""
    from torchft_tpu_torch.ops import flash

    shape = (batch, cfg.max_seq_len // shards, cfg.n_heads, cfg.head_dim)
    log(f"  flash kernels at the ring's pair shape {shape}")
    q, k, v, do = flash_inputs(seed, shape)
    check_flash(q, k, v, do)
    scale = 1.0 / cfg.head_dim ** 0.5
    times = {}
    for causal, kind in ((True, "causal"), (False, "full")):
        out, lse = flash.flash_fwd(q, k, v, causal, scale)
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2)
        delta = delta.contiguous()
        calls = {
            "flash_fwd": lambda: flash.flash_fwd(q, k, v, causal, scale),
            "flash_bwd_dq": lambda: flash.flash_bwd_dq(
                q, k, v, do, lse, delta, causal, scale),
            "flash_bwd_dkv": lambda: flash.flash_bwd_dkv(
                q, k, v, do, lse, delta, causal, scale),
        }
        for name, call in calls.items():
            times[(name, kind)] = cuda_ms(call)
        log(f"  {kind:6s} pair: " + ", ".join(
            f"{n} {times[(n, kind)]:.4f} ms" for n in calls))
    return times


def profile_pass(run, sync, top: int = 6) -> dict:
    """One call of ``run`` under ``torch.profiler`` (host ops, and the
    card's when there is one): its wall ms, the device's busy ms (the
    summed time of every kernel, copy and fill it ran, all on one stream)
    and their count, the aten ops the host dispatched, and the ``top``
    host ops by self time as (name, calls, ms). The busy ms is None where
    the trace holds no device event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        sync()
        wall = (time.perf_counter() - t0) * 1e3
    avgs = prof.key_averages()
    device = [e for e in avgs if e.device_type == DeviceType.CUDA]
    busy = sum(getattr(e, "self_device_time_total", 0) for e in device)
    host = sorted((e for e in avgs if e.device_type == DeviceType.CPU),
                  key=lambda e: e.self_cpu_time_total, reverse=True)[:top]
    return {"wall_ms": wall,
            "device_busy_ms": busy / 1e3 if busy else None,
            "device_ops": sum(e.count for e in device),
            "host_ops": sum(e.count for e in avgs
                            if e.key.startswith("aten::")),
            "host_top": [(e.key, e.count, e.self_cpu_time_total / 1e3)
                         for e in host]}


def llama_ring_parity(cfg, seed: int, card: str,
                      batch: int = LLAMA_RING_BATCH,
                      device: str = "cuda") -> None:
    """One forward/backward of the same parameters and batch through (a)
    the flash ring over ``LLAMA_RING_SHARDS`` virtual shards of the card,
    (b) the einsum ring over them and (c) the unsharded model
    (``causal_attention``, one shard): the loss of (a) and of (b) within
    ``LOSS_TOL`` of (c)'s and ``llama_grad_sample`` within
    ``GRAD_REL_NORM``; raises on a miss. At random init every attention,
    a wrong one too, gives a loss near ln(vocab): the gradient sample,
    the first layer's q and k projections among it, is what checks the
    ring. Then, one thread alone on the card, a second pass of each arm
    timed and one more of (a) and (c) under ``profile_pass``, printed:
    where a pass goes without another group on the card."""
    import torch

    from torchft_tpu_torch.examples.train_llama_ring import make_seq_ring
    from torchft_tpu_torch.models import Llama

    dev = torch.device(device)
    model = Llama(cfg, device=dev, seed=seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    tok = torch.randint(0, cfg.vocab_size, (batch, cfg.max_seq_len),
                        generator=gen, device=dev)
    tgt = torch.roll(tok, -1, dims=1)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    arms = {
        "flash ring": make_seq_ring(cfg, dev, LLAMA_RING_SHARDS, "flash"),
        "einsum ring": make_seq_ring(cfg, dev, LLAMA_RING_SHARDS, "einsum"),
        "unsharded": None,
    }
    named = dict(model.named_parameters())
    sample = llama_grad_sample(cfg.n_layers)

    def run(fn):
        model.zero_grad(set_to_none=True)
        loss = model.loss(tok, tgt, attn_fn=fn)
        loss.backward()
        return loss

    out, steady = {}, {}
    for arm, fn in arms.items():
        sync()
        t0 = time.perf_counter()
        loss = run(fn)
        sync()
        out[arm] = (loss.item(), time.perf_counter() - t0,
                    {n: named[n].grad.detach().clone() for n in sample})
    for arm, fn in arms.items():  # steady state: every arm warm
        sync()
        t0 = time.perf_counter()
        run(fn)
        sync()
        steady[arm] = (time.perf_counter() - t0) * 1e3
    ref_loss, _, ref_grads = out["unsharded"]
    failed = []
    for arm in ("flash ring", "einsum ring"):
        loss, secs, grads = out[arm]
        ok = abs(loss - ref_loss) <= LOSS_TOL
        log(f"  {arm}: loss {loss:.6f} against unsharded {ref_loss:.6f} "
            f"(|diff| {abs(loss - ref_loss):.3e}, tolerance {LOSS_TOL}) "
            f"{'ok' if ok else 'FAIL'}; forward/backward {secs:.2f} s "
            f"first, {steady[arm]:.1f} ms warm ({card})")
        if not ok:
            failed.append(f"{arm} loss {loss} against {ref_loss}")
        for n in sample:
            g, r = grads[n].double(), ref_grads[n].double()
            rel = float((g - r).norm() / r.norm().clamp_min(1e-30))
            ok = bool(torch.isfinite(g).all()) and rel <= GRAD_REL_NORM
            log(f"    grad {n:30s} relative norm of the difference "
                f"{rel:.3e} {'ok' if ok else 'FAIL'}")
            if not ok:
                failed.append(f"{arm} grad {n}: {rel}")
    log(f"  unsharded: forward/backward {out['unsharded'][1]:.2f} s first, "
        f"{steady['unsharded']:.1f} ms warm ({card})")
    for arm in ("flash ring", "unsharded"):
        prof = profile_pass(lambda: run(arms[arm]), sync)
        busy = prof["device_busy_ms"]
        log(f"  profiled {arm} pass, one thread: wall "
            f"{prof['wall_ms']:.1f} ms, device busy "
            + (f"{busy:.1f} ms ({busy / prof['wall_ms']:.1%} of the wall) "
               f"in {prof['device_ops']} kernels and copies"
               if busy is not None else "not measured (no device event)")
            + f" ({card}); {prof['host_ops']} aten ops, the top by self ms: "
            + ", ".join(f"{k} {c}x {ms:.1f}" for k, c, ms in prof["host_top"]))
    del model, named, out
    gc.collect()
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"ring against unsharded attention: {failed}")


def llama_ring_report(result: dict, cfg, batch: int, per_pass: dict,
                      pass_ms: dict, card: str) -> list:
    """The lines train_llama_ring prints about a ``run_llama_ring_drill``
    result: the bitwise heal, per group the step phases' p50s and
    committed step times, committed tokens/s after the heal, the heal's
    wall and rate, and the ring's launches and their summed device time
    per pass beside ``forward_backward``."""
    runs, heal = result["runs"], result["heal_step"]
    lines = [f"both groups bitwise equal (parameters and AdamW state) at "
             f"every step both committed {result['checked_steps']}; group 1 "
             f"healed at step {heal}; groups per step {result['compared']}"]
    for g, run in sorted(runs.items()):
        times = ", ".join(f"{s}: {t:.2f}"
                          for s, t in sorted(run.step_seconds.items()))
        lines.append(f"group {g}: step p50 ms "
                     f"{_p50s(run.metrics, LLAMA_RING_PHASES)}; committed "
                     f"steps (s) {{{times}}} ({card})")
    after = [s for s in result["checked_steps"] if s > heal]
    tokens = 2 * batch * cfg.max_seq_len
    rates = [tokens / max(runs[0].step_seconds[s], runs[1].step_seconds[s])
             for s in after]
    lines.append(f"committed tokens/s, two groups sharing the card, steps "
                 f"{after}: {[round(r) for r in rates]} ({card})")
    h = result["heal"]
    lines.append(f"heal: heal_wall_ms {h['heal_wall_ms']:.1f}, "
                 f"heal_bytes_per_s {h['heal_bytes_per_s'] / 1e9:.3f} GB/s "
                 f"({card})")
    fb = [run.metrics.get("forward_backward_p50_ms")
          for _, run in sorted(runs.items())]
    lines.append(f"ring launches per forward/backward pass: {per_pass} "
                 f"({cfg.n_layers} layers x the schedule of "
                 f"{LLAMA_RING_SHARDS} shards), x 2 per joint step; their "
                 f"device time per pass {pass_ms['total']:.2f} ms ("
                 + ", ".join(f"{n} {ms:.2f}" for n, ms in pass_ms.items()
                             if n != "total")
                 + f") beside forward_backward p50 {fb} ms ({card})")
    lines.append(f"drill {result['seconds']:.1f} s, {result['passes']} "
                 f"forward/backward passes ({card})")
    return lines


def phase_train_llama_ring(seed: int, card: str,
                           batch: int = LLAMA_RING_BATCH):
    """The llama ring phase (module docstring, phase 15): the kernels at
    the pair shape, the parity pass, then the drill with the launch
    counts set to 0 just before it. Returns (the drill's launches, the
    launches the ring schedule says, the head_dim)."""
    import torch

    from torchft_tpu_torch.examples.train_llama_ring import (
        run_llama_ring_drill,
    )
    from torchft_tpu_torch.models import Llama, count_params
    from torchft_tpu_torch.ops import flash, quant
    from torchft_tpu_torch.parallel import ring_launches

    t0 = time.perf_counter()
    cfg = llama_ring_config()
    n_params = count_params(Llama(cfg, device="meta"))
    need_host = llama_ring_host_bytes(n_params)
    free_host = check_host_memory(need_host, what="train_llama_ring")
    need = llama_ring_device_bytes(n_params, cfg, batch)
    gc.collect()  # an earlier phase's cycles may hold tensors
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info()[0]
    if free < need:
        raise AssertionError(f"train_llama_ring needs {need / 1e9:.2f} GB of "
                             f"device memory free, has {free / 1e9:.2f} GB")
    log(f"  llama_120m: {n_params} parameters, vocab {cfg.vocab_size} "
        f"d_model {cfg.d_model} layers {cfg.n_layers} heads {cfg.n_heads} "
        f"(kv {cfg.n_kv_heads}, head_dim {cfg.head_dim}) d_ff {cfg.d_ff} seq "
        f"{cfg.max_seq_len} xent_chunks {cfg.xent_chunks} remat {cfg.remat},"
        f" batch {batch}; seq axis of {LLAMA_RING_SHARDS} virtual shards; "
        f"device memory: up to "
        f"{need / 1e9:.2f} GB, {free / 1e9:.1f} GB free; host memory: up to "
        f"{need_host / 1e9:.2f} GB, {free_host / 1e9:.1f} GB available")
    times = llama_ring_pair_times(seed, cfg, batch)
    per_layer = ring_launches(LLAMA_RING_SHARDS, True, cfg.remat)
    per_pass = {n: c * cfg.n_layers for n, c in per_layer.items()}
    pass_ms = ring_pass_ms(times, cfg.n_layers, remat=cfg.remat)
    llama_ring_parity(cfg, seed, card, batch)
    torch.cuda.reset_peak_memory_stats()
    flash.reset_launch_counts()
    quant.reset_launch_counts()
    result = run_llama_ring_drill(
        cfg, ring_impl="flash", seq_shards=LLAMA_RING_SHARDS,
        device="cuda", batch_size=batch, seed=seed,
        timeout=300.0, log=lambda m: log("  " + m), **LLAMA_RING_SCHEDULE)
    counts = {**flash.LAUNCHES, **quant.LAUNCHES}
    want = {**llama_ring_launches(result["passes"], cfg.n_layers,
                                  remat=cfg.remat),
            **dict.fromkeys(quant.LAUNCHES, 0)}
    for line in llama_ring_report(result, cfg, batch, per_pass, pass_ms,
                                  card):
        log("  " + line)
    log(f"  device memory peak: {torch.cuda.max_memory_allocated() / 1e9:.2f}"
        f" GB allocated, {torch.cuda.max_memory_reserved() / 1e9:.2f} GB "
        f"reserved (reckoned {need / 1e9:.2f} GB) ({card})")
    del result
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  phase {time.perf_counter() - t0:.1f} s ({card})")
    return counts, want, cfg.head_dim


# train_hsdp: the 1b GPT sharded over fsdp x tensor in each replica group
HSDP_AXES = {"fsdp": 2, "tensor": 2}  # a virtual mesh of the one card
HSDP_BATCH = 8
HSDP_STEPS = 5          # committed steps; group 1 heals at 4
HSDP_KILL_AFTER = 2
HSDP_PHASES = ("quorum", "forward_backward", "ddp_wire")


def hsdp_config():
    """"1b" at full width, its depth cut to ``CUT_LAYERS``."""
    from torchft_tpu_torch.models import CONFIGS

    return cut_depth(CONFIGS["1b"])


def hsdp_positions() -> int:
    return math.prod(HSDP_AXES.values())


def hsdp_attention_shape(cfg, batch: int = HSDP_BATCH) -> tuple:
    """[B, S, H, D] of each position's attention: the batch split over
    fsdp, the heads over tensor."""
    return (batch // HSDP_AXES["fsdp"], cfg.max_seq_len,
            cfg.n_heads // HSDP_AXES["tensor"], cfg.head_dim)


def hsdp_launches(passes: int, layers: int, positions: int = 4,
                  remat: bool = True) -> dict:
    """Each flash kernel's launches in ``passes`` forward/backward passes
    of the sharded GPT: one attention per layer per mesh position, its
    forward twice under remat."""
    per = passes * layers * positions
    return {"flash_fwd": per * (2 if remat else 1), "flash_bwd_dq": per,
            "flash_bwd_dkv": per}


def hsdp_activation_bytes(cfg, batch: int) -> int:
    """A reckoning of one sharded forward/backward's live activations, all
    positions together: every layer's bf16 input kept per position, the
    recomputed layer's f32 layer-norm intermediates (4 tensors of a
    position's tokens x d_model, every position), and per position that
    layer's gathered f32 weights, the gathered embedding and lm head, and
    one f32 logits chunk with its gradient. (Measured on the H100: 3.5 GB
    at "1b", batch 8, over ``HSDP_AXES``; this gives 6.3.)"""
    n_pos = hsdp_positions()
    b, s, h, d = hsdp_attention_shape(cfg, batch)
    tokens = b * s
    tp = HSDP_AXES["tensor"]
    keep = 2 * tokens * cfg.d_model * cfg.n_layers * n_pos
    block = 4 * 4 * tokens * cfg.d_model * n_pos
    layer_w = 4 * (4 * cfg.d_model ** 2 + 2 * cfg.d_model * cfg.d_ff) // tp
    heads = 4 * 2 * cfg.vocab_size * cfg.d_model // tp
    chunks = max(1, cfg.xent_chunks)
    logits = 2 * 4 * tokens * cfg.vocab_size // tp // chunks
    return keep + block + n_pos * (layer_w + heads + logits)


def hsdp_device_bytes(n_params: int, cfg, batch: int = HSDP_BATCH,
                      groups: int = 2) -> int:
    """Device memory train_hsdp may hold at once, the larger of its two
    parts: the parity pass (the unsharded and the sharded model, each its
    f32 parameters and gradients, and the unsharded model's activations,
    the larger) and the drill (per group its f32 parameters, gradients and
    two AdamW moments, 16 bytes a parameter; the healer's healed copy of
    parameters and moments before it is loaded, 12; every group's
    activations)."""
    parity = 16 * n_params + max(gpt_activation_bytes(cfg, batch) // 2,
                                 hsdp_activation_bytes(cfg, batch))
    drill = (16 * groups + 12) * n_params \
        + groups * hsdp_activation_bytes(cfg, batch)
    return max(parity, drill)


def hsdp_host_bytes(n_params: int, groups: int = 2) -> int:
    """Host memory train_hsdp may hold at once, in f32 copies of the
    parameters: per group DDP's pinned staging and the wire's buffers
    (2); the heal's staged state on both ends (parameters and AdamW's
    moments, 6)."""
    return (groups * 2 + 6) * 4 * n_params


def hsdp_pass_ms(times: dict, layers: int, positions: int = 4,
                 remat: bool = True) -> dict:
    """Device ms of the flash kernels in one forward/backward pass of the
    sharded GPT, from each kernel's ms per call at the positions' shape;
    returns ms per kernel and ``total``."""
    calls = hsdp_launches(1, layers, positions, remat)
    out = {n: calls[n] * times[n]["ms"] for n in calls}
    out["total"] = sum(out.values())
    return out


def hsdp_flash_times(seed: int, shape: tuple) -> dict:
    """The three flash kernels at the sharded positions' shape against
    their plain versions (``check_flash``), then timed as ``time_flash``
    times them (device ms, host µs, plain, bound, SDPA)."""
    log(f"  flash kernels at the sharded positions' shape {shape}")
    q, k, v, do = flash_inputs(seed, shape)
    errs = check_flash(q, k, v, do)
    times = time_flash(q, k, v, do)
    for name in times:
        times[name]["max_abs_err"] = errs[name]
    return times


def hsdp_parity(cfg, seed: int, card: str, batch: int = HSDP_BATCH,
                device: str = "cuda") -> None:
    """One forward/backward of the same weights and batch through the
    sharded GPT over ``HSDP_AXES`` (a virtual mesh of ``device``) and the
    unsharded GPT (:func:`sharded_parity`)."""
    import torch

    from torchft_tpu_torch.models import GPT, ShardedGPT, gpt_param_tree
    from torchft_tpu_torch.parallel import ft_mesh

    dev = torch.device(device)
    dense = GPT(cfg, device=dev, seed=seed)
    mesh = ft_mesh(HSDP_AXES, devices=[dev] * hsdp_positions())
    sharded = ShardedGPT(cfg, mesh, params=gpt_param_tree(dense))
    sample = [n for n in GRAD_SAMPLE
              if not n.startswith("layers_")
              or int(n.split(".")[0].split("_")[1]) < cfg.n_layers]
    sharded_parity(dense, sharded, sample, seed, card, batch,
                   f"sharded {HSDP_AXES}")


def sharded_parity(dense, sharded, sample, seed: int, card: str,
                   batch: int, label: str) -> None:
    """One forward/backward of the same weights and batch through a
    sharded model and its unsharded twin on the same device: the loss
    within ``LOSS_TOL`` and the gradients named in ``sample`` (the sharded
    model's assembled from its pieces) within ``GRAD_REL_NORM``; raises on
    a miss. Each is then timed warm, one thread alone."""
    import torch

    from torchft_tpu_torch.models.transformer import _tree_get

    cfg = dense.cfg
    dev = next(dense.parameters()).device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    gen = torch.Generator(device=dev).manual_seed(seed)
    tok = torch.randint(0, cfg.vocab_size, (batch, cfg.max_seq_len),
                        generator=gen, device=dev)
    tgt = torch.roll(tok, -1, dims=1)

    def run(model):
        model.zero_grad(set_to_none=True)
        loss = model.loss(tok, tgt)
        loss.backward()
        return loss

    out, warm = {}, {}
    for name, model in (("sharded", sharded), ("unsharded", dense)):
        sync()
        t0 = time.perf_counter()
        loss = run(model).item()
        sync()
        secs = time.perf_counter() - t0
        if name == "sharded":
            tree = model.grad_tree()
            grads = {n: _tree_get(tree, n.replace(".", "/")) for n in sample}
            grads = {n: g.full() if hasattr(g, "full") else g
                     for n, g in grads.items()}
        else:
            named = dict(model.named_parameters())
            grads = {n: named[n].grad.detach().clone() for n in sample}
        out[name] = (loss, secs, grads)
        sync()
        t0 = time.perf_counter()
        run(model)
        sync()
        warm[name] = (time.perf_counter() - t0) * 1e3
        model.zero_grad(set_to_none=True)
    loss, secs, grads = out["sharded"]
    ref_loss, ref_secs, ref_grads = out["unsharded"]
    failed = []
    ok = abs(loss - ref_loss) <= LOSS_TOL and loss == loss
    log(f"  {label}: loss {loss:.6f} against unsharded "
        f"{ref_loss:.6f} (|diff| {abs(loss - ref_loss):.3e}, tolerance "
        f"{LOSS_TOL}) {'ok' if ok else 'FAIL'}; forward/backward "
        f"{secs:.2f} s first, {warm['sharded']:.1f} ms warm; unsharded "
        f"{ref_secs:.2f} s first, {warm['unsharded']:.1f} ms warm ({card})")
    if not ok:
        failed.append(f"loss {loss} against {ref_loss}")
    for n in sample:
        g, r = grads[n].double(), ref_grads[n].double()
        rel = float((g - r).norm() / r.norm().clamp_min(1e-30))
        ok = bool(torch.isfinite(g).all()) and rel <= GRAD_REL_NORM
        log(f"    grad {n:32s} relative norm of the difference {rel:.3e} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(f"grad {n}: {rel}")
    del dense, sharded, out, grads, ref_grads
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"the sharded model against the unsharded: "
                             f"{failed}")


def hsdp_report(result: dict, cfg, batch: int, per_pass: dict,
                pass_ms: dict, card: str, positions: int = 0,
                layout: "str | None" = None) -> list:
    """The lines train_hsdp prints about a ``run_hsdp_drill`` result: the
    bitwise checks, per group the step phases' p50s and committed step
    times, committed tokens/s after the heal, the heal's wall, rate and
    bytes, the bytes of pieces per position, and the flash launches
    (``layout`` says what makes them up) and their summed device time per
    pass beside ``forward_backward``."""
    runs, heal = result["runs"], result["heal_step"]
    lines = [f"both groups bitwise equal (every piece of the parameters "
             f"and AdamW's moments) at every step both committed "
             f"{result['checked_steps']}; group 1 healed at step {heal} "
             f"into its sharded template"]
    for g, run in sorted(runs.items()):
        times = ", ".join(f"{s}: {t:.2f}"
                          for s, t in sorted(run.step_seconds.items()))
        lines.append(f"group {g}: step p50 ms "
                     f"{_p50s(run.metrics, HSDP_PHASES)}; committed "
                     f"steps (s) {{{times}}} ({card})")
    after = [s for s in result["checked_steps"] if s > heal]
    tokens = 2 * batch * cfg.max_seq_len
    rates = [tokens / max(runs[0].step_seconds[s], runs[1].step_seconds[s])
             for s in after]
    lines.append(f"committed tokens/s, two groups sharing the card, steps "
                 f"{after}: {[round(r) for r in rates]} ({card})")
    h = result["heal"]
    lines.append(f"heal: heal_wall_ms {h['heal_wall_ms']:.1f}, "
                 f"heal_bytes_per_s {h['heal_bytes_per_s'] / 1e9:.3f} GB/s, "
                 f"wire bytes {int(h['wire_bytes'])} = the state's "
                 f"{h['state_bytes']} ({card})")
    lines.append(f"bytes of parameter pieces per mesh position "
                 f"{result['piece_bytes']} (f32)")
    fb = [run.metrics.get("forward_backward_p50_ms")
          for _, run in sorted(runs.items())]
    layout = layout or (f"{cfg.n_layers} layers x "
                        f"{positions or hsdp_positions()} positions, remat")
    lines.append(f"flash launches per forward/backward pass: {per_pass} "
                 f"({layout}); their device time per pass "
                 f"{pass_ms['total']:.2f} ms ("
                 + ", ".join(f"{n} {ms:.2f}" for n, ms in pass_ms.items()
                             if n != "total")
                 + f") beside forward_backward p50 {fb} ms ({card})")
    lines.append(f"drill {result['seconds']:.1f} s, {result['passes']} "
                 f"forward/backward passes ({card})")
    return lines


def phase_train_hsdp(seed: int, card: str, batch: int = HSDP_BATCH):
    """The HSDP phase (module docstring, phase 16): the kernels at the
    positions' shape, the parity pass, then the drill with the launch
    counts set to 0 just before it. Returns (the drill's launches, the
    launches the schedule says, the head_dim)."""
    import torch

    from torchft_tpu_torch.examples.train_hsdp import run_hsdp_drill
    from torchft_tpu_torch.models import gpt_param_shapes
    from torchft_tpu_torch.ops import flash, quant

    t0 = time.perf_counter()
    cfg = hsdp_config()
    n_params = sum(math.prod(s) for s in gpt_param_shapes(cfg).values())
    need_host = hsdp_host_bytes(n_params)
    free_host = check_host_memory(need_host, what="train_hsdp")
    need = hsdp_device_bytes(n_params, cfg, batch)
    gc.collect()  # an earlier phase's cycles may hold tensors
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info()[0]
    if free < need:
        raise AssertionError(f"train_hsdp needs {need / 1e9:.2f} GB of "
                             f"device memory free, has {free / 1e9:.2f} GB")
    shape = hsdp_attention_shape(cfg, batch)
    log(f"  1b: {n_params} parameters, vocab {cfg.vocab_size} d_model "
        f"{cfg.d_model} layers {cfg.n_layers} heads {cfg.n_heads} (head_dim "
        f"{cfg.head_dim}) d_ff {cfg.d_ff} seq {cfg.max_seq_len} xent_chunks "
        f"{cfg.xent_chunks} remat {cfg.remat}, batch {batch}; mesh "
        f"{HSDP_AXES} of virtual positions, attention {shape} a position; "
        f"device memory: up to {need / 1e9:.2f} GB, {free / 1e9:.1f} GB "
        f"free; host memory: up to {need_host / 1e9:.2f} GB, "
        f"{free_host / 1e9:.1f} GB available")
    times = hsdp_flash_times(seed, shape)
    per_pass = hsdp_launches(1, cfg.n_layers, hsdp_positions(), cfg.remat)
    pass_ms = hsdp_pass_ms(times, cfg.n_layers, hsdp_positions(), cfg.remat)
    hsdp_parity(cfg, seed, card, batch)
    torch.cuda.reset_peak_memory_stats()
    flash.reset_launch_counts()
    quant.reset_launch_counts()
    result = run_hsdp_drill(
        cfg, HSDP_AXES, steps=HSDP_STEPS, kill_after=HSDP_KILL_AFTER,
        device="cuda", batch_size=batch, seed=seed, timeout=600.0,
        log=lambda m: log("  " + m))
    counts = {**flash.LAUNCHES, **quant.LAUNCHES}
    want = {**hsdp_launches(result["passes"], cfg.n_layers,
                            hsdp_positions(), cfg.remat),
            **dict.fromkeys(quant.LAUNCHES, 0)}
    for line in hsdp_report(result, cfg, batch, per_pass, pass_ms, card):
        log("  " + line)
    log(f"  device memory peak: {torch.cuda.max_memory_allocated() / 1e9:.2f}"
        f" GB allocated, {torch.cuda.max_memory_reserved() / 1e9:.2f} GB "
        f"reserved (reckoned {need / 1e9:.2f} GB) ({card})")
    del result
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  phase {time.perf_counter() - t0:.1f} s ({card})")
    return counts, want, cfg.head_dim


# train_moe_expert: the MoE with its experts over a virtual expert x data
# mesh in each replica group (the reference test's mesh)
MOE_EXPERT_AXES = {"expert": 4, "data": 2}
MOE_EXPERT_BATCH = 8
MOE_EXPERT_SCHEDULE = dict(kill_step=2, steps_after=1)  # heal at 4, 5 steps
MOE_GRAD_SAMPLE = ("wte.embedding", "layers_0.attn.q_proj.kernel",
                   "layers_1.moe.gate.kernel", "layers_1.moe.experts.up",
                   "layers_1.moe.experts.down", "lm_head.kernel")


def moe_expert_positions() -> int:
    return math.prod(MOE_EXPERT_AXES.values())


def moe_expert_attention_shape(cfg, batch: int = MOE_EXPERT_BATCH) -> tuple:
    """[B, S, H, D] of each position's attention: the batch split over
    data x expert (one sequence a position at batch 8)."""
    return (batch // moe_expert_positions(), cfg.max_seq_len, cfg.n_heads,
            cfg.head_dim)


def moe_expert_activation_bytes(cfg, batch: int) -> int:
    """A reckoning of one expert-sharded forward/backward's live
    activations, all positions together: the unsharded reckoning
    (``moe_activation_bytes``: the kept block inputs, one recomputed
    block's routing masks and intermediates, a logits chunk) plus, per
    position, the MoE layer's bf16 exchange tensors ([E, C, D]: its
    partial dispatch, its row's gathered outputs and their gradients, 4)
    and its experts' bf16 hidden [E / ep, C, F] with its GELU input."""
    n = batch * cfg.max_seq_len
    cap = max(1, int(cfg.capacity_factor * n * 2 / cfg.num_experts))
    p = moe_expert_positions()
    ep = MOE_EXPERT_AXES["expert"]
    exchange = 2 * 4 * p * cfg.num_experts * cap * cfg.d_model
    ffn = 2 * 2 * p * (cfg.num_experts // ep) * cap * cfg.d_ff
    return moe_activation_bytes(cfg, batch) + exchange + ffn


def moe_expert_device_bytes(n_params: int, act: int, groups: int = 2) -> int:
    """Device memory train_moe_expert may hold at once, the larger of its
    two parts: the parity pass (the width-1 and the sharded model, each its
    f32 parameters and gradients; one pass's activations) and the drill
    (per group its f32 parameters, gradients and two AdamW moments, 16
    bytes a parameter, each distinct piece held once on the virtual mesh;
    the healer's healed copy of parameters and moments, 12; every group's
    activations)."""
    return max(16 * n_params + act, (16 * groups + 12) * n_params
               + groups * act)


def moe_expert_parity(cfg, seed: int, card: str,
                      batch: int = MOE_EXPERT_BATCH,
                      device: str = "cuda") -> None:
    """One forward/backward of the same weights and batch through the
    expert-sharded MoE over ``MOE_EXPERT_AXES`` (a virtual mesh of
    ``device``) and the width-1 ``MoETransformer``
    (:func:`sharded_parity`)."""
    import torch

    from torchft_tpu_torch.models import (
        MoETransformer,
        ShardedMoETransformer,
        gpt_param_tree,
    )
    from torchft_tpu_torch.parallel import ft_mesh

    dev = torch.device(device)
    dense = MoETransformer(cfg, device=dev, seed=seed)
    mesh = ft_mesh(MOE_EXPERT_AXES, devices=[dev] * moe_expert_positions())
    sharded = ShardedMoETransformer(cfg, mesh, params=gpt_param_tree(dense))
    sharded_parity(dense, sharded, MOE_GRAD_SAMPLE, seed, card, batch,
                   f"expert-sharded {MOE_EXPERT_AXES}")


def phase_train_moe_expert(seed: int, card: str,
                           batch: int = MOE_EXPERT_BATCH):
    """The expert-axis phase (module docstring, phase 17): the kernels at
    a position's shape, the parity pass, then the drill with the launch
    counts set to 0 just before it. Returns (the drill's launches, the
    launches the schedule says, the head_dim)."""
    import torch

    from torchft_tpu_torch.examples.train_moe import run_moe_drill
    from torchft_tpu_torch.models import MOE_CONFIGS, moe_param_shapes
    from torchft_tpu_torch.ops import flash, quant

    t0 = time.perf_counter()
    cfg = cut_depth(MOE_CONFIGS["moe-8x125m"])
    n_params = sum(math.prod(s) for s in moe_param_shapes(cfg).values())
    positions = moe_expert_positions()
    need_host = hsdp_host_bytes(n_params)
    free_host = check_host_memory(need_host, what="train_moe_expert")
    need = moe_expert_device_bytes(n_params,
                                   moe_expert_activation_bytes(cfg, batch))
    gc.collect()  # an earlier phase's cycles may hold tensors
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info()[0]
    if free < need:
        raise AssertionError(f"train_moe_expert needs {need / 1e9:.2f} GB of "
                             f"device memory free, has {free / 1e9:.2f} GB")
    shape = moe_expert_attention_shape(cfg, batch)
    log(f"  moe-8x125m at {cfg.n_layers} layers: {n_params} parameters, "
        f"{cfg.num_experts} experts "
        f"(capacity factor {cfg.capacity_factor}) on every "
        f"{cfg.moe_every}nd layer of {cfg.n_layers}, remat {cfg.remat}, "
        f"batch {batch} x {cfg.max_seq_len}; mesh {MOE_EXPERT_AXES} of "
        f"virtual positions (the batch over data x expert), attention "
        f"{shape} a position; device memory: up to {need / 1e9:.2f} GB, "
        f"{free / 1e9:.1f} GB free; host memory: up to "
        f"{need_host / 1e9:.2f} GB, {free_host / 1e9:.1f} GB available")
    times = hsdp_flash_times(seed, shape)
    per_pass = hsdp_launches(1, cfg.n_layers, positions, cfg.remat)
    pass_ms = hsdp_pass_ms(times, cfg.n_layers, positions, cfg.remat)
    moe_expert_parity(cfg, seed, card, batch)
    torch.cuda.reset_peak_memory_stats()
    flash.reset_launch_counts()
    quant.reset_launch_counts()
    result = run_moe_drill(
        cfg, axes=MOE_EXPERT_AXES, device="cuda", batch_size=batch,
        seed=seed, timeout=600.0, log=lambda m: log("  " + m),
        **MOE_EXPERT_SCHEDULE)
    counts = {**flash.LAUNCHES, **quant.LAUNCHES}
    want = {**hsdp_launches(result["passes"], cfg.n_layers, positions,
                            cfg.remat),
            **dict.fromkeys(quant.LAUNCHES, 0)}
    for line in hsdp_report(result, cfg, batch, per_pass, pass_ms, card,
                            positions):
        log("  " + line)
    log(f"  device memory peak: {torch.cuda.max_memory_allocated() / 1e9:.2f}"
        f" GB allocated, {torch.cuda.max_memory_reserved() / 1e9:.2f} GB "
        f"reserved (reckoned {need / 1e9:.2f} GB) ({card})")
    del result
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  phase {time.perf_counter() - t0:.1f} s ({card})")
    return counts, want, cfg.head_dim


# train_pp: the GPT's blocks over a virtual {"stage": 4} mesh in each
# replica group (tests/test_integration_pp.py's layout at "125m")
PP_AXES = {"stage": 4}    # the reference test's S = 4, positions of the card
PP_BATCH = 8
PP_MICROBATCHES = 4       # the reference test's M: 2 sequences a microbatch
PP_STEPS = 7              # committed steps; group 1 heals at 5
PP_KILL_AFTER = 3
# 1F1B and interleaved 1F1B against GPipe with autograd, the relative norm
# of each stage gradient's difference: the same products, summed over the
# microbatches in another order (1F1B in tick order, autograd its own)
PP_SCHEDULE_TOL = 1e-3
# the parity pass's gradient sample: a layer of the first, a middle and
# the last stage at "125m", the embedding and the head
PP_GRAD_SAMPLE = ("wte.embedding", "layers_0.attn.q_proj.kernel",
                  "layers_5.mlp.up_proj.kernel",
                  "layers_11.attn.o_proj.kernel", "lm_head.kernel")


def pp_stages() -> int:
    return PP_AXES["stage"]


def pp_attention_shape(cfg, batch: int = PP_BATCH,
                       microbatches: int = PP_MICROBATCHES) -> tuple:
    """[B, S, H, D] of each flash call: one microbatch."""
    return (batch // microbatches, cfg.max_seq_len, cfg.n_heads,
            cfg.head_dim)


def pp_launches(passes: int, layers: int,
                microbatches: int = PP_MICROBATCHES) -> dict:
    """Each flash kernel's launches in ``passes`` GPipe forward/backward
    passes of the pipelined GPT. Only the slots the schedule fills run a
    stage, so every microbatch meets every layer once: M x layers forward
    launches a pass and as many of each backward kernel (the stages run
    no activation checkpointing)."""
    per = passes * microbatches * layers
    return {"flash_fwd": per, "flash_bwd_dq": per, "flash_bwd_dkv": per}


def pp_replicated_bytes(cfg) -> int:
    """f32 bytes of the leaves outside the pipeline (the embeddings, ln_f
    and the head), which every forward gathers onto each position."""
    d = cfg.d_model
    return 4 * (2 * cfg.vocab_size * d + cfg.max_seq_len * d + 2 * d)


def pp_device_bytes(n_params: int, cfg, batch: int = PP_BATCH,
                    groups: int = 2) -> int:
    """Device memory train_pp may hold at once, the largest of its parts:
    the parity pass (the unsharded and the pipelined model, each its f32
    parameters and gradients; one pass's activations: GPipe keeps every
    microbatch's, the unpipelined batch's bf16 activations, half of
    ``gpt_activation_bytes``); the drill (per group its f32 parameters,
    gradients and two AdamW moments, 16 bytes a parameter; the healer's
    healed copy of parameters and moments, 12; every group's activations
    and the replicated leaves gathered onto the positions); the schedule
    pass (the weights, stacked copies with their GPipe and 1F1B gradients
    and one pass's activations)."""
    act = gpt_activation_bytes(cfg, batch) // 2 \
        + pp_stages() * pp_replicated_bytes(cfg)
    parity = 16 * n_params + act
    drill = (16 * groups + 12) * n_params + groups * act
    schedules = 20 * n_params + act
    return max(parity, drill, schedules)


def stack_gpt_tree(tree, n_layers: int, stages: int):
    """The GPT's parameter tree (the reference's structure) with its
    layers stage-stacked: stage s holds layers s*L/S .. (s+1)*L/S - 1, as
    ``stages/layers_j`` leaves of a leading [S] dim; the embeddings, ln_f
    and the head stay as they are."""
    from torchft_tpu_torch.parallel import stack_stage_params

    per = n_layers // stages
    out = {k: v for k, v in tree.items() if not k.startswith("layers_")}
    out["stages"] = stack_stage_params([
        {f"layers_{j}": tree[f"layers_{s * per + j}"] for j in range(per)}
        for s in range(stages)])
    return out


@functools.lru_cache(maxsize=None)
def pipelined_gpt():
    """The class of the drill's model (defined on first use: the script
    imports torch and the port inside its phases)."""
    from torchft_tpu_torch.models import GPT, ShardedGPT, gpt_param_tree
    from torchft_tpu_torch.models.transformer import (
        _block,
        _layer_norm,
        _tree_set,
        ce_from_hidden,
        gpt_param_shapes,
    )
    from torchft_tpu_torch.parallel import (
        make_pipeline,
        merge_microbatches,
        split_microbatches,
    )

    class PipelinedGPT(ShardedGPT):
        """The GPT with its blocks over the mesh's ``stage`` axis, as the
        reference's PP test lays its model out: stage s runs layers
        s*L/S .. (s+1)*L/S - 1 through the functional block from
        stage-stacked leaves split on dim 0 over ``"stage"`` (each
        position holds exactly its stage's weights); the batch splits
        into ``microbatches`` GPipe microbatches (``make_pipeline``). The
        embeddings, ln_f and the head are replicated and run outside the
        pipeline, before ``split_microbatches`` and after
        ``merge_microbatches``, so autograd carries the gradient to the
        embedding. ``ShardedGPT``'s machinery holds the pieces, gathers
        the replicated leaves and gives the heal's state trees.
        ``params``: whole leaves in the reference's structure, else the
        unpipelined ``GPT``'s draw from ``seed``."""

        def __init__(self, cfg, mesh, params=None, seed: int = 0,
                     microbatches: int = PP_MICROBATCHES) -> None:
            mesh = getattr(mesh, "mesh", None) or mesh
            self.stages = mesh.shape["stage"]
            if cfg.n_layers % self.stages:
                raise ValueError(f"{cfg.n_layers} layers do not split over "
                                 f"{self.stages} stages")
            if params is None:
                params = gpt_param_tree(GPT(cfg, device=mesh.devices.flat[0],
                                            seed=seed))
            super().__init__(cfg, mesh, params=stack_gpt_tree(
                params, cfg.n_layers, self.stages), seed=seed)
            self.microbatches = microbatches
            self.pipeline = make_pipeline(mesh, self._stage)

        def _param_shapes(self):
            per = self.cfg.n_layers // self.stages
            out = {}
            for path, shape in gpt_param_shapes(self.cfg).items():
                if not path.startswith("layers_"):
                    out[path] = shape
                    continue
                layer, rest = path.split("/", 1)
                if int(layer.split("_")[1]) < per:
                    out[f"stages/{layer}/{rest}"] = (self.stages, *shape)
            return out

        def _rules(self):
            return [(r"stages/.*", 0, "stage")]

        def _check_layout(self, path, sharding):
            """Stage leaves split on dim 0 over "stage", nothing else
            split."""
            spec = tuple(sharding.spec)
            staged = spec[:1] == ("stage",)
            if staged != path.startswith("stages/") or any(
                    e is not None for e in spec[staged:]):
                raise ValueError(f"{path}: spec {sharding.spec} is not the "
                                 f"pipeline's layout")

        def _stage(self, params, h):
            for j in range(len(params)):
                h = _block(self.cfg, params[f"layers_{j}"], h)
            return h

        def stacked(self):
            """The stage leaves as ``ShardedTensor`` s over the live
            parameter pieces (autograd reaches them)."""
            tree = {}
            for path in self.paths:
                if path.startswith("stages/"):
                    _tree_set(tree, path[len("stages/"):],
                              self.layouts[path].like(self.pieces(path)))
            return tree

        def loss(self, tokens, targets):
            cfg, dt = self.cfg, self.cfg.dtype
            # the replicated leaves on the first position, their
            # gradient summed into every copy (ShardedGPT's gather)
            wte, wpe, ln_s, ln_b, head = (self._gather(p)[0] for p in (
                "wte/embedding", "wpe/embedding", "ln_f/scale", "ln_f/bias",
                "lm_head/kernel"))
            x = wte.to(dt)[tokens] \
                + wpe.to(dt)[:tokens.shape[1]][None, :, :]
            h = merge_microbatches(self.pipeline(
                self.stacked(), split_microbatches(x, self.microbatches)))
            return ce_from_hidden(_layer_norm(h, ln_s, ln_b), head, targets,
                                  cfg.xent_chunks)

        def grad_tree(self):
            """The gradients in the unpipelined GPT's structure
            (``layers_i`` for every layer), whole tensors."""
            per = self.cfg.n_layers // self.stages
            out = {}
            for path in self.paths:
                g = self._leaf(path, [p.grad for p in self.pieces(path)])
                g = g.full()
                if not path.startswith("stages/"):
                    _tree_set(out, path, g)
                    continue
                _, layer, rest = path.split("/", 2)
                j = int(layer.split("_")[1])
                for s in range(self.stages):
                    _tree_set(out, f"layers_{s * per + j}/{rest}", g[s])
            return out

    return PipelinedGPT


def run_pp_drill(cfg, *, device=None, batch: int = PP_BATCH, seed: int = 0,
                 microbatches: int = PP_MICROBATCHES, timeout: float = 600.0,
                 log=log) -> dict:
    """The PP x FT drill: ``examples.train_hsdp.run_hsdp_drill`` with each
    group's model a :func:`pipelined_gpt` over a virtual ``PP_AXES`` mesh
    of ``device`` (two groups of one rank, TCP at codec none, AdamW (3e-4)
    in optax's order on the pieces; group 1 fails after its 3rd commit,
    restarts from a poisoned init and heals into its stage-split template
    at 5; both commit to 7, every piece and moment bitwise at every joint
    step, every healed leaf in the healer's sharding, the heal's wire
    bytes the state's)."""
    from torchft_tpu_torch.examples.train_hsdp import run_hsdp_drill

    return run_hsdp_drill(
        cfg, PP_AXES, steps=PP_STEPS, kill_after=PP_KILL_AFTER,
        device=device, batch_size=batch, seed=seed,
        model_fn=functools.partial(pipelined_gpt(),
                                   microbatches=microbatches),
        timeout=timeout, log=log)


def pp_parity(cfg, seed: int, card: str, batch: int = PP_BATCH,
              device: str = "cuda") -> None:
    """One forward/backward of the same weights and batch through the
    pipelined GPT over ``PP_AXES`` (a virtual mesh of ``device``) and the
    unpipelined GPT (:func:`sharded_parity`)."""
    import torch

    from torchft_tpu_torch.models import GPT, gpt_param_tree
    from torchft_tpu_torch.parallel import ft_mesh

    dev = torch.device(device)
    dense = GPT(cfg, device=dev, seed=seed)
    mesh = ft_mesh(PP_AXES, devices=[dev] * pp_stages())
    piped = pipelined_gpt()(cfg, mesh, params=gpt_param_tree(dense))
    sample = [n for n in PP_GRAD_SAMPLE
              if not n.startswith("layers_")
              or int(n.split(".")[0].split("_")[1]) < cfg.n_layers]
    sharded_parity(dense, piped, sample, seed, card, batch,
                   f"pipelined {PP_AXES} x {PP_MICROBATCHES} microbatches")


def pp_schedules(cfg, seed: int, card: str, batch: int = PP_BATCH,
                 device: str = "cuda") -> list:
    """1F1B and interleaved 1F1B against GPipe with autograd at the drill's
    initial weights: the embedding's output fed in detached (the
    reference's ``embed_fn`` and ``loss_fn`` carry no parameters), ln_f,
    the head and the loss as ``loss_fn``. Every stage gradient of
    ``make_pipeline_1f1b`` (S = 4, M = 4, ``stage_fn`` the stage's layers)
    and of ``make_pipeline_interleaved_1f1b`` (V = layers / S: one layer a
    virtual stage) within ``PP_SCHEDULE_TOL`` of GPipe's; the losses
    within 1e-5; 1F1B's peak stored inputs equal to
    ``peak_inflight_activations(one_f_one_b_schedule(S, M))``. Raises on a
    miss; returns the lines it logged."""
    import torch

    from torchft_tpu_torch.models import GPT, gpt_param_tree
    from torchft_tpu_torch.models.transformer import (
        _block,
        _layer_norm,
        _tree_get,
        ce_from_hidden,
        gpt_param_shapes,
    )
    from torchft_tpu_torch.parallel import (
        ft_mesh,
        make_pipeline,
        make_pipeline_1f1b,
        make_pipeline_interleaved_1f1b,
        one_f_one_b_schedule,
        peak_inflight_activations,
        split_microbatches,
        stack_interleaved_params,
    )

    dev = torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    S, M, L = pp_stages(), PP_MICROBATCHES, cfg.n_layers
    V = L // S
    tree = gpt_param_tree(GPT(cfg, device=dev, seed=seed))
    mesh = ft_mesh(PP_AXES, devices=[dev] * S)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    tok = torch.randint(0, cfg.vocab_size, (batch, cfg.max_seq_len),
                        generator=gen, device=dev)
    dt = cfg.dtype
    with torch.no_grad():
        x = tree["wte"]["embedding"].to(dt)[tok] \
            + tree["wpe"]["embedding"].to(dt)[:cfg.max_seq_len][None]
    xm = split_microbatches(x, M)
    ym = split_microbatches(torch.roll(tok, -1, dims=1), M)

    def stage_fn(p, h):
        for j in range(len(p)):
            h = _block(cfg, p[f"layers_{j}"], h)
        return h

    def loss_fn(h, y):
        h = _layer_norm(h, tree["ln_f"]["scale"], tree["ln_f"]["bias"])
        return ce_from_hidden(h, tree["lm_head"]["kernel"], y,
                              cfg.xent_chunks)

    per = L // S
    names = [p.split("/", 1)[1] for p in gpt_param_shapes(cfg)
             if p.startswith("layers_0/")]
    stacked = stack_gpt_tree(tree, L, S)["stages"]
    for j in range(per):
        for n in names:
            _tree_get(stacked, f"layers_{j}/{n}").requires_grad_(True)
    times = {}
    sync()
    t0 = time.perf_counter()
    out = make_pipeline(mesh, stage_fn)(stacked, xm)
    gpipe_loss = sum(loss_fn(out[k], ym[k]) for k in range(M)) / M
    gpipe_loss.backward()
    sync()
    times["gpipe"] = time.perf_counter() - t0
    del out
    one = make_pipeline_1f1b(mesh, stage_fn, loss_fn, M)
    sync()
    t0 = time.perf_counter()
    one_loss, one_grads = one(stacked, xm, ym)
    sync()
    times["1f1b"] = time.perf_counter() - t0
    inter = make_pipeline_interleaved_1f1b(
        mesh, lambda p, h: _block(cfg, p, h), loss_fn, M, V)
    virtual = stack_interleaved_params(
        [tree[f"layers_{v}"] for v in range(L)], S, V)
    sync()
    t0 = time.perf_counter()
    int_loss, int_grads = inter(virtual, xm, ym)
    sync()
    times["interleaved"] = time.perf_counter() - t0
    failed = []
    worst = {"1f1b": 0.0, "interleaved": 0.0}
    for layer in range(L):
        s, j = divmod(layer, per)        # GPipe and 1F1B: stage s, its j-th
        row = (layer % S) * V + layer // S  # interleaved: device-major row
        for n in names:
            want = _tree_get(stacked, f"layers_{j}/{n}").grad[s].double()
            for arm, got in (
                    ("1f1b", _tree_get(one_grads, f"layers_{j}/{n}")[s]),
                    ("interleaved", _tree_get(int_grads, n)[row])):
                e = float((got.double() - want).norm()
                          / want.norm().clamp_min(1e-30))
                worst[arm] = max(worst[arm], e)
                if not e <= PP_SCHEDULE_TOL:
                    failed.append(f"{arm} layer {layer} {n}: {e:.3e}")
    peak = one.stats["peak_inflight"]
    want_peak = peak_inflight_activations(one_f_one_b_schedule(S, M))
    if peak != want_peak:
        failed.append(f"1F1B stored {peak} stage inputs at once, the "
                      f"schedule's peak is {want_peak}")
    losses = {"gpipe": gpipe_loss.item(), "1f1b": one_loss.item(),
              "interleaved": int_loss.item()}
    for arm in ("1f1b", "interleaved"):
        if not abs(losses[arm] - losses["gpipe"]) <= 1e-5 * max(
                1.0, abs(losses["gpipe"])):
            failed.append(f"{arm} loss {losses[arm]} against GPipe's "
                          f"{losses['gpipe']}")
    line = (f"schedules at S = {S}, M = {M}: losses {losses}; stage "
            f"gradients' largest relative difference to GPipe with "
            f"autograd: 1F1B {worst['1f1b']:.3e}, interleaved (V = {V}) "
            f"{worst['interleaved']:.3e} (tolerance {PP_SCHEDULE_TOL}); "
            f"1F1B peak stored inputs {peak}, peak_inflight_activations "
            f"{want_peak}; seconds a pass "
            + ", ".join(f"{k} {v:.3f}" for k, v in times.items())
            + f" ({card})")
    log("  " + line)
    del tree, stacked, virtual, one_grads, int_grads
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"the 1F1B schedules against GPipe: {failed}")
    return [line]


def flash_times_at(rows: dict, shape) -> "dict | None":
    """{kernel: times} the kernels phase took at ``shape``, or None."""
    out = {}
    for name in FLASH_KERNELS:
        for row in rows.get(name, {}).get("per_head_dim", ()):
            for t in [row] + row.get("also_timed", []):
                if t.get("shape") == list(shape):
                    out[name] = t
    return out if len(out) == len(FLASH_KERNELS) else None


def phase_train_pp(seed: int, card: str, batch: int = PP_BATCH,
                   times: "dict | None" = None):
    """The PP phase (module docstring, phase 19): the parity pass, the
    drill with the launch counts set to 0 just before it and read just
    after, then the schedule pass. ``times``: the flash kernels' times at
    a microbatch's shape from the kernels phase (timed here if None).
    Returns (the drill's launches, the launches the schedule says, the
    head_dim)."""
    import torch

    from torchft_tpu_torch.models import gpt_param_shapes
    from torchft_tpu_torch.ops import flash, quant

    t0 = time.perf_counter()
    cfg = pp_config()
    n_params = sum(math.prod(s) for s in gpt_param_shapes(cfg).values())
    need_host = hsdp_host_bytes(n_params)
    free_host = check_host_memory(need_host, what="train_pp")
    need = pp_device_bytes(n_params, cfg, batch)
    gc.collect()  # an earlier phase's cycles may hold tensors
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info()[0]
    if free < need:
        raise AssertionError(f"train_pp needs {need / 1e9:.2f} GB of device "
                             f"memory free, has {free / 1e9:.2f} GB")
    shape = pp_attention_shape(cfg, batch)
    log(f"  125m: {n_params} parameters, {cfg.n_layers} layers, heads "
        f"{cfg.n_heads} of {cfg.head_dim}, seq {cfg.max_seq_len}, "
        f"xent_chunks {cfg.xent_chunks}, remat {cfg.remat}; batch {batch} "
        f"in {PP_MICROBATCHES} microbatches over {PP_AXES} (virtual "
        f"positions, {cfg.n_layers // pp_stages()} layers a stage), "
        f"attention {shape} a call; device memory: up to "
        f"{need / 1e9:.2f} GB (reckoned before the run), "
        f"{free / 1e9:.1f} GB free; host memory: up to "
        f"{need_host / 1e9:.2f} GB, {free_host / 1e9:.1f} GB available")
    if times is None:
        times = hsdp_flash_times(seed, shape)
    per_pass = pp_launches(1, cfg.n_layers)
    pass_ms = {n: per_pass[n] * times[n]["ms"] for n in per_pass}
    pass_ms["total"] = sum(pass_ms.values())
    pp_parity(cfg, seed, card, batch)
    torch.cuda.reset_peak_memory_stats()
    flash.reset_launch_counts()
    quant.reset_launch_counts()
    result = run_pp_drill(cfg, device="cuda", batch=batch, seed=seed,
                          log=lambda m: log("  " + m))
    counts = {**flash.LAUNCHES, **quant.LAUNCHES}
    want = {**pp_launches(result["passes"], cfg.n_layers),
            **dict.fromkeys(quant.LAUNCHES, 0)}
    peak = torch.cuda.max_memory_allocated()
    for line in hsdp_report(result, cfg, batch, per_pass, pass_ms, card,
                            layout=f"{PP_MICROBATCHES} microbatches x "
                                   f"{cfg.n_layers} layers, no remat"):
        log("  " + line)
    log(f"  device memory peak: {peak / 1e9:.2f} GB allocated, "
        f"{torch.cuda.max_memory_reserved() / 1e9:.2f} GB reserved "
        f"(reckoned {need / 1e9:.2f} GB) ({card})")
    del result
    gc.collect()
    torch.cuda.empty_cache()
    pp_schedules(cfg, seed, card, batch)
    log(f"  phase {time.perf_counter() - t0:.1f} s ({card})")
    return counts, want, cfg.head_dim


def pp_config():
    """"125m", full width and depth."""
    from torchft_tpu_torch.models import CONFIGS

    return CONFIGS["125m"]


# pipeline_plane: the MPMD stage plane (pipeline.py) on the card
PLANE = dict(num_stages=4, replicas=2, microbatches=8,
             layer_dims=(768,) * 13, batch=1024)  # 3 layers a stage
PLANE_STEPS = 3
PLANE_CODECS = (("none", False), ("bf16", False), ("int8", True))
PLANE_KILL = (1, 1)         # a middle stage's second replica
PLANE_KILL_AFTER = 2        # schedule actions into the step
PLANE_REBALANCE = [[0, 1, 2, 3], [4, 5, 6], [7, 8], [9, 10, 11]]


def _plane_sum(pipe, name: str) -> float:
    return sum(s.get(name, 0.0) for s in pipe.metrics_snapshots().values())


def plane_lane_sequence(stage: int, lane: int, shape: dict) -> list:
    """Stage ``stage``'s (phase, microbatch) order on lane ``lane`` of a
    fault-free 1F1B step: the per-lane projection of the schedule over the
    lane's microbatches (lane, lane + R, ...)."""
    from torchft_tpu_torch.pipeline import expected_stage_sequence

    r = shape["replicas"]
    seq = expected_stage_sequence(shape["num_stages"],
                                  shape["microbatches"] // r, stage)
    return [(phase, lane + r * k) for phase, k in seq]


def phase_pipeline_plane(seed: int, card: str, device: str = "cuda",
                         shape: "dict | None" = None,
                         steps: int = PLANE_STEPS) -> list:
    """The plane's phase (module docstring, phase 20): the reference's own
    oracles on the card. Raises on a miss; returns the lines it logged."""
    from torchft_tpu_torch.pipeline import (
        Pipeline,
        PipelineConfig,
        reconstruct_pipe_schedule,
    )

    t_phase = time.perf_counter()
    shape = dict(PLANE if shape is None else shape)
    lines = []

    def make(**kw):
        return Pipeline(PipelineConfig(seed=seed, device=device,
                                       step_timeout=120.0, **shape, **kw))

    def say(line: str) -> None:
        lines.append(line)
        log("  " + line)

    def steps_of(pipe, n: int):
        """Run ``n`` fault-free steps: each one's seconds, frame bytes,
        global hash and loss, and the most inputs a replica held."""
        secs, nbytes, hashes, losses, peak = [], [], [], [], 0
        for _ in range(n):
            before = _plane_sum(pipe, "pipe_stage_bytes")
            t0 = time.perf_counter()
            r = pipe.run_step()
            secs.append(time.perf_counter() - t0)
            _require(not r["aborted"] and not r["killed"],
                     f"step {r['step']} aborted or lost a replica")
            _require(r["loss"] is not None and math.isfinite(r["loss"]),
                     f"step {r['step']}: loss {r['loss']}")
            nbytes.append(int(_plane_sum(pipe, "pipe_stage_bytes") - before))
            hashes.append(pipe.global_param_hash())
            losses.append(r["loss"])
            peak = max(peak, r["inflight_peak"])
        return secs, nbytes, hashes, losses, peak

    frame = shape["batch"] * shape["layer_dims"][1] * 4
    say(f"plane: {shape['num_stages']} stages x {shape['replicas']} "
        f"replicas, {shape['microbatches']} microbatches of "
        f"{shape['batch']} rows, layers {len(shape['layer_dims']) - 1} of "
        f"{shape['layer_dims'][1]} (f32 activation frame {frame} bytes), "
        f"on {device}")
    for codec, ef in PLANE_CODECS:
        hashes = {}
        for streaming in (True, False):
            pipe = make(codec=codec, error_feedback=ef, streaming=streaming)
            try:
                secs, nbytes, traj, losses, peak = steps_of(pipe, steps)
                if codec == "none" and streaming:
                    # the executed schedule from the events alone
                    for (s, r), rep in sorted(pipe.replicas.items()):
                        rec = reconstruct_pipe_schedule([rep.events.dump()])
                        want = plane_lane_sequence(s, r, shape)
                        for step in range(steps):
                            _require(rec.get(step, {}).get(s) == want,
                                     f"stage {s} replica {r} step {step}: "
                                     f"events give {rec.get(step, {})}")
            finally:
                pipe.close()
            hashes[streaming] = traj
            say(f"{codec}{' + EF' if ef else ''} "
                f"{'1F1B' if streaming else 'GPipe stage-serial'}: step s "
                f"{[round(x, 3) for x in secs]}, frame bytes a step "
                f"{nbytes}, losses {[round(x, 6) for x in losses]}, "
                f"most inputs a replica held {peak} ({card})")
        _require(hashes[True] == hashes[False],
                 f"{codec}: 1F1B and stage-serial parameters differ")
        say(f"{codec}: 1F1B sha256-equal to stage-serial at every step "
            f"({steps})")
    say(f"the schedule rebuilt from each replica's events equals its "
        f"lane's projection of one_f_one_b_schedule at every step")
    # a mid-step kill of a middle stage's replica, healed and drained
    s_k, r_k = PLANE_KILL
    for on_kill in ("heal", "drain"):
        pipe = make(on_kill=on_kill)
        try:
            steps_of(pipe, 1)
            pipe.schedule_kill(s_k, r_k, after_actions=PLANE_KILL_AFTER)
            t0 = time.perf_counter()
            r = pipe.run_step()
            kill_s = time.perf_counter() - t0
            _require(r["killed"] == [PLANE_KILL] and not r["aborted"],
                     f"{on_kill}: the kill step gave {r['killed']}, "
                     f"aborted {r['aborted']}")
            drained = _plane_sum(pipe, "pipe_drained_steps")
            if on_kill == "heal":
                t0 = time.perf_counter()
                info = pipe.heal(s_k, r_k)
                heal_ms = (time.perf_counter() - t0) * 1e3
                _require(drained == 0, f"heal: {drained} drained steps")
                _require(_plane_sum(pipe, "pipe_replay_microbatches") > 0,
                         "heal: no replay wave")
                _require(info["moved_bytes"] == info["lower_bound_bytes"]
                         == pipe.stage_param_bytes(s_k),
                         f"heal moved {info}, stage bytes "
                         f"{pipe.stage_param_bytes(s_k)}")
                moved = _plane_sum(pipe, "redist_moved_bytes")
                lower = _plane_sum(pipe, "redist_lower_bound_bytes")
                _require(moved == lower, f"redist_moved_bytes {moved} != "
                                         f"redist_lower_bound_bytes {lower}")
                steps_of(pipe, 1)
                say(f"heal arm: stage {s_k} replica {r_k} killed "
                    f"{PLANE_KILL_AFTER} actions into step 1, which "
                    f"committed in {kill_s:.3f} s with pipe_drained_steps "
                    f"0 and {_plane_sum(pipe, 'pipe_replay_microbatches'):g}"
                    f" replayed frames; heal {heal_ms:.1f} ms, "
                    f"redist_moved_bytes {int(moved)} = "
                    f"redist_lower_bound_bytes {int(lower)} (of "
                    f"{pipe.total_param_bytes()} in the model); step 2 "
                    f"committed by all {len(pipe.replicas)} ({card})")
            else:
                moved = _plane_sum(pipe, "redist_moved_bytes")
                _require(drained >= 1, "drain: no drained step")
                _require(moved == pipe.total_param_bytes(),
                         f"drain moved {moved}, the tree is "
                         f"{pipe.total_param_bytes()}")
                say(f"drain arm: the same kill drained {drained:g} replica "
                    f"steps and refetched the full tree, {int(moved)} "
                    f"bytes; the rerun committed in {kill_s:.3f} s ({card})")
        finally:
            pipe.close()
    # one rebalance, bitwise against a control that never rebalanced
    control, moved = make(), make()
    try:
        steps_of(control, 1)
        steps_of(moved, 1)
        before = moved.global_param_hash()
        t0 = time.perf_counter()
        info = moved.rebalance(PLANE_REBALANCE)
        ms = (time.perf_counter() - t0) * 1e3
        _require(info["moved_bytes"] == info["lower_bound_bytes"] > 0,
                 f"rebalance moved {info}")
        _require(moved.global_param_hash() == before,
                 "the rebalance changed the parameters")
        a, b = steps_of(control, 2)[2], steps_of(moved, 2)[2]
        _require(a == b, "the rebalanced run left the control's trajectory")
        say(f"rebalance to {PLANE_REBALANCE}: {info['moved_bytes']} bytes "
            f"moved = the plan's lower bound, {ms:.1f} ms; 2 more steps "
            f"sha256-equal to the control ({card})")
    finally:
        control.close()
        moved.close()
    say(f"phase {time.perf_counter() - t_phase:.1f} s ({card})")
    return lines


# fused_step: the fused HSDP step (fused.py) at "125m" over a replica x
# model mesh of the visible cards (a virtual mesh of one card)
FUSED_MESH = (2, 2)         # replicas x model shards: 4 positions
FUSED_SEQS = 2              # sequences of a position's microbatch
FUSED_STEPS = 3             # steps of each arm per codec, from one state
FUSED_CODECS = ("none", "bf16", "int8")
FUSED_CHURN = ((4, 1), (2, 2), (4, 1))  # the int8 arm's shapes after 2x2
FUSED_CHUNK_BYTES = 1 << 16  # the engine's chunk grid: 16,384 f32
FUSED_PROFILE_STEPS = 2     # steps of each arm in the StepProfiler window
FUSED_ADAMW = dict(learning_rate=3e-4, weight_decay=1e-4)
FUSED_STAGES = 4            # programs of the staged arm


def fused_config():
    """"125m", full width and depth."""
    from torchft_tpu_torch.models import CONFIGS

    return CONFIGS["125m"]


def gpt_row_loss(seq: int):
    """``loss(model, row)``: a position's batch row of f32 token ids, cut
    into sequences of ``seq``, the model's mean next-token loss with the
    targets rolled as ``sharded_parity`` rolls them."""
    import torch

    def loss(model, row):
        tok = row.view(-1, seq).long()
        return model.loss(tok, torch.roll(tok, -1, dims=1))

    return loss


def fused_batch(seed: int, step: int, cfg, positions: int,
                seqs: int = FUSED_SEQS):
    """Step ``step``'s batch rows: ``(positions, seqs * seq)`` f32 token
    ids drawn from the seed."""
    import torch

    gen = torch.Generator().manual_seed(seed * 1000 + step)
    tok = torch.randint(0, cfg.vocab_size,
                        (positions, seqs * cfg.max_seq_len), generator=gen)
    return tok.float().numpy()


def fused_shape(n_params: int, mesh) -> dict:
    """The engine's lengths at a mesh shape: positions, q_len, p_len."""
    r, m = mesh
    q = -(-n_params // (r * m))
    return {"positions": r * m, "q_len": q, "p_len": r * q}


def fused_launches(runs: int, layers: int, positions: int, codec: str,
                   ef: bool = True, cards: int = 1) -> dict:
    """Each kernel's launches in ``runs`` runs of the step's stages (a
    replay, or the warm-up run before a capture): per run one GPT pass per
    position (each flash kernel once per layer, no remat at "125m"), and
    under int8, on each of the ``cards`` that hold positions, one
    ``quant_int8`` for the card's slots, one ``dequant_acc_int8`` for the
    rank-order accumulate of its owners and one more for the error
    feedback's wire image of its slots."""
    flash = runs * positions * layers
    q = runs * cards if codec == "int8" else 0
    return {"flash_fwd": flash, "flash_bwd_dq": flash, "flash_bwd_dkv": flash,
            "quant_int8": q, "dequant_acc_int8": q * (2 if ef else 1)}


def fused_host_hop_bytes(n_params: int, mesh=FUSED_MESH) -> int:
    """Bytes one staged step sends through the host: gm (D x p_len), h and
    new_sub (D x q_len each), f32, each down and up."""
    s = fused_shape(n_params, mesh)
    d = s["positions"]
    return 2 * 4 * (d * s["p_len"] + 2 * d * s["q_len"])


def fused_device_bytes(n_params: int, cfg, mesh=FUSED_MESH,
                       churn=FUSED_CHURN, cards: int = 1) -> int:
    """A reckoning of the phase's device memory at its peak on the fullest
    of ``cards`` (the mesh cycled over them, so the first), the int8 arm's
    churn, where a fused and a staged engine hold both shapes: per engine
    and shape the state of the card's n positions (params and residual, n
    x p_len f32 each; AdamW's moments, n x q_len each); the staged engine's
    input buffers (gm, h, new_sub); per engine the graphs' transients at
    the larger shape (the int8 exchange's gm, gq, wire image and new
    residual at n x p_len f32, the int8 slots at n x p_len bytes, h twice
    at n x q_len, and the update's new sub-shards and moments, 3 x n x
    q_len; over several cards a row's gathered params and a gradient kept
    for its reduce-scatter, M x p_len f32 each); the model's f32
    parameters and one position's activations."""
    shapes = [mesh] + [s for s in churn if s != mesh][:1]
    state = staged = transient = 0
    for sh in shapes:
        s = fused_shape(n_params, sh)
        n = -(-s["positions"] // cards)
        dp, dq = n * s["p_len"], n * s["q_len"]
        state += 4 * (2 * dp + 2 * dq)
        staged += 4 * (dp + 2 * dq)
        row = 2 * 4 * sh[1] * s["p_len"] if cards > 1 else 0
        transient = max(transient, 4 * (4 * dp + 5 * dq) + dp + row)
    return 2 * state + staged + 2 * transient + 4 * n_params \
        + gpt_activation_bytes(cfg, FUSED_SEQS)


def fused_cross_card_bytes(n_params: int, mesh, card_of, codec: str,
                           chunk_bytes: int = FUSED_CHUNK_BYTES) -> dict:
    """Bytes one step moves between cards, per stage, as the stage bodies
    copy them (``cuda_backend._fused_local_fns``), position d on card
    ``card_of[d]``: the model-axis allgather (each other card's shard of a
    row, once per card of the row), the reduce-scatter (each gradient's
    shards bound for another card; the losses to the first card), the
    exchange (each slot whose source and owner lie on two cards: f32 raw,
    2 bytes under bf16/fp16, 1 byte and a scale a chunk under int8) and
    the replica gather (each source's raw sub-shard to every other card of
    its model shard)."""
    r_, m_ = mesh
    s = fused_shape(n_params, mesh)
    q, p = s["q_len"], s["p_len"]
    step = max(1, chunk_bytes // 4)
    slot = {"none": 4 * q, "bf16": 2 * q, "fp16": 2 * q,
            "int8": q + 4 * -(-q // step)}[codec]
    out = dict.fromkeys(("allgather", "reduce_scatter", "exchange",
                         "gather"), 0)
    for r in range(r_):
        row = [card_of[r * m_ + k] for k in range(m_)]
        for c in set(row):
            out["allgather"] += 4 * p * sum(x != c for x in row)
        for m in range(m_):
            out["reduce_scatter"] += 4 * p * sum(x != row[m] for x in row)
    for d in range(r_ * m_):
        r, m = divmod(d, m_)
        out["reduce_scatter"] += 4 * (card_of[d] != card_of[0])
        for src in range(r_):
            other = card_of[src * m_ + m] != card_of[d]
            out["exchange"] += slot * other
            out["gather"] += 4 * q * other
    out["total"] = sum(out.values())
    return out


def fused_host_bytes(n_params: int, mesh=FUSED_MESH,
                     churn=FUSED_CHURN) -> int:
    """Host memory the phase may hold: the staged engine's pinned staging
    at both shapes, and the int8 oracle's copies (gm, the residual before
    and after, gq and the wire image: 5 x D x p_len f32)."""
    shapes = [mesh] + [s for s in churn if s != mesh][:1]
    pinned = sum(fused_host_hop_bytes(n_params, sh) // 2 for sh in shapes)
    s = fused_shape(n_params, mesh)
    return pinned + 5 * 4 * s["positions"] * s["p_len"]


def assemble_grad(h, replicas: int, model_shards: int):
    """The flat averaged gradient from the exchange's ``h`` (D x q_len):
    element (m, r, k) of the padded vector is h[r * M + m, k]."""
    d, q = h.shape
    return h.reshape(replicas, model_shards, q).transpose(1, 0, 2).reshape(-1)


def host_int8_exchange(gm, e, replicas: int, model_shards: int,
                       chunk_bytes: int, ef: bool = True):
    """The int8 exchange on the host, the numpy codec of the TCP wire: every
    destination slot of ``gm`` (+ ``e``) encoded and decoded on its chunk
    grid (``codec_roundtrip``), each position's slots summed from 0 in rank
    order and divided by R*M; the new residual ``gq - wire image``.
    Returns (h, e)."""
    import numpy as np

    from torchft_tpu_torch.comm.transport import _CODECS, codec_roundtrip

    codec = _CODECS["int8"]()
    r_, m_ = replicas, model_shards
    d_, p_len = gm.shape
    q = p_len // r_
    gq = (gm + e).astype(np.float32) if ef else gm
    wire = np.empty_like(gq)
    for d in range(d_):
        for j in range(r_):
            sl = slice(j * q, (j + 1) * q)
            codec_roundtrip(codec, chunk_bytes,
                            np.ascontiguousarray(gq[d, sl]), wire[d, sl])
    h = np.empty((d_, q), np.float32)
    for d in range(d_):
        r, m = divmod(d, m_)
        acc = np.zeros(q, np.float32)
        for src in range(r_):
            acc = acc + wire[src * m_ + m, r * q:(r + 1) * q]
        h[d] = acc / np.float32(r_ * m_)
    return h, ((gq - wire) if ef else e)


def same_state(a, b) -> bool:
    """Two engines' device states bitwise equal (every tensor the digest
    hashes), compared on the device."""
    import torch

    return all(x.shape == y.shape and torch.equal(_bits(x), _bits(y))
               for x, y in zip(a.state_tensors(), b.state_tensors()))


def timed_step(fn, batch, cuda: bool) -> tuple:
    """(loss, device ms by CUDA events around the call, wall ms)."""
    import torch

    ev = None
    if cuda:
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
    t0 = time.perf_counter()
    loss = fn(batch)
    if cuda:
        ev[1].record()
        ev[1].synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    return loss, (ev[0].elapsed_time(ev[1]) if cuda else None), wall


def busy_share(prof, label: str, card=None):
    """The device's busy share inside the host ranges named ``label`` of a
    ``torch.profiler`` trace: the union of the device events' intervals
    there (of card index ``card`` alone when given, else of every card)
    over the ranges' length. None where the trace holds no device
    event."""
    from torch.autograd import DeviceType

    events = list(prof.events())
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.name == label and e.device_type == DeviceType.CPU)
    dev = sorted((e.time_range.start, e.time_range.end) for e in events
                 if e.device_type == DeviceType.CUDA
                 and (card is None or e.device_index == card))
    if not spans or not dev:
        return None
    busy = total = 0.0
    for lo, hi in spans:
        total += hi - lo
        end = lo
        for s, t in dev:
            s, t = max(s, end), min(t, hi)
            if t > s:
                busy += t - s
                end = t
    return busy / total if total else None


def dense_gradient(model, batch, seq: int):
    """The unsharded model's loss and flat gradient on all positions'
    sequences of ``batch`` at once."""
    import torch

    dev = next(model.parameters()).device
    tok = torch.from_numpy(batch).to(dev).view(-1, seq).long()
    model.zero_grad(set_to_none=True)
    loss = model.loss(tok, torch.roll(tok, -1, dims=1))
    loss.backward()
    grad = torch.cat([p.grad.reshape(-1) for p in model.parameters()])
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), grad.cpu().numpy()


def check_grad_parity(staged, loss: float, dense: tuple, card: str) -> None:
    """Codec none: ``h`` as the staged arm read it at its host hop,
    assembled in (m, r) order, against the unsharded model's gradient of
    the same sequences (``GRAD_REL_NORM``), the step's loss against its
    loss (``LOSS_TOL``)."""
    import numpy as np

    spec = staged.spec
    h = staged._host_rows(staged._staged_buffers()["h"][1])
    got = assemble_grad(h, spec.replicas, spec.model_shards)
    got = got[:spec.param_size].astype(np.float64)
    want = dense[1].astype(np.float64)
    rel = float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                 1e-30))
    ok = bool(np.isfinite(got).all()) and rel <= GRAD_REL_NORM \
        and abs(loss - dense[0]) <= LOSS_TOL
    log(f"  codec none, step 1: h at the staged arm's host hop (assembled "
        f"in (m, r) order) against the unsharded GPT's gradient of the same "
        f"{spec.positions * FUSED_SEQS} sequences: relative norm of the "
        f"difference {rel:.3e} (tolerance {GRAD_REL_NORM}); loss {loss:.6f} "
        f"against {dense[0]:.6f} (|diff| {abs(loss - dense[0]):.3e}, "
        f"tolerance {LOSS_TOL}) {'ok' if ok else 'FAIL'} ({card})")
    _require(ok, f"fused step's gradient against the unsharded GPT: "
                 f"relative norm {rel}, loss {loss} against {dense[0]}")


def check_int8_exchange(staged, e_before, card: str) -> None:
    """Int8: the exchange's ``h`` and new residual as the staged arm left
    them, bitwise against the host codec on the same ``gm`` (read at its
    hop) and the residual before the step."""
    import numpy as np

    t0 = time.perf_counter()
    spec = staged.spec
    bufs = staged._staged_buffers()
    gm = staged._host_rows(bufs["gm"][1])
    h = staged._host_rows(bufs["h"][1])
    e_after = staged._host_rows(staged._state.e)
    want_h, want_e = host_int8_exchange(gm, e_before, spec.replicas,
                                        spec.model_shards, spec.chunk_bytes,
                                        spec.error_feedback)
    ok = h.view(np.int32).tobytes() == want_h.view(np.int32).tobytes() \
        and e_after.view(np.int32).tobytes() \
        == want_e.view(np.int32).tobytes()
    log(f"  codec int8, step 2: the exchange's h and residual against the "
        f"host codec on the same gm and residual (q_len {spec.q_len} on "
        f"the {spec.chunk_bytes // 4}-element grid): bitwise "
        f"{'ok' if ok else 'FAIL'} ({time.perf_counter() - t0:.1f} s; "
        f"{card})")
    _require(ok, "the card's int8 exchange disagrees with the host codec")


def run_fused_arm(codec: str, params, loss_fn, batches, device, card: str,
                  dense=None, profile: bool = False,
                  devices=None) -> dict:
    """One codec's arms: a fused and a staged engine from the same state,
    ``FUSED_STEPS`` steps each on the same batches, every state bitwise
    equal after every step, the counters and the program cache checked,
    the oracles of the codec; under int8 the churn over ``FUSED_CHURN``.
    ``devices``: the pool's positions (several cards), else a virtual mesh
    of ``device``. Returns the runs of the stages (for the launch
    schedule), the times and, over several cards, the digest after the
    ``FUSED_STEPS`` steps."""
    import torch

    from torchft_tpu_torch.comm.cuda_backend import DevicePool
    from torchft_tpu_torch.fused import FusedStepEngine
    from torchft_tpu_torch.optim import adamw

    cuda = torch.device(device).type == "cuda"
    R, M = FUSED_MESH
    pool = DevicePool(devices=devices) if devices else DevicePool(device)
    batch_size = batches[0].shape[1]
    kw = dict(codec=codec, chunk_bytes=FUSED_CHUNK_BYTES, fn_key="gpt")
    fused = FusedStepEngine(pool, R, M, params, batch_size, loss_fn,
                            adamw(**FUSED_ADAMW), **kw)
    staged = FusedStepEngine(pool, R, M, params, batch_size, loss_fn,
                             adamw(**FUSED_ADAMW), **kw)
    _require(same_state(fused, staged), f"{codec}: initial states differ")
    captures = {"fused": 1, "staged": FUSED_STAGES} if cuda \
        else {"fused": 0, "staged": 0}
    times = {"fused": [], "staged": [], "fused_wall": [], "staged_wall": []}
    runs = 0
    for step in range(FUSED_STEPS):
        b = batches[step]
        e_before = (staged._host_rows(staged._state.e)
                    if codec == "int8" and step == 1 else None)
        c0 = (fused.counters(), staged.counters())
        lf, ms_f, wall_f = timed_step(fused.step_fused, b, cuda)
        ls, ms_s, wall_s = timed_step(staged.step_staged, b, cuda)
        c1 = (fused.counters(), staged.counters())
        runs += 2 + (2 if step == 0 and cuda else 0)
        for k, v in (("fused", ms_f), ("staged", ms_s),
                     ("fused_wall", wall_f), ("staged_wall", wall_s)):
            times[k].append(v)
        delta = [(c1[i]["step_dispatch_count"] - c0[i]["step_dispatch_count"],
                  c1[i]["step_host_hops"] - c0[i]["step_host_hops"])
                 for i in range(2)]
        _require(delta == [(1, 0), (FUSED_STAGES, 6)],
                 f"{codec}: dispatches/hops per step {delta}, want "
                 f"fused 1/0 and staged {FUSED_STAGES}/6")
        _require(lf == ls and lf == lf, f"{codec}: losses {lf} and {ls}")
        _require(same_state(fused, staged),
                 f"{codec}: fused and staged states differ after step "
                 f"{step + 1}")
        _require(pool.compile_count == 1 + FUSED_STAGES
                 and fused.captures == captures["fused"]
                 and staged.captures == captures["staged"],
                 f"{codec}: {pool.compile_count} programs and "
                 f"{fused.captures}/{staged.captures} captures after step "
                 f"{step + 1}")
        log(f"  {codec} step {step + 1}: loss {lf:.6f} both arms, states "
            f"bitwise equal; device ms fused "
            f"{_ms(ms_f)} (one replay), staged {_ms(ms_s)} (four replays, "
            f"six hops); wall ms {wall_f:.1f} / {wall_s:.1f} ({card})")
        if codec == "none" and step == 0 and dense is not None:
            check_grad_parity(staged, ls, dense, card)
        if e_before is not None:
            check_int8_exchange(staged, e_before, card)
    hits = pool.hit_count
    log(f"  {codec}: programs built {pool.compile_count} (1 fused + "
        f"{FUSED_STAGES} stages), captures {fused.captures} fused + "
        f"{staged.captures} staged, cache hits {hits}")
    out = {"runs": runs, "times": times, "profile": None,
           "digest": fused.digest() if devices else None}
    if profile:
        out["profile"] = fused_profile(fused, staged, batches, cuda, card)
        out["runs"] += 2 * FUSED_PROFILE_STEPS
    if codec == "int8":
        out["runs"] += fused_churn(fused, staged, batches, cuda, card)
        _require(pool.hit_count > hits, "int8 churn hit no cached program")
        t0 = time.perf_counter()
        # the staged state is its bitwise twin (same_state after each step)
        log(f"  int8 after the churn: sha256 of the state "
            f"{fused.digest()[:16]} ({time.perf_counter() - t0:.1f} s)")
    del fused, staged, pool
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return out


def fused_virtual_digest(codec: str, params, loss_fn, batches, device,
                         want: str, card: str) -> int:
    """Over several cards: ``FUSED_STEPS`` fused steps of a fresh engine on
    the virtual 2x2 of ``device`` from the same state and batches (device
    and wall ms a step printed beside the cards'); its digest must be
    ``want``, the cards' after as many steps. Returns the stage runs (the
    steps and the warm-up before the capture)."""
    import torch

    from torchft_tpu_torch.comm.cuda_backend import DevicePool
    from torchft_tpu_torch.fused import FusedStepEngine
    from torchft_tpu_torch.optim import adamw

    t0 = time.perf_counter()
    R, M = FUSED_MESH
    eng = FusedStepEngine(DevicePool(device), R, M, params,
                          batches[0].shape[1], loss_fn, adamw(**FUSED_ADAMW),
                          codec=codec, chunk_bytes=FUSED_CHUNK_BYTES,
                          fn_key="gpt")
    cuda = torch.device(device).type == "cuda"
    ms, wall = [], []
    for step in range(FUSED_STEPS):
        _, m, w = timed_step(eng.step_fused, batches[step], cuda)
        ms.append(m)
        wall.append(w)
    got = eng.digest()
    log(f"  {codec}: {FUSED_STEPS} fused steps on the virtual {R}x{M} of "
        f"{device}: device ms {[_ms(v) for v in ms]}, wall ms "
        f"{[round(v, 1) for v in wall]}; sha256 {got[:16]}, over the cards "
        f"{want[:16]}: {'equal' if got == want else 'FAIL'} "
        f"({time.perf_counter() - t0:.1f} s; {card})")
    _require(got == want, f"{codec}: the virtual mesh's digest {got} is not "
                          f"the cards' {want}")
    del eng
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return FUSED_STEPS + (1 if cuda else 0)


def _ms(v) -> str:
    return "not measured" if v is None else f"{v:.2f}"


def _share(v) -> str:
    return "not measured" if v is None else f"{v:.3f}"


def fused_profile(fused, staged, batches, cuda: bool, card: str) -> dict:
    """``FUSED_PROFILE_STEPS`` steps of each arm in one ``StepProfiler``
    window (a trace under the temp dir, removed after): the device's busy
    share in each arm's steps, the states bitwise after."""
    import shutil
    import tempfile

    import torch

    from torchft_tpu_torch.utils.profiling import StepProfiler

    t0 = time.perf_counter()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    log_dir = tempfile.mkdtemp(prefix="fused_step_trace_")
    try:
        with StepProfiler(log_dir=log_dir, start=0,
                          num_steps=2 * FUSED_PROFILE_STEPS) as prof:
            for label, fn in (("fused_arm", fused.step_fused),
                              ("staged_arm", staged.step_staged)):
                for i in range(FUSED_PROFILE_STEPS):
                    prof.step()
                    sync()
                    with torch.profiler.record_function(label):
                        fn(batches[FUSED_STEPS + i])
                        sync()
            prof.step()
        trace_bytes = sum(os.path.getsize(os.path.join(log_dir, f))
                          for f in os.listdir(log_dir))
        share = {arm: busy_share(prof.profile, f"{arm}_arm")
                 for arm in ("fused", "staged")}
        cards = [d.index for d in fused._cards.devices] if cuda else []
        per_card = {arm: [busy_share(prof.profile, f"{arm}_arm", i)
                          for i in cards] for arm in ("fused", "staged")}
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    _require(same_state(fused, staged), "states differ after the profile")
    log(f"  StepProfiler window ({time.perf_counter() - t0:.1f} s) over "
        f"{FUSED_PROFILE_STEPS} fused and "
        f"{FUSED_PROFILE_STEPS} staged steps (trace {trace_bytes} bytes): "
        f"device busy share fused {_share(share['fused'])}, staged "
        f"{_share(share['staged'])} ({card})")
    if len(cards) > 1:
        log(f"  busy share a card ({', '.join(f'cuda:{i}' for i in cards)}):"
            f" fused {[_share(v) for v in per_card['fused']]}, staged "
            f"{[_share(v) for v in per_card['staged']]} ({card})")
    return share


def fused_churn(fused, staged, batches, cuda: bool, card: str) -> int:
    """Both engines through ``FUSED_CHURN`` (one step of each arm at every
    shape): states bitwise, ``verify_replicas`` on both, a shape seen
    before costs no program and no capture. Returns the stage runs."""
    pool = fused.pool
    seen = {FUSED_MESH}
    runs = 0
    for i, shape in enumerate(FUSED_CHURN):
        t0 = time.perf_counter()
        before = (pool.compile_count, fused.captures, staged.captures)
        for eng in (fused, staged):
            eng.reshape_mesh(*shape)
        _require(same_state(fused, staged), f"states differ at {shape}")
        b = batches[i][:, :]
        lf = fused.step_fused(b)
        ls = staged.step_staged(b)
        new = shape not in seen
        runs += 2 + (2 if new and cuda else 0)
        after = (pool.compile_count, fused.captures, staged.captures)
        want = (before[0] + (1 + FUSED_STAGES if new else 0),
                before[1] + (1 if new and cuda else 0),
                before[2] + (FUSED_STAGES if new and cuda else 0))
        _require(after == want, f"churn to {shape}: programs and captures "
                                f"{after}, want {want}")
        _require(lf == ls and same_state(fused, staged),
                 f"arms differ after the step at {shape}")
        fused.verify_replicas()
        staged.verify_replicas()
        seen.add(shape)
        log(f"  int8 churn to {shape[0]}x{shape[1]}: "
            f"{'first sight, ' if new else 'seen before, '}programs "
            f"{after[0]}, captures {after[1]} + {after[2]}; loss {lf:.6f} "
            f"both arms, states bitwise, replicas verified "
            f"({time.perf_counter() - t0:.1f} s; {card})")
    return runs


def phase_fused_step(seed: int, card: str, device: str = "cuda",
                     devices=None):
    """The fused-step phase (module docstring, phase 21): the unsharded
    gradient first, then the codec arms with the launch counts set to 0
    just before them; ``devices``: the mesh's positions over several
    cards (else a virtual mesh of ``device``), and then each codec's
    virtual run on ``device`` against the cards' digest. Returns
    (launches, the launches the schedule says, the head_dim)."""
    import torch

    from torchft_tpu_torch.comm.cuda_backend import _card_key
    from torchft_tpu_torch.fused import module_loss_fn, module_params
    from torchft_tpu_torch.models import GPT
    from torchft_tpu_torch.ops import flash, quant

    t0 = time.perf_counter()
    cfg = fused_config()
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    R, M = FUSED_MESH
    positions = [torch.device(d) for d in devices] if devices else \
        [dev] * (R * M)
    keys = list(dict.fromkeys(_card_key(d) for d in positions))
    n_cards = len(keys)
    card_of = [keys.index(_card_key(d)) for d in positions]
    model = GPT(cfg, device=dev, seed=seed)
    n_params = sum(p.numel() for p in model.parameters())
    shape = fused_shape(n_params, FUSED_MESH)
    need_host = fused_host_bytes(n_params)
    free_host = check_host_memory(need_host, what="fused_step")
    need = fused_device_bytes(n_params, cfg, cards=n_cards)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        for d in dict.fromkeys(positions):
            free = torch.cuda.mem_get_info(d)[0]
            _require(free >= need, f"fused_step needs {need / 1e9:.2f} GB "
                                   f"of device memory free on {d}, has "
                                   f"{free / 1e9:.2f} GB")
    hop = fused_host_hop_bytes(n_params)
    where = (f"one position a card over {n_cards} cards" if n_cards > 1
             else "virtual positions")
    log(f"  {n_params} parameters, mesh {R}x{M} of {where}, "
        f"q_len {shape['q_len']}, p_len {shape['p_len']}, "
        f"{FUSED_SEQS} sequences of {cfg.max_seq_len} a position, AdamW "
        f"{FUSED_ADAMW}; staged host bytes a step {hop}; device memory: up "
        f"to {need / 1e9:.2f} GB reckoned on the fullest card; host memory: "
        f"up to {need_host / 1e9:.2f} GB, {free_host / 1e9:.1f} GB "
        f"available")
    if n_cards > 1:
        for codec in FUSED_CODECS:
            cross = fused_cross_card_bytes(n_params, FUSED_MESH, card_of,
                                           codec)
            log(f"  {codec}: bytes a step between cards {cross['total']} "
                f"(allgather {cross['allgather']}, reduce-scatter "
                f"{cross['reduce_scatter']}, exchange {cross['exchange']}, "
                f"gather {cross['gather']}) ({card})")
    params = module_params(model)
    loss_fn = module_loss_fn(model, gpt_row_loss(cfg.max_seq_len))
    n_batches = FUSED_STEPS + FUSED_PROFILE_STEPS
    batches = [fused_batch(seed, s, cfg, R * M) for s in range(n_batches)]
    dense = dense_gradient(model, batches[0], cfg.max_seq_len)
    log(f"  model, flat params and the unsharded gradient "
        f"{time.perf_counter() - t0:.1f} s ({card})")
    if cuda:
        for d in dict.fromkeys(positions):
            torch.cuda.reset_peak_memory_stats(d)
    flash.reset_launch_counts()
    quant.reset_launch_counts()
    want = dict.fromkeys((*flash.LAUNCHES, *quant.LAUNCHES), 0)
    summary = {}
    for codec in FUSED_CODECS:
        arm = run_fused_arm(codec, params, loss_fn, batches, device, card,
                            dense=dense if codec == "none" else None,
                            profile=codec == "none",
                            devices=positions if n_cards > 1 else None)
        for k, v in fused_launches(arm["runs"], cfg.n_layers, R * M,
                                   codec, cards=n_cards).items():
            want[k] += v
        if n_cards > 1:
            runs = fused_virtual_digest(codec, params, loss_fn, batches,
                                        device, arm["digest"], card)
            for k, v in fused_launches(runs, cfg.n_layers, R * M,
                                       codec).items():
                want[k] += v
        summary[codec] = arm
    counts = {**flash.LAUNCHES, **quant.LAUNCHES}
    for codec, arm in summary.items():
        t = arm["times"]
        log(f"  {codec}: device ms per fused replay "
            f"{[_ms(v) for v in t['fused']]}, per staged step "
            f"{[_ms(v) for v in t['staged']]}; wall ms fused "
            f"{[round(v, 1) for v in t['fused_wall']]}, staged "
            f"{[round(v, 1) for v in t['staged_wall']]} ({card})")
    share = summary["none"]["profile"]
    if cuda:
        for d in dict.fromkeys(positions):
            log(f"  device memory peak on {d}: "
                f"{torch.cuda.max_memory_allocated(d) / 1e9:.2f} GB "
                f"allocated, {torch.cuda.max_memory_reserved(d) / 1e9:.2f} "
                f"GB reserved (reckoned {need / 1e9:.2f} GB for the fullest "
                f"card) ({card})")
    log(f"  device busy share (codec none, StepProfiler window) fused "
        f"{_share(share['fused'])}, staged {_share(share['staged'])} "
        f"({card})")
    del model, loss_fn, summary
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    log(f"  phase {time.perf_counter() - t0:.1f} s ({card})")
    return counts, want, cfg.head_dim



# train_resnet: BASELINE config 2, ResNet-18 over two DDP groups
RESNET_BATCH = 64
RESNET_IMAGE = 32
RESNET_STEPS = 6        # committed steps; group 1 heals at 4
RESNET_KILL_AFTER = 2
RESNET_POISON_SEED = 99
RESNET_SGD = dict(lr=0.05, momentum=0.9)


def resnet_batch(seed: int, batch: int, image: int, device):
    """The drill's synthetic CIFAR batch, drawn from ``seed`` with numpy as
    the reference's test draws it (NHWC images, labels in 0..9), as NCHW
    tensors on ``device``."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    images = rng.standard_normal((batch, image, image, 3)).astype(np.float32)
    labels = rng.integers(0, 10, (batch,))
    return (torch.from_numpy(images).permute(0, 3, 1, 2).contiguous()
            .to(device), torch.as_tensor(labels).to(device))


def run_resnet_drill(*, batch: int = RESNET_BATCH,
                     image: int = RESNET_IMAGE, steps: int = RESNET_STEPS,
                     kill_after: int = RESNET_KILL_AFTER, seed: int = 0,
                     device: str = "cuda", timeout: float = 60.0,
                     log=log) -> dict:
    """The twin of the reference's ResNet-18 kill-and-heal test: two DDP
    groups of ResNet-18 (``create_resnet18(seed)``) over TCP at codec
    none, SGD (lr 0.05, momentum 0.9; its momentum buffers made before
    the first step, so a fresh group's heal template lists them), the
    same synthetic batch every step (:func:`resnet_batch`), the state the
    reference's tree (``resnet_state_tree``: ``params``, ``batch_stats``
    and the momentum ``trace``) through ``CheckpointServer(template_fn)``.
    Each step waits its quorum before the forward (a donor stages its
    state in the quorum, and the forward moves the running statistics in
    place). Schedule (k = ``kill_after``): both commit 1..k; group 1
    fails; group 0 commits k + 1 alone; group 1 restarts from
    ``create_resnet18(RESNET_POISON_SEED)``, heals at k + 2 and, as the
    reference, runs its forward again on the healed state before the
    update, so its running statistics advance as the donor's did; both
    commit up to ``steps``. At every step both commit, the parameters,
    the running statistics and the momentum buffers of the two must be
    bitwise equal. Raises AssertionError on any difference, a heal at
    another step, heal wire bytes other than the state's, or a
    non-finite loss. Returns the groups' last runs, the steps compared,
    the heal step and gauges, the state's bytes and the drill's seconds."""
    import threading

    import torch
    import torch.nn.functional as F

    from torchft_tpu_torch.checkpointing import CheckpointServer
    from torchft_tpu_torch.comm.store import StoreServer
    from torchft_tpu_torch.comm.transport import TcpCommContext
    from torchft_tpu_torch.control import Lighthouse
    from torchft_tpu_torch.ddp import DistributedDataParallel
    from torchft_tpu_torch.examples.train_ddp import (
        GroupRun,
        InjectedFailure,
        _wait_lighthouse,
    )
    from torchft_tpu_torch.examples.train_hsdp import state_bytes
    from torchft_tpu_torch.manager import Manager
    from torchft_tpu_torch.models import create_resnet18, resnet_state_tree
    from torchft_tpu_torch.models.resnet import load_resnet_state_tree
    from torchft_tpu_torch.optim import init_sgd_state

    t_start = time.perf_counter()
    dev = torch.device(device)
    images, labels = resnet_batch(seed, batch, image, dev)
    lighthouse = Lighthouse(min_replicas=1, heartbeat_timeout_ms=1000,
                            join_timeout_ms=200)
    addr = lighthouse.address()
    heal_step = kill_after + 2
    ahead, stop = threading.Event(), threading.Event()
    lives = {0: [], 1: []}
    errors = []
    lock = threading.Lock()
    meets = {}
    checked = []
    info = {}

    def joint(step: int) -> bool:
        return not kill_after < step < heal_step

    def state_tensors(model, optimizer):
        return ([p.detach() for p in model.parameters()]
                + list(model.buffers())
                + [optimizer.state[p]["momentum_buffer"]
                   for p in model.parameters()])

    def on_commit(g, step, manager, model, optimizer, loss):
        log(f"group {g} committed step {step} loss {loss:.4f} participants "
            f"{manager.num_participants()}"
            + (" (healed)" if manager.did_heal() else ""))
        if joint(step):
            # the groups meet here: the first waits, the second compares
            state = state_tensors(model, optimizer)
            with lock:
                meet = meets.setdefault(step, {"event": threading.Event(),
                                               "state": None})
                other = meet["state"]
                if other is None:
                    meet["state"] = state
            if other is None:
                if not meet["event"].wait(timeout) or stop.is_set():
                    raise TimeoutError(f"group {g}: the other group never "
                                       f"committed step {step}")
            else:
                try:
                    for i, (a, b) in enumerate(zip(other, state)):
                        _require(torch.equal(a, b),
                                 f"group {g} differs at step {step} in "
                                 f"state tensor {i}")
                    checked.append(step)
                finally:
                    meet["state"] = None
                    meet["event"].set()
        if g == 0 and step == heal_step - 1:
            # let group 1 restart, then take the next quorum with it
            ahead.set()
            _wait_lighthouse(addr, "participants", 1, timeout, stop)

    def group(g: int, init_seed: int, fail_at=None, wait_both=False):
        model = create_resnet18(init_seed, device=dev)
        model.train()
        optimizer = torch.optim.SGD(model.parameters(), **RESNET_SGD)
        init_sgd_state(optimizer)
        info.setdefault("state_bytes",
                        state_bytes(resnet_state_tree(model, optimizer)))
        transport = CheckpointServer(
            timeout=timeout, template_fn=lambda: {
                "user": resnet_state_tree(model, optimizer),
                "torchft": {"step": 0, "batches_committed": 0}})
        store = StoreServer()
        manager = Manager(
            comm=TcpCommContext(timeout=timeout),
            load_state_dict=lambda sd: load_resnet_state_tree(
                model, sd, optimizer),
            state_dict=lambda: resnet_state_tree(model, optimizer),
            checkpoint_transport=transport, min_replica_size=1,
            timeout=timeout, quorum_timeout=timeout,
            connect_timeout=timeout, rank=0, world_size=1,
            store_addr=store.addr, lighthouse_addr=addr,
            replica_id=f"resnet_{g}_", heartbeat_interval=0.05)
        ddp = DistributedDataParallel(manager)
        run = GroupRun(replica_id=manager.replica_id())
        try:
            if wait_both:
                _wait_lighthouse(addr, "healthy", 2, timeout, stop)
            while manager.current_step() < steps and not stop.is_set():
                if fail_at is not None and manager.current_step() >= fail_at:
                    raise InjectedFailure(f"group {g} at step {fail_at}", run)
                t0 = time.perf_counter()
                manager.start_quorum()
                manager.wait_quorum()
                optimizer.zero_grad(set_to_none=False)
                run.passes += 1
                with manager.metrics.timed("forward_backward"):
                    loss = F.cross_entropy(model(images, train=True), labels)
                    loss.backward()
                    if dev.type == "cuda":
                        torch.cuda.current_stream(dev).synchronize()
                ddp.average_gradients(model)
                if not manager.should_commit():
                    continue
                step = manager.current_step()
                if manager.did_heal():
                    run.healed_at.append(step)
                    # the healed state is the donor's before its forward:
                    # run it again so the running statistics advance as
                    # the donor's did
                    with torch.no_grad():
                        model(images, train=True)
                optimizer.step()
                run.losses[step] = loss.item()
                run.step_seconds[step] = time.perf_counter() - t0
                run.participants[step] = manager.num_participants()
                on_commit(g, step, manager, model, optimizer,
                          run.losses[step])
        finally:
            run.metrics = manager.metrics.snapshot()
            transport.disallow_checkpoint()
            manager.shutdown(wait=False)
            store.shutdown()
            del model, optimizer, ddp
        return run

    def group0() -> None:
        lives[0].append(group(0, seed, wait_both=True))

    def group1() -> None:
        try:
            group(1, seed, fail_at=kill_after, wait_both=True)
            raise AssertionError("group 1 was never failed")
        except InjectedFailure as e:
            lives[1].append(e.run)
            log(f"injected failure: {e}; restarting from a poisoned init "
                f"(seed {RESNET_POISON_SEED})")
        if not ahead.wait(timeout) or stop.is_set():
            raise TimeoutError(f"group 0 never committed step "
                               f"{heal_step - 1}")
        lives[1].append(group(1, RESNET_POISON_SEED))

    def guarded(fn):
        def _run():
            try:
                fn()
            except BaseException as e:  # noqa: BLE001 — re-raised below
                errors.append(e)
                stop.set()
                ahead.set()
                with lock:
                    for meet in meets.values():
                        meet["event"].set()
        return _run

    threads = [threading.Thread(target=guarded(fn), name=f"resnet{g}")
               for g, fn in enumerate((group0, group1))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        lighthouse.shutdown()
    if errors:
        raise errors[0]
    restarted = lives[1][-1]
    want = [s for s in range(1, steps + 1) if joint(s)]
    _require(restarted.healed_at == [heal_step],
             f"the restarted group healed at {restarted.healed_at}, not at "
             f"step {heal_step}")
    _require(sorted(checked) == want,
             f"groups compared at steps {sorted(checked)}, want {want}")
    wire = restarted.metrics.get("heal_wire_bytes")
    _require(wire == info["state_bytes"],
             f"the heal moved {wire} wire bytes, the state holds "
             f"{info['state_bytes']}")
    losses = [v for runs in lives.values() for r in runs
              for v in r.losses.values()]
    _require(all(math.isfinite(v) for v in losses), "non-finite loss")
    return {"runs": {g: runs[-1] for g, runs in lives.items()},
            "lives": lives, "heal_step": heal_step,
            "checked_steps": sorted(checked),
            "heal": {k: restarted.metrics.get(k) for k in (
                "heal_wall_ms", "heal_bytes_per_s", "heal_wire_bytes")},
            "state_bytes": info["state_bytes"],
            "passes": sum(r.passes for runs in lives.values() for r in runs),
            "seconds": time.perf_counter() - t_start}


def resnet_report(result: dict, card: str) -> list:
    runs, h = result["runs"], result["heal"]
    lines = [f"both groups bitwise equal (parameters, running statistics, "
             f"momentum) at every step both committed "
             f"{result['checked_steps']}; group 1 healed at step "
             f"{result['heal_step']}",
             f"heal: heal_wall_ms {h['heal_wall_ms']:.1f}, heal_bytes_per_s "
             f"{h['heal_bytes_per_s'] / 1e9:.3f} GB/s, wire bytes "
             f"{int(h['heal_wire_bytes'])} = the state's "
             f"{result['state_bytes']} ({card})"]
    for g, run in sorted(runs.items()):
        times = ", ".join(f"{s}: {t:.3f}"
                          for s, t in sorted(run.step_seconds.items()))
        lines.append(f"group {g}: step p50 ms "
                     f"{_p50s(run.metrics, HSDP_PHASES)}; committed steps "
                     f"(s) {{{times}}} ({card})")
    lines.append(f"drill {result['seconds']:.1f} s, {result['passes']} "
                 f"forward/backward passes ({card})")
    return lines


def phase_train_resnet(seed: int, card: str, batch: int = RESNET_BATCH):
    """The ResNet-18 phase (module docstring, phase 18)."""
    import torch

    from torchft_tpu_torch.models import ResNet18, count_params

    t0 = time.perf_counter()
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    log(f"  ResNet-18: {count_params(ResNet18())} parameters, "
        f"{RESNET_IMAGE}x{RESNET_IMAGE}x3 synthetic batches of {batch} a "
        f"group from seed {seed}, SGD {RESNET_SGD}, 2 groups over TCP at "
        f"codec none; cudnn.deterministic "
        f"{torch.backends.cudnn.deterministic}, cudnn.benchmark "
        f"{torch.backends.cudnn.benchmark}, TF32 matmul "
        f"{torch.backends.cuda.matmul.allow_tf32}, TF32 cudnn "
        f"{torch.backends.cudnn.allow_tf32}")
    result = run_resnet_drill(batch=batch, seed=seed, device="cuda",
                              timeout=120.0, log=lambda m: log("  " + m))
    for line in resnet_report(result, card):
        log("  " + line)
    log(f"  phase {time.perf_counter() - t0:.1f} s ({card})")


# A checkpoint holds the f32 parameters and AdamW's two moments; a group
# keeps 2 (keep=2) with one more in flight as its .tmp.
CKPT_FILES_PER_GROUP = 3


def durable_disk_bytes(n_params: int, groups: int = 2) -> int:
    """Disk train_durable may fill at once: every group's kept checkpoints
    and the one it is writing, each 3 f32 copies of the parameters."""
    return groups * CKPT_FILES_PER_GROUP * 3 * 4 * n_params


def check_disk(directory: str, need: int) -> int:
    """Free bytes under ``directory``; fails with both figures if fewer
    than ``need``."""
    import shutil

    free = shutil.disk_usage(directory).free
    if free < need:
        raise AssertionError(
            f"train_durable needs {need / 1e9:.2f} GB free under "
            f"{directory} (2 groups x {CKPT_FILES_PER_GROUP} checkpoints of "
            f"{need / 6e9:.2f} GB), has {free / 1e9:.2f} GB")
    return free


def _p50s(metrics: dict, names) -> dict:
    return {n: round(metrics[f"{n}_p50_ms"], 3) for n in names
            if f"{n}_p50_ms" in metrics}


def durable_report(result: dict, batch: int, seq: int, card: str) -> list:
    """The lines train_durable prints about a ``run_resume_drill`` result:
    the fused path's phase p50s, quorum and commit p50s on full and on
    fast steps, every checkpoint write, the resumes, the heal, the
    committed step times and tokens/s."""
    runs = result["runs"]
    first = {g: runs[g][0] for g in (0, 1)}
    after = {g: runs[g][1] for g in (0, 1)}
    lines = [f"fused solo steps of group 0: {first[0].fused_steps} on "
             f"{first[0].captures} CUDA graph capture(s); phase p50 ms "
             f"{_p50s(first[0].fused_metrics, ('barrier', 'dispatch', 'fence'))}"
             f" ({card})"]
    for g in (0, 1):
        m = first[g].metrics
        fast = sorted(s for s, n in first[g].control_rpcs.items() if n == 0)
        lines.append(
            f"group {g}: full steps quorum p50 {m.get('quorum_p50_ms', 0):.3f}"
            f" ms commit_barrier p50 {m.get('commit_barrier_p50_ms', 0):.3f} "
            f"ms; fast steps {fast} (fastpath_steps "
            f"{m.get('fastpath_steps')}, 0 control RPCs) quorum_fast p50 "
            f"{m.get('quorum_fast_p50_ms', 0):.4f} ms commit_fast p50 "
            f"{m.get('commit_fast_p50_ms', 0):.4f} ms; lease grants "
            f"{m.get('lease_grants')} breaks {m.get('lease_breaks')}")
    for g in (0, 1):
        for life, run in enumerate(runs[g]):
            for c in run.checkpoints:
                lines.append(
                    f"group {g} life {life} checkpoint "
                    f"{os.path.basename(c['path'])}: stage "
                    f"{c['stage_s'] * 1e3:.1f} ms, persist "
                    f"{c['persist_s'] * 1e3:.1f} ms, {c['bytes']} bytes "
                    f"({c['bytes'] / max(c['persist_s'], 1e-9) / 1e9:.3f} "
                    "GB/s to disk)")
    for g in (0, 1):
        lines.append(f"group {g} resumed at step {after[g].resumed_step} in "
                     f"{after[g].resume_seconds * 1e3:.1f} ms (load + copy to "
                     "the card), bitwise equal to its checkpoint")
    heal = first[1].metrics
    lines.append(f"heal at step {result['heal_step']}: wall "
                 f"{heal.get('heal_wall_ms', 0):.1f} ms, wire "
                 f"{heal.get('heal_bytes_per_s', 0) / 1e9:.3f} GB/s")
    tokens = 2 * batch * seq
    for life, runs_ in ((0, first), (1, after)):
        joint = sorted(set(runs_[0].step_seconds) & set(runs_[1].step_seconds))
        ms = {s: round(max(runs_[0].step_seconds[s],
                           runs_[1].step_seconds[s]) * 1e3, 1) for s in joint}
        rates = [round(tokens / (v / 1e3)) for v in ms.values()]
        lines.append(f"life {life} joint step ms {ms}, tokens/s of both "
                     f"groups {rates} ({card})")
    solo = {s: round(t * 1e3, 1) for s, t in first[0].step_seconds.items()
            if s <= result["heal_step"] - 1}
    lines.append(f"group 0 fused solo step host ms {solo} (dispatch; the "
                 "fence reads back 8 steps at a time)")
    lines.append(f"resumed step {result['resume_step'] + 1} repeated the "
                 f"first life's bitwise: {result['replay_equal']}")
    return lines


def phase_train_durable(seed: int, card: str, batch: int = 8):
    """run_resume_drill at "125m"'s full width, its depth cut to
    ``CUT_LAYERS``, over TCP under a
    lease_ms=2000 lighthouse, checkpoints in a temporary directory that is
    removed; returns the flash launches it must have made (one per layer
    per pass, graph replays and capture warm-ups included) and the
    result."""
    import shutil
    import tempfile

    from torchft_tpu_torch.examples.train_ddp import run_resume_drill
    from torchft_tpu_torch.models import CONFIGS, GPT, count_params

    cfg = cut_depth(CONFIGS["125m"])
    n_params = count_params(GPT(cfg, device="meta"))
    directory = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        need = durable_disk_bytes(n_params)
        free = check_disk(directory, need)
        log(f"  125m at {cfg.n_layers} layers: {n_params} parameters; checkpoints under {directory}: "
            f"up to {need / 1e9:.2f} GB, {free / 1e9:.1f} GB free")
        t0 = time.perf_counter()
        result = run_resume_drill(cfg, device="cuda", batch_size=batch,
                                  seed=seed, timeout=120.0,
                                  ckpt_dir=directory,
                                  log=lambda m: log("  " + m))
        log(f"  drill {time.perf_counter() - t0:.1f} s; both groups bitwise "
            f"equal at steps {result['checked_steps']}; telemetry during a "
            f"fast step: lease_live {result['telemetry']['lease_live']} "
            f"control_rpcs_per_step "
            f"{result['telemetry']['control_rpcs_per_step']}")
        for line in durable_report(result, batch, cfg.max_seq_len, card):
            log("  " + line)
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    if result["runs"][0][0].captures < 1 and result["runs"][0][0].fused_steps:
        raise AssertionError("group 0's fused steps ran without a CUDA graph")
    log(f"  forward/backward passes of all runs: {result['passes']}")
    return result["passes"] * cfg.n_layers, result


def fused_vs_classic(seed: int, card: str, batch: int = 8, steps: int = 3,
                     timed: int = 5) -> dict:
    """The fused step (one CUDA graph) against the same step run eagerly,
    on two "125m" models from one seed: bitwise equal parameters and AdamW
    state after ``steps`` steps, then the device time of each per step
    (CUDA events, median of ``timed``). Also reports whether AdamW's
    ``capturable=True`` (the step count on the card, which the graph
    needs) changes any bit of the eager step against ``capturable=False``."""
    import torch

    from torchft_tpu_torch.models import CONFIGS, GPT, make_train_step

    cfg = CONFIGS["125m"]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    batches = []
    for _ in range(steps + timed):
        tok = torch.randint(0, cfg.vocab_size, (batch, cfg.max_seq_len),
                            generator=gen, device="cuda")
        batches.append((tok, torch.roll(tok, -1, dims=1)))

    def build():
        model = GPT(cfg, device="cuda", seed=seed)
        optimizer = torch.optim.AdamW(model.parameters(), lr=3e-4,
                                      weight_decay=1e-4, capturable=True)
        return model, optimizer, make_train_step(model, optimizer)

    (ma, oa, eager), (mb, ob, graph) = build(), build()
    for tok, tgt in batches[:steps]:
        eager._eager(tok, tgt)
        graph(tok, tgt)
    torch.cuda.synchronize()
    equal = all(torch.equal(a, b) for a, b in zip(ma.parameters(),
                                                   mb.parameters()))
    equal = equal and all(
        torch.equal(oa.state[a][k], ob.state[b][k])
        for a, b in zip(ma.parameters(), mb.parameters())
        for k in oa.state[a])
    mc = GPT(cfg, device="cuda", seed=seed)
    oc = torch.optim.AdamW(mc.parameters(), lr=3e-4, weight_decay=1e-4)
    for tok, tgt in batches[:steps]:
        oc.zero_grad(set_to_none=True)
        mc.loss(tok, tgt).backward()
        oc.step()
    torch.cuda.synchronize()
    flag_equal = all(torch.equal(a, c) for a, c in zip(ma.parameters(),
                                                       mc.parameters()))
    del mc, oc

    def per_step(fn):
        times = []
        for tok, tgt in batches[steps:]:
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            fn(tok, tgt)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return sorted(times)[len(times) // 2]

    out = {"bitwise_equal": equal, "classic_ms": per_step(eager._eager),
           "fused_ms": per_step(graph), "captures": graph.captures,
           "capturable_bits_equal": flag_equal}
    log(f"  fused step {out['fused_ms']:.2f} ms (one CUDA graph) against the "
        f"same step eager {out['classic_ms']:.2f} ms, 125m batch {batch}, "
        f"median of {timed}; bitwise equal after {steps} steps: {equal}; "
        f"eager steps with capturable=True equal to capturable=False: "
        f"{flag_equal} ({card})")
    del ma, mb, oa, ob, eager, graph
    torch.cuda.empty_cache()
    if not equal:
        raise AssertionError("the fused step's CUDA graph differs from the "
                             "same step run eagerly")
    return out


def _outer_report(run, card: str) -> str:
    """One group's outer-sync p50s (ms) and last-round gauges."""
    m = run.metrics
    p50 = _p50s(m, ("outer_d2h", "outer_ef", "outer_wire", "outer_land",
                    "quorum", "commit_barrier"))
    gauges = {k: round(m[k], 3) for k in (
        "outer_wire_ms", "outer_wire_exposed_ms", "outer_overlap",
        "outer_wire_bytes", "outer_inflight_at_drain") if k in m}
    rounds = {s: round(t * 1e3, 1) for s, t in run.round_seconds.items()}
    return (f"phase p50 ms {p50}; last round {gauges}; committed round ms "
            f"{rounds} ({card})")


def phase_train_diloco(seed: int, card: str, batch: int = 8):
    """run_diloco_drill at "125m" (module docstring, phase 9); returns the
    flash launches it must have made and the result."""
    from torchft_tpu_torch.examples.train_diloco import run_diloco_drill
    from torchft_tpu_torch.models import CONFIGS, GPT, count_params

    cfg = CONFIGS["125m"]
    n_params = count_params(GPT(cfg, device="meta"))
    log(f"  125m: {n_params} parameters, batch {batch}, 2 groups over TCP, "
        f"sync_every 8, 2 fragments: {4 * n_params} bytes of f32 per round "
        "per group")
    t0 = time.perf_counter()
    result = run_diloco_drill(cfg, device="cuda", batch_size=batch,
                              seed=seed, timeout=120.0,
                              log=lambda m: log("  " + m))
    runs = result["runs"]
    survivor, restarted = runs[0][0], runs[1][1]
    if result["checked_rounds"] != {1: 2, 2: 2, 4: 2, 5: 2}:
        raise AssertionError(f"rounds both groups committed: "
                             f"{result['checked_rounds']}, the schedule has "
                             "1, 2, 4 and 5")
    log(f"  drill {time.perf_counter() - t0:.1f} s; rounds both groups "
        f"committed, bitwise equal (parameters and outer state): "
        f"{sorted(result['checked_rounds'])}; group 1 healed at round "
        f"{restarted.healed_at}")
    for g, life in ((0, survivor), (1, runs[1][0]), (1, restarted)):
        log(f"  group {g}: {_outer_report(life, card)}")
    heal = restarted.metrics
    log(f"  heal: wall {heal.get('heal_wall_ms', 0):.1f} ms, wire "
        f"{heal.get('heal_bytes_per_s', 0) / 1e9:.3f} GB/s ({card})")
    tokens = 2 * 8 * batch * cfg.max_seq_len  # both groups' inner steps
    g1 = {**runs[1][0].round_seconds, **restarted.round_seconds}
    rates = {s: round(tokens / max(t, g1[s]))
             for s, t in sorted(survivor.round_seconds.items()) if s in g1}
    log(f"  tokens/s of both groups by committed round {rates} ({card})")
    losses = survivor.losses
    log(f"  group 0 loss first {losses[0]:.4f} last {losses[-1]:.4f}; "
        f"forward/backward passes of all runs: {result['passes']}")
    return result["passes"] * cfg.n_layers, result


# train_diloco_sharded: the sharded outer update with exchange on heal, one
# group's wire in a child process
DILOCO_SHARDED = dict(groups=3, sync_every=8, num_fragments=3,
                      subproc_groups=(2,))
# the schedule: group 2 killed at inner step 4 of round 3, its restart
# heals at round 4, its child SIGSTOPped at round 5's fence, 6 rounds
DILOCO_SHARDED_SCHEDULE = dict(rounds=6, kill=(2, 2, 4), wedge=(2, 4))
# the wire's timeout (s): a wedge costs it on the peers, and 10 s more on
# the wedged group, whose pump gives its child up after timeout + 10
DILOCO_WIRE_TIMEOUT = 8.0
DILOCO_SHARDED_P50S = ("outer_d2h", "outer_wire", "outer_land", "reshard")


def diloco_sharded_host_bytes(n_params: int,
                              groups: int = DILOCO_SHARDED["groups"]) -> int:
    """Host memory train_diloco_sharded may hold at once, in f32 copies of
    the parameters: per group the backup, the fragment arenas, the outer
    momentum (all of it in the replicated arm), a fence's snapshot of it and
    a committed round's parameters (5); once, the heal's staged state on
    both ends (params, AdamW's moments, backup, momentum: 10), the kept
    rounds of both arms (4) and the wire child's copies of a fragment (2)."""
    return (groups * 5 + 16) * 4 * n_params


def diloco_sharded_device_bytes(n_params: int, act: int,
                                groups: int = DILOCO_SHARDED["groups"]
                                ) -> int:
    """Device memory train_diloco_sharded may hold at once: each group's
    f32 parameters, gradients and two AdamW moments (16 bytes a parameter),
    a restarted group's model beside its dead life's (4), and per group one
    pass's activations and its CUDA graph's private pool (one more)."""
    return (16 * groups + 4) * n_params + 2 * groups * act


def _reshards(run) -> list:
    keys = ("old_world", "new_world", "rank", "owned_fragments",
            "adopted_fragments", "wire_bytes", "lower_bound_bytes",
            "reinit_fragments", "dropped_fragments")
    return [{k: e.get(k) for k in keys} for e in run.events
            if e["kind"] == "reshard"]


def check_diloco_sharded(result: dict, replicated: dict) -> list:
    """The schedule's five checks on a ``run_diloco_drill`` result of
    train_diloco_sharded (module docstring, phase 14) against its
    replicated arm; raises on a miss, returns one line per check."""
    runs = result["runs"]
    survivors, restarted = (0, 1), runs[2][1]
    lines = []
    ranks = {g: next(r["rank"] for r in _reshards(runs[g][0])
                     if r["new_world"] == 3) for g in (0, 1, 2)}
    rounds = result["checked_rounds"]
    # 1. rounds 1-2: all three, each its own fragment, equal to replicated
    _require(rounds.get(1) == 3 and rounds.get(2) == 3
                   and replicated["checked_rounds"] == {1: 3, 2: 3},
                   f"rounds 1-2 not committed by all three groups in both "
                   f"arms: {rounds}, {replicated['checked_rounds']}")
    for step in (1, 2):
        want = {g: [f for f in range(3) if f % 3 == ranks[g]]
                for g in (0, 1, 2)}
        _require(result["held"][step] == want,
                       f"round {step}: held {result['held'][step]}, want "
                       f"{want}")
        same = all(a.equal(b) for a, b in zip(result["params"][step],
                                               replicated["params"][step]))
        _require(same, f"round {step}: sharded parameters differ from "
                             "the replicated arm's")
    lines.append("1. rounds 1-2: 3 groups bitwise equal, each holding "
                 f"fragment f % 3 == rank (ranks {ranks}), bitwise equal to "
                 "the replicated arm: passed")
    # 2. round 3: group 2 killed, its child gone; 0 and 1 commit at world 2
    shrink = {g: [r for r in _reshards(runs[g][0]) if r["new_world"] == 2]
              for g in survivors}
    # f2's owner at world 2: wire rank 2 % 2
    owner = next((g for g in survivors
                  if shrink[g] and shrink[g][0]["rank"] == 2 % 2), None)
    _require(rounds.get(3) == 2 and all(len(v) == 1
                                              for v in shrink.values()),
                   f"round 3: committed by {rounds.get(3)} groups, reshards "
                   f"at world 2 {shrink}")
    _require(all(shrink[g][0]["reinit_fragments"] == (g == owner)
                       for g in survivors),
                   f"round 3: reinit_fragments {shrink}, want 1 on f2's new "
                   f"owner (group {owner}) and 0 on the other")
    _require(result["killed_pid"] is not None,
                   "group 2's wire child was never seen")
    lines.append(f"2. round 3: group 2 killed at inner step 4 (its child "
                 f"{result['killed_pid']} gone), groups 0 and 1 committed at "
                 f"world 2 after a reshard {shrink}: passed")
    # 3. the restart heals, and the grow moves exactly the lower bound
    grow = {g: [r for r in _reshards(runs[g][-1]) if r["new_world"] == 3
                and r["old_world"] in (2, None)][-1] for g in (0, 1, 2)}
    holder = result["grow"]["holders"].get(2)
    donor_group = next((g for g in survivors
                        if ranks[g] == result["donor"]), None)
    moved = sum(g["wire_bytes"] for g in grow.values())
    _require(restarted.healed_at == [4]
                   and all(r["reinit_fragments"] == 0 for r in grow.values())
                   and result["grow"]["equal"]
                   and (donor_group == holder or moved > 0),
                   f"grow: healed at {restarted.healed_at}, reshards {grow}, "
                   f"{result['grow']}, donor group {donor_group}")
    new_pid = result["pids"][(2, 1)][0]
    _require(new_pid != result["killed_pid"],
                   "the restarted group reused its dead child's pid")
    lines.append(f"3. group 2 restarted (child {new_pid}), healed at 4 from "
                 f"group {donor_group} (f2's holder: group {holder}); grow "
                 f"reshards {grow}; its f2 state bitwise the holder's: passed")
    # 4. round 5: the wedge aborts every group's round, all reconfigure
    wedged = result["wedged"]
    aborted = {g: (4, False) in runs[g][-1].rounds for g in (0, 1, 2)}
    reform = {g: [r for r in _reshards(runs[g][-1])
                  if r["old_world"] == r["new_world"] == 3] for g in (0, 1, 2)}
    _require(all(aborted.values()) and all(reform.values()),
                   f"round 5: aborted {aborted}, reconfigure reshards "
                   f"{reform}")
    lines.append(f"4. round 5: group 2's child {wedged['pid']} SIGSTOPped "
                 f"mid-round, every group aborted and rolled back bitwise "
                 f"(parameters and outer states), every group reconfigured, "
                 f"the child SIGKILLed and replaced by {wedged['next_pid']}: "
                 "passed")
    # 5. round 6: all three commit
    _require(rounds.get(5) == 3 and rounds.get(6) == 3,
                   f"rounds 5-6 committed by {rounds.get(5)}, "
                   f"{rounds.get(6)} groups")
    lines.append("5. rounds 5-6 (the wedged round retried, then round 6): "
                 "all three groups bitwise equal: passed")
    lines.append(f"coverage: after every committed round the live groups "
                 f"held each fragment once {result['held']}")
    return lines


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def phase_train_diloco_sharded(seed: int, card: str, batch: int = 8):
    """The sharded DiLoCo drill (module docstring, phase 14) after its
    replicated arm; returns the flash launches it must have made and the
    result."""
    import torch

    from torchft_tpu_torch.examples.train_diloco import run_diloco_drill
    from torchft_tpu_torch.models import CONFIGS, GPT, count_params

    t0 = time.perf_counter()
    cfg = cut_depth(CONFIGS["125m"])
    n_params = count_params(GPT(cfg, device="meta"))
    need_host = diloco_sharded_host_bytes(n_params)
    free_host = check_host_memory(need_host, what="train_diloco_sharded")
    act = gpt_activation_bytes(cfg, batch)
    need = diloco_sharded_device_bytes(n_params, act)
    cuda = torch.cuda.is_available()
    if cuda:
        gc.collect()
        torch.cuda.empty_cache()
        free = torch.cuda.mem_get_info()[0]
        if free < need:
            raise AssertionError(
                f"train_diloco_sharded needs {need / 1e9:.2f} GB of device "
                f"memory free, has {free / 1e9:.2f} GB")
        torch.cuda.reset_peak_memory_stats()
    log(f"  125m at {cfg.n_layers} layers: {n_params} parameters, batch "
        f"{batch}, 3 groups over TCP "
        f"at codec none (group 2's wire in a child), sync_every 8, 3 "
        f"fragments, wire timeout {DILOCO_WIRE_TIMEOUT} s; host memory: up "
        f"to {need_host / 1e9:.2f} GB, {free_host / 1e9:.1f} GB available; "
        f"device memory: up to {need / 1e9:.2f} GB")
    common = dict(DILOCO_SHARDED, device="cuda", batch_size=batch, seed=seed,
                  timeout=120.0, keep_params=(1, 2),
                  comm_options={"timeout": DILOCO_WIRE_TIMEOUT},
                  log=lambda m: log("  " + m))
    t1 = time.perf_counter()
    replicated = run_diloco_drill(cfg, rounds=2, kill=None,
                                  sharded_outer=False, **common)
    t_rep = time.perf_counter() - t1
    log(f"  replicated arm (sharded_outer=False, 2 rounds): {t_rep:.1f} s")
    t1 = time.perf_counter()
    result = run_diloco_drill(cfg, sharded_outer=True,
                              **DILOCO_SHARDED_SCHEDULE, **common)
    t_drill = time.perf_counter() - t1
    for line in check_diloco_sharded(result, replicated):
        log("  " + line)
    runs = result["runs"]
    for g in sorted(runs):
        for life, run in enumerate(runs[g]):
            rounds = {s: round(t, 3) for s, t in run.round_seconds.items()}
            log(f"  group {g} life {life}: p50 ms "
                f"{_p50s(run.metrics, DILOCO_SHARDED_P50S)}; committed "
                f"round s {rounds}; reshard events {_reshards(run)} ({card})")
    heal = runs[2][1].metrics
    log(f"  heal of group 2 at round 4: wall "
        f"{heal.get('heal_wall_ms', 0):.1f} ms, wire "
        f"{heal.get('heal_bytes_per_s', 0) / 1e9:.3f} GB/s ({card})")
    peak = (f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB allocated"
            if cuda else "not measured")
    log(f"  drill {t_drill:.1f} s, replicated arm {t_rep:.1f} s, phase "
        f"{time.perf_counter() - t0:.1f} s; device memory peak {peak}; "
        f"forward/backward passes: {replicated['passes']} + "
        f"{result['passes']} ({card})")
    del replicated["params"], result["params"]
    passes = replicated["passes"] + result["passes"]
    return passes * cfg.n_layers, result


def _compute_pids() -> list:
    return subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30).stdout.split()


def check_comm_child(card: str, mb: int = 181) -> None:
    """A ``SubprocessCommContext`` child on the card's host holds no CUDA
    context: the device's free memory does not move when it starts (a
    context costs hundreds of MB) and ``nvidia-smi`` lists no new compute
    process. (The child maps ``libcuda``, as any process that imports torch
    does; that alone makes no context.) Then one allreduce of ``mb`` MB of
    f32 (a 125m fragment) through it at world 1, timed: the round trip
    through the process boundary."""
    import torch

    from torchft_tpu_torch.comm.store import StoreServer
    from torchft_tpu_torch.comm.subproc import SubprocessCommContext

    torch.cuda.synchronize()
    free0 = torch.cuda.mem_get_info()[0]
    apps0 = _compute_pids()
    store = StoreServer()
    ctx = SubprocessCommContext(timeout=60.0)
    try:
        t0 = time.perf_counter()
        ctx.configure(f"{store.addr}/smoke_child", 0, 1)
        spawn = time.perf_counter() - t0
        pid = ctx.child_pid()
        free1 = torch.cuda.mem_get_info()[0]
        apps1 = _compute_pids()
        with open(f"/proc/{pid}/maps") as f:
            libcuda = "libcuda.so" in f.read()
        x = torch.arange(mb * (1 << 20) // 4, dtype=torch.float32).numpy()
        trips = []
        for _ in range(3):
            t0 = time.perf_counter()
            out = ctx.allreduce([x.copy()]).future().result(timeout=120)[0]
            trips.append(time.perf_counter() - t0)
        same = out.tobytes() == x.tobytes()
    finally:
        ctx.shutdown()
        store.shutdown()
    log(f"  comm child {pid}: spawned and configured in {spawn:.2f} s; "
        f"device free memory {free0 / 1e9:.3f} -> {free1 / 1e9:.3f} GB; "
        f"nvidia-smi compute pids {apps0} -> {apps1}; libcuda mapped "
        f"{libcuda}; {mb} MB allreduce at world 1 through the child "
        f"{[round(t * 1e3, 1) for t in trips]} ms, bitwise {same} ({card})")
    if (str(pid) in apps1 or len(apps1) > len(apps0)
            or free0 - free1 > 64 * (1 << 20) or not same):
        raise AssertionError(f"the comm child {pid} made a CUDA context "
                             f"(compute pids {apps0} -> {apps1}, free memory "
                             f"{free0} -> {free1}) or garbled its op")


LOCALSGD_GROUPS = 4


def localsgd_host_bytes(n_params: int, groups: int = LOCALSGD_GROUPS) -> int:
    """Host memory train_localsgd_int8 may hold at once, in f32 copies of
    the parameters: per group the backup, the fragment arenas, the
    error-feedback residuals and scratch, round 1's recorded fragment ops
    (inputs and outputs) and their CPU replay (8); once, the heal's staged
    state on both ends (parameters and AdamW's moments, 6)."""
    return (groups * 8 + 6) * 4 * n_params


def check_host_memory(need: int, meminfo: str = "/proc/meminfo",
                      what: str = "train_localsgd_int8") -> int:
    """The host's available memory (``MemAvailable``); fails with both
    figures if less than ``need``."""
    with open(meminfo) as f:
        fields = dict(line.split(":", 1) for line in f)
    free = int(fields["MemAvailable"].split()[0]) * 1024
    if free < need:
        raise AssertionError(
            f"{what} needs {need / 1e9:.2f} GB of host memory "
            f"available, has {free / 1e9:.2f} GB")
    return free


def check_plane_at_fragments(recorded, seed: int) -> None:
    """Round 1's fragment ops on the card against the same plane on the
    CPU, bitwise: each recorded op's inputs of every group, reduced by
    ``DevicePool("cpu")`` contexts, must give the bits each group got."""
    from concurrent.futures import ThreadPoolExecutor

    from torchft_tpu_torch.comm.context import ReduceOp
    from torchft_tpu_torch.comm.cuda_backend import CudaCommContext, DevicePool

    groups = sorted(recorded)
    world = len(groups)
    pool = DevicePool("cpu")
    for op in sorted(recorded[groups[0]]):
        ctxs = [CudaCommContext(timeout=300.0, **INT8_OPTIONS,
                                chunk_bytes=CHUNK_BYTES, device_pool=pool)
                for _ in groups]

        def worker(r):
            ctxs[r].configure(f"smoke://fragment{op}", r, world)
            inputs = [a.copy() for a in recorded[groups[r]][op][0]]
            return ctxs[r].allreduce(inputs, ReduceOp.SUM).future().result(
                timeout=300)

        try:
            with ThreadPoolExecutor(world) as ex:
                cpu = [f.result(600) for f in
                       [ex.submit(worker, r) for r in range(world)]]
        finally:
            for c in ctxs:
                c.shutdown()
        same = all(a.tobytes() == b.tobytes()
                   for r, g in enumerate(groups)
                   for a, b in zip(cpu[r], recorded[g][op][1]))
        size = recorded[groups[0]][op][0][0].size
        log(f"  round 1 fragment op {op} ({size} f32, {world} groups): card "
            f"plane vs CPU plane bitwise {'ok' if same else 'FAIL'}")
        if not same:
            raise AssertionError(f"int8 plane on the card differs from the "
                                 f"CPU plane at fragment op {op}")


def phase_train_localsgd_int8(seed: int, card: str, batch: int = 8,
                              devices=None):
    """The LocalSGD drill on the int8 device plane (module docstring, phase
    10), on the card or group g on ``devices[g % len(devices)]``; returns
    the flash launches, the codec launches per kernel and the result."""
    from torchft_tpu_torch.examples.train_diloco import run_diloco_drill
    from torchft_tpu_torch.models import CONFIGS, GPT, count_params

    cfg = cut_depth(CONFIGS["125m"])
    n_params = count_params(GPT(cfg, device="meta"))
    need = localsgd_host_bytes(n_params)
    free = check_host_memory(need)
    log(f"  125m at {cfg.n_layers} layers: {n_params} parameters, batch {batch}, {LOCALSGD_GROUPS} "
        f"groups on the cuda plane {INT8_OPTIONS}; host memory: up to "
        f"{need / 1e9:.2f} GB, {free / 1e9:.1f} GB available")
    t0 = time.perf_counter()
    place = dict(device="cuda") if devices is None else dict(devices=devices)
    result = run_diloco_drill(
        cfg, algo="local_sgd", groups=LOCALSGD_GROUPS, rounds=3, kill=None,
        fault=(3, 4), record_ops=(1, 2), batch_size=batch, **place,
        seed=seed, timeout=300.0, log=lambda m: log("  " + m),
        comm_backend="cuda", comm_options=INT8_OPTIONS)
    runs = result["runs"]
    if result["checked_rounds"] != {1: 4, 2: 3, 3: 4}:
        raise AssertionError(f"groups committing each round: "
                             f"{result['checked_rounds']}, the schedule has "
                             "4, 3 and 4")
    log(f"  drill {time.perf_counter() - t0:.1f} s; groups committing each "
        f"round, bitwise equal: {result['checked_rounds']}; group 3's round "
        f"2 aborted and rolled back bitwise, healed at "
        f"{runs[3][0].healed_at}")
    for g in sorted(runs):
        m = runs[g][0].metrics
        ratio = m.get("comm_encoded_bytes", 0) / max(1, m.get("comm_raw_bytes",
                                                              1))
        log(f"  group {g}: {_outer_report(runs[g][0], card)}; "
            f"comm_encoded_bytes {m.get('comm_encoded_bytes')} "
            f"({ratio:.3f} of raw)")
    heal = runs[3][0].metrics
    log(f"  heal of group 3: wall {heal.get('heal_wall_ms', 0):.1f} ms, wire "
        f"{heal.get('heal_bytes_per_s', 0) / 1e9:.3f} GB/s ({card})")
    # every fragment op of the 3 rounds had 3 peers on the wire
    per_op = (2 if devices is None
              else codec_launches(LOCALSGD_GROUPS,
                                  cycled(devices, LOCALSGD_GROUPS)))
    codec = 2 * 3 * per_op
    log(f"  2 fragments x 3 rounds with a peer x {per_op} launches = "
        f"{codec} of each codec kernel; forward/backward passes: "
        f"{result['passes']}")
    check_plane_at_fragments(result["recorded"], seed)
    return result["passes"] * cfg.n_layers, codec, result


# train_multijob: the multi-tenant control plane at 125m
MULTIJOB_TRAINERS = 5  # a0, a1, b0, b1, hi0 (the observer trains nothing)
MULTIJOB_CONCURRENT = 4  # a0, a1, b0 and b1 train at once
MULTIJOB_GRAPHS = 3  # solo steps capture CUDA graphs: a0 (alone), b0, hi0


def gpt_activation_bytes(cfg, batch: int) -> int:
    """A reckoning of one forward/backward's live activations in f32: per
    layer 18 tensors of batch x seq x d_model (the block's inputs, norms,
    q/k/v, attention output, residuals and the MLP's two d_ff-wide ones at
    4 each), and the logits with their gradient."""
    bsd = batch * cfg.max_seq_len * cfg.d_model
    return 4 * (18 * bsd * cfg.n_layers
                + 2 * batch * cfg.max_seq_len * cfg.vocab_size)


def multijob_device_bytes(n_params: int, act: int,
                          trainers: int = MULTIJOB_TRAINERS) -> int:
    """Device memory train_multijob may hold at once: each trainer's f32
    parameters, gradients and two AdamW moments (16 bytes a parameter),
    the observer's parameters, the activations of the groups training at
    once, and the private memory pools of the CUDA graphs the solo steps
    capture (one pass's activations each)."""
    return (16 * trainers + 4) * n_params + act * (MULTIJOB_CONCURRENT
                                                   + MULTIJOB_GRAPHS)


def multijob_host_bytes(n_params: int) -> int:
    """Host memory train_multijob may hold at once, in f32 copies of the
    parameters: per trainer the DDP staging arena, the wire's buffers and
    scratch (4); once, the heal's staged state on both ends (6)."""
    return (MULTIJOB_TRAINERS * 4 + 6) * 4 * n_params


MULTIJOB_PHASES = ("quorum", "quorum_fast", "forward_backward", "ddp_wire",
                   "commit_barrier", "commit_fast", "probe_forward")


def multijob_report(result: dict, card: str) -> list:
    """The lines train_multijob prints about a ``run_multijob_drill``
    result: per job and group the phase p50s, B's during A's kill and
    heal, its counters, the heal, the eviction and the drill's wall time."""
    runs = result["runs"]
    lines = []
    for job, names in (("a", ("a0", "a1", "a_obs")), ("b", ("b0", "b1")),
                       ("hi", ("hi0",))):
        for name in names:
            for life, run in enumerate(runs[name]):
                lines.append(f"job {job} {name} life {life} phase p50 ms "
                             f"{_p50s(run.metrics, MULTIJOB_PHASES)} "
                             f"({card})")
    k = result["heal_step"] - 2
    for name, m in sorted(result["b_window"].items()):
        lines.append(f"job b {name} during a's kill and heal (steps {k}-"
                     f"{result['heal_step'] + 1}): quorum_fast p50 "
                     f"{m.get('quorum_fast_p50_ms', 0):.4f} ms, commit_fast "
                     f"p50 {m.get('commit_fast_p50_ms', 0):.4f} ms, 0 control "
                     f"RPCs a step ({card})")
    keys = ("membership_epoch", "quorum_compute_count", "lease_breaks")
    lines.append("job b's counters before and after the window: "
                 + ", ".join(f"{key} {result['b_status']['before'][key]} -> "
                             f"{result['b_status']['after'][key]}"
                             for key in keys))
    heal = runs["a1"][-1].metrics
    lines.append(f"a1's heal at step {result['heal_step']}: wall "
                 f"{heal.get('heal_wall_ms', 0):.1f} ms, wire "
                 f"{heal.get('heal_bytes_per_s', 0) / 1e9:.3f} GB/s ({card})")
    ev = result["eviction"]
    lines.append(f"b1 evicted at step {result['total']}: answered in "
                 f"{ev['seconds'] * 1e3:.2f} ms; jobs.b preemptions "
                 f"{ev['status']['preemptions']}, evicted "
                 f"{ev['status']['evicted']}; job_preempted events "
                 f"{len(ev['events'])}; parameters unchanged "
                 f"{ev['unchanged']}")
    lines.append(f"a0 and b0 (same seeds and data) bitwise equal at steps "
                 f"{result['cross_job_equal']} of 1-{k}")
    lines.append(f"drill {result['seconds']:.1f} s; passes: {result['passes']}"
                 f" training, {result['probe_passes']} observer probe, "
                 f"{result['hi_passes']} hi0 ({card})")
    return lines


def phase_train_multijob(seed: int, card: str, batch: int = 8):
    """The multi-tenant drill (module docstring, phase 4): returns the flash
    kernels' launches by head_dim and the result."""
    import torch

    from torchft_tpu_torch.examples.train_ddp import run_multijob_drill
    from torchft_tpu_torch.models import CONFIGS, GPT, count_params

    t0 = time.perf_counter()
    cfg = CONFIGS["125m"]
    n_params = count_params(GPT(cfg, device="meta"))
    need_host = multijob_host_bytes(n_params)
    free_host = check_host_memory(need_host, what="train_multijob")
    act = gpt_activation_bytes(cfg, batch)
    need = multijob_device_bytes(n_params, act)
    gc.collect()  # an earlier phase's cycles may hold tensors
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    free = torch.cuda.mem_get_info()[0]
    hi_name = "125m"
    if free < need:
        # the late job at "tiny": jobs a and b stay at full size
        hi_name = "tiny"
        need = multijob_device_bytes(n_params, act, MULTIJOB_TRAINERS - 1)
        if free < need:
            raise AssertionError(
                f"train_multijob needs {need / 1e9:.2f} GB of device memory "
                f"free, has {free / 1e9:.2f} GB")
    hi_cfg = CONFIGS[hi_name]
    log(f"  125m: {n_params} parameters, batch {batch}; jobs a (a0, a1, an "
        f"observer), b (b0, b1) and hi (hi0 at {hi_name}) over TCP at "
        "codec none; "
        f"device memory: up to {need / 1e9:.2f} GB, {free / 1e9:.1f} GB free "
        f"({held / 1e9:.2f} GB held by earlier phases);"
        f" host memory: up to {need_host / 1e9:.2f} GB, "
        f"{free_host / 1e9:.1f} GB available")
    torch.cuda.reset_peak_memory_stats()
    result = run_multijob_drill(cfg, hi_cfg=hi_cfg, device="cuda",
                                batch_size=batch, seed=seed, timeout=300.0,
                                log=lambda m: log("  " + m))
    for line in multijob_report(result, card):
        log("  " + line)
    log(f"  device memory peak: {torch.cuda.max_memory_allocated() / 1e9:.2f}"
        f" GB allocated, {torch.cuda.max_memory_reserved() / 1e9:.2f} GB "
        f"reserved (reckoned {need / 1e9:.2f} GB) ({card})")
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  phase {time.perf_counter() - t0:.1f} s ({card})")
    trained = result["passes"] * cfg.n_layers
    per_d = {cfg.head_dim: {"flash_fwd": trained
                            + result["probe_passes"] * cfg.n_layers,
                            "flash_bwd_dq": trained,
                            "flash_bwd_dkv": trained}}
    hi = result["hi_passes"] * hi_cfg.n_layers
    row = per_d.setdefault(hi_cfg.head_dim, dict.fromkeys(per_d[cfg.head_dim],
                                                          0))
    for name in row:
        row[name] += hi
    return per_d, result


# train_moe: the template heal of examples/train_moe.py's twin at
# "moe-8x125m", two groups of MOE_RANKS ranks
MOE_RANKS = 2
MOE_SCHEDULE = dict(kill_step=3, steps_alone=1, steps_after=1)
MOE_PHASES = ("quorum", "forward_backward", "ddp_d2h", "ddp_wire", "ddp_h2d",
              "commit_barrier", "heal_stage", "heal_wire", "heal_h2d")


def moe_activation_bytes(cfg, batch: int) -> int:
    """A reckoning of one rank's live activations in a forward/backward of
    the MoE model with activation checkpointing: every block's bf16 input
    kept, one block recomputed at a time, whose routing holds about 8 f32
    tensors of tokens x experts x capacity (the dispatch and combine
    masks, their parts and gradients), and the chunked loss's logits with
    their gradient (one chunk of the vocabulary, f32)."""
    n = batch * cfg.max_seq_len
    cap = max(1, int(cfg.capacity_factor * n * 2 / cfg.num_experts))
    keep = 2 * n * cfg.d_model * cfg.n_layers
    routing = 4 * 8 * n * cfg.num_experts * cap
    block = 4 * 18 * n * max(cfg.d_model, cfg.d_ff)
    logits = 2 * 4 * n * cfg.vocab_size // max(1, cfg.xent_chunks)
    return keep + routing + block + logits


def moe_device_bytes(n_params: int, act: int, ranks: int = 2 * MOE_RANKS
                     ) -> int:
    """Device memory train_moe may hold at once: each rank's f32
    parameters, gradients and two AdamW moments (16 bytes a parameter),
    the drill's kept copy of one rank's parameters and moments (12), each
    healer rank's incoming state before it is copied in (12 each), and
    every rank's activations."""
    return (16 * ranks + 12 + 12 * MOE_RANKS) * n_params + act * ranks


def moe_host_bytes(n_params: int, ranks: int = 2 * MOE_RANKS) -> int:
    """Host memory train_moe may hold at once, in f32 copies of the
    parameters: per rank DDP's two staging arenas and the wire's buffers
    (4); per donor rank its staged state (3), per healer rank its pinned
    regions (3)."""
    return (ranks * 4 + 2 * MOE_RANKS * 3) * 4 * n_params


def moe_report(result: dict, n_params: int, state_bytes: int,
               card: str) -> list:
    lines = [f"every live rank bitwise equal (parameters and AdamW state) at "
             f"every committed step {result['compared']}; group 1 healed at "
             f"steps 2 and {result['heal_step']}"]
    for r, h in sorted(result["heals"].items()):
        lines.append(
            f"heal of group 1 rank {r} at step {result['heal_step']}: wall "
            f"{h['heal_wall_ms']:.1f} ms, wire {h['heal_bytes_per_s'] / 1e9:.3f}"
            f" GB/s, {int(h['heal_wire_bytes'])} wire bytes of a "
            f"{state_bytes} B state, upload p50 {h['heal_h2d_p50_ms']} ms "
            f"({card})")
    lines.append("bytes served in that heal by group 0's ranks: "
                 + ", ".join(f"rank {r} {int(b)}"
                             for r, b in sorted(result["served"].items())))
    for (g, r), run in sorted(result["runs"].items()):
        times = ", ".join(f"{s}: {t:.2f}"
                          for s, t in sorted(run.step_seconds.items()))
        lines.append(f"group {g} rank {r}: phase p50 ms "
                     f"{_p50s(run.metrics, MOE_PHASES)}; committed steps (s) "
                     f"{{{times}}} ({card})")
    lines.append(f"drill {result['seconds']:.1f} s, {result['passes']} "
                 f"forward/backward passes ({n_params} parameters; {card})")
    return lines


def phase_train_moe(seed: int, card: str, batch: int = 8):
    """The MoE drill (module docstring, phase 13): returns the passes and
    the layers."""
    import torch

    from torchft_tpu_torch.examples.train_moe import run_moe_drill
    from torchft_tpu_torch.models import (
        MOE_CONFIGS,
        MoETransformer,
        count_params,
    )

    t0 = time.perf_counter()
    cfg = cut_depth(MOE_CONFIGS["moe-8x125m"])
    n_params = count_params(MoETransformer(cfg, device="meta"))
    need_host = moe_host_bytes(n_params)
    free_host = check_host_memory(need_host, what="train_moe")
    need = moe_device_bytes(n_params, moe_activation_bytes(cfg, batch))
    gc.collect()  # an earlier phase's cycles may hold tensors
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info()[0]
    if free < need:
        raise AssertionError(f"train_moe needs {need / 1e9:.2f} GB of device "
                             f"memory free, has {free / 1e9:.2f} GB")
    log(f"  moe-8x125m at {cfg.n_layers} layers: {n_params} parameters, "
        f"{cfg.num_experts} experts "
        f"(capacity factor {cfg.capacity_factor}) on every "
        f"{cfg.moe_every}nd layer of {cfg.n_layers}, remat {cfg.remat}, "
        f"batch {batch} x {cfg.max_seq_len}; 2 groups x {MOE_RANKS} ranks "
        f"over TCP at codec none; device memory: up to {need / 1e9:.2f} GB, "
        f"{free / 1e9:.1f} GB free; host memory: up to "
        f"{need_host / 1e9:.2f} GB, {free_host / 1e9:.1f} GB available")
    torch.cuda.reset_peak_memory_stats()
    result = run_moe_drill(cfg, ranks=MOE_RANKS, device="cuda",
                           batch_size=batch, seed=seed, timeout=300.0,
                           log=lambda m: log("  " + m), **MOE_SCHEDULE)
    # the heal moves the parameters and AdamW's moments and step counts
    state_bytes = 12 * n_params + 4 * len(list(
        MoETransformer(cfg, device="meta").parameters()))
    for line in moe_report(result, n_params, state_bytes, card):
        log("  " + line)
    log(f"  device memory peak: {torch.cuda.max_memory_allocated() / 1e9:.2f}"
        f" GB allocated, {torch.cuda.max_memory_reserved() / 1e9:.2f} GB "
        f"reserved (reckoned {need / 1e9:.2f} GB) ({card})")
    passes = result["passes"]
    del result
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  phase {time.perf_counter() - t0:.1f} s ({card})")
    return passes, cfg.n_layers


# train_sharded: the reference example's two remaining arms, DDP's
# streamed pipeline against its lock-step arm and SHARDED=1
SHARDED_GROUPS = 3
# the drill: (kill_step, steps_alone, steps_after, kill_group)
SHARDED_SCHEDULE = (3, 1, 2, 0)
SHARDED_AB_STEPS = 2  # cut from 3 to keep the script under 900 s
SHARDED_PHASES = ("quorum", "forward_backward", "opt_update", "reshard",
                  "commit_barrier")
DDP_STAGES = ("ddp_d2h", "ddp_ef", "ddp_wire", "ddp_h2d", "ddp_wire_total",
              "ddp_wire_exposed")


def sharded_device_bytes(n_params: int, act: int,
                         groups: int = SHARDED_GROUPS) -> int:
    """Device memory the sharded drill may hold at once: per group the f32
    parameters and gradients (8 bytes a parameter) and, at the smallest
    wire (groups - 1), its optimizer shard (two moments) and the staged
    update of it (parameters and both moments): 20 bytes over the wire's
    size; and every group's activations."""
    return groups * ((8 + 20 // max(1, groups - 1)) * n_params + act)


def sharded_expected_launches(buckets: int, steps: int = SHARDED_AB_STEPS,
                              wire_steps: int = SHARDED_AB_STEPS) -> dict:
    """Each codec kernel's launches in train_sharded: the A/B arms (two
    runs of ``steps`` steps of two groups, each step an allreduce of every
    DDP bucket: 2 launches per kernel per bucket), then the card plane's
    sharded arm, whose reduce_scatter of the two owned shard buckets is the
    native scatter, one launch per kernel per step with a peer."""
    return {"ab": 2 * 2 * buckets * steps, "sharded": wire_steps}


def _digests_equal(runs, steps) -> bool:
    return all(len({r.param_digests.get(s) for r in runs}) == 1
               and runs[0].param_digests.get(s) is not None for s in steps)


def sharded_report(result: dict, replicated_bytes: int, card: str) -> list:
    """The lines train_sharded prints about the drill: per group and life
    the optimizer bytes held against the replicated bytes, the reshards
    (new world, moved and lower-bound bytes, reinitialized leaves, ms),
    the heal's optimizer bytes and its plan, and the phase p50s."""
    lines = []
    for g, lives in sorted(result["lives"].items()):
        for life, run in enumerate(lives):
            m = run.metrics
            resh = [(e["new_world"], e["wire_bytes"], e["lower_bound_bytes"],
                     e["reinit_leaves"]) for e in run.events
                    if e["kind"] == "reshard"]
            heal = [(e["moved_bytes"], e["lower_bound_bytes"])
                    for e in run.events if e["kind"] == "redist_plan"
                    and e["source"] == "opt_shard_heal"]
            lines.append(
                f"g{g} life {life}: optimizer state held "
                f"{int(m.get('opt_state_bytes', 0))} B of "
                f"{replicated_bytes} replicated; reshards (new world, moved, "
                f"lower bound, reinit leaves) {resh}; reshard p50 "
                f"{m.get('reshard_p50_ms', 0):.1f} ms; heal_opt_bytes "
                f"{int(m.get('heal_opt_bytes', 0))}, heal plan (moved, "
                f"lower bound) {heal}; phase p50 ms "
                f"{_p50s(m, SHARDED_PHASES)} ({card})")
    return lines


def check_sharded_drill(result: dict, replicated: dict) -> None:
    """The drill's own checks beyond bitwise equality of the live groups
    (``run_kill_and_heal``): every reshard and the heal moved exactly their
    lower bound, the shrink reinitialized the killed group's states, and
    steps 1-3 equal the replicated arm's bitwise."""
    for g, lives in result["lives"].items():
        for run in lives:
            for e in run.events:
                if e["kind"] == "reshard" and \
                        e["wire_bytes"] != e["lower_bound_bytes"]:
                    raise AssertionError(f"g{g}: a reshard moved "
                                         f"{e['wire_bytes']} bytes, lower "
                                         f"bound {e['lower_bound_bytes']}")
                if e["kind"] == "redist_plan" and \
                        e["moved_bytes"] != e["lower_bound_bytes"]:
                    raise AssertionError(f"g{g}: a {e['source']} plan moved "
                                         f"{e['moved_bytes']} bytes, lower "
                                         f"bound {e['lower_bound_bytes']}")
    kill_step, alone, _, kill_group = SHARDED_SCHEDULE
    healed = result["lives"][kill_group][-1]
    heals = [e for e in healed.events if e["kind"] == "redist_plan"
             and e["source"] == "opt_shard_heal"]
    if not heals or heals[0]["moved_bytes"] <= 0:
        raise AssertionError("the restarted group never fetched its "
                             "optimizer shard with fetch_opt_shard")
    survivor = result["lives"][(kill_group + 1) % SHARDED_GROUPS][0]
    shrink = [e for e in survivor.events if e["kind"] == "reshard"
              and e["new_world"] == SHARDED_GROUPS - 1]
    if not shrink:
        raise AssertionError("no reshard onto the shrunken wire")
    grow = [e for e in survivor.events if e["kind"] == "reshard"
            and e["new_world"] == SHARDED_GROUPS and e["old_world"]]
    if not grow:
        raise AssertionError("no reshard back onto the grown wire")
    reinit = sum(e["reinit_leaves"] for g, lives in result["lives"].items()
                 for run in lives for e in run.events
                 if e["kind"] == "reshard"
                 and e["new_world"] == SHARDED_GROUPS - 1)
    if reinit <= 0:
        raise AssertionError("the shrink reported no reinitialized leaves")
    steps = range(1, kill_step + 1)
    mine = survivor.param_digests
    theirs = replicated[0].param_digests
    same = [s for s in steps if mine.get(s) == theirs.get(s) is not None]
    if same != list(steps):
        raise AssertionError(f"the sharded arm equals the replicated arm "
                             f"bitwise at steps {same} of {list(steps)}")


def phase_train_sharded(seed: int, card: str, batch: int = 8):
    """The reference example's two remaining arms (module docstring, phase
    5): returns the flash launches, each codec kernel's launches, and the
    runs."""
    import torch

    from torchft_tpu_torch.examples.train_ddp import (
        run_joint,
        run_kill_and_heal,
    )
    from torchft_tpu_torch.models import CONFIGS, GPT, count_params

    t0 = time.perf_counter()
    cfg = cut_depth(CONFIGS["125m"])
    n_params = count_params(GPT(cfg, device="meta"))
    act = gpt_activation_bytes(cfg, batch)
    need = sharded_device_bytes(n_params, act)
    gc.collect()
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info()[0]
    held = torch.cuda.memory_allocated()
    log(f"  125m at {cfg.n_layers} layers: {n_params} parameters, batch "
        f"{batch}; device memory: up "
        f"to {need / 1e9:.2f} GB, {free / 1e9:.1f} GB free ({held / 1e9:.2f}"
        f" GB held by earlier phases)")
    if free < need:
        raise AssertionError(f"train_sharded needs {need / 1e9:.2f} GB of "
                             f"device memory free, has {free / 1e9:.2f} GB")
    passes = 0
    # (b) SHARDED=1: three groups over TCP at codec none, g0 killed after
    # step 3, the survivors shrink, g0 heals at 5, the three grow back
    kill_step, alone, after, kill_group = SHARDED_SCHEDULE
    t1 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    drill = run_kill_and_heal(
        cfg, kill_step=kill_step, steps_alone=alone, steps_after=after,
        groups=SHARDED_GROUPS, kill_group=kill_group, device="cuda",
        batch_size=batch, seed=seed, timeout=300.0, sharded=True,
        digest_params=True, log=lambda m: log("  " + m))
    drill_s = time.perf_counter() - t1
    passes += drill["passes"]
    t1 = time.perf_counter()
    replicated = run_joint(cfg, groups=SHARDED_GROUPS, steps=kill_step,
                           device="cuda", batch_size=batch, seed=seed,
                           timeout=300.0, sharded=False, digest_params=True)
    replicated_s = time.perf_counter() - t1
    passes += sum(r.passes for r in replicated.values())
    rep_bytes = int(replicated[0].metrics.get("opt_state_bytes", 0))
    check_sharded_drill(drill, replicated)
    log(f"  (b) SHARDED=1 drill {drill_s:.1f} s: heal at step "
        f"{drill['heal_step']}, live groups bitwise equal at every committed "
        f"step, steps 1-{kill_step} bitwise equal to the replicated arm "
        f"(its run {replicated_s:.1f} s); device memory peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB allocated "
        f"(reckoned {need / 1e9:.2f} GB) ({card})")
    for line in sharded_report(drill, rep_bytes, card):
        log("  " + line)
    for g, run in sorted(drill["runs"].items()):
        times = ", ".join(f"{s}: {t * 1e3:.1f}"
                          for s, t in sorted(run.step_seconds.items()))
        log(f"  g{g} step ms {{{times}}}")
    del drill, replicated
    gc.collect()
    torch.cuda.empty_cache()
    # (a) DDP's streamed pipeline against its lock-step arm on the card's
    # int8 plane with error feedback: the same seeds and batches
    arms = {}
    for streamed in (True, False):
        t1 = time.perf_counter()
        arms[streamed] = run_joint(
            cfg, groups=2, steps=SHARDED_AB_STEPS, device="cuda",
            batch_size=batch, seed=seed, timeout=300.0, streamed=streamed,
            comm_backend="cuda", comm_options=INT8_OPTIONS,
            digest_averages=True)
        passes += sum(r.passes for r in arms[streamed].values())
        for g, run in sorted(arms[streamed].items()):
            steps_ms = [round(t * 1e3, 1)
                        for _, t in sorted(run.step_seconds.items())]
            log(f"  (a) {'streamed' if streamed else 'lock-step'} g{g}: "
                f"{time.perf_counter() - t1:.1f} s, step ms {steps_ms} "
                f"(digests included); p50 ms "
                f"{_p50s(run.metrics, DDP_STAGES)} ({card})")
    for g in (0, 1):
        a, b = arms[True][g].average_digests, arms[False][g].average_digests
        steps = list(range(1, SHARDED_AB_STEPS + 1))
        if [s for s in steps if a.get(s) == b.get(s) is not None] != steps:
            raise AssertionError(f"g{g}: streamed and lock-step averages or "
                                 f"residuals differ ({a} vs {b})")
    buckets = len(arms[True][0].buckets)
    log(f"  (a) streamed == lock-step bitwise, averaged gradients and EF "
        f"residuals, after each of {SHARDED_AB_STEPS} steps, both groups "
        f"({buckets} buckets)")
    del arms
    gc.collect()
    # (c) the sharded arm on the card's int8 plane
    t1 = time.perf_counter()
    card_runs = run_joint(cfg, groups=2, steps=SHARDED_AB_STEPS,
                          device="cuda", batch_size=batch, seed=seed,
                          timeout=300.0, sharded=True, comm_backend="cuda",
                          comm_options=INT8_OPTIONS, digest_params=True)
    passes += sum(r.passes for r in card_runs.values())
    runs = list(card_runs.values())
    if not _digests_equal(runs, range(1, SHARDED_AB_STEPS + 1)):
        raise AssertionError("(c): the two groups' parameters differ")
    wire_steps = runs[0].wire_steps
    log(f"  (c) sharded on the int8 card plane {time.perf_counter() - t1:.1f}"
        f" s: both groups bitwise equal after each of {SHARDED_AB_STEPS} "
        f"steps; {len(runs[0].buckets)} shard buckets, {wire_steps} steps "
        f"with a peer; p50 ms {_p50s(runs[0].metrics, SHARDED_PHASES)} "
        f"({card})")
    del card_runs, runs
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  phase {time.perf_counter() - t0:.1f} s; device memory held "
        f"after it {torch.cuda.memory_allocated() / 1e9:.2f} GB ({card})")
    codec = sharded_expected_launches(buckets, wire_steps=wire_steps)
    return passes * cfg.n_layers, codec["ab"] + codec["sharded"]


# train_hier_int8: four groups in two domains over the hierarchical TCP
# wire, int8 across domains, error feedback on the compensable egress
HIER_DOMAINS = {"rack0": [0, 1], "rack1": [2, 3]}
HIER_OPTIONS = {"algorithm": "star", "compression": "int8",
                "topology": "hier", "channels": 4, "chunk_bytes": CHUNK_BYTES}
# (kill_step, steps_alone, steps_after, kill_group, record_step): steps 1-3
# joint, group 2 (rack1's egress) killed, 4-5 with rack1 = {g3}, the heal
# at 6, 7-8 joint; step 2's bucket ops recorded
HIER_SCHEDULE = (3, 2, 2, 2, 2)
# the codec kernels a hier op launches per bucket on the card plane:
# star: the encode/decode of the non-root domain sums and the root's
# re-encode; psum: one encode of the egress rows, one decode-accumulate
HIER_LAUNCHES = {"star": 2, "psum": 1}
# the card plane's psum arm against the f64 sum: one quantization of each
# domain's sum (tests/test_hier_topology.py's envelope)
HIER_PSUM_TOL = 3 / 100
# the device train_hier_int8 trains on and runs the card plane's arms on
# (the CPU tests move it)
HIER_DEVICE = "cuda"


def hier_host_bytes(n_params: int, groups: int = 4) -> int:
    """Host memory train_hier_int8 may hold at once, in f32 copies of the
    parameters: per group the pinned staging, the error-feedback residual,
    the broadcast's landing and wire scratch (4); the recorded step's
    inputs and outputs of every group (8); the heal's staged state on both
    ends (6); the host oracle's domain sums and result (4)."""
    return (groups * 4 + 18) * 4 * n_params


def _hier_roles(step: int, group: int) -> "tuple[int, bool]":
    """(members of the group's domain, is its egress) at a step of the
    drill's schedule."""
    k, s_alone, _, killed, _ = HIER_SCHEDULE
    domain = next(d for d, gs in HIER_DOMAINS.items() if group in gs)
    alive = [g for g in HIER_DOMAINS[domain]
             if not (g == killed and k < step <= k + s_alone)]
    return len(alive), group == min(alive)


def check_hier_drill(result: dict, cfg, card: str) -> list:
    """The drill's checks, raising on any miss, and its report lines: the
    groups bitwise equal at every committed step, each life's tier
    counters against the schedule (``comm_inter_bytes`` only on egress
    steps, equal to ``codec_wire_nbytes`` of the contribution;
    ``comm_intra_bytes`` zero in a singleton domain; ``comm_hops`` 4 per op
    in a two-member domain and 2 in a singleton), error feedback on the
    compensable roles only, and the recorded step against the port's
    ``_host_hier_allreduce``."""
    import numpy as np

    from torchft_tpu_torch.comm.cuda_backend import _host_hier_allreduce
    from torchft_tpu_torch.comm.transport import (
        codec_wire_nbytes,
        make_wire_codec,
    )

    k, s_alone, after, killed, record_step = HIER_SCHEDULE
    total = k + s_alone + 1 + after
    want = {s: (3 if k < s <= k + s_alone else 4)
            for s in range(1, total + 1)}
    if result["compared"] != want:
        raise AssertionError(f"groups bitwise equal per step "
                             f"{result['compared']}, the schedule has {want}")
    lines = [f"  groups bitwise equal at every committed step "
             f"{result['compared']}; group {killed} healed at step "
             f"{result['heal_step']}, bitwise equal to its donor from then"]
    codec = make_wire_codec("int8")
    buckets = result["runs"][0].buckets
    raw_step = float(sum(4 * b for b in buckets))
    enc_step = float(sum(codec_wire_nbytes(codec, CHUNK_BYTES,
                                           np.zeros(b, np.float32))
                         for b in buckets))
    for g, lives in sorted(result["lives"].items()):
        for life, run in enumerate(lives):
            steps = sorted(run.participants)
            if run.wire_steps != len(steps):
                raise AssertionError(f"group {g} life {life}: "
                                     f"{run.wire_steps} wire steps of "
                                     f"{len(steps)} committed")
            roles = [_hier_roles(s, g) for s in steps]
            want_ctr = {
                "comm_intra_bytes": sum(raw_step for m, _ in roles if m > 1),
                "comm_inter_bytes": sum(enc_step for _, e in roles if e),
                "comm_hops": sum(len(buckets) * (2.0 * (m > 1) + 2.0)
                                 for m, _ in roles),
            }
            got = {c: run.metrics.get(c, 0.0) for c in want_ctr}
            if got != want_ctr:
                raise AssertionError(f"group {g} life {life} tier counters "
                                     f"{got}, the schedule gives {want_ctr}")
            # compensable: an egress outside domain 0 (the inter root),
            # in a step it contributes real gradients (not its heal step)
            healing = set(run.healed_at)
            ef = any(e and g not in HIER_DOMAINS["rack0"]
                     for s, (_, e) in zip(steps, roles) if s not in healing)
            if ("ddp_ef_p50_ms" in run.metrics) != ef:
                raise AssertionError(f"group {g} life {life}: ddp_ef "
                                     f"{'missing' if ef else 'present'}")
            lines.append(
                f"  group {g} life {life}: steps {steps[0]}-{steps[-1]}, "
                f"comm_intra_bytes {got['comm_intra_bytes']:.0f}, "
                f"comm_inter_bytes {got['comm_inter_bytes']:.0f} "
                f"({got['comm_inter_bytes'] / max(1.0, raw_step * len(steps)):.3f}"
                f" of raw), comm_hops {got['comm_hops']:.0f} "
                f"({got['comm_hops'] / (len(buckets) * len(steps)):.2f} per "
                f"op), error feedback {'on' if ef else 'off'} ({card})")
    recorded = {g: lives[0].recorded for g, lives in result["lives"].items()}
    groups = tuple(tuple(gs) for _, gs in sorted(HIER_DOMAINS.items()))
    ops = sorted(recorded[0])
    if len(ops) != len(buckets) or any(sorted(r) != ops
                                       for r in recorded.values()):
        raise AssertionError(f"recorded ops {[sorted(r) for r in recorded.values()]}"
                             f", want {len(buckets)} per group")
    for op in ops:
        want_out = _host_hier_allreduce(
            [[a.copy() for a in recorded[g][op][0]] for g in sorted(recorded)],
            "int8", CHUNK_BYTES, "sum", groups, len(recorded))
        for g in sorted(recorded):
            for got_a, w in zip(recorded[g][op][1], want_out):
                if got_a.tobytes() != w.tobytes():
                    raise AssertionError(
                        f"step {record_step} bucket op {op}: group {g} "
                        "differs from _host_hier_allreduce")
    lines.append(f"  step {record_step}: {len(ops)} bucket ops of every "
                 f"group bitwise equal to _host_hier_allreduce of the "
                 f"recorded contributions ({card})")
    return lines


def check_hier_planes(sizes, seed: int, card: str) -> "tuple[list, int]":
    """The card plane's hier arms against the TCP hier path at each
    distinct bucket size, in the drill's 2x2 layout: ``CudaCommContext(
    topology="hier", compression="int8")`` with algorithm "star" bitwise
    equal to four TCP hier contexts and to the same plane on
    ``DevicePool("cpu")``; with "psum", identical on every rank and within
    ``HIER_PSUM_TOL * absmax`` of the f64 sum. Returns the report lines and
    the launches of each codec kernel the card arms make."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from torchft_tpu_torch.comm.context import ReduceOp
    from torchft_tpu_torch.comm.cuda_backend import CudaCommContext, DevicePool
    from torchft_tpu_torch.comm.store import StoreServer
    from torchft_tpu_torch.comm.topology import DomainTopology
    from torchft_tpu_torch.comm.transport import TcpCommContext

    world = 4
    smap = {d: [f"rank{g}" for g in gs] for d, gs in HIER_DOMAINS.items()}
    opts = {k: v for k, v in HIER_OPTIONS.items()
            if k not in ("algorithm", "channels")}
    pools = {"card": DevicePool(HIER_DEVICE), "cpu": DevicePool("cpu")}
    rng = np.random.default_rng(seed)
    lines = []
    launches = 0

    def cohort(make, tag, grads):
        ctxs = [make() for _ in range(world)]

        def worker(r):
            ctxs[r].configure(tag, r, world)
            w = ctxs[r].allreduce([grads[r].copy()], ReduceOp.SUM)
            return w.future().result(timeout=300)[0]

        try:
            with ThreadPoolExecutor(world) as ex:
                return [f.result(600) for f in
                        [ex.submit(worker, r) for r in range(world)]]
        finally:
            for c in ctxs:
                c.shutdown()

    store = StoreServer()
    try:
        for size in sorted(set(sizes)):
            grads = [(rng.standard_normal(size) * 1e-3 * (r + 1))
                     .astype(np.float32) for r in range(world)]
            out = {"tcp": cohort(lambda: TcpCommContext(
                timeout=300.0, channels=HIER_OPTIONS["channels"],
                algorithm="star", domain_resolver=DomainTopology(
                    static_map=smap), **opts),
                f"{store.addr}/hier{size}", grads)}
            for name, pool in pools.items():
                for algo in ("star", "psum"):
                    out[f"{name}/{algo}"] = cohort(
                        lambda: CudaCommContext(
                            timeout=300.0, algorithm=algo, device_pool=pool,
                            domain_resolver=DomainTopology(static_map=smap),
                            **opts),
                        f"smoke://hier{size}/{name}/{algo}", grads)
            launches += sum(HIER_LAUNCHES.values())
            star = all(a.tobytes() == b.tobytes() == c.tobytes()
                       for a, b, c in zip(out["card/star"], out["tcp"],
                                          out["cpu/star"]))
            psum = out["card/psum"]
            exact = np.sum(grads, axis=0, dtype=np.float64)
            absmax = float(max(np.abs(g).max() for g in grads))
            err = float(np.abs(psum[0].astype(np.float64) - exact).max())
            same = len({p.tobytes() for p in psum}) == 1
            ok_psum = same and err <= HIER_PSUM_TOL * absmax
            lines.append(
                f"  bucket of {size} f32: card hier star vs TCP hier and "
                f"CPU plane bitwise {'ok' if star else 'FAIL'}; card hier "
                f"psum identical on every rank {same}, max |err| "
                f"{err:.3e} <= {HIER_PSUM_TOL} x absmax {absmax:.3e}: "
                f"{'ok' if ok_psum else 'FAIL'} ({card})")
            if not (star and ok_psum):
                raise AssertionError("\n".join(lines))
    finally:
        store.shutdown()
    return lines, launches


def phase_train_hier_int8(seed: int, card: str, batch: int = 8):
    """The hierarchical drill (module docstring, phase 11): returns the
    flash kernels' launches, the codec kernels' launches and the result."""
    from torchft_tpu_torch.examples.train_ddp import run_kill_and_heal
    from torchft_tpu_torch.models import CONFIGS, GPT, count_params

    cfg = cut_depth(CONFIGS["125m"])
    n_params = count_params(GPT(cfg, device="meta"))
    need = hier_host_bytes(n_params)
    free = check_host_memory(need, what="train_hier_int8")
    log(f"  125m at {cfg.n_layers} layers: {n_params} parameters, batch {batch}, 4 groups in "
        f"domains {HIER_DOMAINS} over TCP {HIER_OPTIONS}; host memory: up "
        f"to {need / 1e9:.2f} GB, {free / 1e9:.1f} GB available")
    k, s_alone, after, killed, record_step = HIER_SCHEDULE
    t0 = time.perf_counter()
    result = run_kill_and_heal(
        cfg, kill_step=k, steps_alone=s_alone, steps_after=after, groups=4,
        kill_group=killed, domains=HIER_DOMAINS, record_step=record_step,
        device=HIER_DEVICE, batch_size=batch, seed=seed, timeout=300.0,
        log=lambda m: log("  " + m), comm_backend="host",
        comm_options=HIER_OPTIONS)
    log(f"  drill {time.perf_counter() - t0:.1f} s ({card})")
    for line in check_hier_drill(result, cfg, card):
        log(line)
    lives = result["lives"]
    phases = ("quorum", "forward_backward", "ddp_d2h", "ddp_ef", "ddp_wire",
              "ddp_h2d", "commit_barrier", "comm_op_wire")
    for g, runs in sorted(lives.items()):
        for life, run in enumerate(runs):
            log(f"  group {g} life {life} phase p50 ms "
                f"{_p50s(run.metrics, phases)} ({card})")
    healed = lives[killed][-1].metrics
    log(f"  heal of group {killed}: wall {healed.get('heal_wall_ms', 0):.1f} "
        f"ms, wire {healed.get('heal_bytes_per_s', 0) / 1e9:.3f} GB/s "
        f"({card})")
    runs = result["runs"]
    tokens = batch * cfg.max_seq_len
    rates = {s: round(tokens * len(runs) / max(r.step_seconds[s]
                                               for r in runs.values()))
             for s in result["checked_steps"][1:]}
    log(f"  committed tokens/s, 4 groups sharing the card, joint steps "
        f"after the heal: {rates} ({card})")
    lines, per_kernel = check_hier_planes(runs[0].buckets, seed, card)
    for line in lines:
        log(line)
    log(f"  {len(set(runs[0].buckets))} distinct bucket sizes x (star "
        f"{HIER_LAUNCHES['star']} + psum {HIER_LAUNCHES['psum']}) = "
        f"{per_kernel} of each codec kernel; forward/backward passes: "
        f"{result['passes']}")
    return result["passes"] * cfg.n_layers, per_kernel, result


# ------------------------------------------------------------ serve_deploy

SERVE_MEMBERS = 4           # the cohort before it grows to 5
SERVE_REPLICATION = 2
SERVE_STEPS = 6             # committed steps of the trainer
SERVE_PUBLISH = (2, 4, 6)   # the steps whose parameters are deployed
SERVE_KILLED = 1            # the member killed after v2, rejoined at v4
SERVE_HEARTBEAT_MS = 1500   # the lighthouse's: a dead member's lease ends
# An answer is sum(unit) * x summed in f32 on the card: |got - want| <=
# SERVE_ANSWER_TOL * sum(|unit|) * |x| against the float64 sum of the
# published leaf (tests/test_torch_serve_plane.py's ANSWER_TOL)
SERVE_ANSWER_TOL = 1e-5
SERVE_COUNTERS = ("serve_requests", "serve_reroutes", "serve_dropped",
                  "serve_stale_reads", "deploy_bytes_moved",
                  "deploy_lower_bound_bytes", "deploy_train_bytes",
                  "deploy_peer_bytes", "deploy_adoptions")


def serve_config():
    from torchft_tpu_torch.models import CONFIGS

    return CONFIGS["125m"]


def _serve_epoch(addr: str, job: str) -> int:
    import urllib.request

    with urllib.request.urlopen(f"{addr}/status.json", timeout=10) as r:
        return int(json.load(r)["jobs"].get(job, {}).get(
            "membership_epoch", 0))


def _shard_bytes(layout, member: int, unit_bytes) -> int:
    return sum(unit_bytes[u] for u in layout.units_of(member))


def _telemetry_counters(addr: str) -> dict:
    import urllib.request

    with urllib.request.urlopen(f"{addr}/telemetry/metrics",
                                timeout=10) as r:
        got = json.load(r)["metrics"]
    return {k: got.get(k) for k in SERVE_COUNTERS}


class _Hammer:
    """A seeded closed-loop request stream through ``cohort.answer``: units
    uniform, x in [-2, 2). Keeps every answer's (time, version, unit, x,
    value) and counts the drops the caller sees."""

    def __init__(self, cohort, n_units: int, seed: int) -> None:
        import threading

        import numpy as np

        self.cohort = cohort
        self.rng = np.random.default_rng(seed)
        self.n_units = n_units
        self.answers: list = []
        self.drops = 0
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       name="serve_hammer")

    def _run(self) -> None:
        while not self.stop.is_set():
            u = int(self.rng.integers(self.n_units))
            x = float(self.rng.uniform(-2.0, 2.0))
            try:
                v, value = self.cohort.answer(u, x)
            except ConnectionError:
                self.drops += 1
                continue
            self.answers.append((time.perf_counter(), v, u, x, value))

    def rate(self, t0: float, t1: float) -> float:
        n = sum(1 for a in self.answers if t0 <= a[0] <= t1)
        return n / max(t1 - t0, 1e-9)


def run_serve_drill(cfg, *, device=None, batch: int = 8, seed: int = 0,
                    timeout: float = 120.0) -> dict:
    """The train-to-serve drill of the ``serve_deploy`` phase (module
    docstring, phase 22): one trainer group of ``cfg`` in job "train" and a
    ``ServeCohort(SERVE_MEMBERS, replication=2)`` in job "serve" on one
    lighthouse; a seeded request stream runs through ``cohort.answer`` the
    whole drill. The trainer commits ``SERVE_STEPS`` steps; its commit hook
    records each committed step, and at the steps of ``SERVE_PUBLISH`` it
    publishes its parameters (after the update) with that version and
    waits for the drill. Deploy v2; kill member ``SERVE_KILLED`` and let
    the trainer commit 3-4 through it; deploy v4 to the survivors; rejoin
    the member from its serve peers; grow to 5; deploy v6 (the union
    transition). Raises AssertionError on any oracle; returns the
    figures."""
    import queue
    import threading

    import torch

    from torchft_tpu_torch.control import Lighthouse
    from torchft_tpu_torch.examples.train_ddp import train_group
    from torchft_tpu_torch.serve import (
        SERVE_JOB_ID,
        DeployPublisher,
        ServeCohort,
    )
    from torchft_tpu_torch.utils.metrics import Metrics

    cuda = torch.device(device or "cuda").type == "cuda"
    t_start = time.perf_counter()
    lighthouse = Lighthouse(min_replicas=1, join_timeout_ms=100,
                            quorum_tick_ms=10,
                            heartbeat_timeout_ms=SERVE_HEARTBEAT_MS)
    addr = lighthouse.address()
    pub_metrics = Metrics()
    pub = DeployPublisher(timeout=timeout, metrics=pub_metrics)
    published: "queue.Queue" = queue.Queue()
    gates = {v: threading.Event() for v in SERVE_PUBLISH[:-1]}
    stop = threading.Event()
    hook_steps: list = []
    commits: dict = {}
    sums: dict = {}
    publish_s: dict = {}
    errors: list = []
    trainer_run: list = []

    def on_start(manager) -> None:
        manager.set_commit_hook(lambda step, parts: hook_steps.append(step))

    def on_commit(step, manager, model, loss) -> None:
        # the hook fired inside should_commit, before the update; the
        # parameters read here are the committed step's, updated
        if not hook_steps or hook_steps[-1] != step - 1:
            raise AssertionError(f"commit hook recorded {hook_steps}, "
                                 f"the trainer committed step {step}")
        commits[step] = time.perf_counter()
        if step not in SERVE_PUBLISH:
            return
        params = [p.detach() for p in model.parameters()]
        sums[step] = [(float(p.double().sum()), float(p.double().abs().sum()))
                      for p in params]
        t0 = time.perf_counter()
        published.put((step, pub.publish(step, params)))
        publish_s[step] = time.perf_counter() - t0
        gate = gates.get(step)
        if gate is not None:
            while not gate.wait(0.1):
                if stop.is_set():
                    raise RuntimeError("the serve drill failed")

    def trainer() -> None:
        try:
            trainer_run.append(train_group(
                cfg, replica_group=0, num_groups=1, total_steps=SERVE_STEPS,
                lighthouse_addr=addr, device=device, batch_size=batch,
                init_seed=seed, data_seed=seed, on_start=on_start,
                on_commit=on_commit, stop=stop, timeout=timeout,
                job_id="train"))
        except BaseException as e:  # noqa: BLE001 — reported by the drill
            errors.append(e)
            stop.set()

    def next_version(want: int) -> str:
        deadline = time.monotonic() + 4 * timeout
        while True:
            if errors:
                raise RuntimeError(f"the trainer failed: {errors[0]!r}")
            try:
                v, a = published.get(timeout=0.5)
            except queue.Empty:
                if time.monotonic() > deadline:
                    raise TimeoutError(f"no publication of v{want}")
                continue
            _require(v == want, f"published v{v}, want v{want}")
            return a

    def check_member(m, version: int, what: str) -> None:
        snap = m.metrics.snapshot()
        _require(snap["deploy_bytes_moved"] == snap[
            "deploy_lower_bound_bytes"], f"{what}: member {m.member_index} "
            f"moved {snap['deploy_bytes_moved']}, lower bound "
            f"{snap['deploy_lower_bound_bytes']}")
        want = pub.digests(version)
        got = m.live_digests()
        _require(m.version == version and got and all(
            d == want[u] for u, d in got.items()),
            f"{what}: member {m.member_index}'s live units at version "
            f"{m.version} differ from the publication's digests")

    cohort = ServeCohort(SERVE_MEMBERS, lighthouse_addr=addr,
                         replication=SERVE_REPLICATION, timeout=timeout,
                         heartbeat_interval=0.1, device=device)
    hammer = None
    thread = threading.Thread(target=trainer, name="serve_trainer",
                              daemon=True)
    deploys: dict = {}
    try:
        thread.start()
        a2 = next_version(2)
        unit_bytes = pub.unit_bytes
        model_bytes = sum(unit_bytes)
        n_units = len(unit_bytes)

        def deploy(version: int, address: str) -> dict:
            before = {m.member_index: m.metrics.snapshot()
                      for m in cohort.members}
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            moved = cohort.deploy(version, [address], unit_bytes)
            t1 = time.perf_counter()
            live = [m for m in cohort.members if m.alive]
            for m in live:
                check_member(m, version, f"v{version}")
            snaps = {m.member_index: m.metrics.snapshot() for m in live}
            rec = {"wall_s": t1 - t0, "moved": int(moved), "t0": t0,
                   "t1": t1,
                   "peak_gb": (torch.cuda.max_memory_allocated() / 1e9
                               if cuda else None),
                   "per_member": {i: s["deploy_bytes_moved"] - before[i]
                                  .get("deploy_bytes_moved", 0.0)
                                  for i, s in snaps.items()},
                   "lower": sum(s["deploy_lower_bound_bytes"] - before[i]
                                .get("deploy_lower_bound_bytes", 0.0)
                                for i, s in snaps.items()),
                   "adopt_ms": {i: s.get("deploy_wall_ms")
                                for i, s in snaps.items()},
                   "upload_ms": {i: s.get("deploy_upload_max_ms")
                                 for i, s in snaps.items()}}
            deploys[version] = rec
            return rec

        # -- v2 to the whole cohort --------------------------------------
        d2 = deploy(2, a2)
        _require(d2["moved"] == SERVE_REPLICATION * model_bytes,
                 f"v2 moved {d2['moved']}, want {SERVE_REPLICATION} x the "
                 f"model's {model_bytes}")
        hammer = _Hammer(cohort, n_units, seed)
        hammer.thread.start()
        time.sleep(0.5)
        # -- the kill; the trainer commits through it --------------------
        epoch0 = _serve_epoch(addr, SERVE_JOB_ID)
        t_kill = time.perf_counter()
        cohort.members[SERVE_KILLED].kill()
        gates[2].set()
        deadline = time.monotonic() + 10 * SERVE_HEARTBEAT_MS / 1e3
        while _serve_epoch(addr, SERVE_JOB_ID) == epoch0:
            _require(time.monotonic() < deadline,
                     f"the serve job's membership_epoch stayed {epoch0} "
                     f"after member {SERVE_KILLED}'s kill")
            time.sleep(0.05)
        epoch1 = _serve_epoch(addr, SERVE_JOB_ID)
        t_epoch = time.perf_counter()
        # -- v4 to the survivors, under traffic ---------------------------
        a4 = next_version(4)
        _require(all(commits[s] > t_kill for s in (3, 4)),
                 "the trainer did not commit steps 3-4 after the kill")
        d4 = deploy(4, a4)
        killed_bytes = _shard_bytes(cohort.layout, SERVE_KILLED, unit_bytes)
        _require(d4["moved"] == SERVE_REPLICATION * model_bytes
                 - killed_bytes,
                 f"v4 moved {d4['moved']}, want 2 x {model_bytes} less the "
                 f"killed member's shard {killed_bytes}")
        _require(float(cohort.metrics.snapshot().get("serve_reroutes")
                       or 0) > 0, "no request was re-routed after the kill")
        # -- the rejoin from serve peers ---------------------------------
        victim = cohort.members[SERVE_KILLED]
        snap0 = victim.metrics.snapshot()
        t0 = time.perf_counter()
        healed = cohort.rejoin_member(SERVE_KILLED)
        rejoin_s = time.perf_counter() - t0
        snap1 = victim.metrics.snapshot()
        d_train = snap1.get("deploy_train_bytes", 0) - snap0.get(
            "deploy_train_bytes", 0)
        d_peer = snap1.get("deploy_peer_bytes", 0) - snap0.get(
            "deploy_peer_bytes", 0)
        _require(d_train == 0 and d_peer == healed == killed_bytes,
                 f"rejoin: train bytes moved {d_train}, peer bytes "
                 f"{d_peer}, healed {healed}, the shard {killed_bytes}")
        check_member(victim, 4, "rejoin")
        # -- growth, then v6: the union transition ------------------------
        joiner = cohort.grow()
        gates[4].set()
        d6 = deploy(6, next_version(6))
        for v, d in deploys.items():
            _require(d["moved"] == d["lower"],
                     f"v{v} moved {d['moved']}, the lower bounds sum to "
                     f"{d['lower']}")
        jm = d6["per_member"][joiner.member_index]
        _require(0 < jm < model_bytes,
                 f"the joiner moved {jm} of the model's {model_bytes}")
        time.sleep(0.5)
        hammer.stop.set()
        hammer.thread.join(timeout=timeout)
        thread.join(timeout=timeout)
        _require(not errors, f"the trainer failed: {errors!r}")
        # -- the serving oracles -----------------------------------------
        dropped = float(cohort.metrics.snapshot().get("serve_dropped") or 0)
        stale = sum(float(m.metrics.snapshot().get("serve_stale_reads")
                          or 0) for m in cohort.members if m.alive)
        _require(dropped == 0 and hammer.drops == 0,
                 f"{dropped} requests dropped ({hammer.drops} seen)")
        _require(stale == 0, f"{stale} stale reads")
        _require(len(hammer.answers) > 1, "no request was answered")
        worst = 0.0
        for _, v, u, x, value in hammer.answers:
            s, a = sums[v][u]
            worst = max(worst, abs(value - s * x) / max(a * abs(x), 1e-30))
        _require(worst <= SERVE_ANSWER_TOL,
                 f"an answer is {worst:.3e} (relative to sum |unit| |x|) "
                 f"off the float64 sum, bound {SERVE_ANSWER_TOL}")
        tele = {"router": (_telemetry_counters(cohort.router_address()),
                           cohort.metrics.snapshot())}
        for m in cohort.members:
            tele[f"member {m.member_index}"] = (
                _telemetry_counters(m.address), m.metrics.snapshot())
        for who, (http, snap) in tele.items():
            want = {k: snap.get(k) for k in SERVE_COUNTERS}
            _require(http == want, f"{who}'s /telemetry counters {http} "
                                   f"differ from its Metrics {want}")
        answers = hammer.answers
        return {
            "run": trainer_run[0], "deploys": deploys,
            "model_bytes": model_bytes, "units": n_units,
            "killed_bytes": killed_bytes,
            "rejoin": {"moved": healed, "wall_s": rejoin_s},
            "epochs": (epoch0, epoch1), "epoch_s": t_epoch - t_kill,
            "after_kill": sorted(s for s, t in commits.items()
                                 if t > t_kill),
            "answers": len(answers),
            "answer_rate": len(answers) / max(
                answers[-1][0] - answers[0][0], 1e-9),
            "rates": {v: hammer.rate(d["t0"], d["t1"])
                      for v, d in deploys.items()},
            "worst": worst,
            "reroutes": float(cohort.metrics.snapshot()["serve_reroutes"]),
            "publish_s": publish_s,
            "publish_metrics": pub_metrics.snapshot(),
            "answer_ms": {m.member_index: (
                m.metrics.snapshot().get("serve_answer_avg_ms"),
                m.metrics.snapshot().get("serve_answer_max_ms"))
                for m in cohort.members},
            "seconds": time.perf_counter() - t_start,
        }
    finally:
        stop.set()
        for g in gates.values():
            g.set()
        if hammer is not None:
            hammer.stop.set()
            hammer.thread.join(timeout=timeout)
        thread.join(timeout=timeout)
        cohort.shutdown()
        pub.close()
        lighthouse.shutdown()


def serve_report(result: dict, card: str) -> list:
    lines = [f"{result['units']} units, the model {result['model_bytes']} "
             f"bytes; the serve job's membership_epoch "
             f"{result['epochs'][0]} -> {result['epochs'][1]} "
             f"{result['epoch_s']:.2f} s after the kill; the trainer "
             f"committed steps {result['after_kill']} after it"]
    for v, d in sorted(result["deploys"].items()):
        peak = "not measured" if d["peak_gb"] is None \
            else f"{d['peak_gb']:.2f} GB"
        lines.append(
            f"deploy v{v}: wall {d['wall_s']:.3f} s, moved {d['moved']} "
            f"bytes, lower bound {int(d['lower'])}, per member (each = its "
            f"lower bound) "
            f"{sorted((k, int(b)) for k, b in d['per_member'].items())}, "
            f"{d['moved'] / max(d['wall_s'], 1e-9) / 1e9:.3f} GB/s; "
            f"answers {result['rates'][v]:.1f}/s during it; peak device "
            f"memory {peak} ({card})")
        lines.append(
            f"deploy v{v} per member: adopt ms "
            f"{ {k: round(x, 1) for k, x in d['adopt_ms'].items()} }, the "
            f"upload to the device in it ms "
            f"{ {k: round(x or 0, 1) for k, x in d['upload_ms'].items()} }")
    pm = result["publish_metrics"]
    lines.append(
        "publish s " + str({v: round(s, 3)
                            for v, s in result["publish_s"].items()})
        + f": D2H of the units avg "
        f"{pm.get('deploy_publish_d2h_avg_ms', 0):.1f} ms, sha256 avg "
        f"{pm.get('deploy_publish_digest_avg_ms', 0):.1f} ms ({card})")
    r = result["rejoin"]
    lines.append(f"rejoin of member {SERVE_KILLED}: {int(r['moved'])} bytes "
                 f"from serve peers (= its shard {result['killed_bytes']}), "
                 f"0 from the trainer, {r['wall_s']:.3f} s")
    lines.append(
        f"answers: {result['answers']} at {result['answer_rate']:.1f}/s "
        f"overall, 0 dropped, 0 stale, {result['reroutes']:.0f} re-routed, "
        f"worst |got - want| / (sum |unit| |x|) {result['worst']:.2e} "
        f"(bound {SERVE_ANSWER_TOL}); per member answer ms (avg, max) "
        + str({k: (round(a or 0, 2), round(b or 0, 2))
               for k, (a, b) in result["answer_ms"].items()}) + f" ({card})")
    run = result["run"]
    times = ", ".join(f"{s}: {t * 1e3:.1f}"
                      for s, t in sorted(run.step_seconds.items()))
    lines.append(f"trainer step ms {{{times}}}; {run.passes} "
                 f"forward/backward passes; drill {result['seconds']:.1f} s "
                 f"({card})")
    return lines


def phase_serve_deploy(seed: int, card: str, device: str = "cuda"):
    """The train-to-serve phase (module docstring, phase 22). Returns the
    kernel launches, those the trainer's passes want, and the head_dim."""
    from torchft_tpu_torch.ops import flash, quant

    cfg = serve_config()
    t0 = time.perf_counter()
    log(f"  trainer: d_model {cfg.d_model} layers {cfg.n_layers} heads "
        f"{cfg.n_heads} (head_dim {cfg.head_dim}) seq {cfg.max_seq_len}, "
        f"batch 8; cohort {SERVE_MEMBERS} members, replication "
        f"{SERVE_REPLICATION}, on {device}")
    flash.reset_launch_counts()
    quant.reset_launch_counts()
    result = run_serve_drill(cfg, device=device, seed=seed)
    counts = {**flash.LAUNCHES, **quant.LAUNCHES}
    for line in serve_report(result, card):
        log("  " + line)
    log(f"  phase {time.perf_counter() - t0:.1f} s ({card})")
    want = {**{n: result["run"].passes * cfg.n_layers
               for n in flash.LAUNCHES},
            **dict.fromkeys(quant.LAUNCHES, 0)}
    return counts, want, cfg.head_dim


# train_proc: replica groups as OS processes at 125m (run_process_drill)
PROC_BATCH = 8
# one CUDA context with cuBLAS's workspace and the kernels' module, reckoned
PROC_CONTEXT_BYTES = 1 << 30
PROC_PORTS = (29600, 29700)  # the launcher's defaults: manager, store
# a child's device bytes at rest beyond its parameters, gradients and
# moments: DDP's buckets and the step's small tensors (92.7 MiB measured
# at 125m on the H100); a second parameters + AdamW footprint is 1.63 GB
PROC_REST_SLACK = 256 << 20
# a classic update's rise, bytes a parameter: the foreach AdamW's
# temporaries (one parameter-sized tensor, reckoned), the overlapped
# arm's backup of the parameters and both moments, and the donated arm's
# bound, under the backup
PROC_UPDATE_TEMP = 4
PROC_BACKUP = 12
PROC_DONATED_RISE = 8
# group 0 (both lives) decides first; group 1 overlaps (the default)
PROC_DONATE = (True, False)


def proc_child_bytes(n_params: int, act: int, graphs: int = 0,
                     overlapped: bool = True) -> int:
    """Device memory one train_proc child may allocate: its f32
    parameters, gradients and two AdamW moments (16 bytes a parameter),
    the private pool of each CUDA graph it captured (one pass's
    activations), and the larger of two windows: a forward/backward (one
    pass's activations) and a classic update (the foreach AdamW's
    temporaries, 4 bytes a parameter, and on the overlapped arm the
    backup, 12: 16 + 12 + 4 in all). At 125m, batch 8, the activations
    (7.58 GB, 55.7 bytes a parameter) outweigh the update (2.18 GB
    overlapped), so the peak is the forward/backward's: a second
    footprint that outlived the update would show at rest, not here."""
    update = PROC_UPDATE_TEMP + (PROC_BACKUP if overlapped else 0)
    return 16 * n_params + act * graphs + max(act, update * n_params)


def train_proc_device_bytes(n_params: int, act: int) -> int:
    """Device memory train_proc may hold at once: two children (the victim
    or the relaunch, and the survivor with the graph of its solo steps),
    each with a CUDA context."""
    return (proc_child_bytes(n_params, act)
            + proc_child_bytes(n_params, act, graphs=1)
            + 2 * PROC_CONTEXT_BYTES)


def proc_host_bytes(n_params: int, groups: int = 2) -> int:
    """Host memory train_proc may hold at once, in f32 copies of the
    parameters: per child the DDP staging arena, the wire's buffers and
    scratch (4); once, the heal's staged state on both ends (6)."""
    return (groups * 4 + 6) * 4 * n_params


PROC_PHASES = ("quorum", "forward_backward", "ddp_wire", "commit_barrier")
# the optimizer wrapper's classic phases: the backup and the update's
# enqueue, and the exposed barrier
PROC_COMMIT_PHASES = ("prologue", "dispatch", "barrier")
_LIFE = {(0, 0): "group 0 (killed)", (1, 0): "group 1 (survivor)",
         (0, 1): "group 0 (relaunch)"}


def proc_report(result: dict, n_params: int, act: int, card: str) -> list:
    """The lines train_proc prints about a ``run_process_drill`` result:
    the kill-to-heal timeline, the card's memory through it, and each
    life's passes, launches, peak memory and phase p50s."""
    tl, mem = result["timeline"], result["memory"]
    su = tl["relaunch_startup"]
    latch = tl["survivor_latch_s"]
    lc = result["lifecycle"]
    lines = [
        f"kill-to-heal, seconds from the SIGKILL of group 0 in its step "
        f"{max(result['commits'][(0, 0)]) + 1}: reaped {tl['reap_s']:.3f}; survivor latch "
        + (f"{latch:.3f}" if latch is not None else "none (its next quorum "
           "formed without the dead peer)")
        + f"; member_dead {tl['member_dead_s']:.3f}; solo commits "
        f"{[round(t, 3) for t in tl['solo_commit_s']]}; "
        f"relaunch spawned at {tl['relaunch_after_kill_s']:.3f}, its "
        f"interpreter and imports {tl['relaunch_spawn_s']:.2f}, CUDA init "
        f"{su.get('cuda_init_s', 0):.2f}, kernel load "
        f"{su.get('kernel_load_s', 0):.3f}, model build "
        f"{su.get('model_build_s', 0):.2f} (model, optimizer, manager): "
        f"started {tl['relaunch_started_s']:.2f} after its spawn; heal at "
        f"step {result['heal_step']}: "
        f"{tl['heal'].get('heal_wire_bytes', 0):.0f} bytes in "
        f"{tl['heal'].get('heal_wall_ms', 0):.1f} ms "
        f"({tl['heal'].get('heal_bytes_per_s', 0) / 1e9:.3f} GB/s); first "
        f"joint commit {tl['first_joint_commit_s']:.2f} ({card})",
        f"lifecycle from /telemetry alone: survivor's last two-wire quorum "
        f"epoch {lc['last_two_wire_epoch']}, member_dead of group 0's first "
        f"life at epoch {lc['death_epoch']} (step {lc['death_step']}, "
        f"{tl['member_dead_s']:.3f} s after the kill), two-wire again at "
        f"epoch {lc['rejoin_epoch']}; relaunch heal_start "
        f"{tl['heal_start_s']:.3f} -> heal_done {tl['heal_done_s']:.3f} s "
        f"at epoch {lc['heal_epoch']}, first resumed commit from step "
        f"{lc['first_resumed_commit']} at {tl['first_resumed_s']:.3f} s; "
        f"survivor steps_committed {lc['steps_committed']:.0f}, allreduce "
        f"p50 {lc['allreduce_p50_ms']:.2f} ms; events "
        + "; ".join(f"{life} {sum(kinds.values())} "
                    + ", ".join(f"{k} {n}" for k, n in sorted(kinds.items()))
                    for life, kinds in lc["event_counts"].items())
        + f"; merged Chrome trace valid ({lc['trace_events']} events) "
        f"({card})"]
    if mem:
        lines.append(
            f"card free memory: {mem['before'] / 1e9:.3f} GB before the "
            f"groups, {mem['at_kill'] / 1e9:.3f} at the kill, "
            f"{mem['after_kill'] / 1e9:.3f} after the reap (want "
            f"{mem['want_after_kill'] / 1e9:.3f} - 1 GiB; survivor's share "
            f"{mem['survivor_share'] / 1e9:.3f}, a context "
            f"{mem['context'] / 1e9:.3f}), reclaimed in "
            f"{mem['reclaim_s']:.2f} s; {mem['after'] / 1e9:.3f} after the "
            f"drill ({card})")
    for key, name in _LIFE.items():
        commits = result["commits"].get(key, {})
        rest = [c["allocated"] for c in commits.values()]
        rises = {s: c["update_rise"] for s, c in sorted(commits.items())
                 if c.get("update_rise") is not None}
        done = result["done"].get(key, (None, {}))[1]
        graphs = done.get("captures", 0)
        peak = result["peaks"].get(key)
        donated = result["donate_update"][key[0]]
        reckoned = proc_child_bytes(n_params, act, graphs, not donated)
        lines.append(
            f"{name}: committed {min(commits)}-{max(commits)} "
            f"({'decide first' if donated else 'overlapped'}), "
            f"{result['passes'][key]} passes, flash launches "
            f"{result['launches'][key]}, graphs {graphs}"
            + (f", peak {peak / 1e9:.3f} GB allocated (reckoned "
               f"{reckoned / 1e9:.3f}; a second parameters + AdamW "
               f"footprint is "
               f"{12 * n_params / 1e9:.3f}), at rest after commits "
               f"{min(rest) / 1e9:.3f}-{max(rest) / 1e9:.3f} GB"
               if peak is not None else "")
            + (", update rise by step, bytes (a parameter): "
               + ", ".join(f"{s}: {r} ({r / n_params:.2f})"
                           for s, r in rises.items()) if rises else "")
            + (f", phase p50 ms {_p50s(done['metrics'], PROC_PHASES)}, "
               f"commit p50 ms "
               f"{_p50s(done['classic_metrics'], PROC_COMMIT_PHASES)}"
               if done else ""))
    lines.append(f"drill {result['seconds']:.1f} s ({card})")
    return lines


def check_proc_memory(result: dict, n_params: int, act: int) -> None:
    """Each child's peak within its reckoning (``proc_child_bytes``: one
    parameters + gradients + AdamW footprint, its activations and graph
    pools, and its arm's update), and at rest after every commit at most
    one footprint of parameters, gradients and moments (16 bytes a
    parameter) beside its graph pools and ``PROC_REST_SLACK``: no commit
    left a second parameters + AdamW footprint behind. The classic
    commits' update rises hold the claim of tests/test_memory_plan.py:
    in a decide-first child every one is under ``PROC_DONATED_RISE``
    bytes a parameter (no second footprint, even transiently); in an
    overlapped child the largest is at least ``PROC_BACKUP`` (the
    transient backup)."""
    for key, name in _LIFE.items():
        donated = result["donate_update"][key[0]]
        graphs = result["done"].get(key, (None, {}))[1].get("captures", 0)
        peak = result["peaks"][key]
        want = proc_child_bytes(n_params, act, graphs,
                                overlapped=not donated)
        _require(peak <= want, f"{name}: peak {peak} bytes allocated, "
                 f"reckoned {want}")
        commits = result["commits"][key].values()
        rest = max(c["allocated"] for c in commits)
        bound = 16 * n_params + graphs * act + PROC_REST_SLACK
        _require(rest <= bound, f"{name}: {rest} bytes allocated after a "
                 f"commit, more than one footprint ({bound})")
        rises = [c["update_rise"] for c in commits
                 if c.get("update_rise") is not None]
        _require(bool(rises), f"{name}: no classic commit reported its "
                 "update's rise")
        if donated:
            _require(max(rises) < PROC_DONATED_RISE * n_params,
                     f"{name} (decide first): an update rose {max(rises)} "
                     f"bytes, not under {PROC_DONATED_RISE} a parameter")
        else:
            _require(max(rises) >= PROC_BACKUP * n_params,
                     f"{name} (overlapped): the largest update rise "
                     f"{max(rises)} bytes is under the backup's "
                     f"{PROC_BACKUP} a parameter")


def phase_train_proc(seed: int, card: str, batch: int = PROC_BATCH):
    """Replica groups as OS processes (module docstring, phase 23):
    returns the children's flash launches, those the schedule wants, and
    the head_dim."""
    import torch

    from torchft_tpu_torch.examples.train_ddp import run_process_drill
    from torchft_tpu_torch.models import CONFIGS, GPT, count_params

    t0 = time.perf_counter()
    cfg = cut_depth(CONFIGS["125m"])
    n_params = count_params(GPT(cfg, device="meta"))
    free_host = check_host_memory(proc_host_bytes(n_params),
                                  what="train_proc")
    act = gpt_activation_bytes(cfg, batch)
    need = train_proc_device_bytes(n_params, act)
    gc.collect()
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info()[0]
    if free < need:
        raise AssertionError(f"train_proc needs {need / 1e9:.2f} GB of "
                             f"device memory free, has {free / 1e9:.2f} GB")
    log(f"  125m at {cfg.n_layers} layers: {n_params} parameters, batch "
        f"{batch}, two groups as OS "
        f"processes (spawn) over TCP at codec none; device memory: up to "
        f"{need / 1e9:.2f} GB, {free / 1e9:.1f} GB free; host memory "
        f"{free_host / 1e9:.1f} GB available")
    result = run_process_drill(
        cfg, device="cuda", batch_size=batch, seed=seed, timeout=120.0,
        base_manager_port=PROC_PORTS[0], base_store_port=PROC_PORTS[1],
        donate_update=PROC_DONATE, log=lambda m: log("  " + m))
    for line in proc_report(result, n_params, act, card):
        log("  " + line)
    check_proc_memory(result, n_params, act)
    counts = {k: sum(c[k] for c in result["launches"].values())
              for k in FLASH_KERNELS}
    want = cfg.n_layers * sum(result["passes"].values())
    log(f"  phase {time.perf_counter() - t0:.1f} s ({card})")
    return counts, dict.fromkeys(FLASH_KERNELS, want), cfg.head_dim


# train_churn: repeated kills while the job commits (run_churn_drill), the
# reference churn test's schedule at "125m", then a latched card plane
CHURN_BATCH = 8
# arm (b): two groups on the int8 card plane; group 0 latches its wire at
# the start of step 4, and each group commits every step after it
CHURN_LATCH = dict(groups=2, kills=(), min_replicas=2, total_steps=6,
                   latch=(0, 3))
# arm (b)'s wire timeout, which the latched step's peer waits out once: at
# most the init heal's 1.63 GB skews the groups' first bucket op
CHURN_WIRE_TIMEOUT = 10.0
CHURN_PHASES = ("quorum", "forward_backward", "ddp_wire", "commit_barrier")


def churn_device_bytes(n_params: int, act: int, groups: int = 5,
                       cards: int = 1) -> int:
    """Device memory train_churn's arm (a) may hold at once on its fullest
    card: each group there is a train_proc child's reckoning
    (``proc_child_bytes``: parameters, gradients and AdamW moments, and
    the larger of a pass's activations and an overlapped update). A dead
    life is freed before its restart builds, so no card holds more than
    its groups' share."""
    return -(-groups // cards) * proc_child_bytes(n_params, act)


def churn_launches(churn: dict, latch: dict, layers: int,
                   positions: list) -> tuple:
    """The launches train_churn wants of each kernel: each flash kernel
    once per layer per pass of every life of both arms; each codec kernel
    ``codec_launches`` per bucket op of arm (b), one op a DDP bucket a
    committed step with a peer (the latched step reduces nothing: its
    ops fail on the latched side and time out on the other). Returns the
    counts and the wire steps and buckets they came from."""
    runs = [r for rs in latch["lives"].values() for r in rs]
    wire = {r.wire_steps for r in runs}
    if len(wire) != 1:
        raise AssertionError(f"arm (b)'s groups committed {sorted(wire)} "
                             "steps with a peer: each should have all")
    steps, buckets = wire.pop(), len(runs[0].buckets)
    flash = layers * (churn["passes"] + latch["passes"])
    codec = codec_launches(2, positions) * buckets * steps
    return ({**dict.fromkeys(FLASH_KERNELS, flash),
             **dict.fromkeys(("quant_int8", "dequant_acc_int8"), codec)},
            steps, buckets)


def _s(v) -> str:
    return "n/a" if v is None else f"{v:.3f}"


def churn_report(result: dict, card: str) -> list:
    """The lines train_churn prints about a ``run_churn_drill`` result:
    each kill's timeline, heal and device memory, each group's commits,
    the committed tokens/s before the first kill and over the run, the
    latch, and the drill's figures."""
    lines = []
    for k in result["kills"]:
        rate = k["heal_bytes_per_s"]
        lines.append(
            f"kill of group {k['group']} life {k['life']} after step "
            f"{k['death_step']} (scheduled at {k['step']}), seconds from "
            f"the kill: survivors' first commit without it "
            f"{_s(k['survivors_first_commit_s'])}; restart started "
            f"{_s(k['restart_started_s'])}; heal_start "
            f"{_s(k['heal_start_s'])}, heal_done {_s(k['heal_done_s'])} "
            f"(step {k['heal_step']}); first commit "
            f"{_s(k['first_commit_s'])} ({card})")
        lines.append(
            f"  heal: {k['heal_bytes'] or 0:.0f} bytes in "
            f"{k['heal_ms'] or 0:.1f} ms, "
            f"{(rate or 0) / 1e9:.3f} GB/s ({card})")
        if result["cuda"]:
            lines.append(
                f"  device memory allocated, every group between steps: "
                f"{k['memory_before'] / 1e9:.3f} GB at the kill's last "
                f"commit (step {k['death_step']}), "
                f"{k['memory_after'] / 1e9:.3f} GB after the heal (step "
                f"{k['heal_step']}); limit + one model's parameters "
                f"{result['param_bytes'] / 1e9:.3f} GB")
    for g, runs in result["lives"].items():
        spans = []
        for life, run in enumerate(runs):
            steps = sorted(result["commits"].get((g, life), {}))
            spans.append(f"life {life} {steps[0]}-{steps[-1]}" if steps
                         else f"life {life} none")
        p50 = _p50s(runs[-1].metrics, CHURN_PHASES)
        lines.append(f"group {g}: committed {', '.join(spans)}; last life's "
                     f"p50 ms {p50} ({card})")
    rates = result["tokens_per_s"]
    lines.append(f"committed tokens/s of the gated drill (commit-hook "
                 f"meetings and restart holds included), all groups: "
                 f"{rates['before_first_kill'] or 0:.1f} before the first "
                 f"kill, {rates['whole_run'] or 0:.1f} over the run "
                 f"({card})")
    latch = result["latch"]
    if latch is not None:
        epochs = {s: b["comm_epoch"] for s, b in sorted(
            result["commits"][(latch["group"], 0)].items())}
        lines.append(f"latch: group {latch['group']} latched its wire at "
                     f"the start of step {latch['step'] + 1}; its "
                     f"comm_epoch by committed step {epochs}; commits "
                     f"after the latch {latch['post_commits']}")
    lines.append(f"drill {result['seconds']:.1f} s; {result['passes']} "
                 f"passes; steps committed by two lives or more: "
                 f"{result['overlap']} ({card})")
    return lines


def phase_train_churn(seed: int, card: str, batch: int = CHURN_BATCH,
                      devices=None):
    """Repeated kills while the job commits (module docstring, phase 25):
    returns the launches the phase wants, arm (a)'s result and arm (b)'s."""
    import torch

    from torchft_tpu_torch.examples.train_ddp import (CHURN_GROUPS,
                                                      run_churn_drill)
    from torchft_tpu_torch.models import CONFIGS, GPT, count_params

    t0 = time.perf_counter()
    cfg = CONFIGS["125m"]
    n_params = count_params(GPT(cfg, device="meta"))
    free_host = check_host_memory(proc_host_bytes(n_params, CHURN_GROUPS),
                                  what="train_churn")
    act = gpt_activation_bytes(cfg, batch)
    cards = list(devices) if devices is not None else [torch.device("cuda")]
    need = churn_device_bytes(n_params, act, CHURN_GROUPS, len(cards))
    gc.collect()
    torch.cuda.empty_cache()
    free = min(torch.cuda.mem_get_info(d)[0] for d in cards)
    if free < need:
        raise AssertionError(f"train_churn needs {need / 1e9:.2f} GB of "
                             f"device memory free on each card, has "
                             f"{free / 1e9:.2f} GB")
    log(f"  125m: {n_params} parameters, batch {batch}; (a) "
        f"{CHURN_GROUPS} groups over TCP at codec none, min_replicas 3, "
        f"10 steps, kills (group, step) (1, 2), (3, 4), (1, 6); device "
        f"memory: up to {need / 1e9:.2f} GB a card, {free / 1e9:.1f} GB "
        f"free; host memory {free_host / 1e9:.1f} GB available")
    place = dict(device="cuda") if devices is None else dict(devices=devices)
    torch.cuda.reset_peak_memory_stats()
    churn = run_churn_drill(cfg, batch_size=batch, seed=seed, timeout=120.0,
                            log=lambda m: log("  " + m), **place)
    for line in churn_report(churn, card):
        log("  " + line)
    log(f"  (b) 2 groups on the card plane {INT8_OPTIONS}, wire timeout "
        f"{CHURN_WIRE_TIMEOUT} s, group 0 latching its wire at the start "
        "of step 4")
    latch = run_churn_drill(
        cfg, batch_size=batch, seed=seed, timeout=120.0,
        comm_backend="cuda",
        comm_options={**INT8_OPTIONS, "timeout": CHURN_WIRE_TIMEOUT},
        log=lambda m: log("  " + m), **CHURN_LATCH, **place)
    for line in churn_report(latch, card):
        log("  " + line)
    positions = cycled(list(devices) if devices is not None
                       else [torch.device("cuda", 0)], 2)
    want, steps, buckets = churn_launches(churn, latch, cfg.n_layers,
                                          positions)
    log(f"  (b) {buckets} gradient buckets x {steps} steps with a peer x "
        f"{codec_launches(2, positions)} launches of each codec kernel")
    log(f"  device memory peak {torch.cuda.max_memory_allocated() / 1e9:.2f}"
        f" GB allocated (reckoned {need / 1e9:.2f} GB a card) ({card})")
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  phase {time.perf_counter() - t0:.1f} s ({card})")
    return want, churn, latch


# dryrun_multichip: the driver entry's twin on a virtual mesh of the card
DRYRUN_POSITIONS = 8  # the reference driver's count
ENTRY_CALLS = 5       # timed forwards of entry()'s fn


def dryrun_launches(n: int) -> dict:
    """Each segment's flash launches in ``dryrun_multichip(n)`` ("tiny",
    2 layers, no remat): the sharded step one attention per layer per
    position, the ring its pairs per layer, the MoE transformer one per
    layer per position, and each unsharded counterpart one per layer."""
    from torchft_tpu_torch.parallel import ring_launches

    layers = 2
    dense = hsdp_launches(1, layers, 1, remat=False)
    ring = {k: v * layers + dense[k]
            for k, v in ring_launches(n, causal=True).items()}
    sharded = {k: v + dense[k] for k, v in
               hsdp_launches(1, layers, n, remat=False).items()}
    zero = dict.fromkeys(FLASH_KERNELS, 0)
    return {"step": sharded, "vocab": zero, "ring": ring, "moe": sharded,
            "pipeline": zero, "ft": zero}


def check_entry(card: str, calls: int = ENTRY_CALLS,
                device: str = "cuda") -> dict:
    """``graft_entry.entry()`` at "125m" on the card (or ``device``):
    ``calls`` timed forwards of its fn (CUDA events on the card, after one
    warm call), and its logits held against the same model with
    ``reference_attention``: the loss of the logits within ``LOSS_TOL`` and
    the logits within ``GRAD_REL_NORM`` (relative norm of the difference).
    Returns its flash launches."""
    import torch

    from torchft_tpu_torch.graft_entry import entry
    from torchft_tpu_torch.models import transformer
    from torchft_tpu_torch.ops import attention, flash

    fn, (params, tokens) = entry(device)
    before = dict(flash.LAUNCHES)
    with torch.no_grad():
        logits = fn(params, tokens)
        _, device_ms, wall_ms = timed_step(
            lambda _: [fn(params, tokens) for _ in range(calls)], None,
            device == "cuda")
        ms = (wall_ms if device_ms is None else device_ms) / calls
        launches = {k: flash.LAUNCHES[k] - before[k] for k in before}
        kernel_attention = transformer.causal_attention
        transformer.causal_attention = attention.reference_attention
        try:
            ref = fn(params, tokens)
        finally:
            transformer.causal_attention = kernel_attention
    if {k: flash.LAUNCHES[k] - before[k] for k in before} != launches:
        raise AssertionError("the reference model launched a flash kernel")
    tgt = torch.roll(tokens.long(), -1, dims=1)

    def ce(x):
        return float(torch.nn.functional.cross_entropy(
            x.reshape(-1, x.shape[-1]), tgt.reshape(-1)))

    loss, ref_loss = ce(logits), ce(ref)
    rel = float((logits.double() - ref.double()).norm()
                / ref.double().norm())
    log(f"  entry(): logits {tuple(logits.shape)} {logits.dtype}; loss "
        f"{loss:.6f} against {ref_loss:.6f} with reference_attention "
        f"(|diff| {abs(loss - ref_loss):.3e}, tolerance {LOSS_TOL}); "
        f"logits relative norm of the difference {rel:.3e} (tolerance "
        f"{GRAD_REL_NORM}); forward {ms:.3f} ms a call over {calls} calls "
        f"after a warm one ({card})")
    if not (abs(loss - ref_loss) <= LOSS_TOL and rel <= GRAD_REL_NORM
            and bool(torch.isfinite(logits).all())):
        raise AssertionError(f"entry()'s logits against reference_attention:"
                             f" loss {loss} vs {ref_loss}, relative {rel}")
    del params, logits, ref
    torch.cuda.empty_cache()
    return launches


def phase_dryrun_multichip(seed: int, card: str, n: int = DRYRUN_POSITIONS,
                           device: str = "cuda", devices=None) -> dict:
    """``dryrun_multichip(n)`` on a virtual mesh of the card (or
    ``device``), or position p on ``devices[p % len(devices)]``, each
    segment's flash launches against ``dryrun_launches`` (none off the
    card), then ``check_entry``. Returns the flash launches by head_dim."""
    from torchft_tpu_torch.graft_entry import dryrun_multichip
    from torchft_tpu_torch.models import CONFIGS

    t0 = time.perf_counter()
    result = (dryrun_multichip(n, device) if devices is None
              else dryrun_multichip(n, devices=devices))
    if devices is not None:
        from torchft_tpu_torch.ops import flash

        before = dict(flash.LAUNCHES)
        virtual = dryrun_multichip(n, device)
        flash.LAUNCHES.update(before)  # a comparison: its launches don't count
        same = all(result["segments"][k] == v for k, v in
                   virtual["segments"].items() if k != "ft")
        log(f"  over {len(set(devices))} cards / virtual on {device}, "
            "seconds: " + ", ".join(
                f"{k} {result['seconds'][k]:.2f} / {v:.2f}"
                for k, v in virtual["seconds"].items())
            + f"; figures but ft's equal: {'yes' if same else 'no'}")
    want = dryrun_launches(n)
    if device != "cuda":
        want = {k: dict.fromkeys(v, 0) for k, v in want.items()}
    for name, secs in result["seconds"].items():
        log(f"  segment {name}: {secs:.2f} s, flash launches "
            f"{result['launches'][name]} (want {want[name]}) "
            f"{ {k: v for k, v in result['segments'][name].items() if k not in ('commits',)} }")
        if result["launches"][name] != want[name]:
            raise AssertionError(f"segment {name}: flash launches "
                                 f"{result['launches'][name]}, want "
                                 f"{want[name]}")
    tiny = {k: sum(c[k] for c in result["launches"].values())
            for k in FLASH_KERNELS}
    entry_launches = check_entry(card, device=device)
    fwd = CONFIGS["125m"].n_layers * (ENTRY_CALLS + 1)
    if entry_launches != {"flash_fwd": fwd if device == "cuda" else 0,
                          "flash_bwd_dq": 0, "flash_bwd_dkv": 0}:
        raise AssertionError(f"entry()'s flash launches {entry_launches}")
    log(f"  phase {time.perf_counter() - t0:.1f} s ({card})")
    return {CONFIGS["tiny"].head_dim: tiny,
            CONFIGS["125m"].head_dim: entry_launches}


def _check_launches(counts, want, what: str) -> None:
    log(f"  kernel launches on the main path: {counts} (want {want})")
    if counts != want:
        raise AssertionError(f"kernel launches on the main path {counts}, "
                             f"want {want} ({what})")


PHASES = ("kernels", "train", "train_multijob", "train_sharded",
          "train_moe", "train_cuda_int8",
          "train_tiny", "gpt_1b", "train_llama_ring", "train_hsdp",
          "train_moe_expert", "train_pp", "pipeline_plane", "fused_step",
          "train_resnet", "serve_deploy", "train_diloco",
          "train_diloco_sharded", "train_localsgd_int8", "train_churn",
          "train_hier_int8", "train_proc", "dryrun_multichip",
          "train_durable")


def _add_launches(rows: dict, counts: dict, head_dim: int) -> None:
    """Add a main-path phase's launches to the kernels rows: a flash
    kernel's to its row and to its ``head_dim`` instantiation's."""
    for name, c in counts.items():
        if name not in rows:
            continue
        rows[name]["launches"] += c
        for row in rows[name].get("per_head_dim", ()):
            if row["head_dim"] == head_dim:
                row["launches"] += c


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--phases", default=",".join(PHASES),
                        help="comma list of " + ",".join(PHASES) +
                             " (device always runs)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--steps", type=int, default=3,
                        help="committed steps before and after the heal")
    parser.add_argument("--layers", type=int, default=None,
                        help="cut the 125m depth of the TCP drill (train) "
                             "to this many layers")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import torchft_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repo ({e})",
              file=sys.stderr)
        return 2
    # f32 products stay f32 (the reference's f32 lm-head and loss)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phases = set(args.phases.split(","))
    unknown = phases - set(PHASES)
    if unknown:
        print(f"chip_smoke: unknown phases {sorted(unknown)}", file=sys.stderr)
        return 2
    PHASE_STARTS[:] = [("device", time.perf_counter())]
    smi, ptxas = phase_device()
    from torchft_tpu_torch.models import CONFIGS, MOE_CONFIGS
    from torchft_tpu_torch.ops import flash, quant

    rows = {}
    cards = visible_cards()
    if "kernels" in phases:
        begin_phase("kernels")
        rows = phase_kernels(args.seed, ptxas)
        rows.update(phase_quant_kernels(args.seed))
        for name in ("quant_int8", "dequant_acc_int8"):
            rows[name]["ptxas"] = ptxas.get(name)
        for dev, times in check_other_cards(args.seed, cards).items():
            for name, ms in times.items():
                rows[name].setdefault("ms_by_card", {})[dev] = ms
    if "train" in phases:
        begin_phase("train")
        flash.reset_launch_counts()
        want, _ = phase_train("125m", args.steps, args.layers, args.seed, smi)
        counts = dict(flash.LAUNCHES)
        _check_launches(counts, {n: want for n in counts},
                        "one per layer per forward/backward pass")
        _add_launches(rows, counts, CONFIGS["125m"].head_dim)
        flash.reset_launch_counts()
        passes = commit_raise(args.seed, smi)
        counts = dict(flash.LAUNCHES)
        _check_launches(counts, {n: passes * CONFIGS["125m"].n_layers
                                 for n in counts},
                        "commit_raise: one per layer per forward/backward "
                        "pass")
        _add_launches(rows, counts, CONFIGS["125m"].head_dim)
    if "train_multijob" in phases:
        begin_phase("train_multijob")
        flash.reset_launch_counts()
        quant.reset_launch_counts()
        per_d, _ = phase_train_multijob(args.seed, smi)
        counts = {**flash.LAUNCHES, **quant.LAUNCHES}
        want = {n: sum(c[n] for c in per_d.values()) for n in flash.LAUNCHES}
        _check_launches(counts, {**want, **dict.fromkeys(quant.LAUNCHES, 0)},
                        "flash: one per layer per pass, the observer's "
                        "forward-only passes and the captures' warm-up "
                        "passes included; codec: none")
        for head_dim, c in per_d.items():
            _add_launches(rows, c, head_dim)
    if "train_sharded" in phases:
        begin_phase("train_sharded")
        flash.reset_launch_counts()
        quant.reset_launch_counts()
        want, codec = phase_train_sharded(args.seed, smi)
        counts = {**flash.LAUNCHES, **quant.LAUNCHES}
        _check_launches(counts, {**{n: want for n in flash.LAUNCHES},
                                 **{n: codec for n in quant.LAUNCHES}},
                        "flash: one per layer per pass; codec: 2 per DDP "
                        "bucket per allreduce in the A/B arms, 1 per "
                        "sharded reduce_scatter")
        _add_launches(rows, counts, CONFIGS["125m"].head_dim)
    if "train_moe" in phases:
        begin_phase("train_moe")
        flash.reset_launch_counts()
        passes, layers = phase_train_moe(args.seed, smi)
        counts = dict(flash.LAUNCHES)
        _check_launches(counts, {"flash_fwd": 2 * passes * layers,
                                 "flash_bwd_dq": passes * layers,
                                 "flash_bwd_dkv": passes * layers},
                        "remat: per layer per pass 2 forward (the "
                        "recompute), 1 dQ, 1 dK/dV")
        _add_launches(rows, counts, MOE_CONFIGS["moe-8x125m"].head_dim)
    if "train_cuda_int8" in phases:
        begin_phase("train_cuda_int8")
        groups = cycled(cards, 2)
        log("  " + layout_line(groups))
        flash.reset_launch_counts()
        quant.reset_launch_counts()
        want, result = phase_train(
            "125m", args.steps, None, args.seed, smi, comm_backend="cuda",
            comm_options=INT8_OPTIONS,
            devices=cards if len(cards) > 1 else None)
        counts = {**flash.LAUNCHES, **quant.LAUNCHES}
        # the fixed schedule has a peer on the wire in k + 1 + a steps
        # (all but the survivor's solo step); each of those reduces every
        # frozen DDP bucket once, with 2 launches of each codec kernel
        survivor = result["runs"][0]
        wire_steps = args.steps + 1 + (args.steps - 1)
        if survivor.wire_steps != wire_steps:
            raise AssertionError(f"{survivor.wire_steps} steps with a wire "
                                 f"peer, the schedule has {wire_steps}")
        per_op = codec_launches(2, groups)
        per_kernel = per_op * len(survivor.buckets) * wire_steps
        log(f"  {len(survivor.buckets)} gradient buckets x {wire_steps} steps "
            f"with a peer x {per_op} launches = {per_kernel} of each codec "
            "kernel")
        _check_launches(counts, {**{n: want for n in flash.LAUNCHES},
                                 **{n: per_kernel for n in quant.LAUNCHES}},
                        "flash: one per layer per pass; codec: 2 per bucket "
                        "per allreduce with a peer on one card, world + "
                        "cards over several")
        _add_launches(rows, counts, CONFIGS["125m"].head_dim)
        check_plane_at_buckets(survivor.buckets, args.seed, groups)
        if len(cards) > 1:
            log("  the same drill on cuda:0 alone, beside the run over the "
                "cards")
            phase_train("125m", args.steps, None, args.seed, smi,
                        comm_backend="cuda", comm_options=INT8_OPTIONS)
    if "train_tiny" in phases:
        begin_phase("train_tiny")
        flash.reset_launch_counts()
        want, _ = phase_train("tiny", args.steps, None, args.seed, smi)
        counts = dict(flash.LAUNCHES)
        _check_launches(counts, {n: want for n in counts},
                        "one per layer per forward/backward pass")
        _add_launches(rows, counts, CONFIGS["tiny"].head_dim)
    if "gpt_1b" in phases:
        begin_phase("gpt_1b")
        flash.reset_launch_counts()
        counts, layers = phase_gpt_1b(args.seed)
        # activation checkpointing runs each block's forward again in the
        # backward: two forward launches per layer, one of each backward
        _check_launches(counts, {"flash_fwd": 2 * layers,
                                 "flash_bwd_dq": layers,
                                 "flash_bwd_dkv": layers},
                        "1b, remat: 2 forward, 1 dQ, 1 dK/dV per layer")
        _add_launches(rows, counts, CONFIGS["1b"].head_dim)
    if "train_llama_ring" in phases:
        begin_phase("train_llama_ring")
        counts, want, head_dim = phase_train_llama_ring(args.seed, smi)
        _check_launches(counts, want,
                        "flash: per layer per pass the causal ring of "
                        f"{LLAMA_RING_SHARDS} shards, its pairs that run "
                        "once each backward and twice forward (remat); "
                        "codec: none")
        _add_launches(rows, counts, head_dim)
    if "train_hsdp" in phases:
        begin_phase("train_hsdp")
        counts, want, head_dim = phase_train_hsdp(args.seed, smi)
        _check_launches(counts, want,
                        "flash: per layer per pass one attention per mesh "
                        "position, the forward twice (remat); codec: none")
        _add_launches(rows, counts, head_dim)
    if "train_moe_expert" in phases:
        begin_phase("train_moe_expert")
        counts, want, head_dim = phase_train_moe_expert(args.seed, smi)
        _check_launches(counts, want,
                        "flash: per layer per pass one attention per mesh "
                        "position (the batch over data x expert), the "
                        "forward twice (remat); codec: none")
        _add_launches(rows, counts, head_dim)
    if "train_pp" in phases:
        begin_phase("train_pp")
        counts, want, head_dim = phase_train_pp(
            args.seed, smi, times=flash_times_at(
                rows, pp_attention_shape(pp_config())))
        _check_launches(counts, want,
                        "flash: per pass every microbatch through every "
                        "layer, once forward and once each backward; "
                        "codec: none")
        _add_launches(rows, counts, head_dim)
    if "pipeline_plane" in phases:
        begin_phase("pipeline_plane")
        flash.reset_launch_counts()
        quant.reset_launch_counts()
        phase_pipeline_plane(args.seed, smi)
        counts = {**flash.LAUNCHES, **quant.LAUNCHES}
        _check_launches(counts, dict.fromkeys(counts, 0),
                        "the plane's stage compute is an f32 MLP of "
                        "torch.matmul, as the reference's is numpy; its "
                        "int8 stage wire is the host codec in both")
    if "fused_step" in phases:
        begin_phase("fused_step")
        positions = cycled(cards, FUSED_MESH[0] * FUSED_MESH[1])
        log("  " + layout_line(positions))
        counts, want, head_dim = phase_fused_step(
            args.seed, smi, devices=positions if len(cards) > 1 else None)
        _check_launches(counts, want,
                        "flash: per run of the grad stage (a replay, or the "
                        "warm-up before a capture) one GPT pass per mesh "
                        "position; codec: per run of the int8 exchange one "
                        "quant_int8 and two dequant_acc_int8 a card")
        _add_launches(rows, counts, head_dim)
    if "train_resnet" in phases:
        begin_phase("train_resnet")
        flash.reset_launch_counts()
        quant.reset_launch_counts()
        phase_train_resnet(args.seed, smi)
        counts = {**flash.LAUNCHES, **quant.LAUNCHES}
        _check_launches(counts, dict.fromkeys(counts, 0),
                        "ResNet-18 has no attention and codec none: its "
                        "convolutions are library calls, as the "
                        "reference's are XLA's")
    if "serve_deploy" in phases:
        begin_phase("serve_deploy")
        counts, want, head_dim = phase_serve_deploy(args.seed, smi)
        _check_launches(counts, want,
                        "flash: one per layer per pass of the trainer, "
                        "graph replays and capture warm-ups included; the "
                        "serving cohort launches none; codec: none")
        _add_launches(rows, counts, head_dim)
    if "train_diloco" in phases:
        begin_phase("train_diloco")
        flash.reset_launch_counts()
        want, _ = phase_train_diloco(args.seed, smi)
        counts = dict(flash.LAUNCHES)
        _check_launches(counts, {n: want for n in counts},
                        "one per layer per pass, graph replays and capture "
                        "warm-ups included")
        _add_launches(rows, counts, CONFIGS["125m"].head_dim)
    if "train_diloco_sharded" in phases:
        begin_phase("train_diloco_sharded")
        check_comm_child(smi)
        flash.reset_launch_counts()
        want, _ = phase_train_diloco_sharded(args.seed, smi)
        counts = dict(flash.LAUNCHES)
        _check_launches(counts, {n: want for n in counts},
                        "one per layer per pass of both arms, graph replays "
                        "and capture warm-ups included")
        _add_launches(rows, counts, CONFIGS["125m"].head_dim)
    if "train_localsgd_int8" in phases:
        begin_phase("train_localsgd_int8")
        log("  " + layout_line(cycled(cards, LOCALSGD_GROUPS)))
        flash.reset_launch_counts()
        quant.reset_launch_counts()
        want, codec, _ = phase_train_localsgd_int8(
            args.seed, smi, devices=cards if len(cards) > 1 else None)
        counts = {**flash.LAUNCHES, **quant.LAUNCHES}
        _check_launches(counts, {**{n: want for n in flash.LAUNCHES},
                                 **{n: codec for n in quant.LAUNCHES}},
                        "flash: one per layer per pass; codec: per "
                        "fragment op with a peer 2 on one card, world + "
                        "cards over several")
        _add_launches(rows, counts, CONFIGS["125m"].head_dim)
    if "train_churn" in phases:
        begin_phase("train_churn")
        log("  " + layout_line(cycled(cards, 5)))
        flash.reset_launch_counts()
        quant.reset_launch_counts()
        want, _, _ = phase_train_churn(
            args.seed, smi, devices=cards if len(cards) > 1 else None)
        counts = {**flash.LAUNCHES, **quant.LAUNCHES}
        _check_launches(counts, want,
                        "flash: one per layer per pass of every life of "
                        "both arms; codec: per bucket op of arm (b) with a "
                        "peer 2 on one card, world + cards over several")
        _add_launches(rows, counts, CONFIGS["125m"].head_dim)
    if "train_hier_int8" in phases:
        begin_phase("train_hier_int8")
        flash.reset_launch_counts()
        quant.reset_launch_counts()
        want, codec, _ = phase_train_hier_int8(args.seed, smi)
        counts = {**flash.LAUNCHES, **quant.LAUNCHES}
        _check_launches(counts, {**{n: want for n in flash.LAUNCHES},
                                 **{n: codec for n in quant.LAUNCHES}},
                        "flash: one per layer per pass; codec: the card "
                        "plane's hier arms at each distinct bucket size")
        _add_launches(rows, counts, CONFIGS["125m"].head_dim)
    if "train_proc" in phases:
        begin_phase("train_proc")
        flash.reset_launch_counts()
        quant.reset_launch_counts()
        counts, want, head_dim = phase_train_proc(args.seed, smi)
        parent = {**flash.LAUNCHES, **quant.LAUNCHES}
        _check_launches(parent, dict.fromkeys(parent, 0),
                        "this process drives the groups and launches none")
        _check_launches(counts, want,
                        "flash, counted in each child and posted with its "
                        "commits: one per layer per pass of every life, the "
                        "survivor's capture warm-ups included")
        _add_launches(rows, counts, head_dim)
    if "dryrun_multichip" in phases:
        begin_phase("dryrun_multichip")
        log("  " + layout_line(cycled(cards, DRYRUN_POSITIONS)))
        flash.reset_launch_counts()
        quant.reset_launch_counts()
        per_d = phase_dryrun_multichip(
            args.seed, smi, devices=cards if len(cards) > 1 else None)
        counts = {**flash.LAUNCHES, **quant.LAUNCHES}
        want = {n: sum(c[n] for c in per_d.values()) for n in flash.LAUNCHES}
        _check_launches(counts, {**want, **dict.fromkeys(quant.LAUNCHES, 0)},
                        "flash: each segment's, and entry()'s forwards; "
                        "codec: none")
        for head_dim, c in per_d.items():
            _add_launches(rows, c, head_dim)
    if "train_durable" in phases:
        begin_phase("train_durable")
        flash.reset_launch_counts()
        want, _ = phase_train_durable(args.seed, smi)
        counts = dict(flash.LAUNCHES)
        _check_launches(counts, {n: want for n in counts},
                        "one per layer per pass, graph replays included")
        _add_launches(rows, counts, CONFIGS["125m"].head_dim)
        fused_vs_classic(args.seed, smi)
    log("phase seconds, each from its start to the next's: " + json.dumps(
        phase_seconds(PHASE_STARTS, time.perf_counter())) + f" ({smi})")
    if rows:
        print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
