"""Drive the PyTorch port's main path on one CUDA card and check it.

Run from the repository root:  python3 chip_smoke.py
(no arguments: every database is at its full size, ``*_SCALE`` below).

Phases (any failure exits non-zero before the last line is printed):

1. device   — a CUDA card is required; prints its name, count, versions and
              ``nvidia-smi`` name / power limit.
2. build    — compiles the CUDA kernels from ``src/repro_torch/kernels/csrc``
              and prints the build time and ``ptxas`` register, shared
              memory and spill lines; fails if K6's Hopper and mma.sync
              kernels, K2's two kernels, K1's four, K4's or K3's two spill
              (``NO_SPILL_KERNELS``), or if K4's branch-free division or
              frexp gives other bits than the correctly rounded operation
              anywhere in its domain (``bdeu.check_division``, exhaustive).
3. main     — HYBRID model discovery over the sparse executor on the IMDb
              stand-in at full size (1.06M rows, 3 relationships), counting
              every kernel launch; its wall time and peak memory are read on
              this run alone.  The IMDb run is made once more under
              ``torch.profiler``: device busy time against wall time, and
              the kernels that took most of it, and K1's, K2's, K4's and
              the id kernel's device time by kernel name.  Then HYBRID
              pre-counting alone on the VisualGenome stand-in (15.8M rows,
              8 relationships, chains of 3, which take the dense-message
              hop), and once more keeping K2's largest call and its
              largest in the direct regime (the dense-message hop), each
              held bit for bit against its plain version and timed, and
              the id kernel's (``ops.hop_ids``: the sparse executor's
              segment ids, dense gather indices and entity codes) largest
              leaf, dense and root calls, each held bit for bit against
              its plain version (``segsum.hop_ids_plain``) and timed
              beside its bound (``ids_reading``).  Checks that each kernel
              of the main path was launched (``MAIN_PATH_KERNELS``: K1-K4
              and the id kernel), that K2 took both regimes (launch counts
              by regime printed), and that every single-relation positive
              table sums to its relation's edge count.
4. kernels  — the IMDb run once more, keeping a copy of the inputs of each
              kernel's largest call (the id kernel's of each kind too: its
              row is VisualGenome's largest leaf call, with phase 3's other
              calls and IMDb's beside it); each kernel against its plain
              PyTorch version on those inputs: exact for the
              segment sums, the Möbius transform and BDeu (BDeu is
              bit-reproducible by design; the ``rtol=1e-4, atol=1e-2``
              tolerance is the JAX reference's and is checked too).  Times
              the kernel, the plain version and one PyTorch library call of
              the same function where there is one, beside the least time
              the card could take (bytes over 3.35 TB/s, float32 operations
              over 67 TFLOP/s: NVIDIA H100 SXM data sheet), each twice: CUDA
              events around back-to-back calls (``ms``, which also counts
              host launch gaps) and device time under ``torch.profiler``
              (``device_ms``, the calls' own device events over the reps).
              K2 is also checked and timed in its other regime where the
              wrapper chose the privatised one; K1 at its largest call and
              at its largest privatised one (an entity histogram), each
              also in its other plans (``ones_alternatives``: the direct
              regime sliced and not, the privatised one where P allows
              it), its device time split by event (the zeroing apart from
              the scatter); K4 also
              at ``K4_SCALING``, where its lgammas bind; K3 also at
              ``K3_SCALING``, where its bytes bind (bit for bit on counts
              above 2^24, its device time beside the bound and
              ``matmul(T, X)``'s).
5. parity   — model discovery on the full UW stand-in, HYBRID and
              ONDEMAND over sparse and over dense, on the card and on the
              CPU: edge-identical.  ONDEMAND's prefetch runs the batched
              positive path (``Executor.positive_batch``), so this is where
              the dense executor's stacked groups run on the card; the
              stacked groups are counted and must be some.
6. hist     — K5's path: the weighted segment histogram at the three
              shapes of ``benchmarks/bench_kernels.py``'s ``bench_hist``,
              counting launches; each against its plain version
              (``rtol=1e-5, atol=1e-3``: float sums whose atomics land in
              any order), the largest timed against ``index_add_`` (CUDA
              events and device time).
7. k6-edges — K6 against its plain version in bf16 (``K6_BF16_TOL``) on a
              grid of small shapes that reach every edge of its tiles:
              ``Sq = Skv`` in ``K6_EDGE_LENGTHS``, causal and not, and
              ``Sq != Skv`` (``K6_EDGE_RAGGED``, not causal); 16 query
              heads over 1, 2 or 16 KV heads; batch 1 and 3; hd 128 (the
              Hopper kernel), 64, 192 and 256 (the mma.sync kernel) and 160
              (the CUDA-core kernel); and the same in float32
              (``K6_F32_TOL``) at hd 160, 192, 256 and 512 (the CUDA-core
              kernel's widest); and at hd 576, 640 and 1,024
              (``K6_EDGE_SLICED_HDS``, the sliced CUDA-core kernel, which
              streams the head dim) in bf16 and float32.  One line per
              shape: the shape, the kernel the C entry chose,
              max_abs_err.  K6's row in the kernels line keeps each
              kernel's largest error apart (``max_abs_err_by_route``,
              float32's under its own key).  Then the sliced kernel is
              timed at ``K6_SLICED_SHAPE`` beside SDPA and its bound (the
              ``sliced`` entry of K6's row).
8. lm       — Qwen2.5-3B serving at its published full size (36 layers,
              d_model 2048, 16/2 heads, vocab 151,936, bf16; random weights
              from generator seed 0).  (c) prefill/decode consistency at
              full width and depth on 2 x 256 tokens; (a) the main run:
              prefill of 4 x 4,096 tokens, then 32 greedy decode steps into
              a 4,128-token cache, and one prefill of 1 x 32,768 tokens
              (``prefill_32k``'s length, its batch cut from 32 to 1), K6
              launched exactly once per layer of each prefill; four
              decode steps and the main prefill once more under
              ``torch.profiler``; (b) K6 against
              its plain version on layer 0's q, k, v of the main prefill,
              in bf16 and in float32, and of the long prefill in bf16;
              timed at both shapes against PyTorch's
              ``scaled_dot_product_attention`` (CUDA events and device
              time), with K6's share of each prefill (launches x ms /
              wall).
9. k2-edges — K2 bit for bit against its plain version on a grid of shapes
              that reaches both regimes and every edge: ``D`` in
              ``K2_EDGE_WIDTHS``, ``P`` in ``K2_EDGE_SEGMENTS`` and the
              privatisation limit and either side of it, ``E`` in
              ``K2_EDGE_EDGES``; ids -1 and P mixed in, a non-zero ``out``
              to add into, fresh inputs and 4-byte-offset views, and the
              direct regime too where the wrapper chose the privatised one.
              One line per shape with the regime chosen; the phase's
              seconds.
10. k1k4-edges — K4 bit for bit against its plain version on a grid of
              shapes (``K4_EDGE_*``: q either side of a warp, of its 256
              lanes and past one chunk, r up to a chunk too wide for 256
              rows, 1, 9 and 200 families, ess 1 and 10) mixing all-zero
              families, counts of a few, counts above 2^20 and counts
              above 2^100 (lgamma's slow path); and K1
              exactly against its plain version on its grid (``K1_EDGE_*``,
              P at the privatisation limit and either side of it), ids -1
              and P mixed in, weights 0 to 3, fresh and 4-byte-offset
              inputs, through the wrapper and in each of K1's other plans
              (``ones_alternatives``).  One
              line per shape (K1's with the regime chosen); the phase's
              seconds.
11. nemotron — Nemotron-4-340B serving at its published width (d_model
              18,432, 96/8 heads, hd 192, d_ff 73,728 squared-ReLU, vocab
              256,000, bf16; random weights from generator seed 0), its 96
              layers cut to ``NEMOTRON_LAYERS`` = 4 so that one card holds
              them: prefill/decode consistency as in phase 8 (c), a prefill
              of 2 x 4,096 tokens with K6 launched once per layer on the
              mma.sync route, 16 greedy decode steps (prefill tokens/s,
              decode ms a step, peak memory); K6 against its plain version
              on layer 0's q, k, v, timed against SDPA and its bound (the
              ``nemotron`` entry of K6's kernels-line row).
12. strategies — the paper's three strategies on the card, over the sparse
              executor on the IMDb stand-in at ``IMDB_SCALE`` with phase
              3's chains and parents: ONDEMAND (post-counting: every
              family's positives contracted from the data through the
              batched positive path), PRECOUNT, and HYBRID under
              ``cache_budget_bytes`` = ``TIGHT_BUDGET`` (64 KiB), so that
              evicted tables re-contract through ``positive_batch``; phase
              3's HYBRID is the fourth.  Each run: wall (host clock ending
              in ``torch.cuda.synchronize()``), the Fig. 3 split, joins,
              rows scanned, peak device memory, launches by kernel and by
              K1/K2 regime, ``positive_batch`` calls, plans, stack groups
              (those of two or more plans are stacked) and the largest;
              every kernel of the run's path launched (all four, but no
              Möbius transform in PRECOUNT, whose complete tables keep
              edge-attribute axes: a blockwise negative phase), no plain
              version; ONDEMAND's and HYBRID's models edge-identical to
              phase 3's (the same operations on the same tables).
              PRECOUNT's tables are projections of complete tables whose
              counts pass 2^24, which float32 cannot hold exactly, so
              each family its search scored is held to HYBRID's: the same
              axes in the same order, every cell below 2^24 bit for bit,
              every cell past it within ``ROUNDING_PAST_2_24``; the same
              families from a negative phase that subtracts no positive
              count (a planted fault) must differ from HYBRID's past 2^24
              by more than that bound; and PRECOUNT run on the CPU over
              the same database must learn the card's models, with those
              families' tables equal bit for bit.  Its models may differ
              from HYBRID's only at points where a family's cells past
              2^24 rounded differently (``precount_tables``, printed with
              both readings).  Then the
              ONDEMAND run's ``positive_batch`` plan lists are replayed
              through ``positive_batch`` and through ``positive`` one plan
              at a time: the tables bit for bit equal, every stacked
              group with fewer K1/K2 launches than its plans one at a
              time; K1/K2 launches, wall and device time of each
              replay.  The runs' launches and the replay are the
              ``strategies`` entries of K1's and K2's kernels-line rows.

13. mutations — writes and delta count maintenance on the card.  (a) The
              IMDb stand-in at ``IMDB_SCALE``: HYBRID and ONDEMAND
              (``MUTATION_STRATEGIES``) warmed by discovery on copies of
              the store (phases 3 and 12 keep theirs), then each write of
              ``IMDB_WRITES`` (drawn from a generator seeded
              ``MUTATION_SEED``) applied and reconciled with
              ``strategy.apply_delta``: the ``DeltaReport``, the
              reconciliation's wall (host clock ending in
              ``torch.cuda.synchronize()``) and K1/K2/K3 launches (K1 and
              K2 by regime), no plain version; the first write must update
              HYBRID in place through K1 or K2 and K3, both small fact
              deltas must invalidate nothing, the large delete must update
              nothing.  A third HYBRID copy takes every write under
              ``torch.profiler`` (device busy time).  (b) After each write
              every resident ``"pos"``/``"full"``/``"fam"``/``"complete"``
              entry against a fresh strategy's recount on the mutated
              store (``recount_entries``): cells below 2^24 bit for bit,
              past it within ``ROUNDING_PAST_2_24``; a fourth copy takes
              the first write reconciled with its sign flipped (a planted
              fault), which must differ below 2^24.  (c) After each write
              the search (``StructureSearch``) on the reconciled strategy,
              launching K4, against ``discover_model`` on a fresh one: edge
              for edge but at points where a family's cells past 2^24
              differ or that inherit a differing sub-point's edges
              (printed with the edges each side alone has); both walls.  (d) UW at
              ``UW_SCALE``, all four strategies over both executors, card
              and CPU taking the same interleaving (``UW_WRITES``): equal
              reports and every resident entry bit for bit.  The phase's
              launches are the ``mutations`` entries of K1's, K2's and
              K3's kernels-line rows (K4's: the rediscoveries').
14. served  — model discovery served on the card through
              ``repro_torch.serve.CountingService`` (its dispatcher thread
              started, deadline ``SERVED_MAX_WAIT_S``) and
              ``repro_torch.discover.DiscoveryService``, on copies of the
              IMDb stand-in at ``IMDB_SCALE``.  (a) One client, traced
              (``Tracer``): wall (host clock ending in
              ``torch.cuda.synchronize()``), the service's stats (requests,
              coalesced, cache hits, batches, bucket sizes, queue-wait,
              bucket and end-to-end p50/p95/p99), K1-K4 launches (K1 and K2
              by regime; each at least once, no plain version); models edge
              for edge phase 3's HYBRID models but at points where a scored
              family's cells past 2^24 differ (printed with both readings);
              the host span breakdown by name (seconds and counts), every
              ``service.exec`` span under a ``service.queue`` span
              (``build_trees``), the threads that ran the batches; then an
              untraced copy's wall and a profiled copy's device busy time.
              (b) ``SERVED_CLIENTS`` threads call ``discover()`` at once on a
              fresh service, cold and then warm: one signature and version,
              (a)'s, and some queries coalesced.  (c) The first of
              ``IMDB_WRITES`` through ``svc.insert_facts`` and
              ``refresh("imdb_R0")``: some families retained, fewer
              rescored than known; models against a fresh relearn of the
              mutated store as in (a); every family score of the refreshed
              memo equal bit for bit to K4 on the family's table as the
              service now holds it (a score carried forward stale differs),
              and against the relearn's scores bit for bit where the table
              stays below 2^24, past it within the discovery tests'
              tolerance plus ``4 eps M`` (``refresh_check``); (b)'s service
              refreshed after the same write naming ``imdb_R1`` (a planted
              fault) must fail that check; refresh and relearn walls.  Then a
              writer thread makes the fenced inserts of ``SERVED_WRITES``
              while ``SERVED_SEARCHERS`` threads run ``discover()``: their
              final results carry one version and one signature, a fresh
              relearn's of the final store.  (d) UW at ``UW_SCALE``: served
              discovery and a refresh after the first of ``UW_WRITES`` on
              the card and on the CPU, signatures, scores and refresh
              counts equal bit for bit; the card's served signature equals
              a local ``DiscoveryService`` over HYBRID.  The phase's launches
              are the ``served`` entries of K1-K4's kernels-line rows.
15. sharded — the IMDb stand-in at ``IMDB_SCALE`` hash-partitioned into
              ``SHARDS`` shards (``shard_database``) behind
              ``repro_torch.serve.CountingRouter`` (one counting service per
              shard, all on the card).  (a) ``complete_many`` over every
              lattice point's complete table, over its entity attributes
              and indicators (the butterfly, K3) and over every axis (the
              blockwise negative phase): each table against the single
              database's service on the card, below 2^24 bit for bit and
              past it within ``ROUNDING_PAST_2_24``; every merged positive
              table in the router's cache against the single database's
              contraction, bit for bit while its largest cell (printed)
              stays below 2^24; the router's counters, its fused flush
              groups and the flushes that fell back to the shard services.
              (b) Router discovery (``router.discovery().discover()``) on
              fresh routers, untraced, traced (``Tracer``: the host spans
              by name) and under ``torch.profiler`` (device busy share,
              host-to-device copies, top kernels): each learns phase 14's
              one-client served models and score exactly.  (c)
              ``SHARDED_WRITES`` (4,000 edges into partitioned
              ``imdb_R0``, 1,000 into shared ``imdb_R2``) through
              ``router.insert_facts``, then ``refresh``: the refreshed
              models and score those of a fresh router's discovery of the
              written store, the scores through ``refresh_check``; the
              write check (``write_check``: every partitioned edge on its
              own shard, every resident shard entry equal to a recount of
              its shard's store, the router's complete tables equal to
              the single written database's); a planted fault (the
              partitioned insert routed one shard over) must fail its
              merged tables.  (d) (a)'s router splits its shard with the
              most partitioned rows (``rebalance``): (a)'s tables again,
              bit for bit, and the untouched shards keep every cache entry
              (the same table objects: nothing counted again).  (e) A
              ``TenantRegistry`` (sparse, on the card) of IMDb seeds 0 and
              1 at ``IMDB_SCALE`` (one shape, so their plans stack), UW and
              UW in ``TENANT_UW_SHARDS`` shards: ``count_many`` across the
              tenants launches fewer K1+K2 kernels than the tenants served
              one after another, each table bit for bit its own service's
              (or router's) alone; under a tight global budget the reserved
              tenant keeps its floor while its neighbour floods.  (f) UW:
              a router and a registry on the card against the same on the
              CPU, tables and models bit for bit.  Every step's K1-K4
              launches (no plain version) are the ``sharded`` entries of
              K1-K4's kernels-line rows.
16. mesh    — mesh sharding (``repro_torch.core.distributed``) with ranks
              that share the card: this process is rank 0 (the
              controller), workers are spawned on the same card and meet
              it at a ``FileStore`` under gloo (NCCL refuses two ranks on
              one device).  At the first of ``MESH_WORLDS``: (a) every
              IMDb lattice point's positive table (chains <= 2, every
              attribute) through ``sharded_sparse_positive_ct`` and
              ``sharded_positive_ct`` on meshes (2,1) and (1,2), each the
              single device's bit for bit, and ``superset_mobius_sharded``
              over ``model`` against K3 alone; (b) HYBRID discovery over
              ``ShardedSparseExecutor`` (untraced, then under
              ``torch.profiler``: device busy time on rank 0) learning
              phase 3's models and score exactly, with its sharded steps,
              bytes scattered and reduced, and K1-K4 launches on every rank
              (``rank_counts``: no plain version anywhere); (c) the first
              of ``IMDB_WRITES`` on (b)'s warm cache, reconciled with no
              sharded step (``local_mode``), against a recount
              (``recount_entries``); (d) ``CountingRouter`` over
              ``SHARDS`` shards with ``executor="sparse_sharded"``: phase
              15 (a)'s complete tables bit for bit; (e) VisualGenome:
              every chain-3 point that carries the largest dense-message
              hop, each the single device's table (computed before the
              counts are reset, so (e)'s launches are the mesh path's).
              Then (b) at the other worlds; (f) NCCL at world 1 (one rank:
              the single-device steps, no sharded step); (g) the launcher
              under ``torch.distributed.run`` (``repro_torch.launch
              .discover`` on UW, ``MESH_LAUNCH``), its per-point scores and
              edge counts those of one device.  Walls are printed beside
              the card's name and power limit; no speed-up is claimed
              (every rank shares one card).  K1-K4 launches by step and
              by rank are the ``mesh`` entries of K1-K4's kernels-line
              rows.

17. train   — the LM's training path.  (a) K6 under autograd
              (``ops.FlashAttention``) at Qwen2.5-3B's layer-0 shape
              (``TRAIN_K6_SHAPE``), bf16 and float32: the forward against
              its plain version, ``dq``, ``dk``, ``dv`` against autograd
              through the plain version in float32 (``K6_GRAD_TOL``); the
              forward, the backward and both timed (CUDA events and device
              time) beside SDPA's forward plus backward and the bound of
              the backward's work; (b) ``rms_norm``'s hand-written VJP
              against autograd of the naive expression; (c) the reduced
              qwen2.5-3b in float32, loss and every gradient on the card
              against the CPU; (d) Qwen2.5-3B at full size (36 layers,
              random weights from seed 0) trained ``TRAIN_STEPS`` AdamW
              steps at batch 4 x 2,048 with ``microbatch=2`` through the
              launcher (``repro_torch.launch.train``) on
              ``SyntheticCorpus``: finite losses whose last three average
              below the first, K6 launched ``2 x 36 x 2`` times a step (the
              forward and each layer's remat), no plain attention; step
              seconds, tokens/s and peak memory; the state saved and
              restored bit for bit; one more step under ``torch.profiler``
              (device busy share, top kernels, K6's share and the attention
              backward's).  The ``training`` entry of K6's kernels-line row.
18. train-mesh — multi-rank training and the sequence-sharded decode
              (``repro_torch.train.sharding``), ranks spawned on the card
              sharing it under gloo (every collective through pinned host
              buffers).  (a) K6 with ``q_offset`` against its plain
              version on every route (``MESH_K6_ROUTES``: hd 128 wgmma;
              64, 192, 256 mma.sync; 160 CUDA cores; 1,024 sliced; float32
              at 160 and 1,024), offsets 0, one query tile and a
              non-multiple of it, bf16 within ``K6_BF16_TOL`` and float32
              within ``K6_F32_TOL``; timed at ``MESH_K6_SHAPE`` beside SDPA
              with an explicit mask and the bound.  Then, once (b)-(d)
              have run, K6 against its plain version at every shape the
              ranks of (b)-(d) gave it (each rank records the shapes,
              dtypes and offsets of its launches; its local heads in (c)
              and (d), each rank's query rows and real offset on (b)'s
              sequence route).  (b) Float32 parity: the
              reduced qwen2.5-3b, 3 AdamW steps over 4 ranks on (2, 2) and
              2 ranks on (1, 2) against one rank in this process (losses
              within ``MESH_LOSS_RTOL``, parameters within
              ``MESH_PARAM_ATOL``), one step of a 3-head variant on (1, 2)
              (the sequence-parallel route: K6 with ``q_offset`` under
              autograd), and the (2, 2) state saved and restored on (1, 2)
              bit for bit.  (c) Qwen2.5-3B at full width and depth over 2
              ranks on (1, 2) through the launcher: phase 17's batch,
              ``MESH_TRAIN_STEPS`` steps, the first loss within
              ``MESH_FIRST_LOSS_RTOL`` of
              phase 17's; step seconds, tokens/s, each rank's peak memory,
              bytes staged and collective seconds a step, K6 launched 144
              times a step on each rank (8 local heads); one more step
              profiled on rank 0.  (d) Qwen2.5-3B prefill and
              ``MESH_DECODE_NEW`` decode steps with the cache's sequence
              axis over ``model``: logits against one rank's within
              ``LM_DECODE_TOL`` of the largest, decode step times; and
              the reduced qwen2.5-3b in float32 (``MESH_DECODE_F32``)
              against one rank within ``MESH_DECODE_F32_TOL``, the CPU
              test's tolerance, which a wrong combine of the ranks'
              partials exceeds where bf16's does not.  The
              ``mesh_training`` entry of K6's kernels-line row.
19. moe      — mixture-of-experts (``repro_torch.models.moe``,
              ``train.monitor``).  (a) Qwen3-30B-A3B served whole (48
              layers, d_model 2,048, 32/4 heads, 128 experts top-8, bf16,
              random weights from generator seed 0; no depth cut):
              prefill of ``MOE_BATCH`` x ``MOE_PROMPT`` tokens, then
              ``MOE_NEW`` greedy decode steps into a 4,128 cache; the
              weights' bytes, peak memory, prefill tokens/s and decode ms
              a step beside the bound of streaming every expert's weights
              once (the capacity buffer at S = 1 holds a slot for each of
              the 128 experts); four decode steps and the prefill once
              more under ``torch.profiler``; K6 launched 48 times a
              prefill, no plain attention; K6 against its plain version
              on layer 0's q, k, v (``K6_BF16_TOL``), timed beside SDPA
              and its bound.  (e) The routing monitor on (a)'s model and
              prompts: ``routing_trace`` of the 16,384 tokens, equal at
              layers ``MOE_MONITOR_LAYERS`` to the routing ``moe_apply``
              used in a prefill of them; ``routing_ct`` of each on the
              card (K1, K2 and K3 launched, no plain version), its
              complete table equal bit for bit to a direct count.  (b)
              The reduced qwen3-moe and arctic (a dense MLP beside the
              experts) in float32, card against CPU: loss, aux, every
              gradient (phase 17 (c)'s tolerances), each layer's routing
              equal; prefill and 16 decode steps against ``forward`` at
              lossless capacity (``MOE_CONSISTENCY_TOL``).  (c) Training
              at full width, the depth cut to ``MOE_TRAIN_LAYERS``
              (registered as ``MOE_TRAIN_ARCH``) through the launcher:
              phase 17's batch,
              ``MOE_TRAIN_STEPS`` steps, finite losses whose last three
              average below the first, K6 16 launches and 8 backwards a
              step; one more step profiled, with its aux.  (d) (c)'s
              model over 2 ranks sharing the card (mesh (1, 2), 64
              experts a rank, the ``ep`` body), ``MOE_MESH_STEPS`` steps:
              the first loss within ``MOE_MESH_FIRST_RTOL`` of (c)'s,
              collectives, bytes staged and peak memory by rank; and the
              reduced qwen3-moe in float32, 3 steps, against one rank.
              K6 against its plain version at every signature that
              (a)-(d) launched it with, here and on the ranks.  The
              ``moe`` entry of K6's kernels-line row; K1-K3's rows gain
              ``moe_monitor``.
20. subq    — the sub-quadratic blocks at their published full sizes,
              random weights from generator seed 0: (a) RWKV6-1.6B (24
              layers, d_model 2,048, 32 heads of 64, no attention) and
              (b) Hymba-1.5B (32 layers, d_model 1,600, 25/5 attention
              heads of 64 beside 25 SSM heads): parameters and bytes,
              phase 8's prefill/decode consistency on 2 x 256 held in
              float32 at full size (in bf16 a reading: the chunk length
              changes with S, and the reference's own bf16 models part
              by several % at depth), prefill 4
              x 4,096 and 32 greedy decode steps at batch 4 (s,
              tokens/s, ms a step beside the bound of reading the
              weights once, peak memory), each profiled (busy share, top
              kernels, device events a decode step); RWKV also one 1 x
              32,768 prefill (no KV cache: its peak memory beside the
              main run's); Hymba's prefill launches K6 32 times and no
              plain attention, and K6 is held to its plain version on
              layer 0's q, k, v (B 4, S 4,096, 25/5 heads, hd 64, bf16,
              ``K6_BF16_TOL``), timed beside SDPA and its bound.  (c) The
              reduced configs in float32, card against CPU: logits, loss,
              every gradient; prefill and 16 decode steps against
              ``forward`` (``SUBQ_PARITY_TOL``).  (d) RWKV6-1.6B trained
              at full size through the launcher: phase 17's batch,
              ``SUBQ_TRAIN_STEPS`` steps, finite losses whose last three
              average below the first, no K6; one more step profiled.
              (e) Float32 parity over 2 ranks sharing the card (mesh (1,
              2), gloo) against one rank: the reduced RWKV and Hymba and
              a Hymba of 5 heads (``SUBQ_MESH_VARIANTS``; its SSM on the
              chunks route, its attention on the sequence route, K6 with
              ``q_offset``), the init's constants perturbed, 2 AdamW
              steps of 4 x 256: losses within ``MESH_LOSS_RTOL``,
              parameters within ``SUBQ_MESH_PARAM_ATOL``.  (f) RWKV6-1.6B
              and Hymba-1.5B at full size over the 2 ranks through the
              launcher (phase 17's batch, ``SUBQ_MESH_TRAIN_STEPS`` steps
              each): s a step, tokens/s, each rank's peak memory,
              collectives and bytes staged each way a step, K6 launches
              a step on each rank (Hymba's sequence route), finite
              losses, the first within ``SUBQ_MESH_FIRST_RTOL`` of one
              card's; and Hymba-1.5B trained on one card
              (``SUBQ_HYMBA_STEPS`` steps, one more profiled).  K6
              against its plain version at every signature (a)-(f)
              launched it with, here and on the ranks.  The
              ``subquadratic`` entry of K6's kernels-line row.
21. vlm      — Qwen2-VL-72B (M-RoPE, embedding inputs) at its published
              width (d_model 8,192, 64/8 heads of 128, d_ff 29,568,
              vocab 152,064, bf16, random weights from generator seed
              0), its 80 layers cut to ``VLM_LAYERS``: the reduced config
              in float32 first, prefill and decode fed ``embed1`` against
              ``forward`` under phase 8's bars; then a prefill of
              ``VLM_BATCH`` x ``VLM_PROMPT`` seeded embeddings whose
              M-RoPE ids hold a ``VLM_GRID`` image between two text
              runs, K6 launched once a layer on the ``wgmma`` route and
              no plain attention, ``VLM_NEW`` greedy decode steps (ms a
              step beside the bound of reading the weights once), peak
              memory, the prefill profiled; K6 against its plain version
              on layer 0's q, k, v (``K6_BF16_TOL``), timed beside SDPA
              and its bound.  The ``vlm`` entry of K6's kernels-line row.
22. whisper  — Whisper-base (the encoder-decoder) at its published size,
              nothing cut (6 + 6 layers, d_model 512, 8/8 heads of 64,
              vocab 51,865, 1,500 stub frames; bf16, random weights from
              generator seed 0).  (a) ``WHISPER_BATCH`` chunks of 1,500
              seeded frames encoded, prompts of ``WHISPER_PROMPT`` tokens
              prefilled into a ``WHISPER_CTX`` cache, ``WHISPER_NEW``
              greedy decode steps: encode, prefill and decode seconds,
              tokens/s, each step's ms beside the bound of reading the
              decoder's weights, the tied head and ``xk``/``xv`` once,
              peak memory; K6 launched 18 times a prefill (6 encoder,
              non-causal over 1,500 keys, a ragged end for every key tile;
              6 decoder self; 6 cross at ``Sq != Skv``) and 6 a decode
              step (the cross-attention at one query row), no plain
              attention; 4 decode steps and the prefill profiled.  (b)
              Phase 8's consistency at full size, and the reduced config
              in float32 on the card at 64 and 50 frames within
              ``WHISPER_F32_REL``.  (c) K6 against its plain version on
              layer 0's q, k, v at the three signatures
              (``K6_BF16_TOL``), timed beside SDPA and its bound.  (d)
              ``WHISPER_TRAIN_STEPS`` AdamW steps of ``WHISPER_BATCH`` x
              ``WHISPER_CTX`` tokens over the stub frames through the
              launcher: losses finite and falling, K6 18 launches and 18
              plain backwards a step (the encoder's non-causal included),
              s a step, tokens/s, peak memory, one step profiled.  K6
              against its plain version at every signature (a), (b) and
              (d) launched it with.  (e) Over 2 ranks sharing the card
              (mesh (1, 2), gloo): the reduced config in float32 against
              one rank (losses and parameters); whisper-base at full size,
              ``WHISPER_MESH_STEPS`` steps of (d)'s batch through the
              launcher (s a step, collectives and bytes staged each way,
              each rank's peak memory, K6 launches and backwards a step,
              the first loss against (d)'s); (a)'s prefill into a cache
              split 224/224 over the ranks and ``WHISPER_MESH_NEW`` greedy
              steps (ms a step; the first step's logits against (a)'s);
              the launcher under ``torch.distributed.run``.  K6 against
              its plain version at every signature the ranks launched
              (a rank's 4 of the 8 heads) and timed at each beside SDPA
              and its bound.  The ``whisper`` entry of K6's kernels-line
              row.

23. strategies — ``examples/discover_strategies_torch.py`` (the paper's
              Figs. 3-4 comparison) on UW at ``UW_SCALE`` on the card:
              PRECOUNT, ONDEMAND, HYBRID and TUPLEID learn one model
              through the dense executor (the default) and the sparse
              one, the same edges as the same calls on the host; K1-K4
              launched by each strategy (K1 by the sparse executor's leaf
              hops; no plain version); each strategy's wall, Fig. 3
              split, joins and peak.  The ``uw_strategies``
              entries of K1-K4's kernels-line rows.

The line before the last is one JSON object with a row per kernel; the
last is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

# The H100 SXM's rates (data sheet), the port's roofline constants: device
# memory, float32 outside the tensor cores, bf16 dense tensor cores.
from repro_torch.roofline import (HBM_BW as HBM_BYTES_PER_S,  # noqa: E402
                                  PEAK_FLOPS_BF16 as BF16_OPS_PER_S,
                                  PEAK_FLOPS_F32 as FP32_OPS_PER_S)

LGAMMA_OPS = 70                    # float32 operations per lgamma_f32 call
                                   # (count of bdeu.cu's lgamma_f32 + log_f32)
PROFILE_PAUSE_S = 0.1              # host pause before a kept profiler step

# Database sizes (``paper_benchmark_db`` scale): all full size, none cut.
IMDB_SCALE = 1.0
VG_SCALE = 1.0
UW_SCALE = 1.0

# The counting path's kernels (phases 3-4); K5 and K6 have paths of their own.
COUNTING_KERNELS = ("segsum_ones", "segsum_rows", "mobius", "bdeu")
# ... and the sparse executor's id kernel, on the main path (phase 3).
MAIN_PATH_KERNELS = COUNTING_KERNELS + ("hop_ids",)
# K2's CUDA kernels (csrc/segsum.cu), by the names ptxas and the profiler
# give them.
K2_KERNEL_NAMES = ("rows_private_kernel", "rows_direct_kernel")
# K1's and K4's CUDA kernels (csrc/segsum.cu, csrc/bdeu.cu), by the
# prefixes of the names ptxas and the profiler give them, and the kernels
# phase 2 holds to 0 bytes spilled.
K1_KERNEL_NAMES = ("segsum_ones",)
K4_KERNEL_NAMES = ("bdeu_",)
NO_SPILL_KERNELS = ("flash_wgmma", "flash_mma", "rows_private_kernel",
                    "rows_direct_kernel", "segsum_ones_direct_kernel",
                    "segsum_ones_sliced_kernel", "segsum_ones_private_kernel",
                    "segsum_ones_zero_kernel", "bdeu_chunk_kernel",
                    "mobius_reg_kernel", "mobius_tile_kernel",
                    "hop_ids_kernel")
# K4's edge shapes (phase 10): q either side of a warp, of the 256 lanes
# and past one chunk; r from one column to a chunk that no longer fits
# 256 rows' lgammas (33); B of one family, the IMDb largest call's 9 and
# 200; both equivalent sample sizes the tests use.  K4_EDGE_SCALING is
# the shape where the lgammas themselves bind, timed in phase 4.
K4_EDGE_Q = (1, 2, 31, 32, 33, 255, 256, 257, 1000, 4096)
K4_EDGE_R = (1, 2, 3, 8, 33)
K4_EDGE_B = (1, 9, 200)
K4_EDGE_ESS = (1.0, 10.0)
# and (B, q, r) shapes beside the grid: a chunk of one row whose lgammas
# and the kernel's static shared memory pass 48 KB together
K4_EDGE_EXTRA = ((1, 1, 12_100), (9, 3, 12_100))
K4_SCALING = (64, 4096, 4)
# K3's shapes where its bytes bind (phase 4), [B, 2^k, D]: the register
# path at k = 3 and k = 5 with 128 MB in, the shared-memory path at k = 8,
# and the batched negative phase's stack of many families of a
# 2-relationship chain over three 12-valued attributes.
K3_SCALING = ((1, 8, 1 << 22), (1, 32, 1 << 20), (1, 256, 1 << 16),
              (1024, 4, 1728))
# K1's edge shapes (phase 10): segment counts besides the privatisation
# limit and either side of it (which the phase adds), up to the IMDb hops'
# 10.8M; edge counts either side of a block's 256 threads and the IMDb
# largest call's 400,000.
K1_EDGE_SEGMENTS = (1, 1024, 10_800_000)
K1_EDGE_EDGES = (1, 255, 256, 257, 400_000)
# K2's edge shapes (phase 9): widths at and either side of its 4-column
# quads, one past a warp's 128 and a tile's 256 columns, and the IMDb
# root combine's; segment counts besides the privatisation limit and
# either side of it (which the phase adds); edge counts either side of a
# block's 256 staged ids.  A shape whose rows
# pass K2_EDGE_ROWS_MAX floats or whose table passes K2_EDGE_CELLS_MAX
# cells is left out (D = 11,664 with E = 100,000 or P = 10^6).
K2_EDGE_WIDTHS = (1, 3, 4, 5, 64, 257, 11664)
K2_EDGE_SEGMENTS = (1, 12, 27, 1024, 10 ** 6)
K2_EDGE_EDGES = (1, 255, 256, 257, 100_000)
K2_EDGE_ROWS_MAX = 2 ** 25
K2_EDGE_CELLS_MAX = 2 ** 28

# Qwen2.5-3B serving (phase 7): the main run and the long prefill.
LM_ARCH = "qwen2.5-3b"
LM_BATCH, LM_PROMPT, LM_NEW = 4, 4096, 32
LM_LONG = 32768                    # prefill_32k's length; batch cut 32 -> 1
LM_CHECK_BATCH, LM_CHECK_LEN = 2, 256
# Tolerances.  K6 against its plain version: bf16 output, probabilities
# rounded to bf16 at the running (kernel) or the final (plain) max: two
# bf16 roundings, 2^-7 relative; float32 inputs: 1e-4.  Prefill/decode
# consistency at 36 layers of bf16: the JAX arch test's 2e-2 and 5e-2 (at
# 2 layers), applied to the logits' max abs difference as a fraction of
# their max abs value.
K6_BF16_TOL = dict(rtol=2 ** -7, atol=2 ** -7)
# K6's edge shapes (phase 7): lengths either side of its 64- and 128-row
# tiles, and a query length unlike the key length; in bf16 at the head
# dims of each route (128 the Hopper kernel; 64, 192 and 256 mma.sync; 160
# the CUDA-core kernel), and in float32 (the CUDA-core kernel) above 128 up
# to its limit of 512.
K6_EDGE_LENGTHS = (1, 64, 127, 128, 129, 300, 1000)
K6_EDGE_RAGGED = (200, 333)
K6_EDGE_HEADS, K6_EDGE_KV_HEADS = 16, (1, 2, 16)
K6_EDGE_BATCHES, K6_EDGE_HDS = (1, 3), (128, 64, 160, 192, 256)
K6_EDGE_F32_HDS = (160, 192, 256, 512)
# The sliced route's head dims (phase 7), in bf16 and float32, and the
# shape where it is timed beside SDPA: (B, S, H, Hkv, hd), causal, bf16.
K6_EDGE_SLICED_HDS = (576, 640, 1024)
K6_SLICED_SHAPE = (1, 2048, 8, 1, 1024)
K6_F32_TOL = dict(rtol=1e-4, atol=1e-4)
LM_PREFILL_TOL = 0.02
LM_DECODE_TOL = 0.05
# Nemotron-4-340B serving (phase 11) at its published width; depth cut from
# 96 to 4 layers so that one H100 holds the weights (37.1 GB of bf16; all
# 96 would be about 672 GB).
NEMOTRON_ARCH = "nemotron-4-340b"
NEMOTRON_LAYERS = 4
NEMOTRON_BATCH, NEMOTRON_PROMPT, NEMOTRON_NEW = 2, 4096, 16
# The strategies phase (12): the tight cache budget of its HYBRID run, and
# the runs as (label, strategy, keyword arguments, the kernels its path
# launches).  PRECOUNT's complete tables keep every edge-attribute axis, so
# its negative phase is the blockwise sum, which runs no Möbius transform.
TIGHT_BUDGET = 64 << 10
STRATEGY_RUNS = (
    ("ONDEMAND", "ONDEMAND", {}, COUNTING_KERNELS),
    ("PRECOUNT", "PRECOUNT", {}, ("segsum_ones", "segsum_rows", "bdeu")),
    ("HYBRID 64 KiB", "HYBRID", {"cache_budget_bytes": TIGHT_BUDGET},
     COUNTING_KERNELS))
DISCOVERY = dict(max_chain_length=2, max_parents=3)    # phases 3, 4 and 12
# The relative difference PRECOUNT's families and HYBRID's may show in
# cells past 2^24, where float32 rounds counts (phase 12): 64 units in the
# last place.  tests/test_torch_batching.py holds the CPU to the same bound.
ROUNDING_PAST_2_24 = 2.0 ** -18
# The mutations phase (13): the strategies warmed on IMDb copies; the
# writes on IMDb and on UW, as (op, target, count),
# drawn from one generator seeded MUTATION_SEED.  IMDb: 1 % fresh pairs
# into imdb_R0, 4,000 deletes from imdb_R1 and 1,000 rows of one attribute
# of imdb_e0 (all updated in place), then 30,000 deletes from imdb_R2, above
# max_update_fraction = 0.25 of the 83,000 edges left (the invalidation
# fallback).  UW: an interleaving whose insert of 40 RA edges passes the
# same fraction.
MUTATION_STRATEGIES = ("HYBRID", "ONDEMAND")
MUTATION_SEED = 13
IMDB_WRITES = (("insert", "imdb_R0", 4000), ("delete", "imdb_R1", 4000),
               ("attrs", "imdb_e0", 1000), ("delete", "imdb_R2", 30000))
UW_WRITES = (("insert", "Registered", 6), ("delete", "RA", 4),
             ("attrs", "student", 5), ("insert", "RA", 40),
             ("delete", "Registered", 5), ("attrs", "course", 3),
             ("insert", "Registered", 3))
# The served discovery phase (14): the service's deadline, past which its
# dispatcher thread drains what waits; the clients of (b) and the
# searchers of (c), and the small fenced inserts (op, target, count) the
# writer of (c) makes, drawn from MUTATION_SEED + 1; the ring of the
# traced runs, large enough that no span of an IMDb discovery falls off;
# the discovery tests' score tolerance, to which 4 eps M is added (M: the
# magnitude of the score's lgamma terms, eps = 2^-24).
SERVED_MAX_WAIT_S = 0.002
SERVED_CLIENTS = 4
# The interpreter's thread switch interval while (b)'s clients run: at the
# default 5 ms one client submits a whole round and flushes it before the
# next client runs, so no query of one is pending when another asks it.
SERVED_SWITCH_S = 1e-4
SERVED_SEARCHERS = 2
SERVED_WRITES = (("insert", "imdb_R0", 100), ("insert", "imdb_R1", 100),
                 ("insert", "imdb_R2", 100))
SERVED_RING = 1 << 21
# The sharded phase (15): IMDb at ``IMDB_SCALE`` in ``SHARDS`` hash
# partitions behind ``repro_torch.serve.CountingRouter`` (the reference
# picks root ``imdb_e1``: ``imdb_R0`` and ``imdb_R1`` split by edge,
# ``imdb_R2`` shared); its writes (one partitioned insert, one into the
# shared relation) drawn from ``MUTATION_SEED + 2``; the tenancy step's
# sharded UW tenant in ``TENANT_UW_SHARDS`` shards.
SHARDS = 4
SHARDED_WRITES = (("insert", "imdb_R0", 4000), ("insert", "imdb_R2", 1000))
TENANT_UW_SHARDS = 2
# The mesh phase (16): ranks sharing the card (gloo; NCCL refuses two ranks
# on one device) at ``MESH_WORLDS``: steps (a), (c)-(e) at the first, (b)'s
# discovery at each; a collective that waits ``MESH_TIMEOUT_S`` raises; (c)'s
# write is the first of ``IMDB_WRITES``; (g) runs the launcher under
# ``torch.distributed.run`` on UW at ``UW_SCALE`` with ``MESH_LAUNCH``.
MESH_WORLDS = (2, 4)
MESH_TIMEOUT_S = 300.0
MESH_LAUNCH = dict(max_chain_length=2, max_parents=2)   # launch/discover.py
SCORE_RTOL, SCORE_ATOL = 1e-4, 1e-2
EPS32 = 2.0 ** -24
# Qwen2.5-3B training (phase 17) at full size, through the launcher: batch
# 4 x 2,048 in 2 microbatches, ``TRAIN_STEPS`` AdamW steps at a learning
# rate of 3e-4 (Qwen2.5's scale: the launcher's default 3e-3 is a small
# model's); K6 under autograd at layer 0's shape (B, S, H, Hkv, hd).
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICROBATCH = 4, 2048, 2
TRAIN_STEPS = 8
TRAIN_LR = 3e-4
TRAIN_K6_SHAPE = (2, 2048, 16, 2, 128)
# K6's gradients against autograd through its plain version in float32, as
# a fraction of each gradient's largest magnitude: 1e-4 for float32
# inputs; 2^-7 for bf16 (the probabilities that multiply v, and each
# gradient, are rounded to bf16 once).  rms_norm's VJP against autograd of
# the naive expression: 1e-5 in float32 (the JAX test's), 2^-7 in bf16.
K6_GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2 ** -7}
RMS_GRAD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -7}
# Card against host on the reduced qwen2.5-3b in float32 (phase 17 (c)):
# the CPU parity tests' float32 tolerances for the loss and the gradients.
TRAIN_PARITY_LOSS_RTOL = 1e-5
TRAIN_PARITY_GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
# Multi-rank training (phase 18), ranks sharing the card under gloo.
# (a) K6 with a query offset: per route (head dim, dtype) the query-row
# tile that offsets step over (the Hopper kernel's 128 rows, mma.sync's 64,
# the CUDA-core kernels' 16), offsets 0, one tile and a non-multiple of
# it, at Sq = MESH_K6_SQ rows over Skv = offset + Sq keys (the last
# shard of a sequence) and offset + 2 Sq (an earlier one); and timed at
# MESH_K6_SHAPE, rank 1's shard of a 2,048-token sequence split over 2
# (B, Sq, Skv, H, Hkv, hd, q_offset), bf16, causal.
MESH_K6_ROUTES = ((torch.bfloat16, 128, 128), (torch.bfloat16, 64, 64),
                  (torch.bfloat16, 192, 64), (torch.bfloat16, 256, 64),
                  (torch.bfloat16, 160, 16), (torch.bfloat16, 1024, 16),
                  (torch.float32, 160, 16), (torch.float32, 1024, 16))
MESH_K6_SQ = 300
MESH_K6_SHAPE = (2, 1024, 2048, 16, 2, 128, 1024)
# (b) float32 parity: the reduced qwen2.5-3b, 3 AdamW steps (eps 1e-6, 2
# microbatches) of 4 x 64 tokens on meshes (1, 2) and (2, 2), one step of
# a 3-query-head variant on (1, 2) (3 % 2 != 0: the sequence-parallel
# route, K6 with q_offset under autograd), against one rank in this
# process; the (2, 2) state saved and restored on (1, 2).
MESH_PARITY_SEQ, MESH_PARITY_BATCH, MESH_PARITY_SEED = 64, 4, 2
MESH_PARITY_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=3, eps=1e-6)
MESH_SP_VARIANT = dict(n_heads=3, n_kv_heads=1)
MESH_LOSS_RTOL, MESH_PARAM_ATOL = 1e-6, 1e-5
# (c) Qwen2.5-3B at full width and depth over MESH_TRAIN_RANKS ranks on
# mesh (1, MESH_TRAIN_RANKS), phase 17's batch and learning rate,
# MESH_TRAIN_STEPS steps; its first loss within MESH_FIRST_LOSS_RTOL of
# phase 17's (bf16: the ranks sum partial products in another order).
MESH_TRAIN_RANKS, MESH_TRAIN_STEPS = 2, 2
MESH_FIRST_LOSS_RTOL = 2e-2
# (d) the sequence-sharded decode at full width: MESH_DECODE_BATCH prompts
# of MESH_DECODE_PROMPT tokens, then MESH_DECODE_NEW decode steps
# (teacher-forced), the cache's sequence axis over the model axis.
MESH_DECODE_BATCH, MESH_DECODE_PROMPT, MESH_DECODE_NEW = 2, 512, 8
# and the reduced qwen2.5-3b in float32: (batch, prompt, new tokens), held
# to one rank at tests/test_torch_train_mesh.py's logits tolerance
MESH_DECODE_F32 = (2, 64, 16)
MESH_DECODE_F32_TOL = dict(rtol=1e-4, atol=1e-4)
# Qwen3-30B-A3B (phase 19), served whole: 48 layers, d_model 2,048, 32/4
# heads, 128 experts top-8 (d_ff 768 each), bf16, random weights from
# generator seed 0 (30.5 B parameters, 61 GB); phase 8's main run
# (MOE_BATCH prompts of MOE_PROMPT tokens, MOE_NEW greedy decode steps).
MOE_ARCH = "qwen3-moe-30b-a3b"
MOE_BATCH, MOE_PROMPT, MOE_NEW = 4, 4096, 16
# (b) the reduced MoE configs in float32, card against CPU (phase 17 (c)'s
# tolerances); the consistency of prefill and decode with forward at
# lossless capacity (capacity factor = the expert count), the CPU test's
# float32 tolerance.
MOE_PARITY_ARCHS = ("qwen3-moe-30b-a3b", "arctic-480b")
MOE_CONSISTENCY_TOL = dict(rtol=1e-4, atol=1e-4)
# (c) training at full width, the 48 layers cut to MOE_TRAIN_LAYERS so that
# one card holds the weights, AdamW's float32 moments, the float32
# gradient accumulator and the activations: phase 17's batch (4 x 2,048 in
# 2 microbatches) and learning rate, MOE_TRAIN_STEPS steps.
MOE_TRAIN_LAYERS, MOE_TRAIN_STEPS = 4, 6
MOE_TRAIN_ARCH = f"{MOE_ARCH}-{MOE_TRAIN_LAYERS}l"   # the launcher's --arch
# (d) (c)'s model over 2 ranks sharing the card (mesh (1, 2): 64 experts a
# rank), MOE_MESH_STEPS steps, the first loss within MOE_MESH_FIRST_RTOL of
# (c)'s (bf16: the ranks sum the experts' partial outputs in another
# order, and the ep body routes from bf16-rounded router weights); and the
# reduced qwen3-moe in float32 against one rank (MESH_LOSS_RTOL,
# MESH_PARAM_ATOL).
MOE_MESH_STEPS = 2
MOE_MESH_FIRST_RTOL = 1e-3
# (e) the routing monitor on (a)'s model and prompts: these layers' complete
# ct-tables over (Routed?, bucket, group) counted on the card.
MOE_MONITOR_LAYERS = (0, 47)
# The sub-quadratic blocks (phase 20): RWKV6-1.6B (24 layers, d_model
# 2,048, 32 heads of 64, no attention) and Hymba-1.5B (32 layers, d_model
# 1,600, 25/5 attention heads of 64 beside 25 SSM heads, N 16) served whole
# at phase 8's shapes (LM_BATCH x LM_PROMPT, LM_NEW greedy steps; RWKV also
# one 1 x LM_LONG prefill), random weights from generator seed 0; (c) the
# reduced configs in float32, card against CPU (phase 17 (c)'s tolerances;
# logits and the consistency of prefill and decode with forward at
# SUBQ_PARITY_TOL, the CPU tests' float32 bar); (d) RWKV6-1.6B trained at
# full size through the launcher: phase 17's batch and learning rate,
# SUBQ_TRAIN_STEPS steps.
SUBQ_ARCHS = ("rwkv6-1.6b", "hymba-1.5b")
SUBQ_PARITY_TOL = dict(rtol=1e-4, atol=1e-4)
SUBQ_TRAIN_ARCH, SUBQ_TRAIN_STEPS = "rwkv6-1.6b", 6
# (e) float32 parity over MESH_TRAIN_RANKS ranks (mesh (1, 2)) against one
# rank: the reduced configs and a Hymba of 5 heads (SUBQ_MESH_VARIANTS:
# its SSM on the chunks route, its attention on the sequence route),
# SUBQ_MESH_STEPS AdamW steps (MESH_PARITY_OPT) of MESH_PARITY_BATCH x
# SUBQ_MESH_SEQ (4 chunks of 64, which 2 ranks divide), from generator
# seed 0 with the init's constants perturbed (SUBQ_NOISE, scales as in
# tests/test_torch_subquadratic.py; a_log's as tests/torch_mesh_ranks.py's
# SUBQ_NOISE_A_LOG).  Losses within MESH_LOSS_RTOL; parameters within
# SUBQ_MESH_PARAM_ATOL: at 1,024 tokens a sum, gradients near AdamW's eps
# part by float32 rounding and the first step magnifies that up to 250
# times (tests/test_torch_subquadratic_mesh.py reads 1.4e-5 to 1.7e-5 on
# 1 element in 10^5).
SUBQ_MESH_VARIANTS = (("rwkv6-1.6b", {}), ("hymba-1.5b", {}),
                      ("hymba-1.5b", dict(n_heads=5, n_kv_heads=1,
                                          ssm_heads=5, head_dim=16,
                                          d_model=80)))
SUBQ_MESH_SEQ, SUBQ_MESH_STEPS = 256, 2
SUBQ_MESH_PARAM_ATOL = 5e-5
SUBQ_NOISE = dict(dict.fromkeys(("mu_r", "mu_k", "mu_v", "mu_w", "mu_g",
                                 "mu_ck", "mu_cr"), 0.15),
                  decay_base=0.7, u_bonus=0.5, ln_x=0.2, norm1=0.2,
                  norm2=0.2, final_norm=0.2, a_log=0.05, d_skip=0.3)
# (f) RWKV6-1.6B and Hymba-1.5B at full size over MESH_TRAIN_RANKS ranks
# sharing the card through the launcher: phase 17's batch and learning
# rate, SUBQ_MESH_TRAIN_STEPS steps each, the first loss within
# SUBQ_MESH_FIRST_RTOL of one card's (bf16: the ranks sum partial products
# in another order, as phase 18 (c)'s); and Hymba-1.5B on one card,
# SUBQ_HYMBA_STEPS steps.
SUBQ_MESH_TRAIN_STEPS, SUBQ_HYMBA_STEPS = 2, 3
SUBQ_MESH_FIRST_RTOL = 2e-2
# Qwen2-VL-72B (phase 21) served at its published width (d_model 8,192,
# 64/8 heads of 128, d_ff 29,568, vocab 152,064, M-RoPE, embedding inputs;
# bf16, random weights from generator seed 0), its 80 layers cut to
# VLM_LAYERS so that one card holds them (about 2.02 GB a layer and 2.49
# GB of tied embedding): VLM_BATCH prompts of VLM_PROMPT seeded embeddings
# whose M-RoPE ids hold a VLM_GRID image (t x h x w) after each row's
# VLM_TEXT text tokens, then text; VLM_NEW greedy decode steps.  The
# reduced config in float32 on the card: prefill and decode with embed1
# against forward under phase 8's bars.
VLM_ARCH, VLM_LAYERS = "qwen2-vl-72b", 16
VLM_BATCH, VLM_PROMPT, VLM_NEW = 4, 4096, 16
VLM_GRID, VLM_TEXT = (1, 32, 32), (1024, 512, 1536, 2048)
# Whisper-base (phase 22) at its published size, nothing cut (6 encoder and
# 6 decoder layers, d_model 512, 8/8 heads of 64, d_ff 2,048 GELU, vocab
# 51,865, 1,500 encoder frames; bf16, random weights from generator seed
# 0): (a) WHISPER_BATCH chunks of 30 s of audio (1,500 seeded stub frames
# each) encoded, prompts of WHISPER_PROMPT tokens (Whisper's previous-text
# limit) prefilled into a cache of WHISPER_CTX (the decoder's context),
# WHISPER_NEW greedy decode steps; (b) phase 8's consistency at full size
# in bf16, and the reduced config in float32 on the card within
# WHISPER_F32_REL of the largest logit (tests/test_torch_whisper.py's
# float32 bar); (d) WHISPER_TRAIN_STEPS AdamW steps of WHISPER_BATCH x
# WHISPER_CTX tokens over the stub frames through the launcher, at
# Whisper's published base learning rate.
WHISPER_ARCH = "whisper-base"
WHISPER_BATCH, WHISPER_PROMPT, WHISPER_CTX, WHISPER_NEW = 16, 224, 448, 64
WHISPER_F32_REL = 1e-4
WHISPER_TRAIN_STEPS, WHISPER_LR = 6, 1e-3
# (e) Whisper over MESH_TRAIN_RANKS ranks sharing the card (mesh (1, 2),
# gloo): the reduced config in float32, WHISPER_MESH_PARITY_STEPS AdamW
# steps (MESH_PARITY_OPT) of MESH_PARITY_BATCH x MESH_PARITY_SEQ tokens over
# seeded frames, against one rank (MESH_LOSS_RTOL, MESH_PARAM_ATOL);
# whisper-base at full size through the launcher, WHISPER_MESH_STEPS steps
# of (d)'s batch, its first loss within MESH_FIRST_LOSS_RTOL of (d)'s;
# (a)'s prefill into a WHISPER_CTX cache split over the ranks, then
# WHISPER_MESH_NEW greedy steps from (a)'s first token, the first step's
# logits within LM_DECODE_TOL of (a)'s over the largest; and the launcher
# under torch.distributed.run, WHISPER_MESH_STEPS steps at its default
# batch.  K6 is held to its plain version at every signature the ranks
# launched it with, and timed at a rank's share of each attention.
WHISPER_MESH_PARITY_STEPS, WHISPER_MESH_STEPS, WHISPER_MESH_NEW = 3, 2, 16
# Phase 23: examples/discover_strategies_torch.py on UW at UW_SCALE, the
# four strategies on the card against the same call on the host.
STRATEGY_EXAMPLE = "examples/discover_strategies_torch.py"


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    log(f"FAIL: {msg}")
    sys.exit(1)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def sync() -> None:
    torch.cuda.synchronize()


def cuda_ms(fn, reps: int = 20) -> float:
    """Mean device time of ``fn()`` in ms over ``reps`` launches, after a
    warm-up, from CUDA events."""
    fn()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / reps


def device_events(prof) -> list:
    """A trace's device events by name, without the spans that annotate()
    draws over them."""
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def device_events_ms(fn, reps: int = 20, tries: int = 3):
    """Device time of one ``fn()`` in ms by event name: the self device time
    of each device event of ``reps`` calls under ``torch.profiler``, over
    ``reps``; host launch gaps do not count.  The profiler drops device
    events from the start of a trace (on the H100 machines, the first
    calls' kernels), so ``reps`` calls run in a warm-up step of its
    schedule, and ``reps`` more, after a pause of ``PROFILE_PAUSE_S``, in
    the step it keeps.  Every call launches the same device work, so a
    trace in which some event's count is not a multiple of ``reps`` still
    lost events: it is taken again, up to ``tries`` times.  ``None`` (not
    measured) if no trace holds every call's device events."""
    from torch.profiler import ProfilerActivity, profile, schedule
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for step in range(2):
                if step:
                    time.sleep(PROFILE_PAUSE_S)
                for _ in range(reps):
                    fn()
                sync()
                prof.step()
        on_card = device_events(prof)
        short = {e.key[:60]: e.count for e in on_card if e.count % reps}
        if on_card and not short:
            return {e.key: e.self_device_time_total / reps / 1e3
                    for e in on_card}
        log(f"device_ms: a trace of {reps} calls held "
            f"{'no device events' if not on_card else short}")
    return None


def device_ms(fn, reps: int = 20, tries: int = 3):
    """Device time of one ``fn()`` in ms, all its events together
    (:func:`device_events_ms`); ``None`` if not measured."""
    events = device_events_ms(fn, reps, tries)
    return None if events is None else sum(events.values())


def timings(kernel, plain, library, plain_reps: int = 20) -> dict:
    """A kernels-line row's times: CUDA events around back-to-back calls
    (``ms``, ``plain_ms``, ``library_ms``) and device time
    (``device_ms``, ``plain_device_ms``, ``library_device_ms``) of the
    kernel's call, its plain version's and the library call's (``None``
    where there is none)."""
    return dict(
        ms=cuda_ms(kernel), plain_ms=cuda_ms(plain, reps=plain_reps),
        library_ms=cuda_ms(library) if library else None,
        device_ms=device_ms(kernel),
        plain_device_ms=device_ms(plain, reps=plain_reps),
        library_device_ms=device_ms(library) if library else None)


def check_no_spills(lines, name: str) -> None:
    """Fail unless ptxas reported every instance of kernel ``name`` with 0
    bytes spilled; print each one's registers, shared memory and spills."""
    props = [i for i, line in enumerate(lines)
             if "Function properties" in line and name in line]
    if not props or any(" 0 bytes spill stores, 0 bytes spill loads"
                        not in " " + lines[i + 1] for i in props):
        fail(f"{name} spills (or ptxas reported no spill line for it)")
    for i in props:
        used = next((line for line in lines[i + 2:i + 4] if "Used" in line),
                    "no register line")
        log(f"ptxas {name}: {used.split(':', 1)[-1].strip()}; "
            f"{lines[i + 1].strip()}")


def bound_ms(n_bytes: float, n_ops: float,
             ops_per_s: float = FP32_OPS_PER_S):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / ops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


class Spy:
    """Wraps the ``ops`` wrappers during a run and keeps a copy of the
    positional inputs of each kernel's largest call (by input elements),
    under the kernel's name and under each extra key that ``tags(name,
    args, kwargs)`` gives the call.  An ``out`` that a call adds into is not
    kept: the comparison sums into a zeroed table."""

    def __init__(self, ops, names, tags=lambda name, args, kwargs: ()):
        self.ops, self.orig, self.big, self.tags = ops, {}, {}, tags
        for name in names:
            self.orig[name] = getattr(ops, name)
            setattr(ops, name, self._wrap(name, self.orig[name]))

    def _wrap(self, name, fn):
        def spy(*args, **kwargs):
            size = sum(a.numel() for a in args if torch.is_tensor(a))
            for key in (name, *self.tags(name, args, kwargs)):
                if size > self.big.get(key, (0,))[0]:
                    self.big[key] = (size, tuple(
                        a.clone() if torch.is_tensor(a) else a
                        for a in args))
            return fn(*args, **kwargs)
        return spy

    def remove(self):
        for name, fn in self.orig.items():
            setattr(self.ops, name, fn)


def edges_of(models):
    return {str(p): sorted((str(a), str(b)) for a, b in m.edges())
            for p, m in models.items()}


def check_positive_invariant(strategy, db, label: str) -> None:
    """Every single-relation full positive table counts each edge once."""
    for point in strategy.lattice:
        if point.length != 1:
            continue
        rel = next(iter(point.rels))
        total = strategy.provider._full(point).total()
        if total != db.relations[rel].num_edges:
            fail(f"{label}: positive table of {rel} sums to {total}, not "
                 f"{db.relations[rel].num_edges}")
    log(f"{label}: single-relation positive tables sum to their edge "
        f"counts")


def profile_main_path(db, discover_model, make_strategy) -> None:
    """The main path once more under ``torch.profiler``: the device's busy
    time against the wall time, and the kernels that took most of it."""
    from torch.profiler import ProfilerActivity, profile
    sync()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        discover_model(db, make_strategy("HYBRID", executor="sparse"),
                       **DISCOVERY)
        sync()
    wall = time.perf_counter() - t0
    on_card = device_events(prof)
    if not on_card:
        log(f"profile: {wall:.3f} s wall under the profiler; device time "
            f"not measured (the trace holds no device events)")
        return
    busy = sum(e.self_device_time_total for e in on_card) / 1e6
    log(f"profile: {wall:.3f} s wall under the profiler, device busy "
        f"{busy:.4f} s ({100 * busy / wall:.2f} %), "
        f"{sum(e.count for e in on_card)} device events")
    for e in sorted(on_card, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<6d} "
            f"{e.key[:100]}")
    for label, names in (("K1 (segsum_ones)", K1_KERNEL_NAMES),
                         ("K2 (the row scatter)", K2_KERNEL_NAMES),
                         ("K4 (bdeu)", K4_KERNEL_NAMES),
                         ("the id kernel (hop_ids)", ("hop_ids_kernel",))):
        mine = [e for e in on_card if any(k in e.key for k in names)]
        log(f"profile: {label} "
            f"{sum(e.self_device_time_total for e in mine) / 1e3:.3f} ms of "
            f"device time in {sum(e.count for e in mine)} launches")


def k2_reading(ops, seg, r, p) -> dict:
    """K2 at one call's inputs: bit for bit against its plain version in
    the regime the wrapper chose and, where that was the privatised one,
    in the direct regime too; times of the kernel, its plain version and
    ``index_add_`` (on the ids in range, masked beforehand), the direct
    regime's device time where it was not chosen, and the bound."""
    from repro_torch.kernels.segsum import (card_of, direct_plan, rows_plan,
                                            segsum_rows_cuda,
                                            segsum_rows_plain)
    e, d = r.shape
    card = card_of(r.device)
    plan = rows_plan(e, d, p, card)
    want = segsum_rows_plain(seg, r, p)
    err = float((ops.segsum_rows(seg, r, p) - want).abs().max())
    if err != 0.0:
        fail(f"segsum_rows ({plan.regime}) differs from its plain version "
             f"by {err} at E={e} D={d} P={p}")
    keep = (seg >= 0) & (seg < p)
    seg_l, r_kept = seg[keep].long(), r[keep]
    b_ms, b_by = bound_ms(4.0 * e + 4.0 * e * d + 4.0 * p * d, e * d)
    reading = dict(
        shape=f"E={e} D={d} P={p}", regime=plan.regime, plan=list(plan),
        max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
        **timings(lambda: ops.segsum_rows(seg, r, p),
                  lambda: segsum_rows_plain(seg, r, p),
                  lambda: torch.zeros((p, d), device=r.device)
                  .index_add_(0, seg_l, r_kept)))
    if plan.regime == "private":
        direct = direct_plan(e, d, card)

        def run_direct():
            return segsum_rows_cuda(seg, r, p, torch.zeros(
                (p, d), device=r.device), direct)
        err_direct = float((run_direct() - want).abs().max())
        if err_direct != 0.0:
            fail(f"segsum_rows (direct) differs from its plain version by "
                 f"{err_direct} at E={e} D={d} P={p}")
        reading["direct_device_ms"] = device_ms(run_direct)
    return reading


class IdsSpy:
    """Wraps ``ops.hop_ids`` during a run and keeps a copy of the inputs of
    its largest call (by ids made) of each kind: ``leaf`` (a hop without
    gather indices), ``dense`` (a hop that also makes them) and ``root``
    (the entity codes of a root or a histogram: no gather, no scatter)."""

    def __init__(self, ops):
        from repro_torch.kernels.segsum import IdPart
        self.ops, self.orig, self.big, self.calls = ops, ops.hop_ids, {}, 0

        def clone(t):
            return None if t is None else t.clone()

        def spy(parts, cards, gathered, step, mult=0, gather_step=None, *,
                device):
            self.calls += 1
            kind = ("root" if parts[0].gather is None else
                    "leaf" if gather_step is None else "dense")
            size = sum(p.n for p in parts)
            if size > self.big.get(kind, (0,))[0]:
                self.big[kind] = (size, (
                    [IdPart(p.n, clone(p.gather), clone(p.scatter),
                            tuple(map(clone, p.cols))) for p in parts],
                    tuple(cards), tuple(gathered), step, mult, gather_step,
                    torch.device(device)))
            return self.orig(parts, cards, gathered, step, mult, gather_step,
                             device=device)
        ops.hop_ids = spy

    def remove(self):
        self.ops.hop_ids = self.orig


def ids_bytes(parts, gathered, gather_step) -> float:
    """The least bytes an id kernel call moves: each distinct input column
    read once (a gathered one at most at as many rows as it is read at)
    and the ids (and gather indices) written."""
    reads, ids = {}, 0
    for p in parts:
        ids += p.n
        cols = [(t, False) for t in (p.gather, p.scatter) if t is not None]
        cols += [(c, at and p.gather is not None)
                 for c, at in zip(p.cols, gathered)]
        for t, at in cols:
            key = (t.data_ptr(), t.numel())
            n = reads.get(key, 0) + (p.n if at else t.numel())
            reads[key] = min(n, t.numel())
    written = ids * (2 if gather_step is not None else 1)
    return 4.0 * (sum(reads.values()) + written)


def ids_reading(ops, call) -> dict:
    """The id kernel at one call's inputs: bit for bit against its plain
    version (ids and gather indices), times of the kernel and its plain
    version (the kernel's include its argument table's copy to the card)
    beside the bound.  No library call computes the ids."""
    from repro_torch.kernels.segsum import hop_ids_plain
    parts, cards, gathered, step, mult, gstep, dev = call

    def kernel():
        return ops.hop_ids(parts, cards, gathered, step, mult, gstep,
                           device=dev)

    def plain():
        return hop_ids_plain(parts, cards, gathered, step, mult, gstep, dev)
    (seg, gidx), (want, want_g) = kernel(), plain()
    shape = (f"plans={len(parts)} ids={seg.numel()} cols={len(cards)} "
             f"gather_indices={gstep is not None}")
    if not torch.equal(seg, want) or (gstep is not None
                                      and not torch.equal(gidx, want_g)):
        fail(f"hop_ids differs from its plain version at {shape}")
    b_ms, b_by = bound_ms(ids_bytes(parts, gathered, gstep), 0)
    return dict(shape=shape, max_abs_err=0, bound_ms=b_ms, bound_by=b_by,
                **timings(kernel, plain, None))


def ids_readings(ops, spy: IdsSpy, label: str, kinds) -> dict:
    """:func:`ids_reading` at the largest call of each kind that ``spy``
    kept; fails where one of ``kinds`` did not run."""
    missing = [k for k in kinds if k not in spy.big]
    if missing:
        fail(f"{label}: the id kernel made no {missing} ids")
    out = {}
    for kind in sorted(spy.big):
        out[kind] = r = ids_reading(ops, spy.big[kind][1])
        log(f"id kernel {label} largest {kind} [{r['shape']}]: bit for bit; "
            f"device {r['device_ms']} ms (events {r['ms']:.4f}), plain "
            f"device {r['plain_device_ms']} ms (events "
            f"{r['plain_ms']:.4f}), bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']})")
    return out


def ones_alternatives(plan, e: int, p: int, card) -> list:
    """K1's plans for ``E`` edges into ``P`` segments other than ``plan``:
    the direct regime sliced (one cooperative launch) and not (a zero
    kernel first), and the privatised regime where ``P`` allows it."""
    from repro_torch.kernels.segsum import (ONES_BLOCKS_PER_SM,
                                            ONES_SLICE_BYTES, OnesPlan,
                                            ones_privatisation_limit)
    blocks = max(1, min(ONES_BLOCKS_PER_SM * card.sms, -(-e // 1024)))
    plans = [OnesPlan("direct", card.sms,
                      max(1, -(-4 * p // ONES_SLICE_BYTES))),
             OnesPlan("direct", blocks, 0)]
    if p <= ones_privatisation_limit(card):
        plans.append(OnesPlan("private", blocks, 0))
    return [x for x in plans if x != plan]


def k1_reading(ops, seg, w, p) -> dict:
    """K1 at one call's inputs: exact against its plain version in the
    plan the wrapper chose and in each of :func:`ones_alternatives`;
    device time by event (the zeroing apart from the scatter); times of
    the kernel, its plain version and ``index_add_`` (on the ids in range,
    masked beforehand) beside the bound, and each alternative's device
    time."""
    from repro_torch.kernels.segsum import (card_of, ones_plan,
                                            segsum_ones_cuda,
                                            segsum_ones_plain)
    e = seg.shape[0]
    card = card_of(seg.device)
    plan = ones_plan(e, p, card)
    others = ones_alternatives(plan, e, p, card)
    want = segsum_ones_plain(seg, w, p)
    errs = [float((got - want).abs().max()) for got in (
        ops.segsum_ones(seg, w, p),
        *(segsum_ones_cuda(seg, w, p, x) for x in others))]
    if any(errs):
        fail(f"segsum_ones differs from its plain version by {errs} "
             f"({plan}, then {others}) at E={e} P={p}")
    keep = (seg >= 0) & (seg < p)
    seg_l, w_kept = seg[keep].long(), w[keep]
    b_ms, b_by = bound_ms(8.0 * e + 4.0 * p, e)
    events = device_events_ms(lambda: ops.segsum_ones(seg, w, p))
    return dict(
        shape=f"E={e} P={p}", regime=plan.regime, plan=list(plan),
        max_abs_err=max(errs), bound_ms=b_ms, bound_by=b_by,
        **timings(lambda: ops.segsum_ones(seg, w, p),
                  lambda: segsum_ones_plain(seg, w, p),
                  lambda: torch.zeros(p, device=seg.device)
                  .index_add_(0, seg_l, w_kept)),
        device_ms_by_event=events and {k[:60]: v for k, v in events.items()},
        other_plans_device_ms={str(list(x)): device_ms(
            lambda x=x: segsum_ones_cuda(seg, w, p, x)) for x in others})


def log_k1(label: str, k: dict) -> None:
    log(f"K1 {label} [{k['shape']}]: {k['regime']} {k['plan']}, "
        f"max_abs_err {k['max_abs_err']}; device {k['device_ms']} ms "
        f"(events {k['ms']:.4f}; by event {k['device_ms_by_event']}), "
        f"index_add_ device {k['library_device_ms']} ms (events "
        f"{k['library_ms']:.4f}), plain device {k['plain_device_ms']} ms, "
        f"other plans {k['other_plans_device_ms']} ms, bound "
        f"{k['bound_ms']:.4f} ms ({k['bound_by']})")


def k4_scaling_reading(ops) -> dict:
    """K4 at ``K4_SCALING``, where the lgammas bind: bit for bit against
    its plain version, its device time beside the bound."""
    from repro_torch.kernels.bdeu import bdeu_plain
    b, q, r = K4_SCALING
    gen = torch.Generator(device="cuda").manual_seed(4)
    nijk = torch.randint(0, 50, (b, q, r), generator=gen,
                         device="cuda").float()
    got, want = ops.bdeu(nijk, 1.0), bdeu_plain(nijk, 1.0)
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        fail(f"bdeu at B={b} q={q} r={r} is not bit-identical to its plain "
             f"version")
    b_ms, b_by = bound_ms(4.0 * nijk.numel() + 4.0 * b,
                          b * ((q * r + q) * LGAMMA_OPS + 4 * q * r + 4 * q))
    reading = dict(shape=f"B={b} q={q} r={r}", max_abs_err=0.0,
                   device_ms=device_ms(lambda: ops.bdeu(nijk, 1.0)),
                   ms=cuda_ms(lambda: ops.bdeu(nijk, 1.0)),
                   bound_ms=b_ms, bound_by=b_by)
    log(f"K4 where the lgammas bind [{reading['shape']}]: bit for bit; "
        f"device {reading['device_ms']} ms (events {reading['ms']:.4f}), "
        f"bound {b_ms:.4f} ms ({b_by})")
    return reading


def k3_reading(ops, x: torch.Tensor) -> dict:
    """K3 on ``x [B, 2^k, D]``: bit for bit against its plain version
    (compared as int32), its time beside the bound and ``matmul(T, X)``'s
    (timing only: its rounding differs above 2^24)."""
    from repro_torch.kernels.mobius import mobius_matrix, mobius_plain
    bsz, height, d = x.shape
    k = height.bit_length() - 1
    got, want = ops.mobius(x), mobius_plain(x)
    shape = f"B={bsz} 2^k={height} D={d}"
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        fail(f"mobius at {shape} is not bit-identical to its plain version")
    err = float((got - want).abs().max())
    del got, want
    tmat = mobius_matrix(k).to(x.device)
    b_ms, b_by = bound_ms(8.0 * x.numel(), bsz * d * k * (height // 2))
    return dict(shape=shape, max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
                ms=cuda_ms(lambda: ops.mobius(x)),
                device_ms=device_ms(lambda: ops.mobius(x)),
                library_ms=cuda_ms(lambda: torch.matmul(tmat, x)),
                library_device_ms=device_ms(lambda: torch.matmul(tmat, x)))


def k3_scaling_reading(ops) -> list:
    """K3 at ``K3_SCALING``, where its bytes bind: counts in [0, 2^30) from
    a seeded generator (above 2^24, so only the plain version's order of
    subtractions gives its bits), one :func:`k3_reading` each."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    readings = []
    for b, r, d in K3_SCALING:
        x = torch.randint(0, 1 << 30, (b, r, d), generator=gen,
                          device="cuda").float()
        reading = k3_reading(ops, x)
        log(f"K3 where its bytes bind [{reading['shape']}]: bit for bit; "
            f"device {reading['device_ms']} ms (events "
            f"{reading['ms']:.4f}), matmul(T, X) device "
            f"{reading['library_device_ms']} ms (events "
            f"{reading['library_ms']:.4f}), bound {reading['bound_ms']:.5f} "
            f"ms ({reading['bound_by']}); device / bound "
            f"{(reading['device_ms'] or float('nan')) / reading['bound_ms']:.2f}")
        readings.append(reading)
        del x
    return readings


def log_row(row: dict) -> None:
    log(f"kernel {row['name']} [{row['shape']}]: {row['ms']:.4f} ms "
        f"(device {row['device_ms']}), plain {row['plain_ms']:.4f} ms "
        f"(device {row['plain_device_ms']}), library {row['library_ms']} ms "
        f"(device {row['library_device_ms']}), bound {row['bound_ms']:.4f} "
        f"ms ({row['bound_by']}), max_abs_err {row['max_abs_err']}")


def log_k2(label: str, k: dict) -> None:
    log(f"K2 {label} [{k['shape']}]: {k['regime']} {k['plan']}, "
        f"max_abs_err {k['max_abs_err']}; device {k['device_ms']} ms "
        f"(events {k['ms']:.4f}), index_add_ device "
        f"{k['library_device_ms']} ms (events {k['library_ms']:.4f}), plain "
        f"device {k['plain_device_ms']} ms, direct regime device "
        f"{k.get('direct_device_ms')} ms, bound {k['bound_ms']:.4f} ms "
        f"({k['bound_by']})")


def hist_phase(ops) -> dict:
    """K5's path: ``bench_hist``'s three shapes (N, P, D), counted; each
    checked against its plain version, the largest timed (and its direct
    regime's device time where the wrapper chose the privatised one)."""
    from repro_torch.kernels.segsum import (card_of, direct_plan, rows_plan,
                                            segment_hist_plain,
                                            segsum_rows_cuda)
    gen = torch.Generator(device="cuda").manual_seed(1)
    inputs = [(torch.randint(0, p, (n,), generator=gen, device="cuda",
                             dtype=torch.int32),
               torch.rand((n, d), generator=gen, device="cuda"), p)
              for n, p, d in ((4096, 64, 128), (65536, 256, 128),
                              (262144, 1024, 64))]
    sync()
    ops.reset_counts()
    t0 = time.perf_counter()
    outs = [ops.segment_hist(*args) for args in inputs]
    sync()
    launches = ops.LAUNCHES["segment_hist"]
    regimes = dict(ops.ROW_REGIMES)
    log(f"hist path (bench_hist shapes): {time.perf_counter() - t0:.4f} s "
        f"wall, {launches} segment_hist launches, by regime "
        f"{json.dumps(regimes)}")
    if launches != len(inputs):
        fail(f"segment_hist launched {launches} times, not {len(inputs)}")
    errs = []
    for (codes, vals, p), got in zip(inputs, outs):
        want = segment_hist_plain(codes, vals, p)
        errs.append(float((got - want).abs().max()))
        if not torch.allclose(got, want, rtol=1e-5, atol=1e-3):
            fail(f"segment_hist at N={codes.shape[0]} P={p} D="
                 f"{vals.shape[1]} outside rtol=1e-5, atol=1e-3 of its "
                 f"plain version (max_abs_err {errs[-1]})")
    log(f"segment_hist against its plain version at the three shapes: "
        f"max_abs_err {errs}")
    err = max(errs)
    codes, vals, p = inputs[-1]
    n, d = vals.shape
    codes_l = codes.long()
    b_ms, b_by = bound_ms(4.0 * n + 4.0 * n * d + 4.0 * p * d, n * d)
    plan = rows_plan(n, d, p, card_of(vals.device))
    direct = direct_plan(n, d, card_of(vals.device))
    return dict(
        name="segment_hist", route="cuda",
        source="src/repro_torch/kernels/csrc/segsum.cu",
        replaces="src/repro/kernels/hist_kernel.py:37",
        launches=launches, launches_by_regime=regimes, max_abs_err=err,
        bound_ms=b_ms, bound_by=b_by, regime=plan.regime, plan=list(plan),
        **timings(lambda: ops.segment_hist(codes, vals, p),
                  lambda: segment_hist_plain(codes, vals, p),
                  lambda: torch.zeros((p, d), device=vals.device)
                  .index_add_(0, codes_l, vals)),
        direct_device_ms=None if plan == direct else device_ms(
            lambda: segsum_rows_cuda(codes, vals, p, torch.zeros(
                (p, d), device=vals.device), direct)),
        shape=f"N={n} P={p} D={d}; max_abs_err over the three shapes")


def sdpa_call(q, k, v, causal: bool = True):
    """One PyTorch library call of the same attention (the yardstick; the
    port never calls it), as a function of no arguments.  KV heads are
    repeated beforehand where this PyTorch has no ``enable_gqa``."""
    import torch.nn.functional as F
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    try:
        F.scaled_dot_product_attention(qt[:, :, :1], kt, vt,
                                       is_causal=causal, enable_gqa=True)
        kw = dict(is_causal=causal, enable_gqa=True)
    except TypeError:
        rep = q.shape[2] // k.shape[2]
        kt, vt = (t.repeat_interleave(rep, dim=1) for t in (kt, vt))
        kw = dict(is_causal=causal)
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, **kw)


def lm_consistency(model, ops, gate: bool = True) -> dict:
    """(c) ``tests/test_arch_smoke.py``'s property at full width and
    depth: prefill's last logits against ``forward`` at s-2, and
    ``decode_step`` at s-1 against ``forward`` at s-1; each max abs
    difference over the largest logit, returned by name.  With ``gate``
    false a reading only, not held to the bar."""
    b, s = LM_CHECK_BATCH, LM_CHECK_LEN
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, model.cfg.vocab, (b, s), dtype=np.int64)).cuda()
    logits_all = model.forward({"tokens": toks})
    cache = model.init_cache(b, s)
    last, cache = model.prefill({"tokens": toks[:, :s - 1]}, cache)
    logits1, _ = model.decode_step(cache, {"token": toks[:, s - 1:],
                                           "pos": s - 1})
    rel = {}
    for name, got, want, tol in (
            ("prefill", last, logits_all[:, s - 2], LM_PREFILL_TOL),
            ("decode", logits1, logits_all[:, s - 1], LM_DECODE_TOL)):
        if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
            fail(f"lm consistency: non-finite {name} logits")
        diff = float((got - want).abs().max())
        scale = float(want.abs().max())
        agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
        rel[name] = diff / scale
        log(f"lm consistency ({b} x {s}, {model.cfg.dtype}): {name} vs "
            f"forward max abs diff {diff:.5f} of max |logit| {scale:.4f} "
            f"({diff / scale:.5f}, "
            f"{'tolerance ' + str(tol) if gate else 'a reading only'}); "
            f"argmax agreement {agree:.2f}")
        if gate and diff > tol * scale:
            fail(f"lm consistency: {name} logits differ from forward by "
                 f"{diff} > {tol} x {scale}")
    return rel


def layer0_qkv(model, tokens):
    """Layer 0's q, k, v of a prefill of ``tokens`` (or of a batch: its
    ``embeds`` and M-RoPE ``positions``): the same operations on the same
    inputs as in the prefill, recomputed."""
    from repro_torch.models.attention import qkv_project
    from repro_torch.models.layers import rms_norm
    from repro_torch.models.model import _positions_for
    cfg = model.cfg
    batch = tokens if isinstance(tokens, dict) else {"tokens": tokens}
    with torch.no_grad():
        x = model._embed_in(batch)
        blk = model.blocks[0]
        return qkv_project(blk.attn, rms_norm(x, blk.norm1), cfg,
                           _positions_for(cfg, batch, x))


def check_k6(ops, q, k, v, label: str, causal: bool = True) -> float:
    """K6 against its plain version on ``q, k, v`` (``K6_BF16_TOL`` in
    bf16, ``K6_F32_TOL`` in float32); the max abs error."""
    from repro_torch.kernels.attention import flash_attention_plain
    tol = K6_BF16_TOL if q.dtype == torch.bfloat16 else K6_F32_TOL
    got = ops.flash_attention(q, k, v, causal=causal)
    want = flash_attention_plain(q, k, v, causal=causal)
    err = float((got.float() - want.float()).abs().max())
    if not torch.allclose(got.float(), want.float(), **tol):
        fail(f"K6 ({q.dtype}, {label}) outside {tol} of its plain version "
             f"(max_abs_err {err})")
    return err


def k6_edge_phase(ops) -> dict:
    """7. K6 against its plain version on the edge shapes; the largest max
    abs error of each route (kernel) that the shapes took, float32's
    apart."""
    from repro_torch.kernels.attention import flash_attention_route
    gen = torch.Generator(device="cuda").manual_seed(2)
    shapes = [(sq, sq, c) for sq in K6_EDGE_LENGTHS for c in (True, False)]
    shapes.append((*K6_EDGE_RAGGED, False))
    cases = ([(torch.bfloat16, hd) for hd in K6_EDGE_HDS]
             + [(torch.float32, hd) for hd in K6_EDGE_F32_HDS]
             + [(dtype, hd) for hd in K6_EDGE_SLICED_HDS
                for dtype in (torch.bfloat16, torch.float32)])
    h, errs, by_route = K6_EDGE_HEADS, [], {}
    t0 = time.perf_counter()
    ops.reset_counts()
    for dtype, hd in cases:
        route = flash_attention_route(dtype, hd)
        key = route if dtype == torch.bfloat16 else f"{route} float32"
        for b in K6_EDGE_BATCHES:
            for hk in K6_EDGE_KV_HEADS:
                for sq, skv, causal in shapes:
                    q = torch.randn((b, sq, h, hd), generator=gen,
                                    device="cuda").to(dtype)
                    k, v = (torch.randn((b, skv, hk, hd), generator=gen,
                                        device="cuda").to(dtype)
                            for _ in range(2))
                    label = (f"B={b} Sq={sq} Skv={skv} H={h} Hkv={hk} "
                             f"hd={hd} {'causal' if causal else 'full'} "
                             f"{str(dtype)[6:]}")
                    errs.append(check_k6(ops, q, k, v, label, causal))
                    by_route[key] = max(by_route.get(key, 0.0), errs[-1])
                    log(f"k6 edge {label}: {route}, max_abs_err "
                        f"{errs[-1]}")
    sync()
    if ops.LAUNCHES["flash_attention"] != len(errs):
        fail(f"k6 edges: {ops.LAUNCHES['flash_attention']} launches for "
             f"{len(errs)} shapes")
    log(f"k6 edges: {len(errs)} shapes within {K6_BF16_TOL} (bf16) or "
        f"{K6_F32_TOL} (float32) of the plain version, largest max_abs_err "
        f"by route {by_route}; {time.perf_counter() - t0:.1f} s")
    return by_route


def k6_sliced_reading(ops) -> dict:
    """7. The sliced route at ``K6_SLICED_SHAPE`` (causal, bf16): against
    its plain version, timed beside SDPA and its bound (bf16 operations
    of the causal pairs, or the bytes of q, k, v and out)."""
    from repro_torch.kernels.attention import (flash_attention_plain,
                                               flash_attention_route,
                                               head_slices)
    b, s, h, hk, hd = K6_SLICED_SHAPE
    route = flash_attention_route(torch.bfloat16, hd)
    if route != "sliced":
        fail(f"K6 takes the {route} route at hd {hd}, not the sliced one")
    gen = torch.Generator(device="cuda").manual_seed(3)
    q = torch.randn((b, s, h, hd), generator=gen, device="cuda").bfloat16()
    k, v = (torch.randn((b, s, hk, hd), generator=gen,
                        device="cuda").bfloat16() for _ in range(2))
    err = check_k6(ops, q, k, v, f"sliced {K6_SLICED_SHAPE}")
    flops = 4.0 * b * h * hd * s * (s + 1) / 2       # causal pairs only
    b_ms, b_by = bound_ms(2.0 * (2 * q.numel() + k.numel() + v.numel()),
                          flops, BF16_OPS_PER_S)
    reading = dict(
        shape=f"B={b} S={s} H={h} Hkv={hk} hd={hd} causal bf16",
        slices=head_slices(hd), max_abs_err=err, bound_ms=b_ms,
        bound_by=b_by,
        **timings(lambda: ops.flash_attention(q, k, v, causal=True),
                  lambda: flash_attention_plain(q, k, v, True),
                  sdpa_call(q, k, v), plain_reps=3))
    log(f"K6 sliced at {reading['shape']} (slices {reading['slices']}): "
        f"{reading['ms']:.4f} ms / device {reading['device_ms']} ms; SDPA "
        f"{reading['library_ms']:.4f} / {reading['library_device_ms']} ms; "
        f"plain {reading['plain_ms']:.4f} ms; bound {b_ms:.4f} ms ({b_by}); "
        f"max_abs_err {err}")
    del q, k, v
    return reading


class BatchRecorder:
    """Records, while installed, every ``Executor.positive_batch`` call's
    plan list (the call itself is unchanged).  ``summary()`` reads the
    calls afterwards: plans, stack groups (by ``plan_stack_key``), the
    groups of two or more plans (stacked), the largest, and the groups of
    one plan (which go through ``positive``)."""

    def __init__(self):
        from repro_torch.core.executors import Executor
        self.cls, self.orig, self.calls = Executor, Executor.positive_batch, []
        orig, calls = self.orig, self.calls

        def spy(ex, db, plans, stats=None):
            calls.append((ex, db, list(plans)))
            return orig(ex, db, plans, stats)
        Executor.positive_batch = spy

    def remove(self) -> None:
        self.cls.positive_batch = self.orig

    def groups(self) -> list:
        """Every call's stack groups, as ``(db, plans)``."""
        from repro_torch.core.executors import plan_stack_key
        out = []
        for _, db, plans in self.calls:
            keys = {}
            for p in plans:
                keys.setdefault(plan_stack_key(db, p), []).append(p)
            out.extend((db, g) for g in keys.values())
        return out

    def summary(self) -> dict:
        sizes = [len(g) for _, g in self.groups()]
        return dict(calls=len(self.calls),
                    plans=sum(len(c[2]) for c in self.calls),
                    groups=len(sizes), stacked=sum(n > 1 for n in sizes),
                    largest=max(sizes, default=0),
                    singletons=sum(n == 1 for n in sizes))


def counting_reading(ops, strategy, wall: float, recorder=None) -> dict:
    """A discovery run's numbers: wall, the Fig. 3 split, joins, rows
    scanned, peak device memory, launches by kernel and by K1/K2 regime,
    and (with ``recorder``) its ``positive_batch`` calls."""
    st = strategy.stats.as_dict()
    out = dict(wall_s=wall, **{k: st[k] for k in (
        "time_metadata", "time_positive", "time_negative", "joins",
        "rows_scanned", "ct_rows")},
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        launches={k: ops.LAUNCHES[k] for k in COUNTING_KERNELS},
        k1_regimes=dict(ops.ONES_REGIMES), k2_regimes=dict(ops.ROW_REGIMES))
    if recorder is not None:
        out["positive_batch"] = recorder.summary()
    return out


def replay_phase(ops, recorder) -> dict:
    """12 (replay). The recorded ``positive_batch`` plan lists once through
    ``positive_batch`` and once through ``positive`` one plan at a time, on
    a fresh sparse executor: bit for bit equal tables; K1/K2 launches,
    wall and device time of each; then every stacked group on its own,
    which must launch K1 and K2 fewer times than its plans one at a
    time."""
    from repro_torch.core.executors import SparseExecutor
    ex = SparseExecutor(device="cuda")
    lists = [(db, plans) for _, db, plans in recorder.calls]

    def batched():
        return [ex.positive_batch(db, plans) for db, plans in lists]

    def single():
        return [[ex.positive(db, p) for p in plans] for db, plans in lists]

    out, tabs = {}, {}
    for label, fn in (("batched", batched), ("single", single)):
        ops.reset_counts()
        sync()
        t0 = time.perf_counter()
        tabs[label] = fn()
        sync()
        out[label] = dict(
            wall_s=time.perf_counter() - t0,
            k1=ops.LAUNCHES["segsum_ones"], k2=ops.LAUNCHES["segsum_rows"],
            k1_regimes=dict(ops.ONES_REGIMES),
            k2_regimes=dict(ops.ROW_REGIMES))
    n_tabs = 0
    for got, want in zip(tabs["batched"], tabs["single"]):
        for g, w in zip(got, want):
            n_tabs += 1
            if g.vars != w.vars or not torch.equal(g.counts, w.counts):
                fail("replay: a batched table differs from its plan's "
                     "unbatched table")
    del tabs
    stacked = 0
    for db, group in recorder.groups():
        if len(group) < 2:
            continue
        stacked += 1
        ops.reset_counts()
        ex.positive_batch(db, group)
        n_batched = ops.LAUNCHES["segsum_ones"] + ops.LAUNCHES["segsum_rows"]
        ops.reset_counts()
        for p in group:
            ex.positive(db, p)
        n_single = ops.LAUNCHES["segsum_ones"] + ops.LAUNCHES["segsum_rows"]
        if n_batched >= n_single:
            fail(f"replay: a stacked group of {len(group)} plans launched "
                 f"K1/K2 {n_batched} times, one at a time {n_single}")
    for label, fn in (("batched", batched), ("single", single)):
        events = device_events_ms(fn, reps=2) or {}
        out[label]["device_ms"] = sum(events.values()) if events else None
        out[label]["top_device_ms"] = {
            k[:48]: v for k, v in sorted(events.items(),
                                         key=lambda kv: -kv[1])[:6]}
    out.update(tables=n_tabs, stacked_groups=stacked)
    log(f"replay of {len(lists)} positive_batch calls ({n_tabs} plans, "
        f"{stacked} stacked groups, each with fewer K1/K2 launches than one "
        f"plan at a time): tables bit for bit equal; "
        + "; ".join(f"{k}: wall {v['wall_s']:.4f} s, device "
                    f"{v['device_ms']} ms, K1 {v['k1']} {v['k1_regimes']}, "
                    f"K2 {v['k2']} {v['k2_regimes']}, largest device "
                    f"events {json.dumps(v['top_device_ms'])}"
                    for k, v in out.items() if isinstance(v, dict)))
    return out


def record_families(strategy) -> list:
    """The ``(point, keep)`` of every family table ``strategy`` serves
    from now on (its ``_family_ct``, behind ``family_ct`` and, for
    PRECOUNT, ``family_ct_many``), in order."""
    asked, inner = [], strategy._family_ct

    def family_ct(point, keep):
        asked.append((point, tuple(keep)))
        return inner(point, keep)
    strategy._family_ct = family_ct
    return asked


class NoPositives:
    """A planted fault: a positive provider that finds no grounding where a
    relationship holds, so a negative phase over it subtracts nothing."""

    def __init__(self, provider):
        self.provider = provider

    def hist(self, var, keep):
        return self.provider.hist(var, keep)

    def positive(self, point, keep):
        from repro_torch.core import CtTable
        t = self.provider.positive(point, keep)
        return CtTable(t.vars, torch.zeros_like(t.counts))


def past_2_24(a: torch.Tensor, b: torch.Tensor):
    """The largest relative difference between two tables in the cells
    past 2^24, and whether any cell below it differs."""
    a, b = a.double(), b.double()
    big = torch.maximum(a.abs(), b.abs())
    diff = a != b
    low = bool((diff & (big < 2.0 ** 24)).any())
    high = diff & (big >= 2.0 ** 24)
    rel = float(((a - b).abs() / big)[high].max()) if bool(high.any()) \
        else 0.0
    return rel, low


def recount_entries(strategy, fresh) -> dict:
    """Every resident ``"pos"``, ``"full"``, ``"fam"``, ``"complete"`` and
    ``"msg"`` entry of ``strategy``'s cache against ``fresh``'s recount of
    it (``fresh``: a strategy of the same kind prepared on the same store
    after the writes).  Returns the entries compared and the keys whose
    axes differ or whose cells below 2^24 differ (``low_differs``: counts
    there are exact, so any difference is a fault), whose cells past 2^24
    differ at all (``rounded``: an in-place ``old + delta`` may round apart
    from a recount there) and by more than ``ROUNDING_PAST_2_24`` of a
    cell (``past_bound``), with the largest such relative difference.
    ``tests/test_torch_mutations.py`` runs the same comparison on the CPU
    and shows that it fails on a planted fault."""
    from repro_torch.core import LatticePoint
    cache = strategy.engine.cache
    low, rounded, high, worst, n = [], [], [], 0.0, 0
    for key in cache.keys_snapshot():
        ns, got = key[0], cache.peek(key)
        if ns == "pos":
            want = fresh.engine.contract(LatticePoint(key[2]), key[3])
        elif ns == "full":
            want = fresh.engine.contract(LatticePoint(key[2]), None)
        elif ns == "fam":
            want = fresh.family_ct(LatticePoint(key[1]), key[2])
        elif ns == "complete":
            want = fresh._complete_full(LatticePoint(key[1]))
        elif ns == "msg":
            want = fresh.provider._msg(*key[2:])
        else:
            continue
        n += 1
        # a message entry is already its (matrix, column vars) pair
        (a, a_vars), (b, b_vars) = (t if ns == "msg" else (t.counts, t.vars)
                                    for t in (got, want))
        if tuple(a_vars) != tuple(b_vars) or a.shape != b.shape:
            low.append(key)
            continue
        rel, differs_low = past_2_24(a, b.to(a.device))
        if differs_low:
            low.append(key)
        if rel > 0.0:
            rounded.append(key)
        if rel > ROUNDING_PAST_2_24:
            high.append(key)
        worst = max(worst, rel)
    return dict(entries=n, low_differs=low, rounded=rounded, past_bound=high,
                worst_past_2_24=worst)


def precount_tables(db, precount, asked, differ, edges) -> dict:
    """PRECOUNT against HYBRID and against itself on the CPU, table by
    table.  PRECOUNT projects each family from the complete table over all
    of a point's axes; HYBRID runs a Möbius join over projected positives.
    Counts past 2^24 (the groundings where a relationship does not hold:
    1e10 and more per point at IMDb's full size) are not exact in float32,
    so the two orders of operations may round them apart, as in the JAX
    package.  Each family PRECOUNT's search scored is fetched from a fresh
    HYBRID: the axes must be the same and in the same order, every cell
    below 2^24 equal bit for bit, and every cell past it within
    ``ROUNDING_PAST_2_24``.  The same families from complete tables whose
    negative phase subtracts no positive count (``NoPositives``) must
    differ from HYBRID's past 2^24 by more than that bound, in the cells
    the fault leaves nonzero (it empties every block where a relationship
    holds, which the cells below 2^24 catch on their own).  PRECOUNT on
    the CPU over the same database (``edges``: the card's models) must
    learn the same models, and give those families bit for bit (its
    families are float64 sums, exact in any order).  Models may differ
    from HYBRID's (``differ``) only at points where some family differed
    past 2^24; anywhere else fails."""
    from repro_torch.core import (build_lattice, discover_model,
                                  make_strategy)
    from repro_torch.core.mobius import complete_ct
    from repro_torch.core.strategies import _project_wide
    lattice = build_lattice(db.schema, DISCOVERY["max_chain_length"])
    ref = make_strategy("HYBRID", executor="sparse")
    ref.prepare(db, lattice)
    fams = list(dict.fromkeys(asked))
    rounded, n_rounded, worst, planted, faulty = set(), 0, 0.0, 0.0, {}
    for point, keep in fams:
        a, b = ref.family_ct(point, keep), precount.family_ct(point, keep)
        if a.vars != b.vars or a.counts.shape != b.counts.shape:
            fail(f"PRECOUNT: family {[str(v) for v in keep]} of {point} has "
                 f"axes {[str(v) for v in b.vars]}, HYBRID's "
                 f"{[str(v) for v in a.vars]}")
        rel, low = past_2_24(a.counts, b.counts)
        if low:
            fail(f"PRECOUNT: family {[str(v) for v in keep]} of {point} "
                 f"differs from HYBRID's in a cell below 2^24")
        if rel > ROUNDING_PAST_2_24:
            fail(f"PRECOUNT: family {[str(v) for v in keep]} of {point} "
                 f"differs from HYBRID's past 2^24 by {rel} of a cell, "
                 f"more than {ROUNDING_PAST_2_24}")
        if rel > 0.0:
            n_rounded += 1
            rounded.add(str(point))
        worst = max(worst, rel)
        if point not in faulty:
            full = precount._complete_full(point)
            faulty[point] = complete_ct(point, full.vars,
                                        NoPositives(precount.provider))
        # the fault empties every block where a relationship holds; what it
        # leaves is the negative phase proper, short of no subtraction
        f = _project_wide(faulty[point], keep).counts
        planted = max(planted, past_2_24(a.counts[f != 0], f[f != 0])[0])
    if not fams:
        fail("PRECOUNT: no family table was recorded")
    if planted <= ROUNDING_PAST_2_24:
        fail(f"PRECOUNT: a negative phase that subtracts no positive count "
             f"differs from HYBRID past 2^24 by {planted} of a cell at "
             f"most, within the bound {ROUNDING_PAST_2_24}")
    if not set(differ) <= rounded:
        fail(f"PRECOUNT: models differ from phase 3's HYBRID at "
             f"{sorted(set(differ) - rounded)}, where every family table "
             f"equals HYBRID's")
    del ref, faulty
    t0 = time.perf_counter()
    on_cpu = make_strategy("PRECOUNT", executor="sparse", device="cpu")
    cpu_models, on_cpu = discover_model(db, on_cpu, device="cpu",
                                        **DISCOVERY)
    if edges_of(cpu_models) != edges:
        fail(f"PRECOUNT: card and CPU models differ:\n{edges}\n"
             f"{edges_of(cpu_models)}")
    for point, keep in fams:
        got, want = precount.family_ct(point, keep), \
            on_cpu.family_ct(point, keep)
        if got.vars != want.vars or not torch.equal(got.counts.cpu(),
                                                    want.counts):
            fail(f"PRECOUNT: family {[str(v) for v in keep]} of {point} "
                 f"differs between the card and the CPU")
    return dict(families=len(fams), rounded_past_2_24=n_rounded,
                largest_relative_difference=worst,
                planted_fault_relative_difference=planted,
                bound=ROUNDING_PAST_2_24,
                points_with_rounded_tables=sorted(rounded),
                models_differ_at=differ,
                cpu_witness_s=time.perf_counter() - t0)


def strategies_phase(ops, hybrid: dict) -> dict:
    """12. ONDEMAND, PRECOUNT and tight-budget HYBRID discovery on the IMDb
    stand-in (``STRATEGY_RUNS``), each against phase 3's HYBRID run
    (``hybrid``: its reading and learned edges), then the replay of the
    ONDEMAND run's ``positive_batch`` calls."""
    from repro_torch.core import (discover_model, make_strategy,
                                  paper_benchmark_db)
    t_phase = time.perf_counter()
    db = paper_benchmark_db("IMDb", seed=0, scale=IMDB_SCALE)
    runs = {"HYBRID (phase 3)": hybrid["reading"]}
    ondemand = None
    for label, name, kw, kernels in STRATEGY_RUNS:
        strategy = make_strategy(name, executor="sparse", **kw)
        asked = record_families(strategy)
        recorder = BatchRecorder()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_counts()
        sync()
        t0 = time.perf_counter()
        models, strategy = discover_model(db, strategy, **DISCOVERY)
        sync()
        wall = time.perf_counter() - t0
        recorder.remove()
        reading = counting_reading(ops, strategy, wall, recorder)
        log(f"{label} (IMDb, sparse): {wall:.3f} s wall; "
            + json.dumps(reading))
        if any(ops.PLAIN_CALLS[k] for k in ops.KERNELS):
            fail(f"{label}: plain versions ran on the card: "
                 f"{ops.PLAIN_CALLS}")
        if any(reading["launches"][k] <= 0 for k in kernels):
            fail(f"{label}: a kernel of its path was not launched: "
                 f"{reading['launches']}")
        edges = edges_of(models)
        differ = sorted(p for p in set(edges) | set(hybrid["edges"])
                        if edges.get(p) != hybrid["edges"].get(p))
        if name == "PRECOUNT":
            reading["tables"] = precount_tables(db, strategy, asked,
                                                differ, edges)
        elif differ:
            fail(f"{label}: models differ from phase 3's HYBRID at {differ}")
        if not all(np.isfinite(m.score) for m in models.values()):
            fail(f"{label}: a learned model has a non-finite score")
        runs[label] = reading
        if name == "ONDEMAND":
            ondemand = recorder
        del models, strategy
    log(f"strategies: ONDEMAND and HYBRID at {TIGHT_BUDGET} B learn phase "
        f"3's models edge for edge; PRECOUNT learns its CPU run's models "
        f"edge for edge, against HYBRID "
        f"{json.dumps(runs['PRECOUNT']['tables'])}")
    replay = replay_phase(ops, ondemand)
    log(f"strategies phase: {time.perf_counter() - t_phase:.1f} s")
    return dict(runs=runs, replay=replay)


def draw_writes(db, plan, seed: int) -> list:
    """Writes drawn from one numpy generator (``seed``), in order, each
    from the state the writes before it left: ``plan`` holds ``(op,
    target, k)`` with ``op`` ``"insert"`` (``k`` fresh pairs, random edge
    attributes), ``"delete"`` (``k`` random edges) or ``"attrs"`` (``k``
    random rows of one random attribute).  Each write is ``(label, op,
    target, arrays...)``, so every copy of the store takes the same one
    (:func:`apply_write`)."""
    import copy
    rng = np.random.default_rng(seed)
    scratch = copy.deepcopy(db)
    out = []
    for op, target, k in plan:
        if op == "insert":
            tab = scratch.relations[target]
            ns = scratch.entities[tab.type.src].size
            nd = scratch.entities[tab.type.dst].size
            have = tab.src.astype(np.int64) * nd + tab.dst.astype(np.int64)
            cand = np.unique(rng.integers(0, ns * nd, size=2 * k + 16,
                                          dtype=np.int64))
            cand = rng.permutation(cand[~np.isin(cand, have)])[:k]
            if cand.size != k:
                fail(f"draw_writes: fewer than {k} fresh pairs for {target}")
            arrays = ((cand // nd).astype(np.int32),
                      (cand % nd).astype(np.int32),
                      {a.name: rng.integers(0, a.card, size=k).astype(
                          np.int32) for a in tab.type.attrs})
        elif op == "delete":
            tab = scratch.relations[target]
            pick = rng.choice(tab.num_edges, size=k, replace=False)
            arrays = (tab.src[pick].copy(), tab.dst[pick].copy())
        else:
            tab = scratch.entities[target]
            attr = tab.type.attrs[int(rng.integers(len(tab.type.attrs)))]
            rows = rng.choice(tab.size, size=k, replace=False).astype(
                np.int32)
            arrays = (rows, {attr.name: rng.integers(
                0, attr.card, size=k).astype(np.int32)})
        detail = f".{attr.name}" if op == "attrs" else ""
        write = (f"{op} {k:,} {target}{detail}", op, target) + arrays
        apply_write(scratch, write)
        out.append(write)
    return out


def apply_write(db, write):
    """One write of :func:`draw_writes` to ``db``; the applied delta."""
    _, op, target, *arrays = write
    if op == "insert":
        return db.insert_facts(target, *arrays)
    if op == "delete":
        return db.delete_facts(target, *arrays)
    return db.update_attrs(target, *arrays)


def cache_diffs(a, b) -> list:
    """The resident keys where two strategies' caches differ: a key on one
    side only, another stamp or other axes, or any cell not equal bit for
    bit."""
    ca, cb = a.engine.cache, b.engine.cache
    ka, kb = ca.keys_snapshot(), cb.keys_snapshot()
    out = sorted(map(str, set(ka) ^ set(kb)))
    for key in set(ka) & set(kb):
        (ma, xa), (mb, xb) = (v if key[0] == "msg" else (v.counts, v.vars)
                              for v in (ca.peek(key), cb.peek(key)))
        if (ca.entry_meta(key) != cb.entry_meta(key)
                or tuple(xa) != tuple(xb)
                or not torch.equal(ma.cpu(), mb.cpu())):
            out.append(str(key))
    return out


def kernel_counts(ops) -> dict:
    """K1-K4 launches since the last ``reset_counts``, K1's and K2's by
    regime."""
    return dict(k1=ops.LAUNCHES["segsum_ones"],
                k2=ops.LAUNCHES["segsum_rows"], k3=ops.LAUNCHES["mobius"],
                k4=ops.LAUNCHES["bdeu"],
                k1_regimes=dict(ops.ONES_REGIMES),
                k2_regimes=dict(ops.ROW_REGIMES))


def check_no_plain(ops, label: str) -> None:
    if any(ops.PLAIN_CALLS[k] for k in ops.KERNELS):
        fail(f"{label}: plain versions ran on the card: {ops.PLAIN_CALLS}")


def prepared(name: str, db, lattice):
    """A fresh ``name`` strategy over the sparse executor on the card,
    prepared on ``db``: the recount side of :func:`recount_entries`."""
    from repro_torch.core import make_strategy
    fresh = make_strategy(name, executor="sparse")
    fresh.prepare(db, lattice)
    return fresh


def rediscovery(ops, db, strategy, name: str, label: str) -> dict:
    """13 (c). The search on the reconciled ``strategy`` over its lattice
    (``StructureSearch`` directly: ``discover_model`` would prepare a new
    engine and drop the reconciled cache), counted (K4 must launch, no
    plain version may run), against ``discover_model`` on a fresh strategy
    over the mutated store: edge for edge, except at points where a
    family's cells past 2^24 differ between the two, or whose climb
    inherits a differing sub-point's edges (printed with the edges each
    side alone has)."""
    from repro_torch.core import (LatticePoint, StructureSearch,
                                  discover_model, make_strategy)
    ops.reset_counts()
    sync()
    t0 = time.perf_counter()
    models = StructureSearch(db, strategy,
                             max_parents=DISCOVERY["max_parents"]).run(
        strategy.lattice)
    sync()
    wall = time.perf_counter() - t0
    launches = kernel_counts(ops)
    check_no_plain(ops, f"{label}: the search on the reconciled cache")
    if launches["k4"] <= 0:
        fail(f"{label}: the search after the writes launched no K4")
    t0 = time.perf_counter()
    fresh_models, fresh = discover_model(
        db, make_strategy(name, executor="sparse"), **DISCOVERY)
    sync()
    fresh_wall = time.perf_counter() - t0
    got, want = edges_of(models), edges_of(fresh_models)
    differ = sorted(p for p in set(got) | set(want)
                    if got.get(p) != want.get(p))
    if differ:
        out = recount_entries(strategy, fresh)
        rounded = {str(LatticePoint(key[1])) for key in out["rounded"]
                   if key[0] in ("fam", "complete")}
        # a point's climb starts from its sub-points' edges, so a sub-point
        # whose model differs explains the point's difference too
        why = {}
        for point in strategy.lattice:            # bottom-up
            p = str(point)
            subs = [str(q) for q in strategy.lattice
                    if q.rels < point.rels and str(q) in why]
            if p in differ and (p in rounded or subs):
                why[p] = ("a family rounded apart past 2^24 here"
                          if p in rounded else f"inherits from {subs}")
        for p in differ:
            a, b = set(got.get(p, ())), set(want.get(p, ()))
            log(f"  {label}: models differ at {p} "
                f"({why.get(p, 'unexplained')}): reconciled only "
                f"{sorted(a - b)}, fresh only {sorted(b - a)}")
        if set(differ) - set(why):
            fail(f"{label}: the reconciled search's models differ from a "
                 f"fresh discovery at {sorted(set(differ) - set(why))}, "
                 f"where no family's cells past 2^24 differ and no "
                 f"sub-point's model differs")
    if not all(np.isfinite(m.score) for m in models.values()):
        fail(f"{label}: a model of the reconciled search has a non-finite "
             f"score")
    return dict(search_s=wall, fresh_discover_s=fresh_wall,
                k4=launches["k4"], models_differ_at=differ)


def uw_mutations(ops) -> dict:
    """13 (d). UW at ``UW_SCALE``, every strategy over both executors,
    warmed by discovery on the card and on the CPU, then the same seeded
    interleaving of inserts, deletes and attribute writes (``UW_WRITES``)
    reconciled on both: equal ``DeltaReport``s, and every resident entry
    bit for bit equal between the card and the CPU after every write, and
    again once every point's full-axes family is asked for anew (UW's
    counts are below 2^24)."""
    import copy

    from repro_torch.core import (STRATEGIES, discover_model, make_strategy,
                                  paper_benchmark_db)
    uw = paper_benchmark_db("UW", seed=0, scale=UW_SCALE)
    writes = draw_writes(uw, UW_WRITES, MUTATION_SEED)
    out = {}
    for sname in sorted(STRATEGIES):
        for ex in ("sparse", "dense"):
            t0 = time.perf_counter()
            dbs = {"card": copy.deepcopy(uw), "cpu": copy.deepcopy(uw)}
            sts = {
                "card": discover_model(dbs["card"], make_strategy(
                    sname, executor=ex))[1],
                "cpu": discover_model(dbs["cpu"], make_strategy(
                    sname, executor=ex, device="cpu"), device="cpu")[1]}
            reports = []
            for write in writes:
                reps = {d: sts[d].apply_delta(apply_write(dbs[d], write))
                        .as_dict() for d in dbs}
                if reps["card"] != reps["cpu"]:
                    fail(f"UW {sname}/{ex}, {write[0]}: reports differ: "
                         f"{reps}")
                for when in ("reconciled", "asked again"):
                    diffs = cache_diffs(sts["card"], sts["cpu"])
                    if diffs:
                        fail(f"UW {sname}/{ex}, {write[0]} ({when}): card "
                             f"and CPU caches differ at "
                             f"{[d[:120] for d in diffs[:5]]}")
                    # every point's full-axes family once more on both, so
                    # that what the write invalidated is resident again
                    for st in sts.values():
                        for p in st.lattice:
                            st.family_ct(p, p.all_ct_vars(uw.schema))
                reports.append(reps["card"])
            out[f"{sname}/{ex}"] = dict(
                entries=len(sts["card"].engine.cache),
                updated=sum(r["updated"] for r in reports),
                invalidated=sum(r["invalidated"] for r in reports),
                seconds=time.perf_counter() - t0)
            log(f"UW {sname}/{ex}: {len(writes)} writes reconciled on the "
                f"card and the CPU, equal reports and caches bit for bit: "
                f"{json.dumps(out[f'{sname}/{ex}'])}")
    return out


def mutations_phase(ops) -> dict:
    """13. Writes and delta count maintenance on the card: (a)-(c) on the
    IMDb stand-in at ``IMDB_SCALE``, (d) on UW (module docstring)."""
    import copy
    import dataclasses

    from repro_torch.core import (discover_model, make_strategy,
                                  paper_benchmark_db)
    from torch.profiler import ProfilerActivity, profile
    t_phase = time.perf_counter()
    base = paper_benchmark_db("IMDb", seed=0, scale=IMDB_SCALE)
    writes = draw_writes(base, IMDB_WRITES, MUTATION_SEED)
    # (a) warm caches on copies of the store (phases 3 and 12 keep theirs);
    # one more HYBRID copy takes every write under torch.profiler (device
    # busy time), and one the first write with its sign flipped (the
    # planted fault)
    stores, warm = {}, {}
    for label in MUTATION_STRATEGIES + ("profiled", "planted"):
        stores[label] = copy.deepcopy(base)
        t0 = time.perf_counter()
        _, warm[label] = discover_model(
            stores[label], make_strategy(
                label if label in MUTATION_STRATEGIES else "HYBRID",
                executor="sparse"), **DISCOVERY)
        sync()
        log(f"mutations: {label} warmed on a copy of IMDb in "
            f"{time.perf_counter() - t0:.3f} s; cache "
            f"{json.dumps(warm[label].engine.cache.info())}")
    del base
    totals = {k: 0 for k in ("k1", "k2", "k3")}
    regimes = {"k1": {}, "k2": {}}
    by_write, busy, readings = {}, {}, []
    for i, write in enumerate(writes):
        wlabel = write[0]
        by_write[wlabel] = {}
        for name in MUTATION_STRATEGIES:
            st, db = warm[name], stores[name]
            delta = apply_write(db, write)
            ops.reset_counts()
            sync()
            t0 = time.perf_counter()
            report = st.apply_delta(delta)
            sync()
            wall = time.perf_counter() - t0
            launches = kernel_counts(ops)
            check_no_plain(ops, f"{name}, {wlabel}")
            for k in totals:
                totals[k] += launches[k]
            for k in regimes:
                for r, n in launches[f"{k}_regimes"].items():
                    regimes[k][r] = regimes[k].get(r, 0) + n
            by_write[wlabel][name] = {k: launches[k] for k in totals}
            if write[1] != "attrs":
                # apply_delta's default max_update_fraction: 0.25
                small = delta.num_edges <= 0.25 * db.relations[
                    write[2]].num_edges
                if small and report.invalidated:
                    fail(f"{name}, {wlabel}: a small fact delta invalidated "
                         f"{report.invalidated} entries")
                if not small and (report.updated or not report.invalidated):
                    fail(f"{name}, {wlabel}: a delta above "
                         f"max_update_fraction updated {report.updated} "
                         f"entries in place, invalidated "
                         f"{report.invalidated}")
            if i == 0 and name == "HYBRID" and (
                    launches["k1"] + launches["k2"] <= 0
                    or launches["k3"] <= 0 or report.updated <= 0):
                fail(f"{name}, {wlabel}: the reconciliation did not update "
                     f"in place through K1 or K2 and K3: {launches}")
            # (b) every resident entry against a recount on this store
            t0 = time.perf_counter()
            check = recount_entries(st, prepared(name, db, st.lattice))
            sync()
            recount_wall = time.perf_counter() - t0
            if check["low_differs"] or check["past_bound"]:
                fail(f"{name}, {wlabel}: resident entries differ from a "
                     f"recount: below 2^24 at "
                     f"{[str(k)[:120] for k in check['low_differs'][:5]]}, "
                     f"past 2^24 beyond {ROUNDING_PAST_2_24} at "
                     f"{[str(k)[:120] for k in check['past_bound'][:5]]}")
            reading = dict(
                write=wlabel, strategy=name, report=report.as_dict(),
                reconcile_s=wall, launches=launches,
                recount_s=recount_wall, entries_compared=check["entries"],
                rounded_past_2_24=len(check["rounded"]),
                worst_past_2_24=check["worst_past_2_24"])
            # (c) the search on the reconciled cache against a fresh one
            reading["rediscovery"] = rediscovery(ops, db, st, name,
                                                 f"{name}, {wlabel}")
            readings.append(reading)
            log(f"mutations: {name}, {wlabel}: "
                f"{json.dumps(report.as_dict())}; reconcile {wall:.4f} s; "
                f"K1 {launches['k1']} {launches['k1_regimes']}, K2 "
                f"{launches['k2']} {launches['k2_regimes']}, K3 "
                f"{launches['k3']}; recount of {check['entries']} entries "
                f"{recount_wall:.3f} s, equal below 2^24 ("
                f"{len(check['rounded'])} rounded apart past it, at most "
                f"{check['worst_past_2_24']} of a cell); rediscovery "
                f"{json.dumps(reading['rediscovery'])}")
        # device busy time of the same reconciliation on the profiled copy
        delta = apply_write(stores["profiled"], write)
        sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            warm["profiled"].apply_delta(delta)
            sync()
        on_card = device_events(prof)
        busy[wlabel] = (sum(e.self_device_time_total for e in on_card) / 1e3
                        if on_card else None)
        log(f"mutations: HYBRID, {wlabel}: device busy {busy[wlabel]} ms in "
            f"{sum(e.count for e in on_card)} device events (the profiled "
            f"copy)")
        if i == 0:
            # the planted fault: the same insert reconciled as a delete
            planted, db = warm.pop("planted"), stores.pop("planted")
            planted.apply_delta(dataclasses.replace(apply_write(db, write),
                                                    op="delete"))
            check = recount_entries(planted, prepared("HYBRID", db,
                                                      planted.lattice))
            if not check["low_differs"]:
                fail("mutations: the first write reconciled with its sign "
                     "flipped matches a recount below 2^24: the comparison "
                     "cannot fail")
            log(f"mutations: the planted fault (the insert reconciled as a "
                f"delete) is caught: {len(check['low_differs'])} of "
                f"{check['entries']} entries differ below 2^24")
            del planted, db
    del warm, stores
    uw = uw_mutations(ops)
    log(f"mutations phase: {time.perf_counter() - t_phase:.1f} s")
    return dict(readings=readings, launches=totals,
                launches_by_regime=regimes, by_write=by_write,
                hybrid_device_busy_ms=busy, uw=uw)


def memo_scores(dsvc) -> dict:
    """A discovery service's family scores under the version its last
    result settled on, by ``(child, parents)``."""
    token = dsvc._token
    return {fam: s for (tok, fam), s in dsvc._memo.items() if tok == token}


def family_tables(dsvc, csvc, fams) -> dict:
    """Each family's table as the counting service ``csvc`` serves it now,
    at the lattice point the family was scored at (its relation set,
    ``dsvc._deps``), by family: ``(point, table)``."""
    axes = {p: set(p.all_ct_vars(dsvc.schema, include_rind=True))
            for p in dsvc.lattice}
    out = {}
    for fam in fams:
        child, parents = fam
        keep = tuple(sorted(parents)) + (child,)
        point = next((p for p in dsvc.lattice
                      if p.rels == dsvc._deps.get(fam)
                      and set(keep) <= axes[p]), None)
        if point is None:
            fail(f"family {child} <- {sorted(map(str, parents))} was scored "
                 f"at no lattice point of its relations")
        out[fam] = (point, csvc.count_complete(point, keep))
    return out


def rescore(tables: dict, ess: float = 1.0) -> dict:
    """K4 on each family's table (``family_tables``), grouped by ``N_ijk``
    shape as the search groups them."""
    from repro_torch.core.bdeu import bdeu_score_batch, family_nijk
    groups = {}
    for fam, (_, tab) in tables.items():
        nijk = family_nijk(tab, fam[0])
        groups.setdefault(tuple(nijk.shape), []).append((fam, nijk))
    out = {}
    for members in groups.values():
        scores = bdeu_score_batch(torch.stack([n for _, n in members]),
                                  ess).cpu().numpy()
        out.update({fam: float(s) for (fam, _), s in zip(members, scores)})
    return out


def score_bound(nijk: torch.Tensor, ess: float = 1.0) -> float:
    """How far a float32 BDeu score of ``nijk`` may lie from another of the
    same counts: the discovery tests' ``atol + rtol |score|`` plus ``4 eps
    M`` (``M``: the magnitude of its lgamma terms, float64)."""
    n = nijk.double()
    q, r = n.shape
    a_j, a_jk = ess / q, ess / (q * r)
    lg = torch.lgamma
    row, cell = lg(n.sum(1) + a_j), lg(n + a_jk)
    c_j = torch.lgamma(torch.tensor(a_j, dtype=torch.float64))
    c_jk = torch.lgamma(torch.tensor(a_jk, dtype=torch.float64))
    exact = float((c_j - row + (cell - c_jk).sum(1)).sum())
    mag = float((c_j.abs() + row.abs()
                 + (cell.abs() + c_jk.abs()).sum(1)).sum())
    return SCORE_ATOL + SCORE_RTOL * abs(exact) + 4 * EPS32 * mag


def refresh_check(dsvc, csvc, fresh_dsvc, fresh_csvc) -> dict:
    """A refreshed discovery service (``dsvc`` over ``csvc``) against a
    fresh relearn of the same store (``fresh_dsvc`` over ``fresh_csvc``),
    family by family.  ``stale``: families whose refreshed score is not
    K4's score, bit for bit, of the table the service now holds (a score
    carried forward across a write to its relations); ``low_differs``:
    families scored by both whose scores differ where the relearn's table
    stays below 2^24 (its counts are exact there); ``past_bound``: those
    past 2^24 whose scores differ by more than ``score_bound``.  A correct
    refresh has none of the three.  ``tests/test_torch_discovery_service
    .py`` runs the same check on the CPU and shows that it fails on a
    refresh that names the wrong relation."""
    from repro_torch.core.bdeu import family_nijk
    got, want = memo_scores(dsvc), memo_scores(fresh_dsvc)
    now = rescore(family_tables(dsvc, csvc, got), dsvc.ess)
    stale = [fam for fam, s in got.items() if s != now[fam]]
    fresh = family_tables(fresh_dsvc, fresh_csvc, want)
    low, over, past, worst = [], [], 0, 0.0
    common = [fam for fam in want if fam in got]
    for fam in common:
        g, w = got[fam], want[fam]
        tab = fresh[fam][1]
        if float(tab.counts.abs().max()) < 2.0 ** 24:
            if g != w:
                low.append(fam)
            continue
        past += 1
        bound = score_bound(family_nijk(tab, fam[0]), dsvc.ess)
        worst = max(worst, abs(g - w) / bound)
        if abs(g - w) > bound:
            over.append(fam)
    return dict(families=len(got), compared=len(common),
                only_in_relearn=len(want) - len(common), stale=stale,
                low_differs=low, past_2_24=past, past_bound=over,
                worst_fraction_of_bound=worst)


def refresh_faults(check: dict) -> list:
    """The kinds of fault a :func:`refresh_check` found."""
    return [k for k in ("stale", "low_differs", "past_bound") if check[k]]


def refresh_summary(check: dict) -> dict:
    """A :func:`refresh_check` with its family lists as their lengths."""
    return {k: len(v) if isinstance(v, list) else v for k, v in check.items()}


def span_breakdown(records) -> dict:
    """Seconds and counts of a tracer's spans by name (spans nest: a
    batch's dispatch lies inside its ``service.exec`` span, and each
    query of a batch has an exec span of its own over the same time)."""
    out = {}
    for r in records:
        n, sec = out.get(r.name, (0, 0.0))
        out[r.name] = (n + 1, sec + r.duration_s)
    return {name: dict(count=n, seconds=sec)
            for name, (n, sec) in sorted(out.items())}


def exec_threads(tracer, label: str) -> dict:
    """The threads that ran the service's batches, by ``service.exec``
    span; fails unless the ring kept every span and ``build_trees`` nests
    every ``service.exec`` under a ``service.queue`` span."""
    from repro_torch.obs import build_trees
    snap = tracer.snapshot()
    if snap["dropped"]:
        fail(f"{label}: the tracer's ring dropped {snap['dropped']} spans")
    threads, orphans = {}, []

    def walk(node, parent):
        if node["name"] == "service.exec":
            threads[node["thread"]] = threads.get(node["thread"], 0) + 1
            if parent != "service.queue":
                orphans.append(node["span_id"])
        for child in node["children"]:
            walk(child, node["name"])

    for tree in build_trees(tracer.records()):
        for root in tree["roots"]:
            walk(root, None)
    if not threads or orphans:
        fail(f"{label}: {len(orphans)} of {sum(threads.values())} "
             f"service.exec spans have no service.queue parent")
    return threads


def explain_model_differences(label: str, lattice, got: dict, want: dict,
                              cache_a, cache_b) -> list:
    """The points where two discoveries' models (``edges_of``) differ must
    be points where a family table the two counting caches both hold
    differs past 2^24, or points whose climb inherits a differing
    sub-point's edges; printed with the edges each side alone has.  A
    family table that differs below 2^24 fails, as does any other
    difference."""
    from repro_torch.core import LatticePoint
    differ = sorted(p for p in set(got) | set(want)
                    if got.get(p) != want.get(p))
    if not differ:
        return differ
    rounded = set()
    for key in set(cache_a.keys_snapshot()) & set(cache_b.keys_snapshot()):
        if key[0] != "fam":
            continue
        a, b = cache_a.peek(key), cache_b.peek(key)
        rel, low = past_2_24(a.counts, b.counts.to(a.counts.device))
        if low:
            fail(f"{label}: family {[str(v) for v in key[2]]} of "
                 f"{LatticePoint(key[1])} differs below 2^24")
        if rel > 0.0:
            rounded.add(str(LatticePoint(key[1])))
    why = {}
    for point in lattice:                         # bottom-up
        p = str(point)
        subs = [str(q) for q in lattice if q.rels < point.rels
                and str(q) in why]
        if p in differ and (p in rounded or subs):
            why[p] = ("a family rounded apart past 2^24 here"
                      if p in rounded else f"inherits from {subs}")
    for p in differ:
        a, b = set(got.get(p, ())), set(want.get(p, ()))
        log(f"  {label}: models differ at {p} "
            f"({why.get(p, 'unexplained')}): this run only "
            f"{sorted(a - b)}, the other only {sorted(b - a)}")
    if set(differ) - set(why):
        fail(f"{label}: models differ at {sorted(set(differ) - set(why))}, "
             f"where no family's cells past 2^24 differ and no sub-point's "
             f"model differs")
    return differ


def run_clients(n: int, fn, label: str, timeout: float = 900.0) -> list:
    """``fn()`` on ``n`` threads released together; their results, in
    thread order.  Fails on an error or a thread still running after
    ``timeout`` seconds."""
    import threading
    barrier = threading.Barrier(n)
    results, errors = [None] * n, []

    def client(i):
        try:
            barrier.wait(60)
            results[i] = fn()
        except BaseException as e:                 # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,),
                                name=f"{label}-{i}") for i in range(n)]
    for t in threads:
        t.start()
    deadline = time.perf_counter() + timeout
    for t in threads:
        t.join(max(deadline - time.perf_counter(), 0.0))
    if any(t.is_alive() for t in threads):
        fail(f"{label}: a client thread still runs after {timeout} s")
    if errors:
        fail(f"{label}: {errors[0]!r}")
    return results


def served_phase(ops, hybrid: dict) -> dict:
    """14. Served discovery on the IMDb stand-in and on UW (module
    docstring); ``hybrid`` is phase 3's HYBRID run (its learned edges)."""
    import copy
    import threading

    from repro_torch.core import (CountingEngine, build_lattice,
                                  discover_model, make_strategy,
                                  paper_benchmark_db)
    from repro_torch.discover import DiscoveryService
    from repro_torch.obs import NULL_TRACER, Tracer
    from repro_torch.serve import CountingService
    from torch.profiler import ProfilerActivity, profile
    t_phase = time.perf_counter()
    base = paper_benchmark_db("IMDb", seed=0, scale=IMDB_SCALE)
    lattice = build_lattice(base.schema, DISCOVERY["max_chain_length"])
    (write,) = draw_writes(base, IMDB_WRITES[:1], MUTATION_SEED)
    services = []

    def service(db, tracer=NULL_TRACER, device=None):
        svc = CountingService(CountingEngine(db, "sparse", device=device),
                              max_wait_s=SERVED_MAX_WAIT_S, tracer=tracer)
        services.append(svc)
        return svc.start()

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t0

    def stats_line(svc) -> dict:
        st = svc.stats()
        return dict(
            {k: st[k] for k in ("requests", "complete_requests", "coalesced",
                                "cache_hits", "enqueued", "batches",
                                "batched_queries", "mobius_batches",
                                "flushes", "wait_flushes")},
            buckets=len(st["buckets"]),
            largest_batch=max((b["max_batch"] for b in st["buckets"]),
                              default=0),
            mean_batch=(st["batched_queries"] / st["batches"]
                        if st["batches"] else 0.0),
            **{f"{h}_{q}": st[h][f"{q}_s"]
               for h in ("queue_wait_hist", "bucket_exec_hist", "e2e_hist")
               for q in ("p50", "p95", "p99")})

    def edges_check(label, got, want_edges, cache_a, ref_cache_fn):
        if edges_of(got) == want_edges:
            return []
        return explain_model_differences(label, lattice, edges_of(got),
                                         want_edges, cache_a,
                                         ref_cache_fn())

    launches = {}

    # (a) one client, traced
    tracer = Tracer(capacity=SERVED_RING, slow_threshold_s=None)
    svc = service(copy.deepcopy(base), tracer)
    dsvc = svc.discovery(**DISCOVERY)
    ops.reset_counts()
    res, wall = timed(dsvc.discover)
    launches["a"] = kernel_counts(ops)
    check_no_plain(ops, "served discovery")
    if any(launches["a"][k] <= 0 for k in ("k1", "k2", "k3", "k4")):
        fail(f"served discovery: a kernel of its path was not launched: "
             f"{launches['a']}")
    if not all(np.isfinite(m.score) for m in res.models.values()):
        fail("served discovery: a learned model has a non-finite score")

    def hybrid_cache():
        _, ref = discover_model(copy.deepcopy(base), make_strategy(
            "HYBRID", executor="sparse"), **DISCOVERY)
        return ref.engine.cache

    differ_a = edges_check("served (a) against phase 3", res.models,
                           hybrid["edges"], svc.engine.cache, hybrid_cache)
    stats_a = stats_line(svc)
    spans = span_breakdown(tracer.records())
    threads_a = exec_threads(tracer, "served (a)")
    log(f"served (a) IMDb, one client: {wall:.3f} s wall on the card; "
        f"families scored {res.families_scored}, restarts {res.restarts}; "
        f"stats {json.dumps(stats_a)}; launches {json.dumps(launches['a'])}; "
        f"plain calls {sum(ops.PLAIN_CALLS.values())}; models "
        f"{'edge for edge phase 3' if not differ_a else f'differ at {differ_a}'}")
    log(f"served (a) host spans (seconds, count): " + json.dumps(
        {k: [round(v['seconds'], 6), v['count']] for k, v in spans.items()}))
    log(f"served (a) service.exec spans by thread: {json.dumps(threads_a)}")
    svc.set_tracer(NULL_TRACER)
    dsvc.tracer = NULL_TRACER
    tracer.clear()
    svc_u = service(copy.deepcopy(base))
    _, wall_untraced = timed(svc_u.discovery(**DISCOVERY).discover)
    svc_p = service(copy.deepcopy(base))
    sync()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        svc_p.discovery(**DISCOVERY).discover()
        sync()
    wall_profiled = time.perf_counter() - t0
    on_card = device_events(prof)
    busy = (sum(e.self_device_time_total for e in on_card) / 1e6
            if on_card else None)
    log(f"served (a) untraced copy: {wall_untraced:.3f} s wall; profiled "
        f"copy: {wall_profiled:.3f} s wall, device busy "
        + (f"{busy:.4f} s ({100 * busy / wall_profiled:.2f} %)"
           if busy is not None else "not measured (no device events)")
        + f" in {sum(e.count for e in on_card)} device events")
    for e in sorted(on_card, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<6d} "
            f"{e.key[:100]}")
    for extra in (svc_u, svc_p):
        extra.shutdown(timeout=60)
    del svc_u, svc_p, prof

    # (b) concurrent clients, cold and then warm
    tracer_b = Tracer(capacity=SERVED_RING, slow_threshold_s=None)
    svc_b = service(copy.deepcopy(base), tracer_b)
    dsvc_b = svc_b.discovery(**DISCOVERY)
    ops.reset_counts()
    walls_b = {}
    switch = sys.getswitchinterval()
    sys.setswitchinterval(SERVED_SWITCH_S)
    try:
        runs = {when: timed(lambda: run_clients(
            SERVED_CLIENTS, dsvc_b.discover, f"served (b) {when}"))
            for when in ("cold", "warm")}
    finally:
        sys.setswitchinterval(switch)
    for when, (results, walls_b[when]) in runs.items():
        sigs = {json.dumps(r.signature(), sort_keys=True) for r in results}
        versions = {r.version for r in results}
        if len(sigs) != 1 or len(versions) != 1:
            fail(f"served (b) {when}: {len(sigs)} signatures and "
                 f"{len(versions)} versions among {SERVED_CLIENTS} clients")
        if results[0].signature() != res.signature():
            fail(f"served (b) {when}: the clients' models differ from (a)'s")
    launches["b"] = kernel_counts(ops)
    check_no_plain(ops, "served (b)")
    stats_b = stats_line(svc_b)
    threads_b = exec_threads(tracer_b, "served (b)")
    if stats_b["coalesced"] <= 0:
        fail(f"served (b): no query coalesced among {SERVED_CLIENTS} clients")
    log(f"served (b) {SERVED_CLIENTS} clients at once: cold "
        f"{walls_b['cold']:.3f} s, warm {walls_b['warm']:.3f} s wall; one "
        f"signature and version, (a)'s; stats {json.dumps(stats_b)}; "
        f"launches {json.dumps(launches['b'])}; service.exec spans by "
        f"thread {json.dumps(threads_b)}")
    svc_b.set_tracer(NULL_TRACER)
    dsvc_b.tracer = NULL_TRACER
    del tracer_b

    # (c) a fenced write and refresh, the planted fault, then a writer
    # racing two searchers
    ops.reset_counts()
    report, write_wall = timed(lambda: svc.insert_facts(write[2],
                                                        *write[3:]))
    rep, refresh_wall = timed(lambda: dsvc.refresh(write[2]))
    if not (rep.retained > 0 and rep.rescored < rep.total_families):
        fail(f"served (c): refresh retained {rep.retained} and rescored "
             f"{rep.rescored} of {rep.total_families} families")
    svc_f = service(copy.deepcopy(svc.engine.db))
    dsvc_f = svc_f.discovery(**DISCOVERY)
    fresh, relearn_wall = timed(dsvc_f.discover)
    differ_c = edges_check("served (c) refresh against a relearn",
                           rep.result.models, edges_of(fresh.models),
                           svc.engine.cache, lambda: svc_f.engine.cache)
    check = refresh_check(dsvc, svc, dsvc_f, svc_f)
    if refresh_faults(check):
        fail(f"served (c): the refreshed scores fail the check at "
             f"{refresh_faults(check)}: {json.dumps(refresh_summary(check))}")
    svc_b.insert_facts(write[2], *write[3:])
    dsvc_b.refresh("imdb_R1")                    # names the wrong relation
    planted = refresh_check(dsvc_b, svc_b, dsvc_f, svc_f)
    if not refresh_faults(planted):
        fail("served (c): a refresh naming the wrong relation passes the "
             "refresh check: it cannot fail")
    launches["c_refresh"] = kernel_counts(ops)
    check_no_plain(ops, "served (c)")
    log(f"served (c) {write[0]}: write {write_wall:.4f} s "
        f"({json.dumps(report.as_dict())}); refresh {refresh_wall:.3f} s "
        f"(rescored {rep.rescored}, retained {rep.retained} of "
        f"{rep.total_families}) against a fresh relearn {relearn_wall:.3f} s; "
        f"models {'edge for edge' if not differ_c else f'differ at {differ_c}'}; "
        f"scores {json.dumps(refresh_summary(check))}; the planted refresh "
        f"(naming imdb_R1) fails at {refresh_faults(planted)}: "
        f"{json.dumps(refresh_summary(planted))}")
    for extra in (svc_b, svc_f):
        extra.shutdown(timeout=60)
    del svc_b, dsvc_b, svc_f, dsvc_f

    more = draw_writes(svc.engine.db, SERVED_WRITES, MUTATION_SEED + 1)
    stop, finals, errors, rounds = threading.Event(), {}, [], {}

    def writer():
        try:
            for w in more:
                svc.insert_facts(w[2], *w[3:])
                time.sleep(0.05)
        except BaseException as e:                 # noqa: BLE001
            errors.append(e)
        finally:
            stop.set()

    def searcher(name):
        try:
            n = 0
            while not stop.is_set():
                dsvc.discover()
                n += 1
            finals[name] = dsvc.discover()
            rounds[name] = n + 1
        except BaseException as e:                 # noqa: BLE001
            errors.append(e)
            stop.set()

    ops.reset_counts()
    threads = [threading.Thread(target=writer, name="served-writer")]
    threads += [threading.Thread(target=searcher, args=(f"s{i}",),
                                 name=f"served-searcher-{i}")
                for i in range(SERVED_SEARCHERS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    race_wall = time.perf_counter() - t0
    if errors:
        fail(f"served (c) writer and searchers: {errors[0]!r}")
    if any(t.is_alive() for t in threads):
        fail("served (c) writer and searchers: a thread still runs")
    launches["c_race"] = kernel_counts(ops)
    check_no_plain(ops, "served (c) race")
    outs = list(finals.values())
    if len({r.version for r in outs}) != 1 or len(
            {json.dumps(r.signature(), sort_keys=True) for r in outs}) != 1:
        fail("served (c): the searchers' final results differ in version "
             "or signature")
    svc_g = service(copy.deepcopy(svc.engine.db))
    final = svc_g.discovery(**DISCOVERY).discover()
    differ_race = edges_check("served (c) race against a relearn",
                              outs[0].models, edges_of(final.models),
                              svc.engine.cache, lambda: svc_g.engine.cache)
    log(f"served (c) {len(more)} fenced inserts racing {SERVED_SEARCHERS} "
        f"searchers: {race_wall:.3f} s; discoveries per searcher "
        f"{json.dumps(rounds)}; final version {outs[0].version}, restarts "
        f"{[r.restarts for r in outs]}; models against a relearn of the "
        f"final store: "
        f"{'edge for edge' if not differ_race else f'differ at {differ_race}'}"
        f"; discovery stats {json.dumps(svc.stats()['discovery'])}")
    svc_g.shutdown(timeout=60)
    del svc_g

    # (d) UW: the card against the CPU, and served against local
    ops.reset_counts()
    uw = paper_benchmark_db("UW", seed=0, scale=UW_SCALE)
    (uw_write,) = draw_writes(uw, UW_WRITES[:1], MUTATION_SEED)
    uw_runs = {}
    for dev in ("card", "cpu"):
        s = service(copy.deepcopy(uw), device=None if dev == "card"
                    else "cpu")
        d = s.discovery(**DISCOVERY)
        first = d.discover()
        s.insert_facts(uw_write[2], *uw_write[3:])
        r = d.refresh(uw_write[2])
        uw_runs[dev] = (first, r)
        s.shutdown(timeout=60)
    for i, label in enumerate(("discovery", "refresh")):
        a, b = (uw_runs[d][i] if i == 0 else uw_runs[d][i].result
                for d in ("card", "cpu"))
        if a.signature() != b.signature() or a.score != b.score:
            fail(f"served (d) UW {label}: card and CPU differ (scores "
                 f"{a.score!r}, {b.score!r})")
    counts = {d: (r.rescored, r.retained, r.total_families)
              for d, (_, r) in uw_runs.items()}
    if counts["card"] != counts["cpu"]:
        fail(f"served (d) UW refresh counts differ: {counts}")
    local = DiscoveryService(make_strategy("HYBRID", executor="sparse"),
                             db=copy.deepcopy(uw), **DISCOVERY).discover()
    if local.signature() != uw_runs["card"][0].signature():
        fail("served (d) UW: served and local discovery differ on the card")
    launches["d"] = kernel_counts(ops)
    log(f"served (d) UW: card and CPU equal bit for bit (score "
        f"{uw_runs['card'][0].score!r}; after {uw_write[0]} "
        f"{uw_runs['card'][1].result.score!r}, rescored/retained/total "
        f"{counts['card']}); local HYBRID {local.score!r}, the same "
        f"signature")
    for s in services:
        s.shutdown(timeout=60)
        if s.running:
            fail("served: a dispatcher thread outlived its shutdown")
    log(f"served phase: {time.perf_counter() - t_phase:.1f} s")
    return dict(
        launches=launches, wall_s=wall, wall_untraced_s=wall_untraced,
        wall_profiled_s=wall_profiled, device_busy_s=busy,
        stats=stats_a, spans=spans, exec_threads=threads_a,
        clients=dict(walls_s=walls_b, stats=stats_b),
        refresh=dict(refresh_s=refresh_wall, relearn_s=relearn_wall,
                     rescored=rep.rescored, retained=rep.retained,
                     total_families=rep.total_families,
                     check=refresh_summary(check),
                     planted=refresh_summary(planted)),
        race=dict(seconds=race_wall, discoveries=rounds),
        models_differ_at=dict(a=differ_a, c=differ_c, race=differ_race),
        signature=res.signature(), score=res.score,
        edges=edges_of(res.models))


def table_faults(got: list, want: list) -> dict:
    """Two lists of aligned tables, table by table: the tables whose axes
    differ or whose cells below 2^24 differ (``low_differs``: counts there
    are exact), those whose cells past 2^24 differ at all (``rounded``) and
    by more than ``ROUNDING_PAST_2_24`` of a cell (``past_bound``), the
    largest such relative difference, and the largest cell."""
    low, rounded, high, worst, top = [], [], [], 0.0, 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        if tuple(a.vars) != tuple(b.vars) or a.counts.shape != b.counts.shape:
            low.append(i)
            continue
        rel, differs_low = past_2_24(a.counts, b.counts.to(a.counts.device))
        if differs_low:
            low.append(i)
        if rel > 0.0:
            rounded.append(i)
        if rel > ROUNDING_PAST_2_24:
            high.append(i)
        worst = max(worst, rel)
        top = max(top, float(a.counts.abs().max()))
    if len(got) != len(want):
        low.append(len(got))
    return dict(tables=len(got), low_differs=low, rounded=rounded,
                past_bound=high, worst_past_2_24=worst, largest_cell=top)


def table_summary(check: dict) -> dict:
    """A :func:`table_faults` (or :func:`recount_shards`) result with its
    lists as their lengths."""
    return {k: len(v) if isinstance(v, list) else v for k, v in check.items()}


def merged_positives(router, engine) -> dict:
    """Every merged positive table in ``router``'s result cache against
    ``engine`` (the single database's) counting the same query: bit for
    bit while the largest merged cell stays below 2^24 (counts are exact
    there and a sum of shard tables in any order is exact), by
    :func:`table_faults`' rule past it."""
    from repro_torch.core import LatticePoint
    with router._lock:
        items = [(k, t) for k, t in router._results.items()
                 if k[0] != "complete"]
    got = [t for _, t in items]
    want = [engine.contract(LatticePoint(k[0]), k[1]) for k, _ in items]
    check = table_faults(got, want)
    exact = check["largest_cell"] < 2.0 ** 24
    check["rule"] = "bit for bit" if exact else "2^-18 past 2^24"
    if exact and (check["low_differs"] or check["rounded"]):
        fail(f"merged positives: {table_summary(check)} differ from the "
             f"single database's below 2^24")
    return check


def misplaced_edges(sdb) -> int:
    """Partitioned edges that live on another shard than their root id
    hashes to (the class's own hash, whatever an instance was patched
    with)."""
    from repro_torch.core import ShardedDatabase
    bad = 0
    for rel in sdb.partitioned:
        for s, shard in enumerate(sdb.shards):
            tab = shard.relations[rel]
            ids = tab.src if tab.type.src == sdb.root_etype else tab.dst
            bad += int((ShardedDatabase.shard_of_ids(sdb, ids) != s).sum())
    return bad


def recount_shards(router) -> dict:
    """Every resident ``"pos"`` entry of every shard's cache against a
    fresh engine's recount on that shard's store (``recount_entries``'
    rule), summed over the shards."""
    from types import SimpleNamespace
    from repro_torch.core import CountingEngine
    out = dict(entries=0, low_differs=[], rounded=[], past_bound=[],
               worst_past_2_24=0.0)
    for s, eng in enumerate(router.engines):
        fresh = SimpleNamespace(engine=CountingEngine(eng.db, "sparse",
                                                      device=eng.device))
        r = recount_entries(SimpleNamespace(engine=eng), fresh)
        out["entries"] += r["entries"]
        for k in ("low_differs", "rounded", "past_bound"):
            out[k] += [(s, key) for key in r[k]]
        out["worst_past_2_24"] = max(out["worst_past_2_24"],
                                     r["worst_past_2_24"])
    return out


def write_check(router, queries, want) -> dict:
    """A written router against the single database with the same writes:
    partitioned edges on their own shards, every resident shard entry
    equal to a recount of its shard's store, and the router's complete
    tables over ``queries`` against ``want`` (the single database's) by
    :func:`table_faults`' rule.  ``faults`` names what failed."""
    router.invalidate()
    check = dict(misplaced=misplaced_edges(router.sdb),
                 recount=table_summary(recount_shards(router)),
                 merged=table_summary(table_faults(
                     router.complete_many(queries), want)))
    check["faults"] = [k for k, bad in (
        ("misplaced", check["misplaced"]),
        ("recount", check["recount"]["low_differs"]
         or check["recount"]["past_bound"]),
        ("merged", check["merged"]["low_differs"]
         or check["merged"]["past_bound"])) if bad]
    return check


def count_fallbacks(router) -> list:
    """Spy on ``router``'s drained flushes that fall back to the shard
    services (queues that do not align for a fused evaluation): a list
    that gains each fallback's number of entries."""
    seen, inner = [], router._execute_drained

    def execute_drained(services, drained):
        seen.append(sum(map(len, drained)))
        return inner(services, drained)
    router._execute_drained = execute_drained
    return seen


def copies_to_card(on_card) -> dict:
    """Host-to-device copies in a trace's device events: count and ms."""
    hd = [e for e in on_card if "HtoD" in e.key]
    return dict(count=sum(e.count for e in hd),
                ms=sum(e.self_device_time_total for e in hd) / 1e3)


def complete_queries(schema, lattice) -> list:
    """Each point's complete table over its entity attributes and
    indicators (the butterfly: K3) and over every axis (edge attributes
    too: the blockwise negative phase): phase 15 (a)'s and 16 (d)'s."""
    queries = [(p, tuple(v for v in p.all_ct_vars(schema, include_rind=True)
                         if v.kind != "edge")) for p in lattice]
    return queries + [(p, None) for p in lattice]


def sharded_phase(ops, served: dict) -> dict:
    """15. IMDb served from ``SHARDS`` shards, writes, a rebalance and a
    tenant registry (module docstring); ``served`` is phase 14's result
    (its one-client models)."""
    import copy

    from repro_torch.core import (CountingEngine, build_lattice,
                                  paper_benchmark_db, shard_database)
    from repro_torch.obs import NULL_TRACER, Tracer
    from repro_torch.serve import (CountingRouter, CountingService,
                                   TenantRegistry)
    from torch.profiler import ProfilerActivity, profile
    t_phase = time.perf_counter()
    base = paper_benchmark_db("IMDb", seed=0, scale=IMDB_SCALE)
    lattice = build_lattice(base.schema, DISCOVERY["max_chain_length"])
    queries = complete_queries(base.schema, lattice)
    routers, launches = [], {}

    def new_router(db, **kw):
        r = CountingRouter(shard_database(db, SHARDS), executor="sparse",
                           **kw)
        routers.append(r)
        return r

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t0

    def need(step: str, kernels) -> None:
        check_no_plain(ops, f"sharded ({step})")
        got = kernel_counts(ops)
        launches[step] = got
        if any(got[k] <= 0 for k in kernels):
            fail(f"sharded ({step}): a kernel of its path was not launched: "
                 f"{got}")

    def same_models(label, res) -> None:
        if res.signature() != served["signature"] or \
                res.score != served["score"]:
            differ = sorted(p for p in set(edges_of(res.models))
                            | set(served["edges"])
                            if edges_of(res.models).get(p)
                            != served["edges"].get(p))
            fail(f"sharded {label}: models differ from phase 14's served "
                 f"models at {differ} (scores {res.score!r}, "
                 f"{served['score']!r})")

    def router_line(r) -> dict:
        st = r.stats()["router"]
        return {k: st[k] for k in (
            "requests", "fanout_requests", "single_shard_requests",
            "complete_requests", "cache_hits", "coalesced", "merged_tables",
            "fused_dispatches", "device_merges", "partial_merges",
            "not_routable", "deltas", "rebalances")}

    # (a) the router's complete tables against the single database's
    router = new_router(copy.deepcopy(base))
    log(f"sharded: IMDb in {SHARDS} shards: root {router.sdb.root_etype}, "
        f"partitioned {sorted(router.sdb.partitioned)}; partitioned rows "
        f"by shard {[router.sdb.partitioned_rows(s) for s in range(SHARDS)]}")
    fallbacks = count_fallbacks(router)
    ops.reset_counts()
    tabs_a, wall_a = timed(lambda: router.complete_many(queries))
    need("a", ("k1", "k2", "k3"))
    single = CountingService(CountingEngine(copy.deepcopy(base), "sparse"))
    want_a, wall_single = timed(lambda: single.complete_many(queries))
    check_a = table_faults(tabs_a, want_a)
    if check_a["low_differs"] or check_a["past_bound"]:
        fail(f"sharded (a): complete tables differ from the single "
             f"database's: {table_summary(check_a)}")
    pos_a = merged_positives(router, single.engine)
    if pos_a["low_differs"] or pos_a["past_bound"]:
        fail(f"sharded (a): merged positives differ from the single "
             f"database's: {table_summary(pos_a)}")
    counters_a = router_line(router)
    log(f"sharded (a) complete_many of {len(queries)} tables: "
        f"{wall_a:.3f} s through the router, {wall_single:.3f} s on the "
        f"single database; complete tables "
        f"{json.dumps(table_summary(check_a))}; merged positives "
        f"({pos_a['rule']}, largest cell {pos_a['largest_cell']:.0f}) "
        f"{json.dumps(table_summary(pos_a))}; router "
        f"{json.dumps(counters_a)}; fused flush groups "
        f"{counters_a['fused_dispatches']}, flushes that fell back to the "
        f"shard services {len(fallbacks)} ({sum(fallbacks)} entries); "
        f"launches {json.dumps(launches['a'])}")
    single.shutdown(timeout=60)

    # (b) router discovery: untraced, traced, profiled
    r_u = new_router(copy.deepcopy(base))
    fallbacks_b = count_fallbacks(r_u)
    ops.reset_counts()
    res_u, wall_u = timed(r_u.discovery(**DISCOVERY).discover)
    need("b", ("k1", "k2", "k3", "k4"))
    same_models("(b) untraced", res_u)
    tracer = Tracer(capacity=SERVED_RING, slow_threshold_s=None)
    r_t = new_router(copy.deepcopy(base), tracer=tracer)
    res_t, wall_t = timed(r_t.discovery(**DISCOVERY).discover)
    same_models("(b) traced", res_t)
    if tracer.snapshot()["dropped"]:
        fail("sharded (b): the tracer's ring dropped spans")
    spans = span_breakdown(tracer.records())
    r_t.set_tracer(NULL_TRACER)
    del tracer
    r_p = new_router(copy.deepcopy(base))
    sync()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res_p = r_p.discovery(**DISCOVERY).discover()
        sync()
    wall_p = time.perf_counter() - t0
    same_models("(b) profiled", res_p)
    on_card = device_events(prof)
    busy = (sum(e.self_device_time_total for e in on_card) / 1e6
            if on_card else None)
    copies = copies_to_card(on_card)
    counters_b = router_line(r_u)
    log(f"sharded (b) router discovery: {wall_u:.3f} s untraced, "
        f"{wall_t:.3f} s traced; families scored {res_u.families_scored}, "
        f"restarts {res_u.restarts}; models edge for edge phase 14's "
        f"served models, score {res_u.score!r}; router "
        f"{json.dumps(counters_b)}; fused flush groups "
        f"{counters_b['fused_dispatches']}, flushes that fell back to the "
        f"shard services {len(fallbacks_b)} ({sum(fallbacks_b)} entries); "
        f"shard services "
        f"{json.dumps({k: r_u.stats()['aggregate'][k] for k in ('requests', 'cache_hits', 'batches', 'batched_queries')})}"
        f"; launches {json.dumps(launches['b'])}")
    log(f"sharded (b) profiled copy: {wall_p:.3f} s wall, device busy "
        + (f"{busy:.4f} s ({100 * busy / wall_p:.2f} % of it, "
           f"{100 * busy / wall_u:.2f} % of the untraced wall)"
           if busy is not None else "not measured (no device events)")
        + f" in {sum(e.count for e in on_card)} device events; "
          f"host-to-device copies {copies['count']}, {copies['ms']:.3f} ms")
    for e in sorted(on_card, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<6d} "
            f"{e.key[:100]}")
    top = sorted(spans.items(), key=lambda kv: -kv[1]["seconds"])[:10]
    log(f"sharded (b) host spans (seconds, count): " + json.dumps(
        {k: [round(v['seconds'], 6), v['count']] for k, v in top}))
    del prof, on_card

    # (c) a partitioned and a shared-relation insert, refresh, recount
    writes = draw_writes(base, SHARDED_WRITES, MUTATION_SEED + 2)
    written = copy.deepcopy(base)
    for w in writes:
        apply_write(written, w)
    single_w = CountingService(CountingEngine(copy.deepcopy(written),
                                              "sparse"))
    want_c = single_w.complete_many(queries)
    single_w.shutdown(timeout=60)
    r_w = new_router(copy.deepcopy(base))
    d_w = r_w.discovery(**DISCOVERY)
    d_w.discover()
    ops.reset_counts()
    reports, write_wall = timed(lambda: [r_w.insert_facts(w[2], *w[3:])
                                         for w in writes])
    rep, refresh_wall = timed(lambda: d_w.refresh([w[2] for w in writes]))
    need("c", ("k1", "k2", "k4"))
    r_f = new_router(copy.deepcopy(written))
    d_f = r_f.discovery(**DISCOVERY)
    fresh, relearn_wall = timed(d_f.discover)
    if rep.result.signature() != fresh.signature() or \
            rep.result.score != fresh.score:
        fail(f"sharded (c): the refreshed models differ from a fresh router "
             f"discovery on the written store (scores {rep.result.score!r}, "
             f"{fresh.score!r})")
    scores = refresh_check(d_w, r_w, d_f, r_f)
    if refresh_faults(scores):
        fail(f"sharded (c): the refreshed scores fail the check at "
             f"{refresh_faults(scores)}: {json.dumps(refresh_summary(scores))}")
    check_c = write_check(r_w, queries, want_c)
    if check_c["faults"]:
        fail(f"sharded (c): the written router fails the write check at "
             f"{check_c['faults']}: {json.dumps(check_c)}")
    # the planted fault: the partitioned insert routed one shard over
    r_x = new_router(copy.deepcopy(base))
    r_x.complete_many(queries)                   # warm shard caches
    right = r_x.sdb.shard_of_ids
    r_x.sdb.shard_of_ids = lambda ids: (right(ids) + 1) % SHARDS
    r_x.insert_facts(writes[0][2], *writes[0][3:])
    del r_x.sdb.shard_of_ids
    for w in writes[1:]:
        r_x.insert_facts(w[2], *w[3:])
    planted = write_check(r_x, queries, want_c)
    if "merged" not in planted["faults"]:
        fail(f"sharded (c): a partitioned insert routed to the wrong shard "
             f"passes the write check: {json.dumps(planted)}")
    touched = {w[0]: [s for s, r in enumerate(reps) if r is not None]
               for w, reps in zip(writes, reports)}
    log(f"sharded (c) {' and '.join(w[0] for w in writes)} through the "
        f"router: {write_wall:.4f} s (shards reconciled {json.dumps(touched)}"
        f"); refresh {refresh_wall:.3f} s (rescored {rep.rescored}, "
        f"retained {rep.retained} of {rep.total_families}) against a fresh "
        f"router's discovery {relearn_wall:.3f} s: the same models and "
        f"score; scores {json.dumps(refresh_summary(scores))}; write check "
        f"{json.dumps(check_c)}; the planted misroute fails it at "
        f"{planted['faults']}: {json.dumps(planted)}; launches "
        f"{json.dumps(launches['c'])}")

    # (d) rebalance (a)'s router: split the shard with the most rows
    sizes = [router.sdb.partitioned_rows(s) for s in range(SHARDS)]
    hot = int(np.argmax(sizes))
    kept = {s: (router.engines[s],
                {k: router.engines[s].cache.peek(k)
                 for k in router.engines[s].cache.keys_snapshot()},
                router.engines[s].stats.joins)
            for s in range(SHARDS) if s != hot}
    ops.reset_counts()
    new_shard, split_wall = timed(lambda: router.rebalance(hot))
    tabs_d, wall_d = timed(lambda: router.complete_many(queries))
    need("d", ("k1", "k2", "k3"))
    for i, (a, d) in enumerate(zip(tabs_a, tabs_d)):
        if a.vars != d.vars or not torch.equal(a.counts, d.counts):
            fail(f"sharded (d): after the split, complete table {i} "
                 f"({queries[i][0]}) differs from (a)'s")
    # kept, not counted again: the same table objects, still resident
    for s, (eng, entries, joins) in kept.items():
        lost = [k for k, v in entries.items() if eng.cache.peek(k) is not v]
        if router.engines[s] is not eng or lost:
            fail(f"sharded (d): untouched shard {s} lost or recounted "
                 f"{len(lost)} of its {len(entries)} cache entries")
    log(f"sharded (d) split shard {hot} (partitioned rows {sizes}) into "
        f"{hot} and {new_shard}: {split_wall:.4f} s; the {len(queries)} "
        f"complete tables again in {wall_d:.3f} s, equal to (a)'s bit for "
        f"bit; the {len(kept)} untouched shards kept their "
        f"{sum(len(k) for _, k, _ in kept.values())} entries (joins since, "
        f"for single-shard queries now routed there: "
        f"{[eng.stats.joins - j for eng, _, j in kept.values()]}); rows now "
        f"{[router.sdb.partitioned_rows(s) for s in range(router.n_shards)]}"
        f"; launches {json.dumps(launches['d'])}")

    # (e) tenancy: two IMDb tenants of one shape, UW, UW in shards
    uw = paper_benchmark_db("UW", seed=0, scale=UW_SCALE)
    tenants = {"imdb0": copy.deepcopy(base),
               "imdb1": paper_benchmark_db("IMDb", seed=1,
                                           scale=IMDB_SCALE),
               "uw": copy.deepcopy(uw),
               "uw_sharded": shard_database(copy.deepcopy(uw),
                                            TENANT_UW_SHARDS)}
    lattices = {t: build_lattice(db.schema, DISCOVERY["max_chain_length"])
                for t, db in tenants.items()}
    tq = [(t, p, None) for t in tenants for p in lattices[t]]
    reg = TenantRegistry(executor="sparse")
    for t, db in tenants.items():
        reg.add_tenant(t, db)
    ops.reset_counts()
    tabs_e, wall_e = timed(lambda: reg.count_many(tq))
    need("e", ("k1", "k2"))
    fused = launches["e"]["k1"] + launches["e"]["k2"]
    serial, wall_serial, alone = 0, 0.0, []
    for t, db in tenants.items():
        qs = [(p, None) for p in lattices[t]]
        fe = (CountingRouter(shard_database(copy.deepcopy(uw),
                                            TENANT_UW_SHARDS),
                             executor="sparse")
              if t == "uw_sharded" else CountingService(CountingEngine(
                  copy.deepcopy(uw if t == "uw" else db), "sparse")))
        ops.reset_counts()
        got, dt = timed(lambda: fe.count_many(qs))
        check_no_plain(ops, f"sharded (e) {t} alone")
        counts = kernel_counts(ops)
        serial += counts["k1"] + counts["k2"]
        wall_serial += dt
        alone += got
        fe.shutdown(timeout=60)
    for i, (a, b) in enumerate(zip(tabs_e, alone)):
        if a.vars != b.vars or not torch.equal(a.counts, b.counts):
            fail(f"sharded (e): tenant table {i} ({tq[i][0]}, "
                 f"{tq[i][1]}) differs from its service alone")
    if not fused < serial:
        fail(f"sharded (e): cross-tenant dispatch launched {fused} K1+K2 "
             f"kernels, the tenants one after another {serial}")
    floor_t, flood_t = "imdb1", "imdb0"
    floor = reg.cache.tenants_info()[floor_t]["nbytes"]
    reg.set_tenant_budget(floor_t, reserved_bytes=floor)
    reg.cache.budget_bytes = floor + floor // 2
    flood_q = [(flood_t, p, None) for p in lattices[flood_t]]
    for _ in range(2):
        reg.tenant(flood_t).service.engine.cache.invalidate()
        reg.count_many(flood_q)
    info = reg.cache.tenants_info()
    if reg.cache.evictions <= 0 or info[floor_t]["nbytes"] < floor:
        fail(f"sharded (e): under a budget of {reg.cache.budget_bytes} B "
             f"the flood evicted {reg.cache.evictions} entries and left "
             f"{info[floor_t]['nbytes']} B of {floor_t}'s reserved {floor}")
    log(f"sharded (e) registry of {len(tenants)} tenants ({len(tq)} "
        f"queries): {wall_e:.3f} s and {fused} K1+K2 launches at once "
        f"against {wall_serial:.3f} s and {serial} one tenant after "
        f"another; every table bit for bit its own service's; under a "
        f"{reg.cache.budget_bytes} B budget {flood_t}'s flood evicted "
        f"{reg.cache.evictions} entries and left {floor_t} "
        f"{info[floor_t]['nbytes']} B of its reserved {floor}; launches "
        f"{json.dumps(launches['e'])}")
    reg.shutdown()
    del reg, tenants, tabs_e, alone

    # (f) UW: router and registry on the card against the CPU
    ops.reset_counts()
    uw_runs = {}
    for dev in ("card", "cpu"):
        device = None if dev == "card" else "cpu"
        r = CountingRouter(shard_database(copy.deepcopy(uw),
                                          TENANT_UW_SHARDS),
                           executor="sparse", device=device)
        uq = [(p, None) for p in build_lattice(uw.schema,
                                               DISCOVERY["max_chain_length"])]
        tabs = r.complete_many(uq)
        res = r.discovery(**DISCOVERY).discover()
        reg = TenantRegistry(executor="sparse", device=device)
        reg.add_tenant("uw0", copy.deepcopy(uw))
        reg.add_tenant("uw1", paper_benchmark_db("UW", seed=1,
                                                 scale=UW_SCALE))
        tabs += reg.count_many([(t, p, None) for t in ("uw0", "uw1")
                                for p, _ in uq])
        res_r = reg.discovery("uw1", **DISCOVERY).discover()
        uw_runs[dev] = ([t.counts.cpu() for t in tabs], res, res_r)
        r.shutdown(timeout=60)
        reg.shutdown()
        if dev == "card":              # the CPU half runs the plain versions
            need("f", ("k1", "k2", "k3", "k4"))
    (ct, cres, crr), (ht, hres, hrr) = uw_runs["card"], uw_runs["cpu"]
    if any(not torch.equal(a, b) for a, b in zip(ct, ht)) \
            or len(ct) != len(ht):
        fail("sharded (f) UW: a table differs between the card and the CPU")
    for label, a, b in (("router", cres, hres), ("registry", crr, hrr)):
        if a.signature() != b.signature() or a.score != b.score:
            fail(f"sharded (f) UW {label} discovery: card and CPU differ "
                 f"(scores {a.score!r}, {b.score!r})")
    log(f"sharded (f) UW: router ({TENANT_UW_SHARDS} shards) and registry "
        f"on the card equal the CPU bit for bit: {len(ct)} tables, "
        f"router discovery score {cres.score!r}, registry tenant "
        f"{crr.score!r}")
    for r in routers:
        r.shutdown(timeout=60)
    log(f"sharded phase: {time.perf_counter() - t_phase:.1f} s")
    return dict(
        launches=launches, fallbacks=dict(a=len(fallbacks),
                                          b=len(fallbacks_b)),
        tables_a=[(tuple(t.vars), t.counts.cpu()) for t in tabs_a],
        a=dict(wall_s=wall_a, single_s=wall_single, router=counters_a,
               tables=table_summary(check_a),
               positives=table_summary(pos_a)),
        b=dict(wall_s=wall_u, traced_s=wall_t, profiled_s=wall_p,
               device_busy_s=busy, copies=copies, router=counters_b),
        c=dict(write_s=write_wall, refresh_s=refresh_wall,
               relearn_s=relearn_wall, rescored=rep.rescored,
               retained=rep.retained, total_families=rep.total_families,
               check=check_c, planted=planted["faults"]),
        d=dict(split_s=split_wall, complete_s=wall_d),
        e=dict(wall_s=wall_e, serial_s=wall_serial, fused=fused,
               serial=serial))


def rank_kernel_counts(mdist, device, label: str) -> list:
    """K1-K4 launches on every rank since the last ``reset_rank_counts``,
    rank 0 first; fails if a plain version ran on any rank."""
    out = []
    for rank, c in enumerate(mdist.rank_counts(device)):
        if any(c["plain_calls"].values()):
            fail(f"mesh ({label}): plain versions ran on rank {rank}: "
                 f"{c['plain_calls']}")
        out.append(dict(k1=c["launches"]["segsum_ones"],
                        k2=c["launches"]["segsum_rows"],
                        k3=c["launches"]["mobius"],
                        k4=c["launches"]["bdeu"]))
    return out


def largest_dense_hop(db, plan) -> int:
    """``E * D`` of the largest dense-message hop ``plan`` takes on the
    sparse executor (a hop whose child has hops of its own: ``E`` edges,
    ``D`` the child's dense columns), 0 without one."""
    def width(node) -> int:               # dense columns a node sends up
        out = 1
        for h in node.hops:
            ds = h.child_node.own.card
            for cv in h.edge_attrs:
                ds *= cv.card
            out *= ds * width(h.child_node)
        return out

    def walk(node) -> int:
        best = 0
        for h in node.hops:
            if h.child_node.hops:
                best = max(best, db.relations[h.atom.rel].num_edges
                           * width(h.child_node))
            best = max(best, walk(h.child_node))
        return best
    return walk(plan.root)


def dense_hops(executor) -> list:
    """Wrap ``executor``'s hop step to record each dense-message hop as
    ``(E, D, P)``; returns the list it appends to."""
    seen, inner = [], executor._edge_segment_sum

    def spy(seg_np, rows, total):
        if rows is not None:
            seen.append((int(seg_np.shape[0]), int(rows.shape[1]), total))
        return inner(seg_np, rows, total)
    executor._edge_segment_sum = spy
    return seen


def mesh_phase(ops, hybrid: dict, tables_15: list, vg, smi: str) -> dict:
    """16. Mesh sharding with ranks sharing the card (module docstring);
    ``hybrid`` is phase 3's run, ``tables_15`` phase 15 (a)'s tables,
    ``vg`` phase 3's VisualGenome store (read only)."""
    import copy
    import os
    import tempfile

    import torch.distributed as dist
    from repro_torch.core import (SparseExecutor, build_lattice,
                                  discover_model, make_strategy,
                                  paper_benchmark_db, shard_database,
                                  sharded_positive_ct,
                                  sharded_sparse_positive_ct)
    from repro_torch.core import distributed as mdist
    from repro_torch.core.distributed import (ShardedSparseExecutor,
                                              superset_mobius_sharded)
    from repro_torch.core.plan import compile_plan
    from repro_torch.launch.discover import model_lines
    from repro_torch.launch.mesh import (init_group, make_local_mesh,
                                         spawn_ranks, stop_spawned)
    from repro_torch.serve import CountingRouter
    from torch.profiler import ProfilerActivity, profile
    t_phase = time.perf_counter()
    device = torch.device("cuda", torch.cuda.current_device())
    tmp = tempfile.mkdtemp(prefix="mesh_phase_")
    base = paper_benchmark_db("IMDb", seed=0, scale=IMDB_SCALE)
    lattice = build_lattice(base.schema, DISCOVERY["max_chain_length"])
    plans = [compile_plan(base.schema, p, p.all_ct_vars(
        base.schema, include_rind=False)) for p in lattice]
    single = SparseExecutor()
    want_a = [single.positive(base, plan) for plan in plans]
    launches, out = {}, {}

    def start(world: int, backend: str = "gloo"):
        torch.cuda.empty_cache()       # phase 11 left Nemotron's cache
        path = os.path.join(tmp, f"{backend}{world}")
        t0 = time.perf_counter()
        procs = spawn_ranks(world, path, device, backend, MESH_TIMEOUT_S)
        init_group(0, world, path, backend, MESH_TIMEOUT_S)
        log(f"mesh: {world} ranks ({backend}, all on {device}) met in "
            f"{time.perf_counter() - t0:.1f} s")
        return procs

    def same_table(label: str, got, want) -> None:
        if tuple(got.vars) != tuple(want.vars):
            got = got.transpose_to(tuple(want.vars))
        if float(want.counts.abs().max()) >= 2.0 ** 24:
            fail(f"mesh {label}: a cell past 2^24 (the check is bit for bit)")
        if not torch.equal(got.counts, want.counts):
            fail(f"mesh {label}: the table differs from the single device's")

    def discover(world: int, db, profiled: bool):
        """(b): HYBRID over the sharded executor, held to phase 3."""
        ops.reset_counts()
        mdist.reset_rank_counts(device)
        sync()
        t0 = time.perf_counter()
        if profiled:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                models, st = discover_model(db, make_strategy(
                    "HYBRID", executor="sparse_sharded"), **DISCOVERY)
                sync()
        else:
            models, st = discover_model(db, make_strategy(
                "HYBRID", executor="sparse_sharded"), **DISCOVERY)
            sync()
        wall = time.perf_counter() - t0
        ex = st.engine.executor
        if ex.n_ranks != world:
            fail(f"mesh (b): the executor spans {ex.n_ranks} ranks, not "
                 f"{world}")
        score = sum(m.score for m in models.values())
        if edges_of(models) != hybrid["edges"] or score != hybrid["score"]:
            fail(f"mesh (b) world {world}: models or score differ from "
                 f"phase 3's ({score!r}, {hybrid['score']!r})")
        by_rank = rank_kernel_counts(mdist, device, f"b, world {world}")
        if any(r["k1"] <= 0 or r["k2"] <= 0 for r in by_rank) or \
                by_rank[0]["k3"] <= 0 or by_rank[0]["k4"] <= 0:
            fail(f"mesh (b) world {world}: a kernel of the path did not "
                 f"launch on some rank: {by_rank}")
        if not profiled:
            launches[f"b{world}"] = by_rank
        reading = dict(wall_s=wall, profiled=profiled, score=score,
                       steps=sum(ex.step_counts.values()),
                       step_kinds=len(ex.step_counts),
                       bytes_scattered=ex.bytes_scattered,
                       bytes_reduced=ex.bytes_reduced)
        if profiled:
            on_card = device_events(prof)
            reading["device_busy_s"] = (sum(
                e.self_device_time_total for e in on_card) / 1e6
                if on_card else None)
        log(f"mesh (b) HYBRID over {world} ranks: {wall:.3f} s wall"
            f"{' under the profiler' if profiled else ''}; phase 3's models "
            f"and score {score!r} exactly; {reading['steps']} sharded steps "
            f"({reading['step_kinds']} shapes), {ex.bytes_scattered} B "
            f"scattered, {ex.bytes_reduced} B reduced; device busy on rank "
            f"0: {reading.get('device_busy_s', 'not measured')} s; K1-K4 by "
            f"rank {json.dumps(by_rank)}; {smi}")
        return st, reading

    # (a) - (e) at the first world
    world = MESH_WORLDS[0]
    procs = start(world)
    try:
        # (a) every lattice point's positive table, three ways
        ops.reset_counts()
        mdist.reset_rank_counts(device)
        meshes = {"(2,1)": make_local_mesh(1), "(1,2)": make_local_mesh(2)}
        walls_a = {}
        for path in ("sparse",) + tuple(meshes):
            t0 = time.perf_counter()
            for point, plan, want in zip(lattice, plans, want_a):
                got = (sharded_sparse_positive_ct(base, point, plan.keep)
                       if path == "sparse" else sharded_positive_ct(
                           base, point, plan.keep, mesh=meshes[path]))
                same_table(f"(a) {path} {point}", got, want)
            sync()
            walls_a[path] = time.perf_counter() - t0
        wall_a = sum(walls_a.values())
        gen = torch.Generator(device=device).manual_seed(MUTATION_SEED)
        stack = torch.randint(0, 1 << 20, (2,) * 4 + (3, 3, 3, 3, 27),
                              generator=gen, device=device).float()
        got = superset_mobius_sharded(stack, 4, mesh=meshes["(1,2)"])
        if not torch.equal(got, ops.mobius(stack.reshape(1, 16, -1))
                           .reshape(stack.shape)):
            fail("mesh (a): superset_mobius_sharded differs from K3 alone")
        launches["a"] = rank_kernel_counts(mdist, device, "a")
        if any(r["k1"] <= 0 or r["k2"] <= 0 or r["k3"] <= 0
               for r in launches["a"]):
            fail(f"mesh (a): a kernel did not launch on some rank: "
                 f"{launches['a']}")
        log(f"mesh (a) {len(lattice)} points x (sparse, dense (2,1), dense "
            f"(1,2)) at {world} ranks: {json.dumps(walls_a)} s, each the "
            f"single device's table bit for bit (largest cell "
            f"{max(float(w.counts.max()) for w in want_a):.0f}); "
            f"superset_mobius_sharded over model={world} on "
            f"{tuple(stack.shape)} equals K3 bit for bit; K1-K4 by rank "
            f"{json.dumps(launches['a'])}")
        out["a"] = dict(wall_s=walls_a, tables=3 * len(lattice))

        # (b) HYBRID discovery over the ranks
        db_b = copy.deepcopy(base)
        st_b, out["b2"] = discover(world, db_b, profiled=False)
        _, out["b2_profiled"] = discover(world, copy.deepcopy(base),
                                         profiled=True)

        # (c) a write on (b)'s warm cache: delta maintenance issues no
        # sharded step (local_mode)
        write = draw_writes(db_b, IMDB_WRITES[:1], MUTATION_SEED)[0]
        ex = st_b.engine.executor
        steps = dict(ex.step_counts)
        ops.reset_counts()
        mdist.reset_rank_counts(device)
        delta = apply_write(db_b, write)
        sync()
        t0 = time.perf_counter()
        report = st_b.apply_delta(delta)
        sync()
        wall_c = time.perf_counter() - t0
        launches["c"] = rank_kernel_counts(mdist, device, "c")
        if ex.step_counts != steps or any(
                sum(r.values()) for r in launches["c"][1:]):
            fail("mesh (c): the reconciliation issued sharded steps")
        if report.updated <= 0:
            fail(f"mesh (c): nothing reconciled in place: {report}")
        recount = recount_entries(st_b, prepared("HYBRID", db_b, lattice))
        if recount["low_differs"] or recount["past_bound"]:
            fail(f"mesh (c): reconciled entries differ from a recount: "
                 f"{table_summary(recount)}")
        log(f"mesh (c) {write[0]} on (b)'s warm cache: {wall_c:.3f} s, "
            f"{json.dumps(report.as_dict())}; no sharded step; "
            f"{recount['entries']} entries against a recount "
            f"{json.dumps(table_summary(recount))}; K1-K4 by rank "
            f"{json.dumps(launches['c'])}")
        log(f"mesh: {time.perf_counter() - t_phase:.1f} s into the phase")
        out["c"] = dict(wall_s=wall_c, updated=report.updated,
                        recount=table_summary(recount))
        del st_b, db_b

        # (d) database sharding composed with mesh sharding
        ops.reset_counts()
        mdist.reset_rank_counts(device)
        router = CountingRouter(shard_database(copy.deepcopy(base), SHARDS),
                                executor="sparse_sharded")
        sync()
        t0 = time.perf_counter()
        tabs_d = router.complete_many(complete_queries(base.schema, lattice))
        sync()
        wall_d = time.perf_counter() - t0
        steps_d = sum(sum(e.executor.step_counts.values())
                      for e in router.engines)
        router.shutdown(timeout=60)
        launches["d"] = rank_kernel_counts(mdist, device, "d")
        if len(tabs_d) != len(tables_15) or any(
                tuple(t.vars) != v or not torch.equal(t.counts.cpu(), c)
                for t, (v, c) in zip(tabs_d, tables_15)):
            fail("mesh (d): the router's complete tables differ from phase "
                 "15 (a)'s")
        if steps_d <= 0 or any(r["k1"] + r["k2"] <= 0
                               for r in launches["d"]):
            fail(f"mesh (d): the shard executors did not split over the "
                 f"ranks ({steps_d} steps, {launches['d']})")
        log(f"mesh (d) CountingRouter({SHARDS} shards, sparse_sharded) at "
            f"{world} ranks: {len(tabs_d)} complete tables in {wall_d:.3f} s, "
            f"phase 15 (a)'s bit for bit; {steps_d} sharded steps; K1-K4 by "
            f"rank {json.dumps(launches['d'])}")
        out["d"] = dict(wall_s=wall_d, tables=len(tabs_d), steps=steps_d)
        del router, tabs_d

        # (e) VisualGenome: the points of the largest dense-message hop
        vlat = [p for p in build_lattice(vg.schema, 3) if len(p.atoms) == 3]
        vplans = [compile_plan(vg.schema, p, p.all_ct_vars(
            vg.schema, include_rind=False)) for p in vlat]
        one = SparseExecutor()
        hops = dense_hops(one)
        largest = [largest_dense_hop(vg, plan) for plan in vplans]
        top = max(largest)
        carry = [(p, pl) for p, pl, e in zip(vlat, vplans, largest)
                 if e == top]
        wants, readings = [], []
        for point, plan in carry:        # the single device's, uncounted
            del hops[:]
            wants.append(one.positive(vg, plan))
            readings.append(dict(point=str(point), hops=list(hops)))
        ops.reset_counts()
        mdist.reset_rank_counts(device)
        sync()
        t0 = time.perf_counter()
        for (point, plan), want in zip(carry, wants):
            got = sharded_sparse_positive_ct(vg, point, plan.keep)
            same_table(f"(e) {point}", got, want)
        sync()
        wall_e = time.perf_counter() - t0
        launches["e"] = rank_kernel_counts(mdist, device, "e")
        if any(r["k2"] <= 0 for r in launches["e"]):
            fail(f"mesh (e): K2 did not launch on some rank: "
                 f"{launches['e']}")
        if any(max(e * d for e, d, _ in r["hops"]) != top
               for r in readings):
            fail(f"mesh (e): the points' hops are not the largest: "
                 f"{readings}")
        log(f"mesh (e) VisualGenome: {len(carry)} chain-3 points carry the "
            f"largest dense-message hop (E*D {top}); at {world} ranks each "
            f"equals the single device's table bit for bit "
            f"({json.dumps(readings)}); {wall_e:.3f} s; K1-K4 by rank "
            f"{json.dumps(launches['e'])}")
        log(f"mesh: {time.perf_counter() - t_phase:.1f} s into the phase")
        out["e"] = dict(wall_s=wall_e, points=readings)
        del vplans, one, wants
    finally:
        stop_spawned(procs, device)

    # (b) at the larger worlds
    for world in MESH_WORLDS[1:]:
        procs = start(world)
        try:
            _, out[f"b{world}"] = discover(world, copy.deepcopy(base),
                                           profiled=False)
        finally:
            stop_spawned(procs, device)

    log(f"mesh: {time.perf_counter() - t_phase:.1f} s into the phase")
    # (f) NCCL at world 1: one rank, the single-device steps
    path = os.path.join(tmp, "nccl1")
    init_group(0, 1, path, "nccl", MESH_TIMEOUT_S)
    try:
        ex = ShardedSparseExecutor()
        for point, plan, want in zip(lattice, plans, want_a):
            same_table(f"(f) {point}", ex.positive(base, plan), want)
        if ex.n_ranks != 1 or ex.step_counts:
            fail(f"mesh (f): {ex.n_ranks} ranks, {ex.step_counts} steps")
    finally:
        dist.destroy_process_group()
    log(f"mesh (f) NCCL at world 1: n_ranks 1, {len(plans)} tables equal "
        f"SparseExecutor's bit for bit, no sharded step")

    # (g) the launcher under torch.distributed.run, against one device
    uw = paper_benchmark_db("UW", seed=0, scale=UW_SCALE)
    models, _ = discover_model(uw, make_strategy("HYBRID", executor="sparse"),
                               **MESH_LAUNCH)
    want_lines = model_lines(models)
    root = Path(__file__).resolve().parent
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(MESH_WORLDS[0]), "-m",
           "repro_torch.launch.discover", "--db", "UW", "--scale",
           str(UW_SCALE)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                         timeout=600, env=dict(os.environ,
                                               PYTHONPATH=str(root / "src")))
    wall_g = time.perf_counter() - t0
    got_lines = [line for line in res.stdout.splitlines()
                 if line.startswith("  [")]
    if res.returncode != 0 or got_lines != want_lines:
        fail(f"mesh (g): the launcher (rc {res.returncode}) printed\n"
             f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}\nnot\n"
             + "\n".join(want_lines))
    log(f"mesh (g) {' '.join(cmd[1:])}: rc 0 in {wall_g:.1f} s; its "
        f"{len(got_lines)} points' scores and edge counts equal one device's")
    out["g"] = dict(wall_s=wall_g, points=len(got_lines))
    log(f"mesh phase: {time.perf_counter() - t_phase:.1f} s")
    return dict(launches=launches, **out)


def k2_edge_phase(ops) -> dict:
    """9. K2 bit for bit against its plain version on the edge shapes, each
    with ids -1 and P mixed in and a non-zero ``out`` to add into: fresh
    (16-byte aligned) inputs in the regime the wrapper chooses, the same
    values as 4-byte-offset views of ``seg`` and ``rows`` (the scalar
    path), and, where the wrapper chose the privatised regime, both again
    in the direct one.  One line per shape; returns the launches by
    regime of the wrapper's calls."""
    from repro_torch.kernels.segsum import (card_of, direct_plan,
                                            privatisation_limit, rows_plan,
                                            segsum_rows_cuda,
                                            segsum_rows_plain)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(3)
    card = card_of(torch.device("cuda"))
    limit = privatisation_limit(card)
    segments = sorted({*K2_EDGE_SEGMENTS, limit - 1, limit, limit + 1})
    ops.reset_counts()
    n_shapes = n_checks = 0
    for d in K2_EDGE_WIDTHS:
        for p in segments:
            for e in K2_EDGE_EDGES:
                if e * d > K2_EDGE_ROWS_MAX or p * d > K2_EDGE_CELLS_MAX:
                    continue
                seg_buf = torch.randint(0, p, (e + 1,), generator=gen,
                                        device="cuda", dtype=torch.int32)
                seg_buf[::7] = -1
                seg_buf[3::11] = p
                row_buf = torch.randint(0, 9, (e * d + 1,), generator=gen,
                                        device="cuda").float()
                out0 = torch.randint(0, 5, (p, d), generator=gen,
                                     device="cuda").float()
                views = {"aligned": (seg_buf[:e].clone(),
                                     row_buf[:e * d].clone().view(e, d)),
                         "offset": (seg_buf[1:], row_buf[1:].view(e, d))}
                plan = rows_plan(e, d, p, card)
                errs = {}
                for name, (seg, rows) in views.items():
                    want = segsum_rows_plain(seg, rows, p, out0.clone())
                    got = ops.segsum_rows(seg, rows, p, out=out0.clone())
                    errs[name] = float((got - want).abs().max())
                    if plan.regime == "private":
                        got = segsum_rows_cuda(seg, rows, p, out0.clone(),
                                               direct_plan(e, d, card))
                        errs[f"{name}, direct"] = float(
                            (got - want).abs().max())
                    del want, got
                n_shapes += 1
                n_checks += len(errs)
                log(f"k2 edge E={e} D={d} P={p}: {plan.regime} "
                    f"{list(plan)}; max_abs_err {errs}")
                if any(errs.values()):
                    fail(f"K2 differs from its plain version at E={e} D={d} "
                         f"P={p}: {errs}")
                del seg_buf, row_buf, out0, views
    sync()
    regimes = dict(ops.ROW_REGIMES)
    log(f"k2 edges: {n_shapes} shapes, {n_checks} checks, all bit for bit "
        f"(privatisation limit {limit} segments on this card); wrapper "
        f"launches by regime {json.dumps(regimes)}; "
        f"{time.perf_counter() - t0:.1f} s")
    if ops.LAUNCHES["segsum_rows"] != 2 * n_shapes or min(regimes.values()) \
            <= 0:
        fail(f"k2 edges: {ops.LAUNCHES['segsum_rows']} launches for "
             f"{n_shapes} shapes, by regime {regimes}")
    return regimes


def k4_family(kind: int, q: int, r: int, gen) -> torch.Tensor:
    """One family of phase 10: all zeros (0), counts of a few with zero
    cells (1), counts above 2^20 with zero cells (2), or counts in [2^100,
    2^101) with zero cells (3), which take lgamma's slow path (the
    correctly rounded division and frexp)."""
    if kind == 0:
        return torch.zeros((q, r), device="cuda")
    lo, hi = (0, 9) if kind == 1 else (2 ** 20, 2 ** 24)
    x = torch.randint(lo, hi, (q, r), generator=gen, device="cuda").float()
    if kind == 3:
        x = (x / 2 ** 24 + 1) * 2.0 ** 100
    return x * (torch.rand((q, r), generator=gen, device="cuda") < 0.7)


def k1k4_edge_phase(ops) -> dict:
    """10. K4 bit for bit against its plain version on the edge shapes
    (``K4_EDGE_*``: family i of a shape is of kind (i + shape) % 4 of
    :func:`k4_family`), and K1 exactly against its plain version on its
    edge shapes (``K1_EDGE_*`` and the privatisation limit either side),
    with ids -1 and P mixed in and weights 0 to 3: fresh (16-byte aligned)
    inputs and 4-byte-offset views (the scalar path), through the wrapper
    and in each of :func:`ones_alternatives`.  One line per shape (K1's
    with the regime chosen); returns K1's wrapper launches by regime."""
    from repro_torch.kernels.bdeu import bdeu_plain
    from repro_torch.kernels.segsum import (card_of, ones_plan,
                                            ones_privatisation_limit,
                                            segsum_ones_cuda,
                                            segsum_ones_plain)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(5)
    ops.reset_counts()
    n_k4 = 0
    shapes = [(b, q, r) for b in K4_EDGE_B for q in K4_EDGE_Q
              for r in K4_EDGE_R] + list(K4_EDGE_EXTRA)
    for b, q, r in shapes:
        nijk = torch.stack([k4_family((i + n_k4) % 4, q, r, gen)
                            for i in range(b)])
        for ess in K4_EDGE_ESS:
            got, want = ops.bdeu(nijk, ess), bdeu_plain(nijk, ess)
            same = torch.equal(got.view(torch.int32), want.view(torch.int32))
            log(f"k4 edge B={b} q={q} r={r} ess={ess}: "
                f"{'bit for bit' if same else 'DIFFERS'}, max_abs_err "
                f"{float((got - want).abs().max())}")
            if not same:
                fail(f"K4 differs from its plain version at B={b} q={q} "
                     f"r={r} ess={ess}")
        n_k4 += 1
        del nijk
    if ops.LAUNCHES["bdeu"] != n_k4 * len(K4_EDGE_ESS):
        fail(f"k4 edges: {ops.LAUNCHES['bdeu']} launches for "
             f"{n_k4 * len(K4_EDGE_ESS)} checks")
    t_k4 = time.perf_counter() - t0
    card = card_of(torch.device("cuda"))
    limit = ones_privatisation_limit(card)
    segments = sorted({*K1_EDGE_SEGMENTS, limit - 1, limit, limit + 1})
    n_shapes = n_checks = 0
    for p in segments:
        for e in K1_EDGE_EDGES:
            seg_buf = torch.randint(0, p, (e + 1,), generator=gen,
                                    device="cuda", dtype=torch.int32)
            seg_buf[::7] = -1
            seg_buf[3::11] = p
            w_buf = torch.randint(0, 4, (e + 1,), generator=gen,
                                  device="cuda").float()
            views = {"aligned": (seg_buf[:e].clone(), w_buf[:e].clone()),
                     "offset": (seg_buf[1:], w_buf[1:])}
            plan = ones_plan(e, p, card)
            others = ones_alternatives(plan, e, p, card)
            errs = {}
            for name, (seg, w) in views.items():
                want = segsum_ones_plain(seg, w, p)
                errs[name] = float((ops.segsum_ones(seg, w, p) - want)
                                   .abs().max())
                for other in others:
                    got = segsum_ones_cuda(seg, w, p, other)
                    errs[f"{name}, {list(other)}"] = float(
                        (got - want).abs().max())
                del want, got
            n_shapes += 1
            n_checks += len(errs)
            log(f"k1 edge E={e} P={p}: {plan.regime} {list(plan)}; "
                f"max_abs_err {errs}")
            if any(errs.values()):
                fail(f"K1 differs from its plain version at E={e} P={p}: "
                     f"{errs}")
            del seg_buf, w_buf, views
    sync()
    regimes = dict(ops.ONES_REGIMES)
    log(f"k1k4 edges: K4 {n_k4} shapes x {len(K4_EDGE_ESS)} ess, all bit "
        f"for bit ({t_k4:.1f} s); K1 {n_shapes} shapes, {n_checks} checks, "
        f"all exact (privatisation limit {limit} segments on this card), "
        f"wrapper launches by regime {json.dumps(regimes)}; "
        f"{time.perf_counter() - t0:.1f} s")
    if ops.LAUNCHES["segsum_ones"] != 2 * n_shapes or min(regimes.values()) \
            <= 0:
        fail(f"k1 edges: {ops.LAUNCHES['segsum_ones']} launches for "
             f"{n_shapes} shapes, by regime {regimes}")
    return regimes


def log_profile(label: str, prof, wall: float) -> None:
    """Device busy time against wall time, K6's share, the top kernels."""
    on_card = device_events(prof)
    if not on_card:
        log(f"{label}: device time not measured (the trace holds no device "
            f"events)")
        return
    busy = sum(e.self_device_time_total for e in on_card) / 1e6
    k6 = sum(e.self_device_time_total for e in on_card
             if "flash_" in e.key) / 1e6
    log(f"{label}: {wall:.4f} s wall under the profiler, device busy "
        f"{busy:.4f} s ({100 * busy / wall:.2f} %), "
        f"{sum(e.count for e in on_card)} device events; K6 {k6:.4f} s "
        f"({100 * k6 / busy:.2f} % of device time)")
    for e in sorted(on_card, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<6d} "
            f"{e.key[:100]}")


def lm_phase(ops, kind: str, edge_errs: dict) -> dict:
    """8. Qwen2.5-3B serving at full size; returns K6's kernels row, whose
    max_abs_err is the largest over the LM shapes and the edge shapes
    (bf16), and whose max_abs_err_by_route keeps each kernel's apart;
    ``edge_errs`` is :func:`k6_edge_phase`'s."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.kernels.attention import (flash_attention_plain,
                                               flash_attention_route)
    from repro_torch.models.model import build_model

    cfg = get_config(LM_ARCH)
    t0 = time.perf_counter()
    model = build_model(cfg).init(
        torch.Generator(device="cuda").manual_seed(0))
    sync()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"lm: {LM_ARCH} at full size ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, hd {cfg.hd}, "
        f"vocab {cfg.vocab}, {cfg.dtype}): {n_params} parameters, "
        f"initialised in {time.perf_counter() - t0:.2f} s; "
        f"memory_allocated {torch.cuda.memory_allocated()} B")

    # (c) first: it also warms up cuBLAS before the timed runs
    lm_consistency(model, ops)

    # (a) the main run
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab, (LM_BATCH, LM_PROMPT), dtype=np.int64)).cuda()
    cache = model.init_cache(LM_BATCH, LM_PROMPT + LM_NEW)
    sync()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    t0 = time.perf_counter()
    logits, cache = model.prefill({"tokens": prompts}, cache)
    sync()
    t_prefill = time.perf_counter() - t0
    k6_launches = ops.LAUNCHES["flash_attention"]
    tok = logits.argmax(dim=-1)[:, None]
    out, steps = [tok], []
    t0 = time.perf_counter()
    for i in range(LM_NEW):
        t1 = time.perf_counter()
        logits, cache = model.decode_step(cache, {"token": tok,
                                                  "pos": LM_PROMPT + i})
        tok = logits.argmax(dim=-1)[:, None]
        out.append(tok)
        sync()
        steps.append(time.perf_counter() - t1)
    t_decode = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    gen = torch.cat(out, dim=1)
    log(f"lm main run: prefill {LM_BATCH} x {LM_PROMPT} tokens in "
        f"{t_prefill:.4f} s ({LM_BATCH * LM_PROMPT / t_prefill:.1f} tok/s); "
        f"{LM_NEW} decode steps x {LM_BATCH} requests in {t_decode:.4f} s "
        f"({LM_BATCH * LM_NEW / t_decode:.2f} tok/s, "
        f"{1e3 * t_decode / LM_NEW:.3f} ms/step); max_memory_allocated "
        f"{peak} B; K6 launches {k6_launches}; first tokens "
        f"{gen[0, :8].tolist()}")
    log(f"lm decode step seconds: first {steps[0]:.4f}, min {min(steps):.4f}"
        f", median {sorted(steps)[len(steps) // 2]:.4f}, max "
        f"{max(steps):.4f}")
    if k6_launches != cfg.n_layers:
        fail(f"the prefill launched K6 {k6_launches} times, not "
             f"{cfg.n_layers}")
    if ops.PLAIN_CALLS["flash_attention"]:
        fail("the plain attention ran on the card")
    if not torch.isfinite(logits).all() or logits.shape != (LM_BATCH,
                                                            cfg.vocab):
        fail(f"lm main run: bad decode logits {tuple(logits.shape)}")
    if gen.shape != (LM_BATCH, LM_NEW + 1) or gen.min() < 0 \
            or gen.max() >= cfg.vocab:
        fail("lm main run: generated tokens out of range")
    # four decode steps once more (rewriting the cache's last positions)
    # under the profiler
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(LM_NEW - 4, LM_NEW):
            model.decode_step(cache, {"token": tok, "pos": LM_PROMPT + i})
        sync()
        wall = time.perf_counter() - t0
    log_profile("lm decode profile (4 steps)", prof, wall)
    del cache, logits

    long_tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab, (1, LM_LONG), dtype=np.int64)).cuda()
    sync()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    t0 = time.perf_counter()
    logits, cache = model.prefill({"tokens": long_tokens})
    sync()
    t_long = time.perf_counter() - t0
    long_launches = ops.LAUNCHES["flash_attention"]
    log(f"lm long prefill: 1 x {LM_LONG} tokens in {t_long:.4f} s "
        f"({LM_LONG / t_long:.1f} tok/s); max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} B; K6 launches "
        f"{long_launches}")
    if long_launches != cfg.n_layers:
        fail(f"the long prefill launched K6 {long_launches} times")
    if not torch.isfinite(logits).all():
        fail("lm long prefill: non-finite logits")
    del cache, logits
    # K6 against its plain version at the long prefill's shape
    q, k, v = layer0_qkv(model, long_tokens)
    err_long = check_k6(ops, q, k, v, f"1 x {LM_LONG}")
    log(f"K6 against its plain version on layer 0 of the long prefill "
        f"(B=1 S={LM_LONG}): bf16 max_abs_err {err_long} (tolerance "
        f"{K6_BF16_TOL})")
    long_ms = cuda_ms(lambda: ops.flash_attention(q, k, v, causal=True))
    long_sdpa = cuda_ms(sdpa_call(q, k, v))
    long_dev = device_ms(lambda: ops.flash_attention(q, k, v, causal=True),
                         reps=5)
    long_sdpa_dev = device_ms(sdpa_call(q, k, v), reps=5)
    long_bound, _ = bound_ms(2.0 * (2 * q.numel() + k.numel() + v.numel()),
                             4.0 * q.shape[2] * q.shape[3] * LM_LONG
                             * (LM_LONG + 1) / 2, BF16_OPS_PER_S)
    log(f"K6 share of the long prefill: {long_launches} x {long_ms:.4f} ms "
        f"= {long_launches * long_ms / 1e3:.4f} s of {t_long:.4f} s "
        f"({100 * long_launches * long_ms / 1e3 / t_long:.2f} %); K6 "
        f"{long_ms:.4f} ms, SDPA {long_sdpa:.4f} ms, bound {long_bound:.4f} "
        f"ms at B=1 S={LM_LONG} on {kind}; device time K6 {long_dev} ms, "
        f"SDPA {long_sdpa_dev} ms")
    del q, k, v, long_tokens

    # the main prefill once more under the profiler: where its time goes
    cache = model.init_cache(LM_BATCH, LM_PROMPT)
    sync()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        model.prefill({"tokens": prompts}, cache)
        sync()
    wall = time.perf_counter() - t0
    log_profile("lm prefill profile", prof, wall)
    del cache

    # (b) K6 against its plain version on layer 0's q, k, v of the main
    # prefill
    q, k, v = layer0_qkv(model, prompts)
    err = check_k6(ops, q, k, v, f"{LM_BATCH} x {LM_PROMPT}")
    err32 = check_k6(ops, q.float(), k.float(), v.float(),
                     f"{LM_BATCH} x {LM_PROMPT}")
    log(f"K6 against its plain version on layer 0 of the main prefill: "
        f"bf16 max_abs_err {err} (tolerance {K6_BF16_TOL}), float32 "
        f"max_abs_err {err32} (tolerance {K6_F32_TOL})")
    b, s, h, hd = q.shape
    hk = k.shape[2]
    by_route = dict(edge_errs)
    lm_route = flash_attention_route(q.dtype, hd)
    by_route[lm_route] = max(by_route.get(lm_route, 0.0), err, err_long)
    flops = 4.0 * b * h * hd * s * (s + 1) / 2       # causal pairs only
    b_ms, b_by = bound_ms(2.0 * (2 * q.numel() + k.numel() + v.numel()),
                          flops, BF16_OPS_PER_S)
    row = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/attention.cu",
        replaces="src/repro/kernels/attention_kernel.py:66",
        launches=k6_launches, max_abs_err=max(by_route.values()),
        max_abs_err_by_route=by_route,
        bound_ms=b_ms, bound_by=b_by,
        **timings(lambda: ops.flash_attention(q, k, v, causal=True),
                  lambda: flash_attention_plain(q, k, v, True),
                  sdpa_call(q, k, v), plain_reps=3),
        shape=f"B={b} S={s} H={h} Hkv={hk} hd={hd} causal bf16; "
              f"max_abs_err over this shape, 1 x {LM_LONG} and the edge "
              f"shapes (bf16), by route {by_route}")
    log(f"K6 share of the main prefill: {k6_launches} x {row['ms']:.4f} ms "
        f"= {k6_launches * row['ms'] / 1e3:.4f} s of {t_prefill:.4f} s "
        f"({100 * k6_launches * row['ms'] / 1e3 / t_prefill:.2f} %) on "
        f"{kind}")
    del model, q, k, v, prompts
    torch.cuda.empty_cache()
    return row


def nemotron_phase(ops, smi: str) -> dict:
    """11. Nemotron-4-340B serving at its published width (d_model 18,432,
    96/8 heads, hd 192, d_ff 73,728 squared-ReLU, vocab 256,000, bf16,
    random weights from generator seed 0), ``NEMOTRON_LAYERS`` of its 96
    layers: prefill/decode consistency (as phase 8's (c)); a prefill of
    ``NEMOTRON_BATCH`` x ``NEMOTRON_PROMPT`` tokens, K6 launched once per
    layer on the mma.sync route, then ``NEMOTRON_NEW`` greedy decode steps,
    and the prefill once more under ``torch.profiler``;
    K6 against its plain version on layer 0's q, k, v and timed against
    SDPA and its bound.  Returns that K6 reading (a second shape for K6's
    kernels-line row)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.attention import flash_attention_route
    from repro_torch.models.model import build_model

    t_phase = time.perf_counter()
    full = get_config(NEMOTRON_ARCH)
    cfg = full.replace(n_layers=NEMOTRON_LAYERS)
    route = flash_attention_route(cfg.act_dtype(), cfg.hd)
    if route != "mma.sync":
        fail(f"K6 takes the {route} route at hd {cfg.hd}, not mma.sync")
    torch.cuda.empty_cache()
    sync()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg).init(
        torch.Generator(device="cuda").manual_seed(0))
    sync()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"nemotron: {NEMOTRON_ARCH} at full width (d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, hd {cfg.hd}, d_ff "
        f"{cfg.d_ff} {cfg.mlp}, vocab {cfg.vocab}, {cfg.dtype}); n_layers "
        f"cut from {full.n_layers} to {cfg.n_layers} so that one card holds "
        f"the weights: {n_params} parameters, initialised in "
        f"{time.perf_counter() - t0:.2f} s; memory_allocated "
        f"{torch.cuda.memory_allocated()} B, max during init "
        f"{torch.cuda.max_memory_allocated()} B; K6 route at hd {cfg.hd}: "
        f"{route}")

    lm_consistency(model, ops)

    b, s, n_new = NEMOTRON_BATCH, NEMOTRON_PROMPT, NEMOTRON_NEW
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (b, s), dtype=np.int64)).cuda()
    cache = model.init_cache(b, s + n_new)
    sync()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    t0 = time.perf_counter()
    logits, cache = model.prefill({"tokens": prompts}, cache)
    sync()
    t_prefill = time.perf_counter() - t0
    k6_launches = ops.LAUNCHES["flash_attention"]
    tok = logits.argmax(dim=-1)[:, None]
    out, steps = [tok], []
    t0 = time.perf_counter()
    for i in range(n_new):
        t1 = time.perf_counter()
        logits, cache = model.decode_step(cache, {"token": tok,
                                                  "pos": s + i})
        tok = logits.argmax(dim=-1)[:, None]
        out.append(tok)
        sync()
        steps.append(time.perf_counter() - t1)
    t_decode = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    gen = torch.cat(out, dim=1)
    log(f"nemotron main run: prefill {b} x {s} tokens in {t_prefill:.4f} s "
        f"({b * s / t_prefill:.1f} tok/s); {n_new} decode steps x {b} "
        f"requests in {t_decode:.4f} s ({1e3 * t_decode / n_new:.3f} "
        f"ms/step; first {1e3 * steps[0]:.3f}, median "
        f"{1e3 * sorted(steps)[len(steps) // 2]:.3f} ms); "
        f"max_memory_allocated {peak} B; K6 launches {k6_launches} "
        f"({route}); first tokens {gen[0, :8].tolist()}; on {smi}")
    if k6_launches != cfg.n_layers:
        fail(f"the nemotron prefill launched K6 {k6_launches} times, not "
             f"{cfg.n_layers}")
    if ops.PLAIN_CALLS["flash_attention"]:
        fail("the plain attention ran on the card")
    if not torch.isfinite(logits).all() or logits.shape != (b, cfg.vocab):
        fail(f"nemotron main run: bad decode logits {tuple(logits.shape)}")
    if gen.shape != (b, n_new + 1) or gen.min() < 0 \
            or gen.max() >= cfg.vocab:
        fail("nemotron main run: generated tokens out of range")
    # the prefill once more under the profiler: where its time goes
    from torch.profiler import ProfilerActivity, profile
    sync()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        model.prefill({"tokens": prompts}, cache)
        sync()
    log_profile("nemotron prefill profile", prof, time.perf_counter() - t0)
    del cache, logits, prof

    q, k, v = layer0_qkv(model, prompts)
    del model
    err = check_k6(ops, q, k, v, f"nemotron {b} x {s}")
    hq, hd = q.shape[2], q.shape[3]
    flops = 4.0 * b * hq * hd * s * (s + 1) / 2      # causal pairs only
    b_ms, b_by = bound_ms(2.0 * (2 * q.numel() + k.numel() + v.numel()),
                          flops, BF16_OPS_PER_S)
    reading = dict(
        shape=f"B={b} S={s} H={hq} Hkv={k.shape[2]} hd={hd} causal bf16 "
              f"(nemotron-4-340b layer 0)",
        route=route, launches=k6_launches, max_abs_err=err,
        bound_ms=b_ms, bound_by=b_by,
        ms=cuda_ms(lambda: ops.flash_attention(q, k, v, causal=True)),
        device_ms=device_ms(lambda: ops.flash_attention(q, k, v,
                                                        causal=True), reps=5),
        library_ms=cuda_ms(sdpa_call(q, k, v)),
        library_device_ms=device_ms(sdpa_call(q, k, v), reps=5),
        prefill_s=t_prefill, prefill_tokens_per_s=b * s / t_prefill,
        decode_ms_per_step=1e3 * t_decode / n_new, peak_bytes=peak)
    log(f"K6 on nemotron layer 0 [{reading['shape']}]: {route}, max_abs_err "
        f"{err} (tolerance {K6_BF16_TOL}); device {reading['device_ms']} ms "
        f"(events {reading['ms']:.4f}), SDPA device "
        f"{reading['library_device_ms']} ms (events "
        f"{reading['library_ms']:.4f}), bound {b_ms:.4f} ms ({b_by}); K6 "
        f"share of the prefill {k6_launches} x {reading['ms']:.4f} ms = "
        f"{100 * k6_launches * reading['ms'] / 1e3 / t_prefill:.2f} %; on "
        f"{smi}; phase {time.perf_counter() - t_phase:.1f} s")
    del q, k, v, prompts
    torch.cuda.empty_cache()
    return reading


def sdpa_train_call(q, k, v, dout):
    """SDPA's forward and backward on ``q, k, v`` for the output gradient
    ``dout``, as a function of no arguments (the library yardstick of K6
    under autograd; the port never calls it)."""
    import torch.nn.functional as F
    kw = dict(is_causal=True, enable_gqa=True)
    try:
        F.scaled_dot_product_attention(*(t[:1, :1].transpose(1, 2)
                                         for t in (q, k, v)), **kw)
    except TypeError:
        rep = q.shape[2] // k.shape[2]
        k, v = (t.repeat_interleave(rep, dim=2) for t in (k, v))
        kw = dict(is_causal=True)
    leaves = [t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]
    dt = dout.transpose(1, 2)

    def call():
        out = F.scaled_dot_product_attention(*leaves, **kw)
        return torch.autograd.grad(out, leaves, dt)
    return call


def k6_train_reading(ops, dtype) -> dict:
    """17 (a): K6 under autograd at ``TRAIN_K6_SHAPE`` in ``dtype``."""
    from repro_torch.kernels.attention import flash_attention_plain
    b, s, h, hk, hd = TRAIN_K6_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(17)
    q, k, v, dout = (torch.randn(shape, generator=gen, device="cuda").to(
        dtype) for shape in ((b, s, h, hd), (b, s, hk, hd), (b, s, hk, hd),
                             (b, s, h, hd)))
    label = f"B={b} S={s} H={h} Hkv={hk} hd={hd} causal {dtype}"
    fwd_err = check_k6(ops, q, k, v, f"training shape {label}")
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    ops.reset_counts()
    out = ops.flash_attention(*leaves)
    got = torch.autograd.grad(out, leaves, dout, retain_graph=True)
    counts = (ops.LAUNCHES["flash_attention"],
              ops.BACKWARD_CALLS["flash_attention"],
              ops.PLAIN_CALLS["flash_attention"])
    if counts != (1, 1, 0):
        fail(f"K6 under autograd: (launches, backwards, plain calls) "
             f"{counts}, not (1, 1, 0)")
    ref = [t.detach().float().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(flash_attention_plain(*ref, True), ref,
                               dout.float())
    errs = {}
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        if g.dtype != dtype or g.shape != w.shape:
            fail(f"K6 under autograd: {name} {g.dtype} {tuple(g.shape)}, "
                 f"expected {dtype} {tuple(w.shape)}")
        err, scale = float((g.float() - w).abs().max()), float(w.abs().max())
        errs[name] = err / scale
        if not err <= K6_GRAD_TOL[dtype] * scale:
            fail(f"K6 under autograd ({label}): {name} max abs error {err} "
                 f"> {K6_GRAD_TOL[dtype]} x {scale}")
    del got, ref, want
    es, pairs = q.element_size(), b * h * s * (s + 1) / 2
    rate = BF16_OPS_PER_S if dtype == torch.bfloat16 else FP32_OPS_PER_S
    fwd_bound, fwd_by = bound_ms(es * (2 * q.numel() + 2 * k.numel()),
                                 4.0 * hd * pairs, rate)
    # the backward reads q, k, v and dout and writes dq, dk, dv; it needs
    # five products per causal pair (the scores again, dp, dv, dq, dk)
    bwd_bound, bwd_by = bound_ms(es * (3 * q.numel() + 4 * k.numel()),
                                 10.0 * hd * pairs, rate)
    both_bound, both_by = bound_ms(es * (4 * q.numel() + 4 * k.numel()),
                                   14.0 * hd * pairs, rate)

    def fwd():
        return ops.flash_attention(q, k, v, causal=True)

    def bwd():
        return torch.autograd.grad(out, leaves, dout, retain_graph=True)

    def both():
        return torch.autograd.grad(ops.flash_attention(*leaves), leaves, dout)

    sdpa = sdpa_train_call(q, k, v, dout)
    forward = timings(fwd, lambda: flash_attention_plain(q, k, v, True),
                      sdpa_call(q, k, v), plain_reps=3)
    reading = dict(
        shape=label, max_abs_err=fwd_err, grad_rel_err=errs,
        **{f"fwd_{key}": val for key, val in forward.items()},
        fwd_bound_ms=fwd_bound, fwd_bound_by=fwd_by,
        bwd_ms=cuda_ms(bwd, reps=5), bwd_device_ms=device_ms(bwd, reps=3),
        fwd_bwd_ms=cuda_ms(both, reps=5),
        fwd_bwd_device_ms=device_ms(both, reps=3),
        library_fwd_bwd_ms=cuda_ms(sdpa, reps=5),
        library_fwd_bwd_device_ms=device_ms(sdpa, reps=5),
        bwd_bound_ms=bwd_bound, bwd_bound_by=bwd_by,
        fwd_bwd_bound_ms=both_bound, fwd_bwd_bound_by=both_by)
    log(f"train (a) K6 under autograd [{label}]: forward max_abs_err "
        f"{fwd_err}; gradients' max abs error / max magnitude {errs} "
        f"(tolerance {K6_GRAD_TOL[dtype]}); forward {reading['fwd_ms']:.4f} "
        f"ms (device {reading['fwd_device_ms']}; plain "
        f"{reading['fwd_plain_ms']:.4f}, device "
        f"{reading['fwd_plain_device_ms']}; SDPA {reading['fwd_library_ms']:.4f}"
        f", device {reading['fwd_library_device_ms']}; bound "
        f"{fwd_bound:.4f} ms, {fwd_by}), backward "
        f"{reading['bwd_ms']:.4f} ms (device {reading['bwd_device_ms']}, "
        f"bound {bwd_bound:.4f} ms, {bwd_by}), both "
        f"{reading['fwd_bwd_ms']:.4f} ms (device "
        f"{reading['fwd_bwd_device_ms']}); SDPA forward + backward "
        f"{reading['library_fwd_bwd_ms']:.4f} ms (device "
        f"{reading['library_fwd_bwd_device_ms']}); bound of both "
        f"{both_bound:.4f} ms ({both_by})")
    return reading


def rms_norm_reading() -> dict:
    """17 (b): ``rms_norm``'s VJP against autograd of the naive expression
    on ``[2, 2048, 2048]`` (Qwen2.5-3B's width), float32 and bf16; the
    largest error over the largest magnitude of each gradient."""
    from repro_torch.models.layers import rms_norm

    def naive(x, w, eps=1e-6):
        x32 = x.float()
        var = (x32 * x32).mean(dim=-1, keepdim=True)
        return ((x32 * torch.rsqrt(var + eps)) * w.float()).to(x.dtype)

    gen = torch.Generator(device="cuda").manual_seed(18)
    x = torch.randn((2, 2048, 2048), generator=gen, device="cuda") * 3
    w = torch.randn(2048, generator=gen, device="cuda") * 0.5 + 1.0
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        grads = []
        for fn in (rms_norm, naive):
            xs = x.to(dtype).requires_grad_()
            ws = w.clone().requires_grad_()
            loss = torch.sin(fn(xs, ws).float()).sum()
            grads.append(torch.autograd.grad(loss, (xs, ws)))
        errs = {}
        for name, g, ref in zip(("dx", "dscale"), *grads):
            if g.dtype != ref.dtype:
                fail(f"rms_norm VJP: {name} in {g.dtype}, not {ref.dtype}")
            err = float((g.float() - ref.float()).abs().max())
            scale = float(ref.float().abs().max())
            errs[name] = err / scale
            if not err <= RMS_GRAD_TOL[dtype] * scale:
                fail(f"rms_norm VJP ({dtype}): {name} max abs error {err} > "
                     f"{RMS_GRAD_TOL[dtype]} x {scale}")
        out[str(dtype).removeprefix("torch.")] = errs
    log(f"train (b) rms_norm VJP against autograd of the naive expression "
        f"(x [2, 2048, 2048]): max abs error / max magnitude {out} "
        f"(tolerance {RMS_GRAD_TOL})")
    return out


def train_parity_reading(ops) -> dict:
    """17 (c): the reduced qwen2.5-3b in float32 (random weights from seed
    0 on the host, copied to the card), one batch of 4 x 64: the loss and
    every gradient on the card against the CPU's."""
    from repro_torch.configs import get_reduced
    from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
    from repro_torch.models.model import build_model
    cfg = get_reduced(LM_ARCH).replace(dtype="float32",
                                       param_dtype="float32")
    host = build_model(cfg, device="cpu", trainable=True).init(
        torch.Generator().manual_seed(0))
    card = build_model(cfg, trainable=True)
    card.load_state_dict(host.state_dict())
    batch = SyntheticCorpus(DataConfig(vocab=cfg.vocab, seq_len=64,
                                       global_batch=4)).batch(0)
    runs = {}
    for dev, model in (("cpu", host), ("cuda", card)):
        ops.reset_counts()
        loss, _ = model.loss({k: torch.from_numpy(a).to(dev)
                              for k, a in batch.items()})
        names, params = zip(*model.named_parameters())
        grads = torch.autograd.grad(loss, params)
        runs[dev] = (float(loss.detach()), {n: g.cpu() for n, g in zip(names, grads)},
                     (ops.LAUNCHES["flash_attention"],
                      ops.PLAIN_CALLS["flash_attention"]))
    (loss_h, grads_h, counts_h), (loss_c, grads_c, counts_c) = \
        runs["cpu"], runs["cuda"]
    n = 2 * cfg.n_layers
    if counts_c != (n, 0) or counts_h != (0, n):
        fail(f"train (c): K6 (launches, plain calls) {counts_c} on the card, "
             f"{counts_h} on the host; expected ({n}, 0) and (0, {n})")
    if abs(loss_c - loss_h) > TRAIN_PARITY_LOSS_RTOL * abs(loss_h):
        fail(f"train (c): loss {loss_c} on the card, {loss_h} on the host")
    worst = 0.0
    for name, g in grads_h.items():
        if not torch.allclose(grads_c[name], g, **TRAIN_PARITY_GRAD_TOL):
            fail(f"train (c): gradient {name} differs card against host by "
                 f"{float((grads_c[name] - g).abs().max())}")
        worst = max(worst, float((grads_c[name] - g).abs().max()))
    log(f"train (c) reduced {LM_ARCH} float32, card against CPU: loss "
        f"{loss_c!r} / {loss_h!r}; {len(grads_h)} gradients within "
        f"{TRAIN_PARITY_GRAD_TOL} (largest abs difference {worst}); K6 "
        f"launches {counts_c[0]} (forward and remat)")
    return dict(loss_card=loss_c, loss_host=loss_h, max_abs_diff=worst)


def raw_step_reading(prof, label: str = "train (d)") -> dict:
    """A profiled training step (or any traced run) from the trace's raw
    events (turning a step of this size into ``FunctionEvent``s takes
    about 20 s): device busy seconds (every device event but the
    annotations), their count, K6's seconds (its kernels are ``flash_*``),
    the span on the device of the ``flash_attention.backward`` ranges
    (``None`` where the trace holds no device-side annotation of them) and
    the top kernels by device time."""
    from torch.autograd import DeviceType
    by_name, span, annotated = {}, 0, False
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        if e.is_user_annotation():
            if e.name() == "flash_attention.backward":
                span += e.duration_ns()
                annotated = True
            continue
        ns, n = by_name.get(e.name(), (0, 0))
        by_name[e.name()] = (ns + e.duration_ns(), n + 1)
    if not by_name:
        fail(f"{label}: the profiled run's trace holds no device event")
    busy = sum(ns for ns, _ in by_name.values()) / 1e9
    k6 = sum(ns for name, (ns, _) in by_name.items() if "flash_" in name)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    return dict(busy_s=busy, k6_s=k6 / 1e9,
                events=sum(n for _, n in by_name.values()),
                backward_span_s=span / 1e9 if annotated else None,
                top=[(name, (ns / 1e6, n)) for name, (ns, n) in top])


def state_leaves(tree, prefix: str = ""):
    """``(name, tensor)`` of a train state (nested dicts of tensors)."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from state_leaves(tree[key],
                                    f"{prefix}.{key}" if prefix else key)
    else:
        yield prefix, tree


def train_phase(ops, smi: str) -> dict:
    """17. The LM's training path (module docstring); returns the
    ``training`` entry of K6's kernels-line row."""
    import gc
    import shutil
    import tempfile
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.checkpoint.store import (restore_checkpoint,
                                              save_checkpoint)
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
    from repro_torch.launch import train as launcher

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"train: memory_allocated {torch.cuda.memory_allocated()} B at the "
        f"start of the phase")
    k6 = {str(dt).removeprefix("torch."): k6_train_reading(ops, dt)
          for dt in (torch.bfloat16, torch.float32)}
    rms = rms_norm_reading()
    parity = train_parity_reading(ops)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"train: (a)-(c) {time.perf_counter() - t_phase:.1f} s")

    # (d) Qwen2.5-3B at full size through the launcher
    cfg = get_config(LM_ARCH)
    per_step = 2 * cfg.n_layers * TRAIN_MICROBATCH
    argv = ["--arch", LM_ARCH, "--steps", str(TRAIN_STEPS), "--batch",
            str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--microbatch",
            str(TRAIN_MICROBATCH), "--lr", str(TRAIN_LR), "--seed", "0",
            "--log-every", "1"]
    sync()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    t0 = time.perf_counter()
    run = launcher.train(launcher.parse_args(argv))
    sync()
    wall = time.perf_counter() - t0
    counts = (ops.LAUNCHES["flash_attention"],
              ops.BACKWARD_CALLS["flash_attention"],
              ops.PLAIN_CALLS["flash_attention"])
    peak = torch.cuda.max_memory_allocated()
    losses = run.losses
    steady = sorted(run.step_seconds[1:])
    step_s = steady[len(steady) // 2]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    n_params = sum(t.numel() for t in run.state["params"].values())
    log(f"train (d) {LM_ARCH} at full size ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {n_params} parameters, {cfg.param_dtype} weights, "
        f"{cfg.opt_state_dtype} AdamW moments, remat {cfg.remat}): "
        f"{TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens in "
        f"{TRAIN_MICROBATCH} microbatches, {wall:.2f} s in the launcher; "
        f"losses {losses}; step seconds {run.step_seconds}; median after "
        f"the first {step_s:.4f} s ({tokens / step_s:.1f} tokens/s); "
        f"max_memory_allocated {peak} B; K6 (launches, backwards, plain "
        f"calls) {counts}; on {smi}")
    if not all(np.isfinite(losses)) or len(losses) != TRAIN_STEPS:
        fail(f"train (d): losses {losses}")
    if not np.mean(losses[-3:]) < losses[0]:
        fail(f"train (d): the last three losses average "
             f"{np.mean(losses[-3:])}, not below the first {losses[0]}")
    if counts != (TRAIN_STEPS * per_step, TRAIN_STEPS * per_step // 2, 0):
        fail(f"train (d): K6 (launches, backwards, plain calls) {counts}, "
             f"not ({TRAIN_STEPS * per_step}, {TRAIN_STEPS * per_step // 2},"
             f" 0)")

    # the state saved and restored bit for bit
    tmp = tempfile.mkdtemp(prefix="train_phase_")
    try:
        t0 = time.perf_counter()
        path = save_checkpoint(tmp, TRAIN_STEPS, run.state)
        t_save = time.perf_counter() - t0
        size = sum(f.stat().st_size for f in path.iterdir())
        t0 = time.perf_counter()
        back = restore_checkpoint(tmp, TRAIN_STEPS, run.state)
        sync()
        t_restore = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    n_leaves = 0
    for (name, a), (_, b) in zip(state_leaves(run.state),
                                 state_leaves(back)):
        n_leaves += 1
        if a.dtype != b.dtype or a.shape != b.shape or a.device != b.device \
                or not torch.equal(a.reshape(-1).view(torch.uint8),
                                   b.reshape(-1).view(torch.uint8)):
            fail(f"train (d): restored {name} differs from the saved one")
    del back
    log(f"train (d) checkpoint ({time.perf_counter() - t_phase:.1f} s into "
        f"the phase): {n_leaves} tensors, {size} B saved in "
        f"{t_save:.2f} s, restored to the card in {t_restore:.2f} s, bit for "
        f"bit")

    # one more step under the profiler
    corpus = SyntheticCorpus(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                        global_batch=TRAIN_BATCH, seed=0))
    batch = launcher.make_model_batch(cfg, corpus.batch(TRAIN_STEPS),
                                      torch.device("cuda"))
    sync()
    ops.reset_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, metrics = run.step_fn(run.state, batch)
        loss = float(metrics["loss"])
        sync()
        wall_p = time.perf_counter() - t0
    if ops.LAUNCHES["flash_attention"] != per_step or not np.isfinite(loss):
        fail(f"train (d) profiled step: K6 launches "
             f"{ops.LAUNCHES['flash_attention']}, loss {loss}")
    t0 = time.perf_counter()
    reading = raw_step_reading(prof)
    log(f"train (d) profile read in {time.perf_counter() - t0:.1f} s")
    busy, k6_s, bwd_s = (reading[k] for k in ("busy_s", "k6_s",
                                              "backward_span_s"))
    shares = dict(busy_s=busy, wall_s=wall_p, busy_share=busy / wall_p,
                  k6_s=k6_s, k6_share=k6_s / busy, backward_span_s=bwd_s,
                  backward_share=None if bwd_s is None else bwd_s / busy)
    log(f"train (d) profiled step ({time.perf_counter() - t_phase:.1f} s "
        f"into the phase): loss {loss:.4f}; {wall_p:.4f} s wall under the "
        f"profiler, device busy {busy:.4f} s; K6 {k6_s:.4f} s, the "
        f"attention backward's ranges span {bwd_s} s of the device's "
        f"timeline: {shares}")
    for name, (ms, n) in reading["top"]:
        log(f"  {ms:9.3f} ms  x{n:<6d} {name[:100]}")
    del state, metrics, run, batch, prof
    gc.collect()
    torch.cuda.empty_cache()
    log(f"train phase: {time.perf_counter() - t_phase:.1f} s")
    return dict(launches_per_step=per_step,
                backwards_per_step=per_step // 2, bf16=k6["bfloat16"],
                float32=k6["float32"], rms_norm=rms, card_vs_host=parity,
                losses=losses, step_s=step_s, tokens_per_s=tokens / step_s,
                peak_bytes=peak, checkpoint_bytes=size, save_s=t_save,
                restore_s=t_restore, profiled_step=shares)


def k6_offset_pairs(sq: int, skv: int, q_offset: int) -> int:
    """The (query, key) pairs a causal attention with a query offset
    keeps: row i keeps keys 0 .. min(Skv - 1, q_offset + i)."""
    return sum(min(skv, q_offset + i + 1) for i in range(sq))


def sdpa_offset_call(q, k, v, q_offset: int):
    """SDPA with an explicit mask (key j <= q_offset + i) on ``q, k, v``,
    as a function of no arguments (the yardstick; the port never calls
    it)."""
    import torch.nn.functional as F
    sq, skv = q.shape[1], k.shape[1]
    mask = (torch.arange(skv, device=q.device)[None, :]
            <= q_offset + torch.arange(sq, device=q.device)[:, None])
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    kt, vt = (t.repeat_interleave(q.shape[2] // k.shape[2], dim=1)
              for t in (kt, vt))
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)


def k6_offset_reading(ops) -> dict:
    """18 (a): K6 with ``q_offset`` against its plain version on every
    route (``MESH_K6_ROUTES``), then timed at ``MESH_K6_SHAPE``."""
    from repro_torch.kernels.attention import (flash_attention_plain,
                                               flash_attention_route)
    gen = torch.Generator(device="cuda").manual_seed(18)
    by_route, n = {}, 0
    ops.reset_counts()
    for dtype, hd, tile in MESH_K6_ROUTES:
        route = flash_attention_route(dtype, hd)
        key = route if dtype == torch.bfloat16 else f"{route} float32"
        tol = K6_BF16_TOL if dtype == torch.bfloat16 else K6_F32_TOL
        for off in (0, tile, 3 * tile // 2 + 5):
            for skv in (off + MESH_K6_SQ, off + 2 * MESH_K6_SQ):
                q = torch.randn((2, MESH_K6_SQ, 16, hd), generator=gen,
                                device="cuda").to(dtype)
                k, v = (torch.randn((2, skv, 2, hd), generator=gen,
                                    device="cuda").to(dtype)
                        for _ in range(2))
                got = ops.flash_attention(q, k, v, True, q_offset=off)
                want = flash_attention_plain(q, k, v, True, q_offset=off)
                err = float((got.float() - want.float()).abs().max())
                n += 1
                label = (f"Sq={MESH_K6_SQ} Skv={skv} q_offset={off} hd={hd} "
                         f"{str(dtype)[6:]}")
                if not torch.allclose(got.float(), want.float(), **tol):
                    fail(f"K6 with q_offset ({label}, {route}) outside {tol} "
                         f"of its plain version (max_abs_err {err})")
                by_route[key] = max(by_route.get(key, 0.0), err)
                log(f"k6 q_offset {label}: {route}, max_abs_err {err}")
    sync()
    if ops.LAUNCHES["flash_attention"] != n or \
            ops.PLAIN_CALLS["flash_attention"]:
        fail(f"k6 q_offset: {ops.LAUNCHES['flash_attention']} launches and "
             f"{ops.PLAIN_CALLS['flash_attention']} plain calls for {n} "
             f"shapes")
    b, sq, skv, h, hk, hd, off = MESH_K6_SHAPE
    q = torch.randn((b, sq, h, hd), generator=gen, device="cuda").bfloat16()
    k, v = (torch.randn((b, skv, hk, hd), generator=gen,
                        device="cuda").bfloat16() for _ in range(2))
    got = ops.flash_attention(q, k, v, True, q_offset=off)
    err = float((got.float() - flash_attention_plain(
        q, k, v, True, q_offset=off).float()).abs().max())
    flops = 4.0 * b * h * hd * k6_offset_pairs(sq, skv, off)
    b_ms, b_by = bound_ms(2.0 * (2 * q.numel() + k.numel() + v.numel()),
                          flops, BF16_OPS_PER_S)
    reading = dict(
        shape=(f"B={b} Sq={sq} Skv={skv} H={h} Hkv={hk} hd={hd} "
               f"q_offset={off} causal bf16"),
        max_abs_err=err, max_abs_err_by_route=by_route, shapes=n,
        bound_ms=b_ms, bound_by=b_by,
        **timings(lambda: ops.flash_attention(q, k, v, True, q_offset=off),
                  lambda: flash_attention_plain(q, k, v, True,
                                                q_offset=off),
                  sdpa_offset_call(q, k, v, off), plain_reps=3))
    log(f"K6 q_offset: {n} shapes within tolerance, largest max_abs_err by "
        f"route {by_route}; at {reading['shape']}: {reading['ms']:.4f} ms / "
        f"device {reading['device_ms']} ms; SDPA (explicit mask) "
        f"{reading['library_ms']:.4f} / {reading['library_device_ms']} ms; "
        f"plain {reading['plain_ms']:.4f} ms; bound {b_ms:.4f} ms ({b_by}); "
        f"max_abs_err {err}")
    return reading


def k6_signature_reading(ops, sig) -> dict:
    """K6 at one recorded launch signature ``(q shape, k shape, dtype,
    causal, q_offset)`` (a rank's shard of a main path, bf16, causal), on
    random inputs: against its plain version, timed beside SDPA with an
    explicit mask and its bound."""
    from repro_torch.kernels.attention import (flash_attention_plain,
                                               flash_attention_route)
    qs, ks, dt, causal, off = sig
    gen = torch.Generator(device="cuda").manual_seed(20)
    q = torch.randn(qs, generator=gen, device="cuda").to(getattr(torch, dt))
    k, v = (torch.randn(ks, generator=gen, device="cuda").to(q.dtype)
            for _ in range(2))
    b, sq, h, hd = qs
    err = check_k6_offset(ops, q, k, v, off)
    flops = 4.0 * b * h * hd * k6_offset_pairs(sq, ks[1], off)
    b_ms, b_by = bound_ms(2.0 * (2 * q.numel() + k.numel() + v.numel()),
                          flops, BF16_OPS_PER_S)
    reading = dict(
        shape=(f"B={b} Sq={sq} Skv={ks[1]} H={h} Hkv={ks[2]} hd={hd} "
               f"q_offset={off} causal {dt}"),
        route=flash_attention_route(q.dtype, hd), max_abs_err=err,
        bound_ms=b_ms, bound_by=b_by,
        **timings(lambda: ops.flash_attention(q, k, v, True, q_offset=off),
                  lambda: flash_attention_plain(q, k, v, True,
                                                q_offset=off),
                  sdpa_offset_call(q, k, v, off), plain_reps=3))
    log(f"K6 at a rank's shard [{reading['shape']}]: {reading['route']}, "
        f"max_abs_err {err}; {reading['ms']:.4f} ms / device "
        f"{reading['device_ms']} ms; SDPA (explicit mask) "
        f"{reading['library_ms']:.4f} / {reading['library_device_ms']} ms; "
        f"plain {reading['plain_ms']:.4f} ms; bound {b_ms:.4f} ms ({b_by})")
    return reading


def check_k6_offset(ops, q, k, v, off: int) -> float:
    """K6 with ``q_offset`` against its plain version (``K6_BF16_TOL``);
    the max abs error."""
    from repro_torch.kernels.attention import flash_attention_plain
    got = ops.flash_attention(q, k, v, True, q_offset=off)
    want = flash_attention_plain(q, k, v, True, q_offset=off)
    err = float((got.float() - want.float()).abs().max())
    if not torch.allclose(got.float(), want.float(), **K6_BF16_TOL):
        fail(f"K6 with q_offset {off} at q {tuple(q.shape)} outside "
             f"{K6_BF16_TOL} of its plain version (max_abs_err {err})")
    return err


def k6_record_launches(ops) -> set:
    """Record the signature ``(q shape, k shape, dtype, causal, q_offset)``
    of every K6 launch in this process from here on (a rank of phase 18);
    returns the set it fills.  The launch counts are untouched."""
    seen = set()
    launch = ops.flash_attention_cuda

    def recorded(q, k, v, causal, q_offset=0):
        seen.add((tuple(q.shape), tuple(k.shape), str(q.dtype)[6:],
                  bool(causal), int(q_offset)))
        return launch(q, k, v, causal, q_offset)
    ops.flash_attention_cuda = recorded
    return seen


def k6_path_reading(ops, signatures) -> dict:
    """18 (a), second part, and 19's check: K6 against its plain version
    at each signature a main path launched it with (recorded by
    :func:`k6_record_launches` in phase 18's ranks, and in phase 19 and
    its ranks), on random inputs; bf16 within ``K6_BF16_TOL``, float32
    within ``K6_F32_TOL``."""
    from repro_torch.kernels.attention import flash_attention_plain
    gen = torch.Generator(device="cuda").manual_seed(181)
    errs = {}
    for qs, ks, dt, causal, off in sorted(signatures):
        dtype = getattr(torch, dt)
        tol = K6_BF16_TOL if dtype == torch.bfloat16 else K6_F32_TOL
        q = torch.randn(qs, generator=gen, device="cuda").to(dtype)
        k, v = (torch.randn(ks, generator=gen, device="cuda").to(dtype)
                for _ in range(2))
        got = ops.flash_attention(q, k, v, causal, q_offset=off)
        want = flash_attention_plain(q, k, v, causal, q_offset=off)
        err = float((got.float() - want.float()).abs().max())
        label = (f"q {qs} k {ks} {dt} causal={causal} q_offset={off}")
        if not torch.allclose(got.float(), want.float(), **tol):
            fail(f"K6 at a shape of the main path ({label}) outside {tol} of "
                 f"its plain version (max_abs_err {err})")
        errs[label] = err
        log(f"k6 at a main-path shape, {label}: max_abs_err {err}")
    if not errs:
        fail("k6: no launch of a main path was recorded")
    return errs


def mesh_parity_config(variant: dict, microbatch: int, arch: str = LM_ARCH):
    from repro_torch.configs import get_reduced
    return get_reduced(arch).replace(dtype="float32",
                                        param_dtype="float32",
                                        microbatch=microbatch, **variant)


def mesh_parity_run(mesh, variant: dict, steps: int, microbatch: int,
                    device: str = "cuda", arch: str = LM_ARCH):
    """18 (b): ``steps`` AdamW steps of the reduced float32 model of
    ``arch`` from generator seed 0 on ``device`` (over ``mesh``, or one
    rank); the losses, the whole parameters on the host and the train
    state."""
    from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    from repro_torch.train import step as tstep
    from repro_torch.train.sharding import shard_batch, unshard
    cfg = mesh_parity_config(variant, microbatch, arch)
    model = build_model(cfg, device, trainable=True)
    opt = adamw.make_optimizer(adamw.OptConfig(**MESH_PARITY_OPT))
    state = tstep.init_train_state(model, opt, torch.Generator(
        device=device).manual_seed(0), mesh)
    fn = tstep.make_train_step(model, opt)
    corpus = SyntheticCorpus(DataConfig(
        vocab=cfg.vocab, seq_len=MESH_PARITY_SEQ,
        global_batch=MESH_PARITY_BATCH, seed=MESH_PARITY_SEED))
    losses = []
    for i in range(steps):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in corpus.batch(i).items()}
        if mesh is not None:
            batch = shard_batch(batch, mesh)
        state, metrics = fn(state, batch)
        losses.append(float(metrics["loss"]))
    params = {n: (p.detach() if mesh is None else
                  unshard(p.detach(), p.spec, mesh)).cpu()
              for n, p in state["params"].items()}
    return losses, params, state


def mesh_rank_parity(rank, world, work, mesh, opts) -> dict:
    """18 (b) on a rank: the 3 steps (saved from (2, 2); the 4-rank
    checkpoint restored on (1, 2)), and the sequence-parallel variant."""
    import os
    from repro_torch.checkpoint.store import (restore_checkpoint,
                                              save_checkpoint)
    from repro_torch.kernels import ops
    from repro_torch.models.attention import attention_route
    from repro_torch.train.sharding import unshard
    from repro_torch.train.step import state_specs
    out = {}
    device = opts["device"]
    losses, params, state = mesh_parity_run(mesh, {}, 3, 2, device)
    out["losses"], out["params"] = losses, params
    specs = state_specs(state, state["params"])
    ckpt = os.path.join(work, "ckpt4")
    if world == 4:
        save_checkpoint(ckpt, 3, state, mesh=mesh, specs=specs)
    else:
        back = restore_checkpoint(ckpt, 3, state, device, mesh, specs)
        from repro_torch.checkpoint.store import _paths
        out["restored"] = {path: unshard(leaf, specs.get(path), mesh).cpu()
                           for path, leaf in _paths(back)}
        tp = mesh.shape["model"]
        route = attention_route(MESH_SP_VARIANT["n_heads"], MESH_PARITY_SEQ,
                                tp)
        ops.reset_counts()
        sp_losses, sp_params, _ = mesh_parity_run(mesh, MESH_SP_VARIANT, 1,
                                                  1, device)
        out["sp"] = dict(route=route, losses=sp_losses, params=sp_params,
                         launches=ops.LAUNCHES["flash_attention"],
                         plain=ops.PLAIN_CALLS["flash_attention"])
    del state
    return out


def mesh_train_argv(world: int) -> list:
    """18 (c)'s launcher command line: phase 17's run over ``world``
    ranks."""
    return ["--arch", LM_ARCH, "--steps", str(MESH_TRAIN_STEPS), "--batch",
            str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--microbatch",
            str(TRAIN_MICROBATCH), "--lr", str(TRAIN_LR), "--seed", "0",
            "--log-every", "1", "--model-axis", str(world)]


def mesh_rank_train(rank, world, work, mesh, opts) -> dict:
    """18 (c) on a rank: Qwen2.5-3B at full size through the launcher."""
    import gc
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launcher
    from repro_torch.parallel import collectives
    argv = opts["train_argv"]
    gc.collect()
    on_card = opts["device"] == "cuda"
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    collectives.reset_staged()
    sync_on(opts["device"])
    t0 = time.perf_counter()
    run = launcher.train(launcher.parse_args(argv))
    sync_on(opts["device"])
    wall = time.perf_counter() - t0
    out = dict(losses=run.losses, step_seconds=run.step_seconds, wall_s=wall,
               peak_bytes=torch.cuda.max_memory_allocated() if on_card
               else None,
               staged=dict(collectives.STAGED),
               k6=(ops.LAUNCHES["flash_attention"],
                   ops.BACKWARD_CALLS["flash_attention"],
                   ops.PLAIN_CALLS["flash_attention"]),
               local_params=sum(p.numel() for p in
                                run.state["params"].values()))
    if on_card and opts.get("profile", True):
        out["profiled"] = mesh_profiled_step(rank, run, argv)
    del run
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return out


def mesh_profiled_step(rank: int, run, argv) -> dict:
    """One more step of (c)'s run, under ``torch.profiler`` on rank 0
    (device busy seconds, K6's, the top kernels) and with every rank's
    collective seconds counted."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
    from repro_torch.launch import train as launcher
    from repro_torch.parallel import collectives
    args = launcher.parse_args(argv)
    cfg = get_config(args.arch).replace(microbatch=args.microbatch)
    batch = launcher.make_model_batch(cfg, SyntheticCorpus(DataConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch,
        seed=args.seed)).batch(args.steps), torch.device("cuda"))
    collectives.reset_staged()
    sync()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
        if rank == 0 else None
    if prof is not None:
        prof.__enter__()
    t0 = time.perf_counter()
    _, metrics = run.step_fn(run.state, batch)
    loss = float(metrics["loss"])
    sync()
    wall = time.perf_counter() - t0
    if prof is not None:
        prof.__exit__(None, None, None)
    out = dict(wall_s=wall, loss=loss, staged=dict(collectives.STAGED))
    if prof is not None:
        reading = raw_step_reading(prof)
        out.update(busy_s=reading["busy_s"], k6_s=reading["k6_s"],
                   top=reading["top"][:8])
    return out


def sync_on(device: str) -> None:
    if device == "cuda":
        sync()


def mesh_decode_run(mesh, opts) -> dict:
    """18 (d): Qwen2.5-3B at full size (generator seed 0) on the card:
    the prefill's last logits and each teacher-forced decode step's, on
    the host, and each decode step's seconds; over ``mesh`` the cache's
    sequence axis is split over ``model``.  ``opts["full"]`` false: the
    reduced config; ``opts["float32"]``: weights and activations in
    float32."""
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    from repro_torch.train import step as tstep
    from repro_torch.train.sharding import param_shardings, shard_batch
    device = opts["device"]
    b, p, new = opts["decode"]
    cfg = (get_config if opts["full"] else get_reduced)(LM_ARCH)
    if opts.get("float32"):
        cfg = cfg.replace(dtype="float32", param_dtype="float32")
    model = build_model(cfg, device).init(
        torch.Generator(device=device).manual_seed(0))
    if mesh is not None:
        model.shard_(mesh, param_shardings(dict(model.named_parameters()),
                                           mesh))
    toks = torch.from_numpy(np.random.default_rng(18).integers(
        0, cfg.vocab, (b, p + new), dtype=np.int64)).to(device)
    if mesh is not None:
        toks = shard_batch({"tokens": toks}, mesh)["tokens"]
    cache = model.init_cache(b, p + new)
    ops.reset_counts()
    sync_on(device)
    t0 = time.perf_counter()
    last, cache = tstep.make_prefill_step(model)({"tokens": toks[:, :p]},
                                                 cache)
    sync_on(device)
    prefill_s = time.perf_counter() - t0
    launches = (ops.LAUNCHES["flash_attention"]
                + ops.PLAIN_CALLS["flash_attention"])
    step = tstep.make_decode_step(model, mesh)
    logits, seconds = [last.float().cpu()], []
    for pos in range(p, p + new):
        t0 = time.perf_counter()
        out, cache = step(cache, {"token": toks[:, pos:pos + 1],
                                  "pos": pos})
        sync_on(device)
        seconds.append(time.perf_counter() - t0)
        logits.append(out.float().cpu())
    out = dict(logits=torch.stack(logits, 1), prefill_s=prefill_s,
               step_seconds=seconds, k6_prefill=launches,
               plain_prefill=ops.PLAIN_CALLS["flash_attention"],
               cache_shape=tuple(cache["k"].shape))
    del model, cache
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def mesh_decode_f32_opts(opts: dict) -> dict:
    """(d)'s float32 run: the reduced config at ``MESH_DECODE_F32``."""
    return dict(opts, full=False, float32=True, decode=MESH_DECODE_F32)


def mesh_rank_decode(rank, world, work, mesh, opts) -> dict:
    out = mesh_decode_run(mesh, opts)
    out["float32"] = mesh_decode_run(mesh, mesh_decode_f32_opts(opts))
    return out


MESH_RANK_STEPS = {"parity": mesh_rank_parity, "train": mesh_rank_train,
                   "decode": mesh_rank_decode}


def mesh_train_rank(rank: int, world: int, work: str, steps,
                    opts: dict) -> None:
    """A rank of phase 18 (spawned on the card): join the gloo group at
    ``work``'s ``FileStore``, make the mesh ``(world // 2, 2)``, run
    ``steps`` (names in ``MESH_RANK_STEPS``) with ``opts`` (``device``;
    ``full``: the full-size config; ``train_argv``, ``decode``) and write
    its results (rank 0's with its tensors) to ``work``; a failure writes
    its traceback."""
    import os
    import pickle
    import traceback

    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        from repro_torch.kernels import build
        from repro_torch.launch.mesh import init_group, make_train_mesh
        from repro_torch.kernels import ops
        seen = set()
        if opts["device"] == "cuda":
            build.load()
            torch.cuda.set_device(0)
            seen = k6_record_launches(ops)
        else:
            torch.set_num_threads(1)
        init_group(rank, world, os.path.join(work, f"group{world}"), "gloo",
                   MESH_TIMEOUT_S)
        try:
            mesh = make_train_mesh(2, opts["device"])
            out = {}
            for name in steps:
                out[name] = MESH_RANK_STEPS[name](rank, world, work, mesh,
                                                  opts)
        finally:
            dist.destroy_process_group()
        if rank:                       # the tensors are every rank's alike
            out = {k: v if k in MESH_RANK_READINGS else
                   {f: v[f] for f in ("peak_bytes", "staged", "k6",
                                      "losses", "step_seconds",
                                      "profiled", "k6_prefill",
                                      "k6_decode", "finite",
                                      "cache_shape") if f in v}
                   for k, v in out.items()}
        out["k6_shapes"] = sorted(seen)
        with open(os.path.join(work, f"rank{world}_{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    except BaseException:
        with open(os.path.join(work, f"error{world}_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def run_mesh_ranks(world: int, work: str, steps, opts: dict) -> list:
    """Spawn ``world`` ranks of :func:`mesh_train_rank` on the card, wait
    for them, and return each rank's results; any failure fails the run."""
    import multiprocessing
    import os
    import pickle
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=mesh_train_rank,
                         args=(r, world, work, tuple(steps), opts))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.time() + 3 * MESH_TIMEOUT_S
    for p in procs:
        p.join(max(1.0, deadline - time.time()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    errors = [Path(work) / f"error{world}_{r}.txt" for r in range(world)]
    msgs = [e.read_text() for e in errors if e.exists()]
    if msgs or any(p.exitcode != 0 for p in procs):
        fail(f"mesh train: {world} ranks exited {[p.exitcode for p in procs]}"
             f"\n" + "\n".join(msgs)[-6000:])
    out = []
    for r in range(world):
        with open(os.path.join(work, f"rank{world}_{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def same_params(label: str, got: dict, want: dict, atol: float) -> float:
    """The largest difference between two dicts of whole parameters; fail
    above ``atol``."""
    if set(got) != set(want):
        fail(f"{label}: parameter names differ")
    worst = max(float((got[n].float() - want[n].float()).abs().max())
                for n in want)
    if worst > atol:
        fail(f"{label}: parameters differ by {worst} > {atol}")
    return worst


def mesh_train_phase(ops, smi: str, first_loss_17: float,
                     opts: dict = None) -> dict:
    """18. Multi-rank training and the sequence-sharded decode (module
    docstring); returns the ``mesh_training`` entry of K6's kernels-line
    row.  ``opts`` (the ranks' options, :func:`mesh_train_rank`) defaults
    to the card at full size; a rehearsal on the host passes its own and
    skips (a)."""
    import gc
    import shutil
    import tempfile
    from repro_torch.checkpoint.store import _paths, restore_checkpoint
    t_phase = time.perf_counter()
    opts = opts or dict(device="cuda", full=True,
                        train_argv=mesh_train_argv(MESH_TRAIN_RANKS),
                        decode=(MESH_DECODE_BATCH, MESH_DECODE_PROMPT,
                                MESH_DECODE_NEW))
    device = opts["device"]
    gc.collect()
    k6 = None
    if device == "cuda":
        torch.cuda.empty_cache()
        k6 = k6_offset_reading(ops)
    log(f"mesh train (a): {time.perf_counter() - t_phase:.1f} s")

    work = tempfile.mkdtemp(prefix="mesh_train_")
    try:
        # (b) float32 parity: one rank here, then 4 ranks on (2, 2) (which
        # save their state), then 2 ranks on (1, 2)
        one_losses, one_params, _ = mesh_parity_run(None, {}, 3, 2, device)
        sp_losses, sp_params, _ = mesh_parity_run(None, MESH_SP_VARIANT, 1, 1,
                                                  device)
        # (d)'s single-rank decode, before the ranks take the card
        one_decode = mesh_decode_run(None, opts)
        one_decode_f32 = mesh_decode_run(None, mesh_decode_f32_opts(opts))
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        four = run_mesh_ranks(4, work, ("parity",), opts)
        wall4 = time.perf_counter() - t0
        t0 = time.perf_counter()
        two = run_mesh_ranks(MESH_TRAIN_RANKS, work,
                             ("parity", "train", "decode"), opts)
        wall2 = time.perf_counter() - t0
        back = restore_checkpoint(Path(work) / "ckpt4", 3, {
            "params": one_params, "opt": {
                "m": one_params, "v": one_params,
                "step": torch.zeros((), dtype=torch.int32)}}, "cpu")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if device == "cuda":                  # (a) at the main path's shapes
        k6["main_path_shapes"] = k6_path_reading(ops, set().union(
            *(map(tuple, r["k6_shapes"]) for r in four + two)))
    parity = {}
    for label, res in (("(1, 2)", two[0]["parity"]),
                       ("(2, 2)", four[0]["parity"])):
        rel = max(abs(a - b) / abs(b) for a, b in zip(res["losses"],
                                                        one_losses))
        if rel > MESH_LOSS_RTOL:
            fail(f"mesh train (b) {label}: losses {res['losses']} against one "
                 f"rank's {one_losses} (relative {rel})")
        worst = same_params(f"mesh train (b) {label}", res["params"],
                            one_params, MESH_PARAM_ATOL)
        parity[label] = dict(losses=res["losses"], loss_rel=rel,
                             param_max_diff=worst)
        log(f"mesh train (b) {label} float32, 3 steps: losses {res['losses']} "
            f"(one rank {one_losses}; largest relative difference {rel:.3e}); "
            f"parameters within {worst:.3e} of one rank's")
    sp = two[0]["parity"]["sp"]
    rel = abs(sp["losses"][0] - sp_losses[0]) / abs(sp_losses[0])
    worst = same_params("mesh train (b) sequence-parallel", sp["params"],
                        sp_params, MESH_PARAM_ATOL)
    ran = (sp["launches"] > 0 and not sp["plain"] if device == "cuda"
           else sp["plain"] > 0)          # the plain version on the host
    if sp["route"] != "sequence" or rel > MESH_LOSS_RTOL or not ran:
        fail(f"mesh train (b) sequence-parallel: {sp['route']} route, loss "
             f"{sp['losses']} against {sp_losses}, K6 launches "
             f"{sp['launches']}, plain calls {sp['plain']}")
    parity["sequence-parallel"] = dict(loss_rel=rel, param_max_diff=worst,
                                       k6_launches=sp["launches"])
    log(f"mesh train (b) {MESH_SP_VARIANT} on (1, 2), the sequence route: "
        f"loss {sp['losses'][0]} (one rank {sp_losses[0]}), parameters "
        f"within {worst:.3e}; K6 with q_offset launched {sp['launches']} "
        f"times on rank 0")
    restored = two[0]["parity"]["restored"]
    n_bits = 0
    for path, leaf in _paths(back):
        if not torch.equal(restored[path].reshape(-1).view(torch.uint8),
                           leaf.reshape(-1).view(torch.uint8)):
            fail(f"mesh train (b): {path} restored on (1, 2) differs from "
                 f"the (2, 2) checkpoint")
        n_bits += 1
    for name, p in four[0]["parity"]["params"].items():
        if not torch.equal(p, back["params"][name]):
            fail(f"mesh train (b): the (2, 2) checkpoint's {name} is not "
                 f"what the 4 ranks trained")
    log(f"mesh train (b): the (2, 2) checkpoint ({n_bits} tensors) restored "
        f"on (1, 2) bit for bit; 4 ranks {wall4:.1f} s, 2 ranks (b)-(d) "
        f"{wall2:.1f} s")

    # (c) Qwen2.5-3B at full size over the ranks
    train = [r["train"] for r in two]
    losses = train[0]["losses"]
    n_layers = 36 if opts["full"] else 2
    per_step = 2 * n_layers * TRAIN_MICROBATCH
    want_k6 = (MESH_TRAIN_STEPS * per_step, MESH_TRAIN_STEPS * per_step // 2,
               0)
    if device != "cuda":                   # the plain version on the host
        want_k6 = (0, want_k6[1], want_k6[0])
    for r, t in enumerate(train):
        if tuple(t["k6"]) != want_k6 or t["losses"] != losses:
            fail(f"mesh train (c) rank {r}: K6 (launches, backwards, plain) "
                 f"{t['k6']}, not {want_k6}, or losses {t['losses']} unlike "
                 f"rank 0's {losses}")
    if not all(np.isfinite(losses)) or abs(losses[0] - first_loss_17) > \
            MESH_FIRST_LOSS_RTOL * abs(first_loss_17):
        fail(f"mesh train (c): losses {losses}; the first not within "
             f"{MESH_FIRST_LOSS_RTOL} of phase 17's {first_loss_17}")
    steady = sorted(train[0]["step_seconds"][1:])
    step_s = steady[len(steady) // 2]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    staged = [t["staged"] for t in train]
    peaks = [t["peak_bytes"] for t in train]
    log(f"mesh train (c) {LM_ARCH} at full size over {MESH_TRAIN_RANKS} ranks "
        f"(mesh (1, {MESH_TRAIN_RANKS}), gloo, sharing the card): "
        f"{MESH_TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} in "
        f"{TRAIN_MICROBATCH} microbatches; losses {losses} (phase 17's first "
        f"{first_loss_17}: {abs(losses[0] - first_loss_17):.5f} apart); step "
        f"seconds {train[0]['step_seconds']}, median after the first "
        f"{step_s:.4f} s ({tokens / step_s:.1f} tokens/s); peak memory by "
        f"rank {peaks} B (sum {sum(p or 0 for p in peaks)}); gloo staging by rank "
        f"{staged} ({staged[0]['to_host'] / MESH_TRAIN_STEPS:.0f} B to the "
        f"host a step on rank 0); K6 (launches, backwards, plain) a rank "
        f"{want_k6}; local parameters {train[0]['local_params']}; on {smi}")
    prof = [t.get("profiled") for t in train]
    if prof[0] is not None:
        p0 = prof[0]
        log(f"mesh train (c) one more step, profiled on rank 0: {p0['wall_s']:.4f} "
            f"s wall (loss {p0['loss']:.4f}); rank 0's device busy "
            f"{p0['busy_s']:.4f} s, K6 {p0['k6_s']:.4f} s; host seconds in "
            f"collectives (staging included) by rank "
            f"{[p['staged']['seconds'] for p in prof]} over "
            f"{[p['staged']['calls'] for p in prof]} calls; in (c)'s "
            f"{MESH_TRAIN_STEPS} steps {[t['staged']['seconds'] for t in train]}"
            f" s")
        for name, (ms, n) in p0["top"]:
            log(f"  {ms:9.3f} ms  x{n:<6d} {name[:100]}")

    # (d) the sequence-sharded decode against one rank's
    dec = two[0]["decode"]
    got, want = dec["logits"], one_decode["logits"]
    diff = float((got - want).abs().max())
    scale = float(want.abs().max())
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    if not torch.isfinite(got).all() or diff > LM_DECODE_TOL * scale:
        fail(f"mesh train (d): logits differ from one rank's by {diff} > "
             f"{LM_DECODE_TOL} x {scale}")
    if dec["k6_prefill"] != n_layers or (device == "cuda"
                                         and dec["plain_prefill"]):
        fail(f"mesh train (d): K6 ran {dec['k6_prefill']} times in the "
             f"prefill ({dec['plain_prefill']} plain), not {n_layers}")
    f32, one_f32 = dec["float32"], one_decode_f32
    diff32 = float((f32["logits"] - one_f32["logits"]).abs().max())
    if not torch.allclose(f32["logits"], one_f32["logits"],
                          **MESH_DECODE_F32_TOL):
        fail(f"mesh train (d) float32: logits differ from one rank's by "
             f"{diff32}, outside {MESH_DECODE_F32_TOL}")
    n_reduced = mesh_parity_config({}, 1).n_layers
    if f32["k6_prefill"] != n_reduced or (device == "cuda"
                                          and f32["plain_prefill"]):
        fail(f"mesh train (d) float32: K6 ran {f32['k6_prefill']} times in "
             f"the prefill ({f32['plain_prefill']} plain), not {n_reduced}")
    log(f"mesh train (d) float32, reduced {LM_ARCH} ({MESH_DECODE_F32[0]} x "
        f"{MESH_DECODE_F32[1]} prompt, {MESH_DECODE_F32[2]} steps, cache "
        f"{f32['cache_shape']} a rank): logits within {diff32:.3e} of one "
        f"rank's (tolerance {MESH_DECODE_F32_TOL})")
    d_steps = sorted(dec["step_seconds"])
    one_steps = sorted(one_decode["step_seconds"])
    log(f"mesh train (d) sequence-sharded decode ({MESH_DECODE_BATCH} x "
        f"{MESH_DECODE_PROMPT} prompt, {MESH_DECODE_NEW} steps, cache "
        f"{dec['cache_shape']} a rank): logits within {diff:.5f} of one "
        f"rank's (max |logit| {scale:.4f}, {diff / scale:.5f}, tolerance "
        f"{LM_DECODE_TOL}); argmax agreement {agree:.3f}; prefill "
        f"{dec['prefill_s']:.3f} s (one rank {one_decode['prefill_s']:.3f}); "
        f"decode step median {d_steps[len(d_steps) // 2] * 1e3:.2f} ms (one "
        f"rank {one_steps[len(one_steps) // 2] * 1e3:.2f} ms); on {smi}")
    log(f"mesh train phase: {time.perf_counter() - t_phase:.1f} s")
    return dict(
        q_offset=k6, parity=parity,
        train=dict(ranks=MESH_TRAIN_RANKS, losses=losses, step_s=step_s,
                   tokens_per_s=tokens / step_s,
                   step_seconds=train[0]["step_seconds"], peak_bytes=peaks,
                   staged_bytes_per_step=[
                       (st["to_host"] + st["to_card"]) / MESH_TRAIN_STEPS
                       for st in staged],
                   collectives_per_step=[st["calls"] / MESH_TRAIN_STEPS
                                         for st in staged],
                   collective_s_per_step=[st["seconds"] / MESH_TRAIN_STEPS
                                          for st in staged],
                   profiled_step={k: v for k, v in (prof[0] or {}).items()
                                  if k != "top"},
                   launches_per_rank_step=per_step),
        decode=dict(max_abs_diff=diff, max_abs_logit=scale,
                    float32_max_abs_diff=diff32,
                    argmax_agreement=agree, step_s=d_steps[len(d_steps) // 2],
                    one_rank_step_s=one_steps[len(one_steps) // 2],
                    prefill_s=dec["prefill_s"],
                    one_rank_prefill_s=one_decode["prefill_s"]))


# ---------------------------------------------------------------- phase 19 --

def moe_direct_count(eidx: np.ndarray, buckets: np.ndarray, n_experts: int,
                     tab) -> np.ndarray:
    """19 (e): the complete table over (Routed?, bucket, group) of one
    layer's routing counted directly on the host (positives by bincount;
    negatives = tokens in the bucket x experts in the group - positives),
    laid out on ``tab``'s axes."""
    tok_b = buckets.reshape(-1).astype(np.int64)
    exp_g = (np.arange(n_experts) * 4) // n_experts
    pairs = np.unique(np.repeat(np.arange(tok_b.size), eidx.shape[-1])
                      * n_experts + eidx.reshape(-1))
    cell = exp_g[pairs % n_experts] * 4 + tok_b[pairs // n_experts]
    pos = np.bincount(cell, minlength=16).reshape(4, 4).astype(np.float64)
    total = np.outer(np.bincount(exp_g, minlength=4),
                     np.bincount(tok_b, minlength=4))
    full = np.stack([total - pos, pos], axis=-1)     # [group, bucket, R]
    order = [{"group": 0, "bucket": 1, "Routed?": 2}[str(v).split("(")[0]]
             for v in tab.vars]
    return full.transpose(order).astype(np.float32)


def moe_serving_reading(ops, smi: str) -> dict:
    """19 (a) and (e): Qwen3-30B-A3B served whole, and the routing monitor
    on it (module docstring)."""
    import gc
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.kernels.attention import (flash_attention_plain,
                                               flash_attention_route)
    from repro_torch.models import transformer
    from repro_torch.models.model import build_model
    from repro_torch.train.monitor import (routing_ct, routing_db,
                                           routing_trace)

    cfg = get_config(MOE_ARCH)
    gc.collect()
    torch.cuda.empty_cache()
    sync()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg).init(
        torch.Generator(device="cuda").manual_seed(0))
    sync()
    n_params = sum(p.numel() for p in model.parameters())
    w_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    expert_bytes = sum(p.numel() * p.element_size()
                       for n, p in model.named_parameters()
                       if ".moe.w" in n)
    log(f"moe (a): {MOE_ARCH} at full size ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, hd {cfg.hd}, "
        f"{cfg.n_experts} experts top-{cfg.top_k}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab}, {cfg.dtype}): {n_params} parameters, {w_bytes} B of "
        f"weights ({expert_bytes} B of them experts'), initialised in "
        f"{time.perf_counter() - t0:.2f} s; memory_allocated "
        f"{torch.cuda.memory_allocated()} B; on {smi}")

    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab, (MOE_BATCH, MOE_PROMPT), dtype=np.int64)).cuda()
    cache = model.init_cache(MOE_BATCH, MOE_PROMPT + MOE_NEW)
    # a short prefill first warms cuBLAS and the allocator
    model.prefill({"tokens": prompts[:, :256]}, cache)
    sync()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    t0 = time.perf_counter()
    logits, cache = model.prefill({"tokens": prompts}, cache)
    sync()
    t_prefill = time.perf_counter() - t0
    k6_launches = ops.LAUNCHES["flash_attention"]
    k6_plain = ops.PLAIN_CALLS["flash_attention"]
    tok = logits.argmax(dim=-1)[:, None]
    out, steps = [tok], []
    t0 = time.perf_counter()
    for i in range(MOE_NEW):
        t1 = time.perf_counter()
        logits, cache = model.decode_step(cache, {"token": tok,
                                                  "pos": MOE_PROMPT + i})
        tok = logits.argmax(dim=-1)[:, None]
        out.append(tok)
        sync()
        steps.append(time.perf_counter() - t1)
    t_decode = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    gen = torch.cat(out, dim=1)
    bound_decode = 1e3 * expert_bytes / HBM_BYTES_PER_S
    median = sorted(steps)[len(steps) // 2]
    log(f"moe (a) main run: prefill {MOE_BATCH} x {MOE_PROMPT} tokens in "
        f"{t_prefill:.4f} s ({MOE_BATCH * MOE_PROMPT / t_prefill:.1f} tok/s); "
        f"{MOE_NEW} decode steps x {MOE_BATCH} requests in {t_decode:.4f} s "
        f"({1e3 * t_decode / MOE_NEW:.3f} ms/step; first "
        f"{1e3 * steps[0]:.3f}, median {1e3 * median:.3f} ms; the experts' "
        f"weights streamed once a step bound it at {bound_decode:.3f} ms); "
        f"max_memory_allocated {peak} B; K6 launches {k6_launches} (plain "
        f"{k6_plain}); first tokens {gen[0, :8].tolist()}; on {smi}")
    if k6_launches != cfg.n_layers or k6_plain:
        fail(f"moe (a): the prefill launched K6 {k6_launches} times "
             f"({k6_plain} plain), not {cfg.n_layers}")
    if not torch.isfinite(logits).all() or logits.shape != (MOE_BATCH,
                                                            cfg.vocab):
        fail(f"moe (a): bad decode logits {tuple(logits.shape)}")
    if gen.shape != (MOE_BATCH, MOE_NEW + 1) or gen.min() < 0 \
            or gen.max() >= cfg.vocab:
        fail("moe (a): generated tokens out of range")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(MOE_NEW - 4, MOE_NEW):
            model.decode_step(cache, {"token": tok, "pos": MOE_PROMPT + i})
        sync()
        wall = time.perf_counter() - t0
    log_profile("moe (a) decode profile (4 steps)", prof, wall)
    del prof
    sync()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        model.prefill({"tokens": prompts}, cache)
        sync()
    log_profile("moe (a) prefill profile", prof, time.perf_counter() - t0)
    del prof, cache, logits
    gc.collect()
    torch.cuda.empty_cache()

    # (e) the routing monitor: each layer's routing on the prompts, and
    # what moe_apply used in a prefill of them
    t_e = time.perf_counter()
    index = {id(blk.moe): i for i, blk in enumerate(model.blocks)}
    used = {}
    route_apply = transformer.moe_route_apply

    def spied(p, x, cfg_, mesh=None):
        res = route_apply(p, x, cfg_, mesh)
        if index[id(p)] in MOE_MONITOR_LAYERS:
            used[index[id(p)]] = res[2].to(torch.int32).cpu()
        return res
    transformer.moe_route_apply = spied
    try:
        model.prefill({"tokens": prompts})
    finally:
        transformer.moe_route_apply = route_apply
    sync()
    t0 = time.perf_counter()
    trace = routing_trace(model, {"tokens": prompts})
    sync()
    t_trace = time.perf_counter() - t0
    buckets = (prompts % 4).to(torch.int32)
    monitor = {}
    for layer in MOE_MONITOR_LAYERS:
        eidx = trace[layer].cpu()
        if not torch.equal(eidx, used[layer]):
            fail(f"moe (e): layer {layer}'s trace differs from the routing "
                 f"moe_apply used in the prefill at "
                 f"{int((eidx != used[layer]).sum())} assignments")
        db = routing_db(eidx, buckets, cfg.n_experts)
        ops.reset_counts()
        sync()
        t0 = time.perf_counter()
        tab, stats = routing_ct(db)
        sync()
        wall = time.perf_counter() - t0
        launches = {k: ops.LAUNCHES[k] for k in ("segsum_ones",
                                                  "segsum_rows", "mobius")}
        if any(v <= 0 for v in launches.values()) or any(
                ops.PLAIN_CALLS[k] for k in ops.KERNELS):
            fail(f"moe (e) layer {layer}: K1-K3 launches {launches}, plain "
                 f"calls {ops.PLAIN_CALLS}")
        got = tab.counts.cpu().numpy()
        want = moe_direct_count(eidx.numpy(), buckets.cpu().numpy(),
                                cfg.n_experts, tab)
        if got.dtype != want.dtype or got.tobytes() != want.tobytes():
            fail(f"moe (e) layer {layer}: the complete table differs from "
                 f"the direct count by {np.abs(got - want).max()}")
        monitor[layer] = dict(edges=db.relations["Routed"].num_edges,
                              stats=stats, wall_s=wall, launches=launches)
        log(f"moe (e) layer {layer}: {db.relations['Routed'].num_edges} "
            f"Routed edges of {MOE_BATCH * MOE_PROMPT} tokens; complete "
            f"table {[str(v) for v in tab.vars]} {tuple(tab.counts.shape)} "
            f"equal to the direct count bit for bit; routed "
            f"{stats['routed_pairs']:.0f} of {stats['pairs_total']:.0f} "
            f"pairs; HYBRID on the card {1e3 * wall:.2f} ms, launches "
            f"{launches}; the trace equals the routing moe_apply used; on "
            f"{smi}")
    log(f"moe (e): routing_trace of {MOE_BATCH} x {MOE_PROMPT} over "
        f"{cfg.n_layers} layers {t_trace:.3f} s, {tuple(trace.shape)}; "
        f"phase part {time.perf_counter() - t_e:.1f} s; on {smi}")
    del trace, used

    # K6 against its plain version at layer 0's shape, timed beside SDPA
    q, k, v = layer0_qkv(model, prompts)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    err = check_k6(ops, q, k, v, f"{MOE_ARCH} layer 0")
    b, s, h, hd = q.shape
    route = flash_attention_route(q.dtype, hd)
    flops = 4.0 * b * h * hd * s * (s + 1) / 2
    b_ms, b_by = bound_ms(2.0 * (2 * q.numel() + k.numel() + v.numel()),
                          flops, BF16_OPS_PER_S)
    k6 = dict(shape=f"B={b} S={s} H={h} Hkv={k.shape[2]} hd={hd} causal "
                    f"bf16 ({MOE_ARCH} layer 0)",
              route=route, launches=k6_launches, max_abs_err=err,
              bound_ms=b_ms, bound_by=b_by,
              ms=cuda_ms(lambda: ops.flash_attention(q, k, v, causal=True)),
              device_ms=device_ms(lambda: ops.flash_attention(
                  q, k, v, causal=True), reps=5),
              plain_ms=cuda_ms(lambda: flash_attention_plain(q, k, v, True),
                               reps=3),
              library_ms=cuda_ms(sdpa_call(q, k, v)),
              library_device_ms=device_ms(sdpa_call(q, k, v), reps=5))
    log(f"moe (a) K6 on layer 0 [{k6['shape']}]: {route}, max_abs_err "
        f"{err} (tolerance {K6_BF16_TOL}); device {k6['device_ms']} ms "
        f"(events {k6['ms']:.4f}), plain {k6['plain_ms']:.4f} ms, SDPA "
        f"device {k6['library_device_ms']} ms (events "
        f"{k6['library_ms']:.4f}), bound {b_ms:.4f} ms ({b_by}); K6 share of "
        f"the prefill {k6_launches} x {k6['ms']:.4f} ms = "
        f"{100 * k6_launches * k6['ms'] / 1e3 / t_prefill:.2f} %; on {smi}")
    del q, k, v
    torch.cuda.empty_cache()
    serving = dict(params=n_params, weight_bytes=w_bytes,
                   expert_bytes=expert_bytes, peak_bytes=peak,
                   prefill_s=t_prefill,
                   prefill_tokens_per_s=MOE_BATCH * MOE_PROMPT / t_prefill,
                   decode_ms_per_step=1e3 * t_decode / MOE_NEW,
                   decode_median_ms=1e3 * median,
                   decode_bound_ms=bound_decode)
    return dict(k6=k6, serving=serving, monitor=monitor)


def moe_parity_reading(ops) -> dict:
    """19 (b): the reduced MoE configs in float32 (random weights from seed
    0 on the host, copied to the card): loss, aux and every gradient, and
    each layer's routing, card against CPU; on the card, prefill and
    decode against forward at lossless capacity."""
    from repro_torch.configs import get_reduced
    from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
    from repro_torch.models.model import build_model
    from repro_torch.train.monitor import routing_trace
    out = {}
    for arch in MOE_PARITY_ARCHS:
        cfg = get_reduced(arch).replace(dtype="float32",
                                        param_dtype="float32")
        host = build_model(cfg, device="cpu", trainable=True).init(
            torch.Generator().manual_seed(0))
        card = build_model(cfg, trainable=True)
        card.load_state_dict(host.state_dict())
        batch = SyntheticCorpus(DataConfig(vocab=cfg.vocab, seq_len=64,
                                           global_batch=4)).batch(0)
        runs = {}
        for dev, model in (("cpu", host), ("cuda", card)):
            b = {k: torch.from_numpy(a).to(dev) for k, a in batch.items()}
            ops.reset_counts()
            loss, metrics = model.loss(b)
            names, params = zip(*model.named_parameters())
            grads = torch.autograd.grad(loss, params)
            eidx = routing_trace(model, {"tokens": b["tokens"]}).cpu()
            runs[dev] = (float(loss.detach()), float(metrics["aux"]),
                         {n: g.cpu() for n, g in zip(names, grads)}, eidx,
                         ops.LAUNCHES["flash_attention"])
        (loss_h, aux_h, grads_h, e_h, _), (loss_c, aux_c, grads_c, e_c,
                                           k6_c) = runs["cpu"], runs["cuda"]
        if k6_c <= 0:
            fail(f"moe (b) {arch}: K6 was not launched on the card")
        if abs(loss_c - loss_h) > TRAIN_PARITY_LOSS_RTOL * abs(loss_h) or \
                abs(aux_c - aux_h) > TRAIN_PARITY_LOSS_RTOL * abs(aux_h):
            fail(f"moe (b) {arch}: loss {loss_c} / aux {aux_c} on the card, "
                 f"{loss_h} / {aux_h} on the host")
        if not torch.equal(e_c, e_h):
            fail(f"moe (b) {arch}: the routing differs card against host at "
                 f"{int((e_c != e_h).sum())} assignments")
        worst = 0.0
        for name, g in grads_h.items():
            if not torch.allclose(grads_c[name], g, **TRAIN_PARITY_GRAD_TOL):
                fail(f"moe (b) {arch}: gradient {name} differs card against "
                     f"host by {float((grads_c[name] - g).abs().max())}")
            worst = max(worst, float((grads_c[name] - g).abs().max()))
        # prefill and decode against forward at lossless capacity
        card.cfg = cfg.replace(capacity_factor=float(cfg.n_experts))
        toks = torch.from_numpy(batch["tokens"][:2, :24]).cuda()
        with torch.no_grad():
            full = card.forward({"tokens": toks})
            cache = card.init_cache(2, 24)
            last, cache = card.prefill({"tokens": toks[:, :8]}, cache)
            steps = [last]
            for pos in range(8, 24):
                logits, cache = card.decode_step(cache, {
                    "token": toks[:, pos:pos + 1], "pos": pos})
                steps.append(logits)
        stepwise = torch.stack(steps, 1)
        diff = float((stepwise - full[:, 7:]).abs().max())
        if not torch.allclose(stepwise, full[:, 7:], **MOE_CONSISTENCY_TOL):
            fail(f"moe (b) {arch}: prefill/decode differ from forward by "
                 f"{diff} at lossless capacity")
        log(f"moe (b) reduced {arch} float32, card against CPU: loss "
            f"{loss_c!r} / {loss_h!r}, aux {aux_c!r} / {aux_h!r}; "
            f"{len(grads_h)} gradients within {TRAIN_PARITY_GRAD_TOL} "
            f"(largest abs difference {worst}); routing {tuple(e_c.shape)} "
            f"equal; prefill + 16 decode steps within {diff:.3e} of forward "
            f"at lossless capacity")
        out[arch] = dict(loss_card=loss_c, loss_host=loss_h, aux_card=aux_c,
                         aux_host=aux_h, grad_max_abs_diff=worst,
                         consistency_max_abs_diff=diff)
    return out


def moe_train_arch() -> str:
    """Register (c)'s config, Qwen3-30B-A3B cut to ``MOE_TRAIN_LAYERS``
    layers at full width, under ``MOE_TRAIN_ARCH`` (in this process) and
    return that name, the launcher's ``--arch``."""
    from repro_torch.configs import get_config, register_config
    register_config(MOE_TRAIN_ARCH, get_config(MOE_ARCH).replace(
        n_layers=MOE_TRAIN_LAYERS))
    return MOE_TRAIN_ARCH


def moe_train_argv(world: int = 1) -> list:
    """19 (c)'s launcher command line (and (d)'s over ``world`` ranks)."""
    argv = ["--arch", moe_train_arch(),
            "--steps", str(MOE_TRAIN_STEPS if world == 1 else MOE_MESH_STEPS),
            "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
            "--microbatch", str(TRAIN_MICROBATCH), "--lr", str(TRAIN_LR),
            "--seed", "0", "--log-every", "1"]
    return argv + (["--model-axis", str(world)] if world > 1 else [])


def moe_training_reading(ops, smi: str) -> dict:
    """19 (c): the full-width MoE, its depth cut, through the launcher."""
    import gc
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
    from repro_torch.launch import train as launcher
    gc.collect()
    torch.cuda.empty_cache()
    full = get_config(MOE_ARCH)
    cfg = get_config(moe_train_arch())
    per_step = 2 * cfg.n_layers * TRAIN_MICROBATCH
    sync()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    t0 = time.perf_counter()
    run = launcher.train(launcher.parse_args(moe_train_argv()))
    sync()
    wall = time.perf_counter() - t0
    counts = (ops.LAUNCHES["flash_attention"],
              ops.BACKWARD_CALLS["flash_attention"],
              ops.PLAIN_CALLS["flash_attention"])
    peak = torch.cuda.max_memory_allocated()
    losses = run.losses
    steady = sorted(run.step_seconds[1:])
    step_s = steady[len(steady) // 2]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    n_params = sum(t.numel() for t in run.state["params"].values())
    # one more step, profiled, reading the auxiliary loss
    batch = launcher.make_model_batch(cfg, SyntheticCorpus(DataConfig(
        vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
        seed=0)).batch(MOE_TRAIN_STEPS), torch.device("cuda"))
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        _, metrics = run.step_fn(run.state, batch)
        aux, loss_p = float(metrics["aux"]), float(metrics["loss"])
        sync()
        wall_p = time.perf_counter() - t1
    reading = raw_step_reading(prof)
    log(f"moe (c) {MOE_ARCH} at full width, n_layers cut from "
        f"{full.n_layers} to {cfg.n_layers} so that one card holds the "
        f"weights, AdamW's moments and the activations ({n_params} "
        f"parameters, {cfg.param_dtype} weights, {cfg.opt_state_dtype} "
        f"moments, remat {cfg.remat}): {MOE_TRAIN_STEPS} steps of "
        f"{TRAIN_BATCH} x {TRAIN_SEQ} in {TRAIN_MICROBATCH} microbatches, "
        f"{wall:.2f} s in the launcher; losses {losses}; step seconds "
        f"{run.step_seconds}; median after the first {step_s:.4f} s "
        f"({tokens / step_s:.1f} tokens/s); max_memory_allocated {peak} B; "
        f"K6 (launches, backwards, plain calls) {counts}; one more step "
        f"profiled: loss {loss_p:.4f}, aux {aux:.5f}, {wall_p:.4f} s wall, "
        f"device busy {reading['busy_s']:.4f} s, K6 {reading['k6_s']:.4f} "
        f"s; on {smi}")
    for name, (ms, n) in reading["top"][:8]:
        log(f"  {ms:9.3f} ms  x{n:<6d} {name[:100]}")
    if not all(np.isfinite(losses)) or len(losses) != MOE_TRAIN_STEPS or \
            not np.isfinite(aux) or aux <= 0:
        fail(f"moe (c): losses {losses}, aux {aux}")
    if not np.mean(losses[-3:]) < losses[0]:
        fail(f"moe (c): the last three losses average "
             f"{np.mean(losses[-3:])}, not below the first {losses[0]}")
    want = (MOE_TRAIN_STEPS * per_step, MOE_TRAIN_STEPS * per_step // 2, 0)
    if counts != want:
        fail(f"moe (c): K6 (launches, backwards, plain calls) {counts}, not "
             f"{want}")
    del run, batch, prof, metrics
    gc.collect()
    torch.cuda.empty_cache()
    return dict(layers=cfg.n_layers, params=n_params, losses=losses,
                aux=aux, step_s=step_s, tokens_per_s=tokens / step_s,
                peak_bytes=peak, launches_per_step=per_step,
                profiled_step=dict(wall_s=wall_p, busy_s=reading["busy_s"],
                                   k6_s=reading["k6_s"]))


def mesh_rank_moe_parity(rank, world, work, mesh, opts) -> dict:
    """19 (d) on a rank: the reduced qwen3-moe in float32, 3 AdamW steps."""
    losses, params, state = mesh_parity_run(mesh, {}, 3, 2, opts["device"],
                                            arch=MOE_ARCH)
    del state
    return dict(losses=losses, params=params)


def mesh_rank_moe_train(rank, world, work, mesh, opts) -> dict:
    """19 (d) on a rank: (c)'s model through the launcher, registered in
    this rank's process first."""
    moe_train_arch()
    return mesh_rank_train(rank, world, work, mesh, opts)


MESH_RANK_STEPS.update(moe_parity=mesh_rank_moe_parity,
                       moe_train=mesh_rank_moe_train)


def moe_mesh_reading(ops, smi: str, first_loss: float,
                     opts: dict = None, k6_shapes: set = None) -> dict:
    """19 (d): (c)'s model over 2 ranks sharing the card, expert parallel
    on mesh (1, 2), and the reduced qwen3-moe in float32 against one
    rank.  ``opts`` as :func:`mesh_train_phase`'s (a host rehearsal passes
    its own); the signatures of the ranks' K6 launches are added to
    ``k6_shapes``."""
    import gc
    import shutil
    import tempfile
    opts = opts or dict(device="cuda", full=True,
                        train_argv=moe_train_argv(MESH_TRAIN_RANKS))
    device = opts["device"]
    one_losses, one_params, _ = mesh_parity_run(None, {}, 3, 2, device,
                                                arch=MOE_ARCH)
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    work = tempfile.mkdtemp(prefix="moe_mesh_")
    try:
        t0 = time.perf_counter()
        ranks = run_mesh_ranks(MESH_TRAIN_RANKS, work,
                               ("moe_parity", "moe_train"), opts)
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for r in ranks:
        if k6_shapes is not None:
            k6_shapes.update(map(tuple, r["k6_shapes"]))
    par = ranks[0]["moe_parity"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(par["losses"], one_losses))
    if rel > MESH_LOSS_RTOL:
        fail(f"moe (d) float32: losses {par['losses']} against one rank's "
             f"{one_losses} (relative {rel})")
    worst = same_params("moe (d) float32", par["params"], one_params,
                        MESH_PARAM_ATOL)
    log(f"moe (d) reduced {MOE_ARCH} float32 on (1, {MESH_TRAIN_RANKS}), 3 "
        f"steps: losses {par['losses']} (one rank {one_losses}; largest "
        f"relative difference {rel:.3e}); parameters within {worst:.3e}")
    train = [r["moe_train"] for r in ranks]
    losses = train[0]["losses"]
    n_layers = MOE_TRAIN_LAYERS if opts["full"] else 2
    per_step = 2 * n_layers * TRAIN_MICROBATCH
    want_k6 = (MOE_MESH_STEPS * per_step, MOE_MESH_STEPS * per_step // 2, 0)
    if device != "cuda":
        want_k6 = (0, want_k6[1], want_k6[0])
    for r, t in enumerate(train):
        if tuple(t["k6"]) != want_k6 or t["losses"] != losses:
            fail(f"moe (d) rank {r}: K6 (launches, backwards, plain) "
                 f"{t['k6']}, not {want_k6}, or losses {t['losses']} unlike "
                 f"rank 0's {losses}")
    if not all(np.isfinite(losses)) or abs(losses[0] - first_loss) > \
            MOE_MESH_FIRST_RTOL * abs(first_loss):
        fail(f"moe (d): losses {losses}; the first not within "
             f"{MOE_MESH_FIRST_RTOL} of (c)'s {first_loss}")
    steady = sorted(train[0]["step_seconds"][1:] or train[0]["step_seconds"])
    step_s = steady[len(steady) // 2]
    staged = [t["staged"] for t in train]
    peaks = [t["peak_bytes"] for t in train]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    log(f"moe (d) {MOE_ARCH}, {n_layers} layers at full width, over "
        f"{MESH_TRAIN_RANKS} ranks (mesh (1, {MESH_TRAIN_RANKS}), "
        f"{128 // MESH_TRAIN_RANKS} experts a rank, gloo, sharing the "
        f"card): {MOE_MESH_STEPS} steps; losses {losses} ((c)'s first "
        f"{first_loss}: {abs(losses[0] - first_loss):.5f} apart); step "
        f"seconds {train[0]['step_seconds']} ({tokens / step_s:.1f} "
        f"tokens/s); peak memory by rank {peaks} B; collectives a step by "
        f"rank {[st['calls'] / MOE_MESH_STEPS for st in staged]}, bytes "
        f"staged through the host a step "
        f"{[(st['to_host'] + st['to_card']) / MOE_MESH_STEPS for st in staged]}"
        f", collective seconds a step "
        f"{[st['seconds'] / MOE_MESH_STEPS for st in staged]}; K6 a rank "
        f"{want_k6}; ranks {wall:.1f} s; on {smi}")
    prof = train[0].get("profiled")
    return dict(float32=dict(losses=par["losses"], loss_rel=rel,
                             param_max_diff=worst),
                ranks=MESH_TRAIN_RANKS, losses=losses, step_s=step_s,
                tokens_per_s=tokens / step_s, peak_bytes=peaks,
                collectives_per_step=[st["calls"] / MOE_MESH_STEPS
                                      for st in staged],
                staged_bytes_per_step=[
                    (st["to_host"] + st["to_card"]) / MOE_MESH_STEPS
                    for st in staged],
                collective_s_per_step=[st["seconds"] / MOE_MESH_STEPS
                                       for st in staged],
                profiled_step={k: v for k, v in (prof or {}).items()
                               if k != "top"})


def moe_phase(ops, smi: str) -> dict:
    """19. Mixture-of-experts (module docstring): (a) and (e) on
    Qwen3-30B-A3B served whole, (b) card against CPU, (c) training at full
    width, (d) over 2 ranks.  Returns the ``moe`` entry of K6's
    kernels-line row and the monitor's K1-K3 launches."""
    t_phase = time.perf_counter()
    launch = ops.flash_attention_cuda
    seen = k6_record_launches(ops)      # every K6 launch of (a)-(d) here
    try:
        served = moe_serving_reading(ops, smi)
        log(f"moe (a) + (e): {time.perf_counter() - t_phase:.1f} s")
        parity = moe_parity_reading(ops)
        train = moe_training_reading(ops, smi)
        log(f"moe (b) + (c): {time.perf_counter() - t_phase:.1f} s")
        mesh = moe_mesh_reading(ops, smi, train["losses"][0], k6_shapes=seen)
    finally:
        ops.flash_attention_cuda = launch
    main_shapes = k6_path_reading(ops, seen)
    log(f"moe phase: {time.perf_counter() - t_phase:.1f} s")
    k6 = dict(served["k6"], serving=served["serving"],
              card_vs_host=parity, training=train, mesh_training=mesh,
              main_path_shapes=main_shapes)
    return dict(k6=k6, monitor=served["monitor"])


# ---------------------------------------------------------------- phase 20 --

def subq_serving_reading(ops, arch: str, smi: str) -> dict:
    """20 (a) or (b): ``arch`` served whole (module docstring); for Hymba
    also K6 on layer 0's q, k, v, timed beside SDPA and its bound."""
    import gc
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.kernels.attention import (flash_attention_plain,
                                               flash_attention_route)
    from repro_torch.models.model import build_model

    part = "(a)" if arch == SUBQ_ARCHS[0] else "(b)"
    cfg = get_config(arch)
    attn_layers = cfg.n_layers if cfg.block == "hymba" else 0
    gc.collect()
    torch.cuda.empty_cache()
    sync()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg).init(
        torch.Generator(device="cuda").manual_seed(0))
    sync()
    n_params = sum(p.numel() for p in model.parameters())
    w_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    heads = (f"{cfg.d_model // cfg.rwkv_head_dim} heads of "
             f"{cfg.rwkv_head_dim}, no attention" if cfg.block == "rwkv"
             else f"{cfg.n_heads}/{cfg.n_kv_heads} attention heads of "
             f"{cfg.hd} beside {cfg.ssm_heads} SSM heads, N "
             f"{cfg.ssm_state}")
    log(f"subq {part}: {arch} at full size ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {heads}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
        f"{cfg.dtype}): {n_params} parameters, {w_bytes} B of weights, "
        f"initialised in {time.perf_counter() - t0:.2f} s; on {smi}")
    # phase 8's bar holds in float32; in bf16 the chunk length changes
    # with S (64 at 256 tokens, 51 at 255) and the reference's own bf16
    # models part by several % at depth (tests/test_torch_subquadratic_
    # depth.py), so bf16's is a reading
    f32 = build_model(cfg.replace(dtype="float32", param_dtype="float32")
                      ).init(torch.Generator(device="cuda").manual_seed(0))
    consistency = dict(float32=lm_consistency(f32, ops))
    del f32
    gc.collect()
    torch.cuda.empty_cache()
    consistency["bfloat16"] = lm_consistency(model, ops, gate=False)

    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab, (LM_BATCH, LM_PROMPT), dtype=np.int64)).cuda()
    cache = model.init_cache(LM_BATCH, LM_PROMPT + LM_NEW)
    # a short prefill first warms cuBLAS and the allocator
    model.prefill({"tokens": prompts[:, :256]}, cache)
    sync()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    t0 = time.perf_counter()
    logits, cache = model.prefill({"tokens": prompts}, cache)
    sync()
    t_prefill = time.perf_counter() - t0
    k6 = (ops.LAUNCHES["flash_attention"], ops.PLAIN_CALLS["flash_attention"])
    tok = logits.argmax(dim=-1)[:, None]
    out, steps = [tok], []
    for i in range(LM_NEW):
        t1 = time.perf_counter()
        logits, cache = model.decode_step(cache, {"token": tok,
                                                  "pos": LM_PROMPT + i})
        tok = logits.argmax(dim=-1)[:, None]
        out.append(tok)
        sync()
        steps.append(time.perf_counter() - t1)
    peak = torch.cuda.max_memory_allocated()
    gen = torch.cat(out, dim=1)
    median = sorted(steps)[len(steps) // 2]
    bound_decode = 1e3 * w_bytes / HBM_BYTES_PER_S
    if k6 != (attn_layers, 0):
        fail(f"subq {part}: the prefill launched K6 {k6[0]} times ({k6[1]} "
             f"plain), not {attn_layers}")
    if not torch.isfinite(logits).all() or logits.shape != (LM_BATCH,
                                                            cfg.vocab):
        fail(f"subq {part}: bad decode logits {tuple(logits.shape)}")
    if gen.shape != (LM_BATCH, LM_NEW + 1) or gen.min() < 0 \
            or gen.max() >= cfg.vocab:
        fail(f"subq {part}: generated tokens out of range")
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(LM_NEW - 4, LM_NEW):
            model.decode_step(cache, {"token": tok, "pos": LM_PROMPT + i})
        sync()
        wall_d = time.perf_counter() - t0
    dec = raw_step_reading(prof, f"subq {part} decode")
    del prof
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        model.prefill({"tokens": prompts}, cache)
        sync()
        wall_p = time.perf_counter() - t0
    pre = raw_step_reading(prof, f"subq {part} prefill")
    del prof, cache, logits
    if ops.PLAIN_CALLS["flash_attention"]:
        fail(f"subq {part}: plain attention ran on the card")
    log(f"subq {part} main run: prefill {LM_BATCH} x {LM_PROMPT} tokens in "
        f"{t_prefill:.4f} s ({LM_BATCH * LM_PROMPT / t_prefill:.1f} tok/s), "
        f"K6 launches {k6[0]} (plain {k6[1]}); {LM_NEW} decode steps x "
        f"{LM_BATCH} requests: first {1e3 * steps[0]:.3f} ms, median "
        f"{1e3 * median:.3f} ms a step (the weights read once a step bound "
        f"it at {bound_decode:.3f} ms); max_memory_allocated {peak} B; first "
        f"tokens {gen[0, :8].tolist()}; on {smi}")
    log(f"subq {part} prefill profile: {wall_p:.4f} s wall, device busy "
        f"{pre['busy_s']:.4f} s ({100 * pre['busy_s'] / wall_p:.2f} %), "
        f"{pre['events']} device events, K6 {pre['k6_s']:.4f} s; decode "
        f"profile (4 steps): {wall_d:.4f} s wall, busy {dec['busy_s']:.4f} s "
        f"({100 * dec['busy_s'] / wall_d:.2f} %), {dec['events'] / 4:.0f} "
        f"device events a step")
    for name, (ms, n) in pre["top"][:8]:
        log(f"  prefill {ms:9.3f} ms  x{n:<6d} {name[:100]}")
    for name, (ms, n) in dec["top"][:5]:
        log(f"  decode  {ms:9.3f} ms  x{n:<6d} {name[:100]}")
    reading = dict(
        params=n_params, weight_bytes=w_bytes, peak_bytes=peak,
        prefill_s=t_prefill,
        prefill_tokens_per_s=LM_BATCH * LM_PROMPT / t_prefill,
        prefill_busy_share=pre["busy_s"] / wall_p,
        prefill_top=[(name[:80], ms) for name, (ms, _) in pre["top"][:6]],
        decode_ms_per_step=1e3 * sum(steps) / LM_NEW,
        decode_median_ms=1e3 * median, decode_bound_ms=bound_decode,
        decode_busy_share=dec["busy_s"] / wall_d,
        decode_events_per_step=dec["events"] / 4, k6_launches=k6[0],
        consistency=consistency)
    gc.collect()
    torch.cuda.empty_cache()
    if cfg.block == "rwkv":
        long = torch.from_numpy(rng.integers(
            0, cfg.vocab, (1, LM_LONG), dtype=np.int64)).cuda()
        sync()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        last, state = model.prefill({"tokens": long})
        sync()
        t_long = time.perf_counter() - t0
        peak_long = torch.cuda.max_memory_allocated()
        if not torch.isfinite(last).all():
            fail(f"subq {part}: non-finite logits after the long prefill")
        state_bytes = sum(t.numel() * t.element_size()
                          for t in state.values())
        log(f"subq {part} long prefill: 1 x {LM_LONG} tokens in "
            f"{t_long:.4f} s ({LM_LONG / t_long:.1f} tok/s); "
            f"max_memory_allocated {peak_long} B (the main run's {peak} B); "
            f"the recurrent state {state_bytes} B, no KV cache; on {smi}")
        reading.update(long_prefill_s=t_long,
                       long_tokens_per_s=LM_LONG / t_long,
                       long_peak_bytes=peak_long, state_bytes=state_bytes)
        del model, long, last, state
        gc.collect()
        torch.cuda.empty_cache()
        return reading
    # K6 against its plain version on layer 0's q, k, v, timed beside SDPA
    q, k, v = layer0_qkv(model, prompts)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    err = check_k6(ops, q, k, v, f"{arch} layer 0")
    b, s, h, hd = q.shape
    route = flash_attention_route(q.dtype, hd)
    flops = 4.0 * b * h * hd * s * (s + 1) / 2
    b_ms, b_by = bound_ms(2.0 * (2 * q.numel() + k.numel() + v.numel()),
                          flops, BF16_OPS_PER_S)
    k6_reading = dict(
        shape=f"B={b} S={s} H={h} Hkv={k.shape[2]} hd={hd} causal bf16 "
              f"({arch} layer 0)",
        route=route, launches=k6[0], max_abs_err=err, bound_ms=b_ms,
        bound_by=b_by,
        ms=cuda_ms(lambda: ops.flash_attention(q, k, v, causal=True)),
        device_ms=device_ms(lambda: ops.flash_attention(
            q, k, v, causal=True), reps=5),
        plain_ms=cuda_ms(lambda: flash_attention_plain(q, k, v, True),
                         reps=3),
        library_ms=cuda_ms(sdpa_call(q, k, v)),
        library_device_ms=device_ms(sdpa_call(q, k, v), reps=5))
    log(f"subq {part} K6 on layer 0 [{k6_reading['shape']}]: {route}, "
        f"max_abs_err {err} (tolerance {K6_BF16_TOL}); device "
        f"{k6_reading['device_ms']} ms (events {k6_reading['ms']:.4f}), plain "
        f"{k6_reading['plain_ms']:.4f} ms, SDPA device "
        f"{k6_reading['library_device_ms']} ms (events "
        f"{k6_reading['library_ms']:.4f}), bound {b_ms:.4f} ms ({b_by}); K6 "
        f"share of the prefill {k6[0]} x {k6_reading['ms']:.4f} ms = "
        f"{100 * k6[0] * k6_reading['ms'] / 1e3 / t_prefill:.2f} %; on {smi}")
    if ops.PLAIN_CALLS["flash_attention"]:
        fail(f"subq {part}: plain attention ran on the card")
    del q, k, v
    torch.cuda.empty_cache()
    reading["k6"] = k6_reading
    return reading


def subq_parity_reading(ops) -> dict:
    """20 (c): the reduced RWKV-6 and Hymba in float32 (random weights from
    seed 0 on the host, copied to the card): logits, loss and every
    gradient, card against CPU; on the card, prefill and 16 decode steps
    against forward."""
    from repro_torch.configs import get_reduced
    from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
    from repro_torch.models.model import build_model
    out = {}
    for arch in SUBQ_ARCHS:
        cfg = get_reduced(arch).replace(dtype="float32",
                                        param_dtype="float32")
        host = build_model(cfg, device="cpu", trainable=True).init(
            torch.Generator().manual_seed(0))
        card = build_model(cfg, trainable=True)
        card.load_state_dict(host.state_dict())
        batch = SyntheticCorpus(DataConfig(vocab=cfg.vocab, seq_len=64,
                                           global_batch=4)).batch(0)
        runs = {}
        for dev, model in (("cpu", host), ("cuda", card)):
            b = {k: torch.from_numpy(a).to(dev) for k, a in batch.items()}
            ops.reset_counts()
            loss, _ = model.loss(b)
            names, params = zip(*model.named_parameters())
            grads = torch.autograd.grad(loss, params)
            logits = model.forward({"tokens": b["tokens"]}).cpu()
            runs[dev] = (float(loss.detach()),
                         {n: g.cpu() for n, g in zip(names, grads)}, logits,
                         ops.LAUNCHES["flash_attention"],
                         ops.PLAIN_CALLS["flash_attention"])
        loss_h, grads_h, logits_h, _, _ = runs["cpu"]
        loss_c, grads_c, logits_c, k6_c, plain_c = runs["cuda"]
        # the loss's forward, its remat in the backward, and forward()
        want_k6 = (cfg.n_layers * (3 if cfg.remat else 2)
                   if cfg.block == "hymba" else 0)
        if (k6_c, plain_c) != (want_k6, 0):
            fail(f"subq (c) {arch}: K6 launched {k6_c} times ({plain_c} "
                 f"plain) on the card, not {want_k6}")
        if abs(loss_c - loss_h) > TRAIN_PARITY_LOSS_RTOL * abs(loss_h):
            fail(f"subq (c) {arch}: loss {loss_c} on the card, {loss_h} on "
                 f"the host")
        logit_diff = float((logits_c - logits_h).abs().max())
        if not torch.allclose(logits_c, logits_h, **SUBQ_PARITY_TOL):
            fail(f"subq (c) {arch}: logits differ card against host by "
                 f"{logit_diff}")
        worst = 0.0
        for name, g in grads_h.items():
            diff = float((grads_c[name] - g).abs().max())
            if not torch.allclose(grads_c[name], g, **TRAIN_PARITY_GRAD_TOL):
                fail(f"subq (c) {arch}: gradient {name} differs card against "
                     f"host by {diff}")
            worst = max(worst, diff)
        toks = torch.from_numpy(batch["tokens"][:2, :24]).cuda()
        with torch.no_grad():
            full = card.forward({"tokens": toks})
            cache = card.init_cache(2, 24)
            last, cache = card.prefill({"tokens": toks[:, :8]}, cache)
            steps = [last]
            for pos in range(8, 24):
                logits, cache = card.decode_step(cache, {
                    "token": toks[:, pos:pos + 1], "pos": pos})
                steps.append(logits)
        stepwise = torch.stack(steps, 1)
        diff = float((stepwise - full[:, 7:]).abs().max())
        if not torch.allclose(stepwise, full[:, 7:], **SUBQ_PARITY_TOL):
            fail(f"subq (c) {arch}: prefill/decode differ from forward by "
                 f"{diff}")
        log(f"subq (c) reduced {arch} float32, card against CPU: loss "
            f"{loss_c!r} / {loss_h!r}; logits within {logit_diff:.3e}; "
            f"{len(grads_h)} gradients within {TRAIN_PARITY_GRAD_TOL} "
            f"(largest abs difference {worst:.3e}); K6 {k6_c} launches on "
            f"the card; prefill + 16 decode steps within {diff:.3e} of "
            f"forward")
        out[arch] = dict(loss_card=loss_c, loss_host=loss_h,
                         logits_max_abs_diff=logit_diff,
                         grad_max_abs_diff=worst,
                         consistency_max_abs_diff=diff)
    return out


def subq_training_reading(ops, smi: str, arch: str = SUBQ_TRAIN_ARCH,
                          steps: int = SUBQ_TRAIN_STEPS) -> dict:
    """20 (d): ``arch`` (RWKV6-1.6B; (f): Hymba-1.5B) trained on one card
    at full size through the launcher for ``steps`` steps, and one more
    step profiled.  K6 runs each attention layer once a microbatch, and
    once more under remat, with one plain backward; at 6 steps or more
    the last three losses average below the first."""
    import gc
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
    from repro_torch.launch import train as launcher
    gc.collect()
    torch.cuda.empty_cache()
    part = "(d)" if arch == SUBQ_TRAIN_ARCH else "(f)"
    cfg = get_config(arch)
    attn_layers = cfg.n_layers if cfg.block == "hymba" else 0
    per_step = attn_layers * TRAIN_MICROBATCH
    want_k6 = (steps * per_step * (2 if cfg.remat else 1),
               steps * per_step, 0)
    argv = ["--arch", arch, "--steps", str(steps),
            "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
            "--microbatch", str(TRAIN_MICROBATCH), "--lr", str(TRAIN_LR),
            "--seed", "0", "--log-every", "1"]
    sync()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    t0 = time.perf_counter()
    run = launcher.train(launcher.parse_args(argv))
    sync()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    counts = (ops.LAUNCHES["flash_attention"],
              ops.BACKWARD_CALLS["flash_attention"],
              ops.PLAIN_CALLS["flash_attention"])
    losses = run.losses
    steady = sorted(run.step_seconds[1:])
    step_s = steady[len(steady) // 2]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    n_params = sum(t.numel() for t in run.state["params"].values())
    batch = launcher.make_model_batch(cfg, SyntheticCorpus(DataConfig(
        vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
        seed=0)).batch(steps), torch.device("cuda"))
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        _, metrics = run.step_fn(run.state, batch)
        loss_p = float(metrics["loss"])
        sync()
        wall_p = time.perf_counter() - t1
    reading = raw_step_reading(prof, f"subq {part}")
    log(f"subq {part} {arch} at full size on one card ({n_params} "
        f"parameters, {cfg.param_dtype} weights, {cfg.opt_state_dtype} "
        f"moments, remat {cfg.remat}): {steps} steps of {TRAIN_BATCH} x "
        f"{TRAIN_SEQ} in {TRAIN_MICROBATCH} microbatches, {wall:.2f} s in the "
        f"launcher; losses {losses}; step seconds {run.step_seconds}; median "
        f"after the first {step_s:.4f} s ({tokens / step_s:.1f} tokens/s); "
        f"max_memory_allocated {peak} B; K6 (launches, backwards, plain "
        f"calls) {counts}; one more step profiled: loss {loss_p:.4f}, "
        f"{wall_p:.4f} s wall, device busy {reading['busy_s']:.4f} s, K6 "
        f"{reading['k6_s']:.4f} s, {reading['events']} device events; on "
        f"{smi}")
    for name, (ms, n) in reading["top"][:8]:
        log(f"  {ms:9.3f} ms  x{n:<6d} {name[:100]}")
    if counts != want_k6:
        fail(f"subq {part}: K6 (launches, backwards, plain calls) {counts} "
             f"in {arch}'s training, not {want_k6}")
    if not all(np.isfinite(losses + [loss_p])) or len(losses) != steps:
        fail(f"subq {part}: losses {losses}, profiled {loss_p}")
    if steps >= 6 and not np.mean(losses[-3:]) < losses[0]:
        fail(f"subq {part}: the last three losses average "
             f"{np.mean(losses[-3:])}, not below the first {losses[0]}")
    del run, batch, prof, metrics
    gc.collect()
    torch.cuda.empty_cache()
    return dict(params=n_params, losses=losses, step_s=step_s,
                tokens_per_s=tokens / step_s, peak_bytes=peak,
                k6_per_step=[c // steps for c in counts[:2]],
                profiled_step=dict(wall_s=wall_p, busy_s=reading["busy_s"],
                                   k6_s=reading["k6_s"],
                                   events=reading["events"],
                                   top=[(name[:80], ms) for name, (ms, _)
                                        in reading["top"][:6]]))


def subq_perturb_(model, seed: int = 7) -> None:
    """Add ``SUBQ_NOISE[name]`` times N(0, 1) (a generator of ``seed`` on
    the model's device) to every parameter whose name ends in a key of
    ``SUBQ_NOISE``: the init's constants, which would hide a rank reading
    another rank's slice of them."""
    gen = torch.Generator(device=model.device).manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            scale = SUBQ_NOISE.get(name.rsplit(".", 1)[-1])
            if scale is not None:
                p.add_((scale * torch.randn(p.shape, generator=gen,
                                            device=p.device)).to(p.dtype))


def subq_mesh_run(mesh, arch: str, variant: dict, device: str) -> dict:
    """20 (e): ``SUBQ_MESH_STEPS`` AdamW steps of the reduced float32
    ``arch`` with ``variant``'s changes (generator seed 0, perturbed) on
    ``device``, over ``mesh`` or one rank: the losses, the whole
    parameters on the host and K6's (launches, plain calls)."""
    from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    from repro_torch.train import step as tstep
    from repro_torch.train.sharding import (param_shardings, shard_batch,
                                            unshard)
    cfg = mesh_parity_config(variant, 1, arch)
    model = build_model(cfg, device, trainable=True).init(
        torch.Generator(device=device).manual_seed(0))
    subq_perturb_(model)
    if mesh is not None:
        model.shard_(mesh, param_shardings(dict(model.named_parameters()),
                                           mesh))
    opt = adamw.make_optimizer(adamw.OptConfig(**MESH_PARITY_OPT))
    params = dict(model.named_parameters())
    state = {"params": params, "opt": opt.init(params)}
    fn = tstep.make_train_step(model, opt)
    corpus = SyntheticCorpus(DataConfig(
        vocab=cfg.vocab, seq_len=SUBQ_MESH_SEQ,
        global_batch=MESH_PARITY_BATCH, seed=MESH_PARITY_SEED))
    ops.reset_counts()
    losses = []
    for i in range(SUBQ_MESH_STEPS):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in corpus.batch(i).items()}
        if mesh is not None:
            batch = shard_batch(batch, mesh)
        state, metrics = fn(state, batch)
        losses.append(float(metrics["loss"]))
    return dict(losses=losses, params={
        n: (p.detach() if mesh is None else
            unshard(p.detach(), p.spec, mesh)).cpu()
        for n, p in state["params"].items()},
        k6=(ops.LAUNCHES["flash_attention"],
            ops.PLAIN_CALLS["flash_attention"]))


def mesh_rank_subq_parity(rank, world, work, mesh, opts) -> dict:
    """20 (e) on a rank: every ``SUBQ_MESH_VARIANTS`` case."""
    return {i: subq_mesh_run(mesh, arch, variant, opts["device"])
            for i, (arch, variant) in enumerate(SUBQ_MESH_VARIANTS)}


def subq_mesh_argv(arch: str, world: int = MESH_TRAIN_RANKS) -> list:
    """20 (f)'s launcher command line for ``arch`` over ``world`` ranks."""
    return ["--arch", arch, "--steps", str(SUBQ_MESH_TRAIN_STEPS),
            "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
            "--microbatch", str(TRAIN_MICROBATCH), "--lr", str(TRAIN_LR),
            "--seed", "0", "--log-every", "1", "--model-axis", str(world)]


def mesh_rank_subq_train(rank, world, work, mesh, opts) -> dict:
    """20 (f) on a rank: each of ``SUBQ_ARCHS`` through the launcher
    (``opts["subq_argv"][arch]``), unprofiled."""
    return {arch: mesh_rank_train(rank, world, work, mesh, dict(
        opts, train_argv=opts["subq_argv"][arch], profile=False))
        for arch in SUBQ_ARCHS}


MESH_RANK_STEPS.update(subq_parity=mesh_rank_subq_parity,
                       subq_train=mesh_rank_subq_train)
# steps whose results hold no tensors: every rank returns them whole
MESH_RANK_READINGS = ("subq_train",)


def subq_mesh_reading(ops, smi: str, first_losses: dict, opts: dict = None,
                      k6_shapes: set = None) -> dict:
    """20 (e) and (f) over ``MESH_TRAIN_RANKS`` ranks sharing the card
    (mesh (1, 2)): (e) float32 parity of every ``SUBQ_MESH_VARIANTS`` case
    against one rank in this process; (f) RWKV6-1.6B and Hymba-1.5B at
    full size through the launcher, each first loss against
    ``first_losses[arch]`` (one card's).  ``opts`` as
    :func:`mesh_train_phase`'s; the ranks' K6 signatures are added to
    ``k6_shapes``."""
    import gc
    import shutil
    import tempfile
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.models.linear_attn import linear_attention_route
    opts = opts or dict(device="cuda", full=True, subq_argv={
        arch: subq_mesh_argv(arch) for arch in SUBQ_ARCHS})
    device = opts["device"]
    tp = MESH_TRAIN_RANKS
    one = [subq_mesh_run(None, arch, variant, device)
           for arch, variant in SUBQ_MESH_VARIANTS]
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    work = tempfile.mkdtemp(prefix="subq_mesh_")
    try:
        t0 = time.perf_counter()
        ranks = run_mesh_ranks(tp, work, ("subq_parity", "subq_train"),
                               opts)
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for r in ranks:
        if k6_shapes is not None:
            k6_shapes.update(map(tuple, r["k6_shapes"]))
    parity = []
    for i, (arch, variant) in enumerate(SUBQ_MESH_VARIANTS):
        got, want = ranks[0]["subq_parity"][i], one[i]
        cfg = get_reduced(arch).replace(**variant)
        heads = (cfg.d_model // cfg.rwkv_head_dim if cfg.block == "rwkv"
                 else cfg.ssm_heads)
        route = linear_attention_route(heads, SUBQ_MESH_SEQ, tp)
        label = f"subq (e) {arch} {variant or 'reduced'} on (1, {tp})"
        rel = max(abs(a - b) / abs(b)
                  for a, b in zip(got["losses"], want["losses"]))
        if rel > MESH_LOSS_RTOL:
            fail(f"{label}: losses {got['losses']} against one rank's "
                 f"{want['losses']} (relative {rel})")
        worst = same_params(label, got["params"], want["params"],
                            SUBQ_MESH_PARAM_ATOL)
        mean = float(np.mean([float((got["params"][n] - p).abs().mean())
                              for n, p in want["params"].items()]))
        want_k6 = want["k6"] if device == "cuda" else (0, want["k6"][1])
        if tuple(got["k6"]) != tuple(want_k6):
            fail(f"{label}: K6 (launches, plain) {got['k6']} on rank 0, one "
                 f"rank {want['k6']}")
        log(f"{label}, float32, {SUBQ_MESH_STEPS} steps of "
            f"{MESH_PARITY_BATCH} x {SUBQ_MESH_SEQ}: the mix's route "
            f"{route}; losses {got['losses']} (one rank {want['losses']}; "
            f"largest relative difference {rel:.3e}); parameters within "
            f"{worst:.3e} (mean {mean:.3e}); K6 (launches, plain) on rank 0 "
            f"{got['k6']}")
        parity.append(dict(arch=arch, variant=variant, route=route,
                           losses=got["losses"], loss_rel=rel,
                           param_max_diff=worst, param_mean_diff=mean))
    full = {}
    tokens = TRAIN_BATCH * TRAIN_SEQ
    for arch in SUBQ_ARCHS:
        cfg = get_config(arch) if opts["full"] else get_reduced(arch)
        train = [r["subq_train"][arch] for r in ranks]
        losses = train[0]["losses"]
        steps = len(losses)
        attn = cfg.n_layers if cfg.block == "hymba" else 0
        per_step = attn * TRAIN_MICROBATCH
        want_k6 = (steps * per_step * (2 if cfg.remat else 1),
                   steps * per_step, 0)
        if device != "cuda":
            want_k6 = (0, want_k6[1], want_k6[0])
        for r, t in enumerate(train):
            if tuple(t["k6"]) != want_k6 or t["losses"] != losses:
                fail(f"subq (f) {arch} rank {r}: K6 (launches, backwards, "
                     f"plain) {t['k6']}, not {want_k6}, or losses "
                     f"{t['losses']} unlike rank 0's {losses}")
        first = first_losses.get(arch)
        if not all(np.isfinite(losses)) or (
                first is not None
                and abs(losses[0] - first) > SUBQ_MESH_FIRST_RTOL
                * abs(first)):
            fail(f"subq (f) {arch}: losses {losses}; the first not within "
                 f"{SUBQ_MESH_FIRST_RTOL} of one card's {first}")
        steady = sorted(train[0]["step_seconds"][1:]
                        or train[0]["step_seconds"])
        step_s = steady[len(steady) // 2]
        staged = [t["staged"] for t in train]
        peaks = [t["peak_bytes"] for t in train]
        reading = dict(
            losses=losses, first_loss_one_card=first, step_s=step_s,
            step_seconds=train[0]["step_seconds"],
            tokens_per_s=tokens / step_s, peak_bytes=peaks,
            collectives_per_step=[st["calls"] / steps for st in staged],
            to_host_bytes_per_step=[st["to_host"] / steps for st in staged],
            to_card_bytes_per_step=[st["to_card"] / steps for st in staged],
            collective_s_per_step=[st["seconds"] / steps for st in staged],
            k6_per_step_per_rank=[want_k6[0] // steps, want_k6[1] // steps])
        log(f"subq (f) {arch} at full size over {tp} ranks (mesh (1, {tp}), "
            f"gloo, sharing the card): {steps} steps of {TRAIN_BATCH} x "
            f"{TRAIN_SEQ} in {TRAIN_MICROBATCH} microbatches; losses "
            f"{losses} (one card's first {first}); step seconds "
            f"{train[0]['step_seconds']} ({tokens / step_s:.1f} tokens/s); "
            f"peak memory by rank {peaks} B; collectives a step by rank "
            f"{reading['collectives_per_step']}, bytes staged a step to the "
            f"host {reading['to_host_bytes_per_step']} and to the card "
            f"{reading['to_card_bytes_per_step']}, collective seconds a step "
            f"{reading['collective_s_per_step']}; K6 (launches, backwards) "
            f"a step on each rank {reading['k6_per_step_per_rank']}; on "
            f"{smi}")
        full[arch] = reading
    log(f"subq (e) + (f) ranks: {wall:.1f} s")
    return dict(float32=parity, full=full)


def subq_phase(ops, smi: str) -> dict:
    """20. The sub-quadratic blocks (module docstring): (a) RWKV6-1.6B and
    (b) Hymba-1.5B served whole, (c) card against CPU, (d) RWKV6-1.6B
    trained at full size, (e) float32 parity over 2 ranks, (f) both
    trained at full size over 2 ranks and Hymba-1.5B on one card; K6 held
    to its plain version at every signature (a)-(f) launched it with,
    here and on the ranks.  Returns the ``subquadratic`` entry of K6's
    kernels-line row."""
    t_phase = time.perf_counter()
    launch = ops.flash_attention_cuda
    seen = k6_record_launches(ops)      # every K6 launch of (a)-(f) here
    try:
        serving = {}
        for arch in SUBQ_ARCHS:
            serving[arch] = subq_serving_reading(ops, arch, smi)
            log(f"subq {arch}: {time.perf_counter() - t_phase:.1f} s into "
                f"the phase")
        parity = subq_parity_reading(ops)
        train = subq_training_reading(ops, smi)
        hymba = subq_training_reading(ops, smi, SUBQ_ARCHS[1],
                                      SUBQ_HYMBA_STEPS)
        log(f"subq (a)-(d), (f) one card: {time.perf_counter() - t_phase:.1f}"
            f" s into the phase")
        mesh = subq_mesh_reading(ops, smi, {
            SUBQ_ARCHS[0]: train["losses"][0],
            SUBQ_ARCHS[1]: hymba["losses"][0]}, k6_shapes=seen)
    finally:
        ops.flash_attention_cuda = launch
    main_shapes = k6_path_reading(ops, seen)
    # (f)'s sequence route: the last rank's query rows, timed
    shard = max((sg for sg in seen if sg[2] == "bfloat16" and sg[4] > 0),
                key=lambda sg: (int(np.prod(sg[0])), sg[4]))
    mesh["k6_rank"] = k6_signature_reading(ops, shard)
    log(f"subq phase: {time.perf_counter() - t_phase:.1f} s")
    k6 = serving[SUBQ_ARCHS[1]].pop("k6")
    mesh["full"][SUBQ_ARCHS[1]]["one_card"] = hymba
    return dict(k6, serving=serving, card_vs_host=parity,
                training=train, mesh=mesh, main_path_shapes=main_shapes)


# ---------------------------------------------------------------- phase 21 --

def vlm_positions(b: int, s: int, grid, text) -> np.ndarray:
    """``[3, b, s]`` int32 M-RoPE ids of VLM prompts: per row ``i``,
    ``text[i]`` text tokens, then an image block of the ``t x h x w``
    ``grid`` (temporal ``text + frame``, height ``text + row``, width
    ``text + column``), then text from the largest id so far plus 1, all
    three streams equal."""
    t, h, w = grid
    out = np.zeros((3, b, s), np.int32)
    frames, rows, cols = np.meshgrid(np.arange(t), np.arange(h),
                                     np.arange(w), indexing="ij")
    img = np.stack([frames, rows, cols]).reshape(3, -1)
    for i in range(b):
        n = text[i % len(text)]
        out[:, i, :n] = np.arange(n)
        out[:, i, n:n + img.shape[1]] = img + n
        rest = s - n - img.shape[1]
        out[:, i, s - rest:] = img.max() + n + 1 + np.arange(rest)
    return out


def vlm_batch(cfg, b: int, s: int, grid, text, seed: int, device) -> dict:
    """Seeded embeddings ``[b, s, D]`` (N(0, 1), as the reference's stub
    frontend draws its table) in the activation dtype and the M-RoPE ids
    of :func:`vlm_positions`, on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    emb = torch.randn((b, s, cfg.d_model), generator=gen, device=device)
    return {"embeds": emb.to(cfg.act_dtype()), "positions": torch.from_numpy(
        vlm_positions(b, s, grid, text)).to(device)}


def vlm_consistency_reading() -> dict:
    """21: the reduced qwen2-vl-72b in float32 on the card (generator seed
    0): a prefill of a VLM prompt's first 20 positions (text, a 1 x 4 x 4
    image, text) and decode steps fed ``embed1`` for the rest, against
    ``forward`` on ids that give the decoded tokens their positions (the
    reference's decode sets all three ids to ``pos``), under phase 8's
    bars over the largest logit."""
    from repro_torch.configs import get_reduced
    from repro_torch.models.model import build_model
    cfg = get_reduced(VLM_ARCH).replace(dtype="float32",
                                        param_dtype="float32")
    model = build_model(cfg).init(torch.Generator(device="cuda")
                                  .manual_seed(0))
    b, s, p = 2, 26, 20
    batch = vlm_batch(cfg, b, s, (1, 4, 4), (4, 2), 21, "cuda")
    pos = batch["positions"].clone()
    pos[:, :, p:] = torch.arange(p, s, device="cuda")
    full = model.forward({"embeds": batch["embeds"], "positions": pos})
    cache = model.init_cache(b, s)
    last, cache = model.prefill({"embeds": batch["embeds"][:, :p],
                                 "positions": pos[:, :, :p]}, cache)
    steps = [last]
    for i in range(p, s - 1):
        out, cache = model.decode_step(cache, {
            "embed1": batch["embeds"][:, i:i + 1], "pos": i})
        steps.append(out)
    stepwise = torch.stack(steps, 1)
    want = full[:, p - 1:s - 1]
    scale = float(want.abs().max())
    rel = dict(prefill=float((last - want[:, 0]).abs().max()) / scale,
               decode=float((stepwise - want).abs().max()) / scale)
    log(f"vlm reduced {VLM_ARCH} float32 on the card: prefill of {p} "
        f"positions (a 1 x 4 x 4 image inside) and {s - 1 - p} decode steps "
        f"fed embed1 against forward, max abs difference over the largest "
        f"logit {rel} (bars {LM_PREFILL_TOL}, {LM_DECODE_TOL})")
    if not (rel["prefill"] <= LM_PREFILL_TOL
            and rel["decode"] <= LM_DECODE_TOL):
        fail(f"vlm: the reduced model's prefill and decode differ from "
             f"forward by {rel}")
    del model, cache
    return rel


def vlm_phase(ops, smi: str) -> dict:
    """21. Qwen2-VL-72B served at its published width, its layers cut to
    ``VLM_LAYERS`` (``VLM_*``; module docstring).  Returns K6's reading at
    layer 0, the ``vlm`` entry of K6's kernels-line row."""
    import gc
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.kernels.attention import (flash_attention_plain,
                                               flash_attention_route)
    from repro_torch.models.model import build_model
    t_phase = time.perf_counter()
    consistency = vlm_consistency_reading()
    full = get_config(VLM_ARCH)
    cfg = full.replace(n_layers=VLM_LAYERS)
    route = flash_attention_route(cfg.act_dtype(), cfg.hd)
    if route != "wgmma":
        fail(f"K6 takes the {route} route at hd {cfg.hd}, not wgmma")
    gc.collect()
    torch.cuda.empty_cache()
    sync()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg).init(
        torch.Generator(device="cuda").manual_seed(0))
    sync()
    n_params = sum(p.numel() for p in model.parameters())
    w_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    log(f"vlm: {VLM_ARCH} at full width (d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.hd}, d_ff {cfg.d_ff} "
        f"{cfg.mlp}, vocab {cfg.vocab}, rope {cfg.rope}, embedding inputs "
        f"{cfg.embeds_input}, {cfg.dtype}); n_layers cut from "
        f"{full.n_layers} to {cfg.n_layers} so that one card holds the "
        f"weights: {n_params} parameters, {w_bytes} B, initialised in "
        f"{time.perf_counter() - t0:.2f} s; K6 route at hd {cfg.hd}: "
        f"{route}; on {smi}")
    b, s, n_new = VLM_BATCH, VLM_PROMPT, VLM_NEW
    batch = vlm_batch(cfg, b, s, VLM_GRID, VLM_TEXT, 0, "cuda")
    cache = model.init_cache(b, s + n_new)
    # a short prefill first warms cuBLAS and the allocator
    model.prefill({"embeds": batch["embeds"][:, :256],
                   "positions": batch["positions"][:, :, :256]}, cache)
    sync()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    t0 = time.perf_counter()
    logits, cache = model.prefill(batch, cache)
    sync()
    t_prefill = time.perf_counter() - t0
    k6 = (ops.LAUNCHES["flash_attention"], ops.PLAIN_CALLS["flash_attention"])
    tok = logits.argmax(dim=-1)[:, None]
    out, steps = [tok], []
    for i in range(n_new):
        t1 = time.perf_counter()
        logits, cache = model.decode_step(cache, {"token": tok,
                                                  "pos": s + i})
        tok = logits.argmax(dim=-1)[:, None]
        out.append(tok)
        sync()
        steps.append(time.perf_counter() - t1)
    peak = torch.cuda.max_memory_allocated()
    gen = torch.cat(out, dim=1)
    median = sorted(steps)[len(steps) // 2]
    bound_decode = 1e3 * w_bytes / HBM_BYTES_PER_S
    if k6 != (cfg.n_layers, 0):
        fail(f"vlm: the prefill launched K6 {k6[0]} times ({k6[1]} plain), "
             f"not {cfg.n_layers}")
    if not torch.isfinite(logits).all() or logits.shape != (b, cfg.vocab):
        fail(f"vlm: bad decode logits {tuple(logits.shape)}")
    if gen.shape != (b, n_new + 1) or gen.min() < 0 \
            or gen.max() >= cfg.vocab:
        fail("vlm: generated tokens out of range")
    log(f"vlm main run: prefill {b} x {s} embeddings (a {VLM_GRID} image "
        f"after {VLM_TEXT} text tokens a row) in {t_prefill:.4f} s "
        f"({b * s / t_prefill:.1f} tok/s), K6 launches {k6[0]} (plain "
        f"{k6[1]}); {n_new} greedy decode steps x {b} requests: first "
        f"{1e3 * steps[0]:.3f} ms, median {1e3 * median:.3f} ms, mean "
        f"{1e3 * sum(steps) / n_new:.3f} ms a step (reading the weights "
        f"once bounds it at {bound_decode:.3f} ms); max_memory_allocated "
        f"{peak} B; first tokens {gen[0, :8].tolist()}; on {smi}")
    sync()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        model.prefill(batch, cache)
        sync()
    wall_p = time.perf_counter() - t0
    pre = raw_step_reading(prof, "vlm prefill")
    log(f"vlm prefill profile: {wall_p:.4f} s wall, device busy "
        f"{pre['busy_s']:.4f} s ({100 * pre['busy_s'] / wall_p:.2f} %), K6 "
        f"{pre['k6_s']:.4f} s")
    for name, (ms, n) in pre["top"][:8]:
        log(f"  prefill {ms:9.3f} ms  x{n:<6d} {name[:100]}")
    del prof, cache, logits
    q, k, v = layer0_qkv(model, batch)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    err = check_k6(ops, q, k, v, f"{VLM_ARCH} layer 0")
    if ops.PLAIN_CALLS["flash_attention"]:
        fail("vlm: plain attention ran on the card")
    hq, hd = q.shape[2], q.shape[3]
    flops = 4.0 * b * hq * hd * s * (s + 1) / 2      # causal pairs only
    b_ms, b_by = bound_ms(2.0 * (2 * q.numel() + k.numel() + v.numel()),
                          flops, BF16_OPS_PER_S)
    reading = dict(
        shape=f"B={b} S={s} H={hq} Hkv={k.shape[2]} hd={hd} causal bf16 "
              f"({VLM_ARCH} layer 0, M-RoPE ids of an image)",
        route=route, launches=k6[0], max_abs_err=err,
        bound_ms=b_ms, bound_by=b_by,
        ms=cuda_ms(lambda: ops.flash_attention(q, k, v, causal=True)),
        device_ms=device_ms(lambda: ops.flash_attention(q, k, v,
                                                        causal=True), reps=5),
        plain_ms=cuda_ms(lambda: flash_attention_plain(q, k, v, True),
                         reps=3),
        library_ms=cuda_ms(sdpa_call(q, k, v)),
        library_device_ms=device_ms(sdpa_call(q, k, v), reps=5),
        layers=cfg.n_layers, params=n_params, weight_bytes=w_bytes,
        prefill_s=t_prefill, prefill_tokens_per_s=b * s / t_prefill,
        prefill_busy_share=pre["busy_s"] / wall_p,
        decode_ms_per_step=1e3 * sum(steps) / n_new,
        decode_median_ms=1e3 * median, decode_bound_ms=bound_decode,
        peak_bytes=peak, reduced_float32=consistency)
    log(f"K6 on {VLM_ARCH} layer 0 [{reading['shape']}]: {route}, "
        f"max_abs_err {err} (tolerance {K6_BF16_TOL}); device "
        f"{reading['device_ms']} ms (events {reading['ms']:.4f}), plain "
        f"{reading['plain_ms']:.4f} ms, SDPA device "
        f"{reading['library_device_ms']} ms (events "
        f"{reading['library_ms']:.4f}), bound {b_ms:.4f} ms ({b_by}); K6 "
        f"share of the prefill {k6[0]} x {reading['ms']:.4f} ms = "
        f"{100 * k6[0] * reading['ms'] / 1e3 / t_prefill:.2f} %; on {smi}; "
        f"phase {time.perf_counter() - t_phase:.1f} s")
    del q, k, v, batch
    gc.collect()
    torch.cuda.empty_cache()
    return reading


# ---------------------------------------------------------------- phase 22 --

def whisper_inputs(cfg, b: int, s: int, seed: int, device="cuda"):
    """Seeded stub frames ``[b, enc_frames, D]`` (N(0, 1), as the
    reference's stub frontend draws them) in the activation dtype and
    tokens ``[b, s]`` int64 (numpy ``default_rng(seed)``) on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    frames = torch.randn((b, cfg.enc_frames, cfg.d_model), generator=gen,
                         device=device).to(cfg.act_dtype())
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, s), dtype=np.int64)).to(device)
    return frames, toks


def whisper_consistency(model, b: int, s: int, bars: dict,
                        seed: int = 1) -> dict:
    """(b) ``tests/test_arch_smoke.py``'s property on the encoder-decoder:
    a prefill of ``s - 1`` tokens (its last logits against ``forward`` at
    ``s - 2``) into a cache of ``s``, then one decode step (against
    ``forward`` at ``s - 1``); each max abs difference over the largest
    logit, held to ``bars`` by name."""
    frames, toks = whisper_inputs(model.cfg, b, s, seed, model.device)
    logits_all = model.forward({"frames": frames, "tokens": toks})
    cache = model.init_cache(b, s)
    last, cache = model.prefill({"frames": frames, "tokens": toks[:, :-1]},
                                cache)
    step, _ = model.decode_step(cache, {"token": toks[:, -1:],
                                        "pos": s - 1})
    rel = {}
    for name, got, want in (("prefill", last, logits_all[:, s - 2]),
                            ("decode", step, logits_all[:, s - 1])):
        if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
            fail(f"whisper consistency: non-finite {name} logits")
        rel[name] = float((got - want).abs().max()) / float(
            want.abs().max())
    log(f"whisper consistency ({b} x {s} tokens over {model.cfg.enc_frames} "
        f"frames, {model.cfg.dtype}, {model.cfg.n_layers} decoder layers): "
        f"max abs difference from forward over the largest logit {rel} "
        f"(bars {bars})")
    if any(rel[k] > bars[k] for k in rel):
        fail(f"whisper consistency: prefill and decode differ from forward "
             f"by {rel} (bars {bars})")
    return rel


def whisper_layer0_qkv(model, frames, tokens) -> dict:
    """Layer 0's q, k, v of each of Whisper's attentions in a prefill of
    ``frames`` and ``tokens``, recomputed by the same operations:
    ``{name: ((q, k, v), causal)}`` for the encoder's self-attention, the
    decoder's self-attention and its cross-attention (the query of the
    decoder's layer 0 over that layer's ``xk``, ``xv`` of the encoder's
    output)."""
    from repro_torch.models.attention import attend, out_project, qkv_project
    from repro_torch.models.layers import rms_norm
    cfg = model.cfg
    with torch.no_grad():
        blk = model.enc[0]
        x = model._positioned(frames.to(cfg.act_dtype()))
        enc = qkv_project(blk.attn, rms_norm(x, blk.norm1), cfg, None)
        dec = model.dec[0]
        y = model._decoder_in(tokens)
        own = qkv_project(dec.attn, rms_norm(y, dec.norm1), cfg, None)
        ao = attend(*own, cfg.n_heads, cfg.n_kv_heads, True)
        b, s = y.shape[:2]
        y = y + out_project(dec.attn.wo, ao.reshape(b, s, -1))
        cross = qkv_project(dec.xattn, rms_norm(y, dec.norm_x), cfg, None,
                            kv_in=model.encode(frames))
    return {"encoder": (enc, False), "decoder_self": (own, True),
            "cross": (cross, False)}


def whisper_k6_reading(ops, name: str, qkv, causal: bool,
                       launches: int) -> dict:
    """(c) K6 at one of Whisper's signatures: against its plain version
    (``K6_BF16_TOL``), timed (CUDA events and device time) beside SDPA and
    the bound of its bytes and its operations (the pairs this run's mask
    keeps)."""
    from repro_torch.kernels.attention import (flash_attention_plain,
                                               flash_attention_route)
    q, k, v = qkv
    b, sq, h, hd = q.shape
    skv = k.shape[1]
    err = check_k6(ops, q, k, v, f"whisper {name}", causal=causal)
    pairs = sq * (sq + 1) / 2 if causal else sq * skv
    flops = 4.0 * b * h * hd * pairs
    b_ms, b_by = bound_ms(2.0 * (2 * q.numel() + k.numel() + v.numel()),
                          flops, BF16_OPS_PER_S)
    reading = dict(
        shape=(f"B={b} Sq={sq} Skv={skv} H={h} Hkv={k.shape[2]} hd={hd} "
               f"{'causal' if causal else 'full'} {str(q.dtype)[6:]} "
               f"({WHISPER_ARCH} layer 0, {name})"),
        route=flash_attention_route(q.dtype, hd), launches=launches,
        max_abs_err=err, operations=flops, bound_ms=b_ms, bound_by=b_by,
        **timings(lambda: ops.flash_attention(q, k, v, causal),
                  lambda: flash_attention_plain(q, k, v, causal),
                  sdpa_call(q, k, v, causal), plain_reps=3))
    log(f"K6 at whisper's {name} [{reading['shape']}]: {reading['route']}, "
        f"max_abs_err {err} (tolerance {K6_BF16_TOL}); events "
        f"{reading['ms']:.4f} ms, device {reading['device_ms']} ms; plain "
        f"{reading['plain_ms']:.4f} ms; SDPA {reading['library_ms']:.4f} / "
        f"{reading['library_device_ms']} ms; bound {b_ms:.4f} ms ({b_by}, "
        f"{flops:.3e} operations); {launches} launches a prefill")
    return reading


def whisper_serving_reading(ops, smi: str) -> dict:
    """22 (a) and (c): whisper-base served at full size, then K6 at its
    three signatures on layer 0's q, k, v."""
    import gc
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    cfg = get_config(WHISPER_ARCH)
    gc.collect()
    torch.cuda.empty_cache()
    sync()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg).init(
        torch.Generator(device="cuda").manual_seed(0))
    sync()
    n_params = sum(p.numel() for p in model.parameters())
    w_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    log(f"whisper: {WHISPER_ARCH} at full size ({cfg.enc_layers} encoder "
        f"and {cfg.n_layers} decoder layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.hd}, d_ff {cfg.d_ff} "
        f"{cfg.mlp}, vocab {cfg.vocab}, {cfg.enc_frames} frames, "
        f"{cfg.dtype}): {n_params} parameters, {w_bytes} B, initialised in "
        f"{time.perf_counter() - t0:.2f} s; on {smi}")
    consistency = whisper_consistency(model, LM_CHECK_BATCH, LM_CHECK_LEN,
                                      dict(prefill=LM_PREFILL_TOL,
                                           decode=LM_DECODE_TOL))
    b, s, n_new = WHISPER_BATCH, WHISPER_PROMPT, WHISPER_NEW
    frames, prompts = whisper_inputs(cfg, b, s, 22)
    cache = model.init_cache(b, WHISPER_CTX)
    # a short prefill first warms cuBLAS and the allocator
    model.prefill({"frames": frames[:2], "tokens": prompts[:2, :16]})
    sync()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    t0 = time.perf_counter()
    enc_out = model.encode(frames)
    sync()
    t_encode = time.perf_counter() - t0
    k6_encode = ops.LAUNCHES["flash_attention"]
    del enc_out
    ops.reset_counts()
    t0 = time.perf_counter()
    logits, cache = model.prefill({"frames": frames, "tokens": prompts},
                                  cache)
    sync()
    t_prefill = time.perf_counter() - t0
    k6 = (ops.LAUNCHES["flash_attention"], ops.PLAIN_CALLS["flash_attention"])
    tok = logits.argmax(dim=-1)[:, None]
    # (e)'s split-cache decode starts from the same token, and its first
    # step's logits are held to this one's
    first = dict(prefill=logits.float().cpu(), token=tok.cpu())
    out, steps = [tok], []
    ops.reset_counts()
    for i in range(n_new):
        t1 = time.perf_counter()
        logits, cache = model.decode_step(cache, {"token": tok,
                                                  "pos": s + i})
        if i == 0:
            first["step"] = logits.float().cpu()
        tok = logits.argmax(dim=-1)[:, None]
        out.append(tok)
        sync()
        steps.append(time.perf_counter() - t1)
    k6_decode = ops.LAUNCHES["flash_attention"]
    check_no_plain(ops, "whisper decode")
    peak = torch.cuda.max_memory_allocated()
    gen = torch.cat(out, dim=1)
    median = sorted(steps)[len(steps) // 2]
    dec_bytes = sum(p.numel() * p.element_size()
                    for p in model.dec.parameters())
    x_bytes = cache["xk"].numel() * cache["xk"].element_size() * 2
    e_bytes = model.embed.numel() * model.embed.element_size()
    bound_decode = 1e3 * (dec_bytes + e_bytes + x_bytes) / HBM_BYTES_PER_S
    want_k6 = (cfg.enc_layers + 2 * cfg.n_layers, 0)
    if k6 != want_k6 or k6_encode != cfg.enc_layers:
        fail(f"whisper: the prefill launched K6 {k6[0]} times ({k6[1]} "
             f"plain), the encoder alone {k6_encode}; not {want_k6[0]} and "
             f"{cfg.enc_layers}")
    if k6_decode != n_new * cfg.n_layers:
        fail(f"whisper: {n_new} decode steps launched K6 {k6_decode} times, "
             f"not once a decoder layer a step")
    if not torch.isfinite(logits).all() or logits.shape != (b, cfg.vocab):
        fail(f"whisper: bad decode logits {tuple(logits.shape)}")
    if gen.shape != (b, n_new + 1) or gen.min() < 0 \
            or gen.max() >= cfg.vocab:
        fail("whisper: generated tokens out of range")
    log(f"whisper main run: encode {b} x {cfg.enc_frames} frames in "
        f"{t_encode:.4f} s ({b * cfg.enc_frames / t_encode:.1f} frames/s, "
        f"K6 {k6_encode}); prefill (encoder, {b} x {s} prompt tokens, xk/xv) "
        f"in {t_prefill:.4f} s ({b * s / t_prefill:.1f} prompt tok/s), K6 "
        f"launches {k6[0]} (plain {k6[1]}); {n_new} greedy decode steps x "
        f"{b} requests into a {WHISPER_CTX} cache: first "
        f"{1e3 * steps[0]:.3f} ms, median {1e3 * median:.3f} ms, mean "
        f"{1e3 * sum(steps) / n_new:.3f} ms a step ({b * n_new / sum(steps):.1f}"
        f" tok/s; reading the decoder's weights, the tied head and xk/xv "
        f"once bounds a step at {bound_decode:.4f} ms), K6 {k6_decode // n_new}"
        f" launches a step; max_memory_allocated {peak} B; first tokens "
        f"{gen[0, :8].tolist()}; on {smi}")
    log(f"  decode step ms: {[round(1e3 * t, 3) for t in steps]}")
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(4):
            model.decode_step(cache, {"token": tok, "pos": s + n_new + i})
        sync()
    dec_prof = raw_step_reading(prof, "whisper decode")
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        model.prefill({"frames": frames, "tokens": prompts}, cache)
        sync()
    wall_p = time.perf_counter() - t0
    pre = raw_step_reading(prof, "whisper prefill")
    log(f"whisper profiles: decode {dec_prof['events'] / 4:.0f} device "
        f"events and {1e3 * dec_prof['busy_s'] / 4:.3f} ms busy a step; "
        f"prefill {wall_p:.4f} s wall, device busy {pre['busy_s']:.4f} s "
        f"({100 * pre['busy_s'] / wall_p:.2f} %), K6 {pre['k6_s']:.4f} s")
    for name, (ms, n) in pre["top"][:8]:
        log(f"  prefill {ms:9.3f} ms  x{n:<6d} {name[:100]}")
    del prof, cache, logits
    sigs = whisper_layer0_qkv(model, frames, prompts)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    launches = {"encoder": cfg.enc_layers, "decoder_self": cfg.n_layers,
                "cross": cfg.n_layers}
    k6_sigs = {name: whisper_k6_reading(ops, name, qkv, causal,
                                        launches[name])
               for name, (qkv, causal) in sigs.items()}
    if ops.PLAIN_CALLS["flash_attention"]:
        fail("whisper: plain attention ran on the card")
    del sigs
    gc.collect()
    torch.cuda.empty_cache()
    return dict(params=n_params, weight_bytes=w_bytes,
                consistency=consistency, encode_s=t_encode,
                prefill_s=t_prefill, prefill_tokens_per_s=b * s / t_prefill,
                prefill_busy_share=pre["busy_s"] / wall_p,
                decode_ms=[1e3 * t for t in steps],
                decode_median_ms=1e3 * median,
                decode_tokens_per_s=b * n_new / sum(steps),
                decode_bound_ms=bound_decode,
                decode_events_per_step=dec_prof["events"] / 4,
                k6_prefill=k6[0], k6_decode_per_step=k6_decode // n_new,
                peak_bytes=peak, k6=k6_sigs, first=first)


def whisper_reduced_f32_reading() -> dict:
    """22 (b): the reduced whisper-base in float32 on the card, its prefill
    and decode against ``forward`` within ``WHISPER_F32_REL``, at the
    reduced config's 64 frames and at 50 (the ragged key end)."""
    from repro_torch.configs import get_reduced
    from repro_torch.models.model import build_model
    out = {}
    for frames in (64, 50):
        cfg = get_reduced(WHISPER_ARCH).replace(
            dtype="float32", param_dtype="float32", enc_frames=frames)
        model = build_model(cfg).init(torch.Generator(device="cuda")
                                      .manual_seed(0))
        bars = dict(prefill=WHISPER_F32_REL, decode=WHISPER_F32_REL)
        out[frames] = whisper_consistency(model, 2, 24, bars, seed=2)
    return out


def whisper_training_reading(ops, smi: str) -> dict:
    """22 (d): whisper-base trained at full size through the launcher,
    ``WHISPER_TRAIN_STEPS`` steps of ``WHISPER_BATCH`` x ``WHISPER_CTX``
    tokens over the stub frames, and one more step profiled.  K6 runs each
    attention once a step (the encoder-decoder runs no layer under remat),
    with one plain backward each; the last three losses average below the
    first."""
    import gc
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
    from repro_torch.launch import train as launcher
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(WHISPER_ARCH)
    steps, b, s = WHISPER_TRAIN_STEPS, WHISPER_BATCH, WHISPER_CTX
    per_step = cfg.enc_layers + 2 * cfg.n_layers
    want_k6 = (steps * per_step, steps * per_step, 0)
    argv = ["--arch", WHISPER_ARCH, "--steps", str(steps), "--batch",
            str(b), "--seq", str(s), "--lr", str(WHISPER_LR), "--seed", "0",
            "--log-every", "1"]
    sync()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    t0 = time.perf_counter()
    run = launcher.train(launcher.parse_args(argv))
    sync()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    counts = (ops.LAUNCHES["flash_attention"],
              ops.BACKWARD_CALLS["flash_attention"],
              ops.PLAIN_CALLS["flash_attention"])
    losses = run.losses
    steady = sorted(run.step_seconds[1:])
    step_s = steady[len(steady) // 2]
    batch = launcher.make_model_batch(cfg, SyntheticCorpus(DataConfig(
        vocab=cfg.vocab, seq_len=s, global_batch=b, seed=0)).batch(steps),
        torch.device("cuda"))
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        _, metrics = run.step_fn(run.state, batch)
        loss_p = float(metrics["loss"])
        sync()
        wall_p = time.perf_counter() - t1
    reading = raw_step_reading(prof, "whisper (d)")
    log(f"whisper (d) {WHISPER_ARCH} trained at full size: {steps} steps of "
        f"{b} x {s} tokens over {b} x {cfg.enc_frames} stub frames, AdamW at "
        f"{WHISPER_LR}, {wall:.2f} s in the launcher; losses {losses}; step "
        f"seconds {run.step_seconds}; median after the first {step_s:.4f} s "
        f"({b * s / step_s:.1f} tokens/s); max_memory_allocated {peak} B; K6 "
        f"(launches, backwards, plain calls) {counts}; one more step "
        f"profiled: loss {loss_p:.4f}, {wall_p:.4f} s wall, device busy "
        f"{reading['busy_s']:.4f} s, K6 {reading['k6_s']:.4f} s, attention "
        f"backward span {reading['backward_span_s']} s; on {smi}")
    for name, (ms, n) in reading["top"][:8]:
        log(f"  {ms:9.3f} ms  x{n:<6d} {name[:100]}")
    if counts != want_k6:
        fail(f"whisper (d): K6 (launches, backwards, plain calls) {counts}, "
             f"not {want_k6}")
    if not all(np.isfinite(losses + [loss_p])) or len(losses) != steps:
        fail(f"whisper (d): losses {losses}, profiled {loss_p}")
    if not np.mean(losses[-3:]) < losses[0]:
        fail(f"whisper (d): the last three losses average "
             f"{np.mean(losses[-3:])}, not below the first {losses[0]}")
    del run, batch, prof, metrics
    gc.collect()
    torch.cuda.empty_cache()
    return dict(losses=losses, step_s=step_s, tokens_per_s=b * s / step_s,
                peak_bytes=peak, k6_per_step=[c // steps for c in counts[:2]],
                profiled_step=dict(wall_s=wall_p, busy_s=reading["busy_s"],
                                   k6_s=reading["k6_s"],
                                   backward_span_s=reading["backward_span_s"],
                                   top=[(name[:80], ms) for name, (ms, _)
                                        in reading["top"][:6]]))


def whisper_mesh_parity_run(mesh, device: str) -> dict:
    """22 (e) 1: ``WHISPER_MESH_PARITY_STEPS`` AdamW steps of the reduced
    whisper-base in float32 (generator seed 0) over seeded frames on
    ``device``, over ``mesh`` or one rank: the losses, the whole
    parameters on the host and K6's (launches, plain calls)."""
    from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    from repro_torch.train import step as tstep
    from repro_torch.train.sharding import (param_shardings, shard_batch,
                                            unshard)
    cfg = mesh_parity_config({}, 1, WHISPER_ARCH)
    model = build_model(cfg, device, trainable=True).init(
        torch.Generator(device=device).manual_seed(0))
    if mesh is not None:
        model.shard_(mesh, param_shardings(dict(model.named_parameters()),
                                           mesh))
    opt = adamw.make_optimizer(adamw.OptConfig(**MESH_PARITY_OPT))
    params = dict(model.named_parameters())
    state = {"params": params, "opt": opt.init(params)}
    fn = tstep.make_train_step(model, opt)
    corpus = SyntheticCorpus(DataConfig(
        vocab=cfg.vocab, seq_len=MESH_PARITY_SEQ,
        global_batch=MESH_PARITY_BATCH, seed=MESH_PARITY_SEED))
    frames = torch.randn((MESH_PARITY_BATCH, cfg.enc_frames, cfg.d_model),
                         generator=torch.Generator(device=device)
                         .manual_seed(22), device=device)
    ops.reset_counts()
    losses = []
    for i in range(WHISPER_MESH_PARITY_STEPS):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in corpus.batch(i).items()}
        batch["frames"] = frames
        if mesh is not None:
            batch = shard_batch(batch, mesh)
        state, metrics = fn(state, batch)
        losses.append(float(metrics["loss"]))
    return dict(losses=losses, params={
        n: (p.detach() if mesh is None else
            unshard(p.detach(), p.spec, mesh)).cpu()
        for n, p in state["params"].items()},
        k6=(ops.LAUNCHES["flash_attention"],
            ops.PLAIN_CALLS["flash_attention"]))


def mesh_rank_whisper_parity(rank, world, work, mesh, opts) -> dict:
    return whisper_mesh_parity_run(mesh, opts["device"])


def whisper_mesh_decode_run(mesh, opts) -> dict:
    """22 (e) 3 on a rank: whisper-base (generator seed 0; the reduced
    config with ``opts["full"]`` false) cut over ``mesh``, (a)'s frames and
    prompts (``opts["whisper_decode"]``: batch, prompt, cache, steps)
    prefilled into this rank's block of the cache, then greedy decode
    steps from ``opts["whisper_token"]`` (one card's first token): the
    prefill's and the first step's logits on the host, each step's
    seconds and K6's launches."""
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    from repro_torch.train import step as tstep
    from repro_torch.train.sharding import param_shardings, shard_batch
    device = opts["device"]
    b, s, ctx, new = opts["whisper_decode"]
    cfg = (get_config if opts["full"] else get_reduced)(WHISPER_ARCH)
    model = build_model(cfg, device).init(
        torch.Generator(device=device).manual_seed(0))
    model.shard_(mesh, param_shardings(dict(model.named_parameters()),
                                       mesh))
    frames, prompts = whisper_inputs(cfg, b, s, 22, device)
    part = shard_batch({"frames": frames, "tokens": prompts}, mesh)
    cache = model.init_cache(b, ctx)
    ops.reset_counts()
    sync_on(device)
    t0 = time.perf_counter()
    last, cache = tstep.make_prefill_step(model)(part, cache)
    sync_on(device)
    prefill_s = time.perf_counter() - t0
    k6_prefill = (ops.LAUNCHES["flash_attention"],
                  ops.PLAIN_CALLS["flash_attention"])
    tok = opts["whisper_token"].to(device)
    step = tstep.make_decode_step(model, mesh)
    ops.reset_counts()
    seconds, first = [], None
    for i in range(new):
        t0 = time.perf_counter()
        logits, cache = step(cache, {"token": tok, "pos": s + i})
        tok = logits.argmax(dim=-1)[:, None]
        sync_on(device)
        seconds.append(time.perf_counter() - t0)
        if first is None:
            first = logits.float().cpu()
    out = dict(prefill_logits=last.float().cpu(), first_logits=first,
               finite=bool(torch.isfinite(logits).all()),
               step_seconds=seconds, prefill_s=prefill_s,
               k6_prefill=k6_prefill,
               k6_decode=(ops.LAUNCHES["flash_attention"],
                          ops.PLAIN_CALLS["flash_attention"]),
               cache_shape=tuple(cache["k"].shape),
               xk_shape=tuple(cache["xk"].shape))
    del model, cache
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def mesh_rank_whisper_decode(rank, world, work, mesh, opts) -> dict:
    return whisper_mesh_decode_run(mesh, opts)


def whisper_mesh_argv(world: int = MESH_TRAIN_RANKS) -> list:
    """22 (e) 2's launcher command line: (d)'s run over ``world`` ranks,
    ``WHISPER_MESH_STEPS`` steps."""
    return ["--arch", WHISPER_ARCH, "--steps", str(WHISPER_MESH_STEPS),
            "--batch", str(WHISPER_BATCH), "--seq", str(WHISPER_CTX),
            "--lr", str(WHISPER_LR), "--seed", "0", "--log-every", "1",
            "--model-axis", str(world)]


def mesh_rank_whisper_train(rank, world, work, mesh, opts) -> dict:
    """22 (e) 2 on a rank: whisper-base through the launcher,
    unprofiled."""
    return mesh_rank_train(rank, world, work, mesh, dict(
        opts, train_argv=opts["whisper_argv"], profile=False))


MESH_RANK_STEPS.update(whisper_parity=mesh_rank_whisper_parity,
                       whisper_decode=mesh_rank_whisper_decode,
                       whisper_train=mesh_rank_whisper_train)


def launcher_losses(stdout: str) -> list:
    """The losses the training launcher printed, one a step."""
    import re
    return [float(m.group(1)) for m in
            re.finditer(r"^step\s+\d+\s+loss\s+(\S+)", stdout, re.M)]


def whisper_mesh_reading(ops, smi: str, first_loss: float, first: dict,
                         opts: dict = None, k6_shapes: set = None) -> dict:
    """22 (e) over ``MESH_TRAIN_RANKS`` ranks sharing the card (mesh (1,
    2), gloo): 1. float32 parity of the reduced config against one rank in
    this process; 2. whisper-base at full size through the launcher, its
    first loss against ``first_loss`` ((d)'s); 3. the split-cache decode,
    its first step against ``first`` ((a)'s prefill logits, token and
    first step's logits); 4. the launcher under ``torch.distributed.run``.
    ``opts`` as :func:`mesh_train_phase`'s (``whisper_argv``,
    ``whisper_decode``, ``launch_argv``); the ranks' K6 signatures are
    added to ``k6_shapes``."""
    import gc
    import os
    import shutil
    import subprocess
    import tempfile
    from repro_torch.configs import get_config, get_reduced
    opts = opts or dict(
        device="cuda", full=True, whisper_argv=whisper_mesh_argv(),
        whisper_decode=(WHISPER_BATCH, WHISPER_PROMPT, WHISPER_CTX,
                        WHISPER_MESH_NEW),
        launch_argv=["--arch", WHISPER_ARCH, "--steps",
                     str(WHISPER_MESH_STEPS), "--seed", "0",
                     "--log-every", "1"])
    opts = dict(opts, whisper_token=first["token"])
    device = opts["device"]
    tp = MESH_TRAIN_RANKS
    t_e = time.perf_counter()
    one = whisper_mesh_parity_run(None, device)
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    work = tempfile.mkdtemp(prefix="whisper_mesh_")
    try:
        t0 = time.perf_counter()
        ranks = run_mesh_ranks(tp, work, ("whisper_parity", "whisper_decode",
                                          "whisper_train"), opts)
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for r in ranks:
        if k6_shapes is not None:
            k6_shapes.update(map(tuple, r["k6_shapes"]))

    # 1. float32 parity
    got = ranks[0]["whisper_parity"]
    label = f"whisper (e) reduced float32 on (1, {tp})"
    rel = max(abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                   one["losses"]))
    if rel > MESH_LOSS_RTOL:
        fail(f"{label}: losses {got['losses']} against one rank's "
             f"{one['losses']} (relative {rel})")
    worst = same_params(label, got["params"], one["params"], MESH_PARAM_ATOL)
    want_k6 = one["k6"] if device == "cuda" else (0, one["k6"][1])
    if tuple(got["k6"]) != tuple(want_k6):
        fail(f"{label}: K6 (launches, plain) {got['k6']} on rank 0, one rank "
             f"{one['k6']}")
    log(f"{label}, {WHISPER_MESH_PARITY_STEPS} AdamW steps of "
        f"{MESH_PARITY_BATCH} x {MESH_PARITY_SEQ} over {MESH_PARITY_BATCH} x "
        f"64 frames: losses {got['losses']} (one rank {one['losses']}; "
        f"largest relative difference {rel:.3e}); parameters within "
        f"{worst:.3e}; K6 (launches, plain) on rank 0 {got['k6']}")
    parity = dict(losses=got["losses"], loss_rel=rel, param_max_diff=worst)

    # 2. full-size training through the launcher
    cfg = get_config(WHISPER_ARCH) if opts["full"] else get_reduced(
        WHISPER_ARCH)
    train = [r["whisper_train"] for r in ranks]
    losses = train[0]["losses"]
    steps = len(losses)
    per_step = cfg.enc_layers + 2 * cfg.n_layers
    want_k6 = (steps * per_step, steps * per_step, 0)
    if device != "cuda":
        want_k6 = (0, want_k6[1], want_k6[0])
    for r, t in enumerate(train):
        if tuple(t["k6"]) != want_k6 or t["losses"] != losses:
            fail(f"whisper (e) training rank {r}: K6 (launches, backwards, "
                 f"plain) {t['k6']}, not {want_k6}, or losses {t['losses']} "
                 f"unlike rank 0's {losses}")
    if not all(np.isfinite(losses)) or steps != WHISPER_MESH_STEPS or (
            abs(losses[0] - first_loss) > MESH_FIRST_LOSS_RTOL
            * abs(first_loss)):
        fail(f"whisper (e) training: losses {losses}; the first not within "
             f"{MESH_FIRST_LOSS_RTOL} of one card's {first_loss}")
    steady = sorted(train[0]["step_seconds"][1:]
                    or train[0]["step_seconds"])
    step_s = steady[len(steady) // 2]
    staged = [t["staged"] for t in train]
    peaks = [t["peak_bytes"] for t in train]
    tokens = WHISPER_BATCH * WHISPER_CTX
    training = dict(
        losses=losses, first_loss_one_card=first_loss, step_s=step_s,
        step_seconds=train[0]["step_seconds"], tokens_per_s=tokens / step_s,
        peak_bytes=peaks,
        collectives_per_step=[st["calls"] / steps for st in staged],
        to_host_bytes_per_step=[st["to_host"] / steps for st in staged],
        to_card_bytes_per_step=[st["to_card"] / steps for st in staged],
        collective_s_per_step=[st["seconds"] / steps for st in staged],
        k6_per_step_per_rank=[want_k6[0] // steps, want_k6[1] // steps])
    log(f"whisper (e) {WHISPER_ARCH} at full size over {tp} ranks (mesh (1, "
        f"{tp}), gloo, sharing the card): {steps} steps of {WHISPER_BATCH} x "
        f"{WHISPER_CTX} tokens over {WHISPER_BATCH} x {cfg.enc_frames} "
        f"frames; losses {losses} (one card's first {first_loss}); step "
        f"seconds {train[0]['step_seconds']} ({tokens / step_s:.1f} "
        f"tokens/s); peak memory by rank {peaks} B; collectives a step by "
        f"rank {training['collectives_per_step']}, bytes staged a step to "
        f"the host {training['to_host_bytes_per_step']} and to the card "
        f"{training['to_card_bytes_per_step']}, collective seconds a step "
        f"{training['collective_s_per_step']}; K6 (launches, backwards) a "
        f"step on each rank {training['k6_per_step_per_rank']}; on {smi}")

    # 3. the split-cache decode
    b, s, ctx, new = opts["whisper_decode"]
    dec = [r["whisper_decode"] for r in ranks]
    got = dec[0]
    rel = {name: float((got[key] - first[ref]).abs().max())
           / float(first[ref].abs().max())
           for name, key, ref in (("prefill", "prefill_logits", "prefill"),
                                  ("first step", "first_logits", "step"))}
    want_pre = (cfg.enc_layers + 2 * cfg.n_layers, 0)
    want_dec = (new * cfg.n_layers, 0)
    if device != "cuda":
        want_pre, want_dec = (0, want_pre[0]), (0, want_dec[0])
    for r, d in enumerate(dec):
        if tuple(d["k6_prefill"]) != want_pre or \
                tuple(d["k6_decode"]) != want_dec or not d["finite"] or \
                d["cache_shape"][2] != ctx // tp:
            fail(f"whisper (e) decode rank {r}: K6 (launches, plain) prefill "
                 f"{d['k6_prefill']} (not {want_pre}), decode "
                 f"{d['k6_decode']} (not {want_dec}), finite {d['finite']}, "
                 f"cache {d['cache_shape']}")
    if rel["first step"] > LM_DECODE_TOL:
        fail(f"whisper (e) decode: the first step's logits differ from one "
             f"card's by {rel['first step']} of the largest (bar "
             f"{LM_DECODE_TOL})")
    ms = sorted(1e3 * t for t in got["step_seconds"])
    decode = dict(prefill_s=got["prefill_s"], step_ms=[
        1e3 * t for t in got["step_seconds"]], step_median_ms=ms[len(ms) // 2],
        rel_to_one_card=rel, cache_shape=got["cache_shape"],
        k6_prefill=got["k6_prefill"][0],
        k6_decode_per_step=got["k6_decode"][0] // new)
    log(f"whisper (e) split-cache decode over {tp} ranks: {b} x {s} prompt "
        f"tokens over {b} x {cfg.enc_frames} frames prefilled in "
        f"{got['prefill_s']:.4f} s into a {ctx} cache of {ctx // tp} a rank "
        f"(k {got['cache_shape']}, xk {got['xk_shape']}), then {new} greedy "
        f"steps from position {s} (rank 1's first row): median "
        f"{decode['step_median_ms']:.3f} ms a step ({decode['step_ms']}); "
        f"max abs difference from one card's over the largest logit {rel}; "
        f"K6 {decode['k6_prefill']} launches a prefill and "
        f"{decode['k6_decode_per_step']} a step on each rank; on {smi}")

    # 4. the launcher under torch.distributed.run
    root = Path(__file__).resolve().parent
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(tp), "-m", "repro_torch.launch.train",
           *opts["launch_argv"], "--model-axis", str(tp)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                         timeout=600, env=dict(os.environ,
                                               PYTHONPATH=str(root / "src")))
    wall_launch = time.perf_counter() - t0
    got_losses = launcher_losses(res.stdout)
    if res.returncode != 0 or len(got_losses) != WHISPER_MESH_STEPS or \
            not all(np.isfinite(got_losses)):
        fail(f"whisper (e) {' '.join(cmd[1:])}: rc {res.returncode}, losses "
             f"{got_losses}\n{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
    log(f"whisper (e) {' '.join(cmd[1:])}: rc 0 in {wall_launch:.1f} s, "
        f"losses {got_losses}")
    log(f"whisper (e): ranks {wall:.1f} s, the reading "
        f"{time.perf_counter() - t_e:.1f} s")
    return dict(float32=parity, training=training, decode=decode,
                launcher=dict(argv=cmd[3:], losses=got_losses,
                              wall_s=wall_launch), ranks_wall_s=wall)


def whisper_rank_k6_readings(ops, signatures, cfg) -> dict:
    """22 (e): K6 at each bf16 signature the ranks launched at a rank's
    share of whisper-base's heads, on random inputs: against its plain
    version, timed beside SDPA and its bound (:func:`whisper_k6_reading`),
    named by the attention it serves, with the launches each makes a
    training step (or a decode step) on each rank."""
    gen = torch.Generator(device="cuda").manual_seed(221)
    heads = cfg.n_heads // MESH_TRAIN_RANKS
    per = {"encoder": cfg.enc_layers, "decoder_self": cfg.n_layers,
           "cross": cfg.n_layers, "decode_cross": cfg.n_layers}
    out = {}
    for qs, ks, dt, causal, _ in sorted(signatures):
        if dt != "bfloat16" or qs[2] != heads or qs[3] != cfg.hd:
            continue
        sq, skv = qs[1], ks[1]
        kind = ("decoder_self" if causal else "decode_cross" if sq == 1
                else "encoder" if sq == skv == cfg.enc_frames else "cross")
        q = torch.randn(qs, generator=gen, device="cuda").bfloat16()
        k, v = (torch.randn(ks, generator=gen, device="cuda").bfloat16()
                for _ in range(2))
        out[f"{kind} Sq={sq} Skv={skv}"] = whisper_k6_reading(
            ops, f"{kind}, a rank's {heads} heads", (q, k, v), causal,
            per[kind])
        del q, k, v
    if not out:
        fail("whisper (e): no K6 launch at a rank's share of the heads")
    return out


def whisper_phase(ops, smi: str) -> dict:
    """22. Whisper-base served and trained at full size (``WHISPER_*``;
    module docstring), K6 held to its plain version at every signature
    (a), (b) and (d) launched it with.  Returns the ``whisper`` entry of
    K6's kernels-line row."""
    t_phase = time.perf_counter()
    launch = ops.flash_attention_cuda
    seen = k6_record_launches(ops)
    try:
        serving = whisper_serving_reading(ops, smi)
        reduced = whisper_reduced_f32_reading()
        training = whisper_training_reading(ops, smi)
        mesh = whisper_mesh_reading(ops, smi, training["losses"][0],
                                    serving.pop("first"), k6_shapes=seen)
    finally:
        ops.flash_attention_cuda = launch
    main_shapes = k6_path_reading(ops, seen)
    from repro_torch.configs import get_config
    mesh["k6"] = whisper_rank_k6_readings(ops, seen,
                                          get_config(WHISPER_ARCH))
    k6 = serving.pop("k6")
    errs = [r["max_abs_err"] for r in list(k6.values())
            + list(mesh["k6"].values())]
    log(f"whisper phase: {time.perf_counter() - t_phase:.1f} s")
    return dict(route=k6["encoder"]["route"], max_abs_err=max(errs),
                signatures=k6, serving=serving, reduced_float32=reduced,
                training=training, mesh=mesh, main_path_shapes=main_shapes)


# ---------------------------------------------------------------- phase 23 --

def strategy_example():
    """``examples/discover_strategies_torch.py`` as a module."""
    import importlib.util
    path = Path(__file__).resolve().parent / STRATEGY_EXAMPLE
    spec = importlib.util.spec_from_file_location(
        "discover_strategies_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def strategy_example_phase(ops, smi: str) -> dict:
    """23. The strategy comparison's ``main`` on UW at ``UW_SCALE`` on the
    card, through each executor (the default dense one, then the sparse
    one, whose leaf hops are K1's), each strategy's K1-K4 launches counted
    apart, then the same calls on the host: the card's four strategies
    learn one model (the example's own check), each strategy's edges and
    score those of the host's, every counting kernel launched, no plain
    version.  Returns, by executor and strategy, the wall, Fig. 3 split,
    joins, peak and launches."""
    t_phase = time.perf_counter()
    ex = strategy_example()
    real = ex.discover_model
    launches = {}

    def counted(db, strategy, **kw):
        before = dict(ops.LAUNCHES)
        out = real(db, strategy, **kw)
        sync()
        launches[strategy.name] = {k: ops.LAUNCHES[k] - before[k]
                                   for k in COUNTING_KERNELS}
        return out
    out, host_s, plain = {}, 0.0, {k: 0 for k in COUNTING_KERNELS}
    for executor in ("dense", "sparse"):
        argv = ["UW", str(UW_SCALE), "--executor", executor]
        launches = {}
        ex.discover_model = counted
        ops.reset_counts()
        try:
            card = ex.main(argv)
        except AssertionError as e:
            fail(f"strategies (23) {executor}: the card's strategies learn "
                 f"different models: {e}")
        finally:
            ex.discover_model = real
        sync()
        for k in COUNTING_KERNELS:     # the host's run below counts its own
            plain[k] += ops.PLAIN_CALLS[k]
        t0 = time.perf_counter()
        host = ex.main(argv + ["--device", "cpu"])
        host_s += time.perf_counter() - t0
        out[executor] = {}
        for name, res in card.items():
            want = host[name]
            if res["edges"] != want["edges"] or abs(
                    res["score"] - want["score"]) > SCORE_RTOL * abs(
                    want["score"]) + SCORE_ATOL:
                fail(f"strategies (23) {name}/{executor}: the card's model "
                     f"differs from the host's (score {res['score']} "
                     f"against {want['score']})")
            st = res["stats"]
            out[executor][name] = dict(
                wall_s=res["wall_s"], host_wall_s=want["wall_s"],
                launches=launches[name], **{k: st[k] for k in (
                    "time_metadata", "time_positive", "time_negative",
                    "joins", "rows_scanned", "peak_bytes")})
            log(f"strategies (23) UW at {UW_SCALE}, {name}/{executor} on the "
                f"card: wall {res['wall_s']:.3f} s (metadata "
                f"{st['time_metadata']:.3f}, positive "
                f"{st['time_positive']:.3f}, negative "
                f"{st['time_negative']:.3f} s), {st['joins']} joins, peak "
                f"{st['peak_bytes']} B, score {res['score']:.3f}, launches "
                f"{launches[name]}; the host's wall {want['wall_s']:.3f} s")
    total = {k: sum(run["launches"][k] for runs in out.values()
                    for run in runs.values()) for k in COUNTING_KERNELS}
    if any(total[k] <= 0 for k in COUNTING_KERNELS) or any(plain.values()):
        fail(f"strategies (23): launches {total}, plain calls {plain}")
    edges = sum(map(len, card["HYBRID"]["edges"].values()))
    tup = out["sparse"]["TUPLEID"]
    log(f"strategies (23): the four strategies learn one model ({edges} "
        f"edges) through either executor, the host's too ({host_s:.1f} s); "
        f"K1-K4 launched {total}, no plain version; TUPLEID/sparse wall "
        f"{tup['wall_s']:.3f} s, peak {tup['peak_bytes']} B, dense "
        f"{out['dense']['TUPLEID']['wall_s']:.3f} s, peak "
        f"{out['dense']['TUPLEID']['peak_bytes']} B; phase "
        f"{time.perf_counter() - t_phase:.1f} s on {smi}")
    return out


def main() -> None:
    t_start = time.perf_counter()
    # -- 1. device -----------------------------------------------------------
    if not torch.cuda.is_available():
        log("FAIL: torch.cuda.is_available() is False; this script needs a "
            "CUDA card")
        sys.exit(2)
    from repro_torch.core import (build_lattice, discover_model,
                                  make_strategy, paper_benchmark_db)
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.bdeu import bdeu_plain, check_division
    from repro_torch.kernels.mobius import mobius_matrix, mobius_plain
    from repro_torch.kernels.segsum import card_of, ones_plan, rows_plan
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi()
    log(f"device: {kind} x{count}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; nvidia-smi: {smi}")

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    build.build(force=True)
    info = dict(build.BUILD_INFO)
    build.load()
    log(f"build: {time.perf_counter() - t0:.2f} s wall, nvcc "
        f"{info['seconds']:.2f} s -> {info['path']}")
    for line in info["ptxas"]:
        log(f"  {line}")
    # the Hopper attention kernel keeps its accumulators in registers, and
    # K2's kernels stream rows through registers into shared memory
    for name in NO_SPILL_KERNELS:
        check_no_spills(info["ptxas"], name)
    # K4's lgamma takes a branch-free division and frexp: over their whole
    # domain they must give the correctly rounded operations' bits
    t0 = time.perf_counter()
    bad = check_division(torch.device("cuda"))
    log(f"K4 fast path against the correctly rounded operations over its "
        f"whole domain (Lanczos divisions, log's quotient, frexp): "
        f"{bad} operands differ ({time.perf_counter() - t0:.2f} s)")
    if any(bad):
        fail(f"K4's branch-free division or frexp differs from the correctly "
             f"rounded one on {bad} operands")

    # -- 3. main path ---------------------------------------------------------
    t0 = time.perf_counter()
    db = paper_benchmark_db("IMDb", seed=0, scale=IMDB_SCALE)
    log(f"IMDb stand-in: {db.total_rows} rows, {len(db.relations)} "
        f"relationships (generated in {time.perf_counter() - t0:.1f} s)")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    sync()
    t0 = time.perf_counter()
    models, strategy = discover_model(
        db, make_strategy("HYBRID", executor="sparse"), **DISCOVERY)
    sync()
    wall = time.perf_counter() - t0
    hybrid = dict(reading=counting_reading(ops, strategy, wall),
                  edges=edges_of(models),
                  score=sum(m.score for m in models.values()))
    launches = dict(ops.LAUNCHES)
    imdb_regimes = dict(ops.ROW_REGIMES)
    imdb_ones_regimes = dict(ops.ONES_REGIMES)
    peak = torch.cuda.max_memory_allocated()
    st = strategy.stats.as_dict()
    log(f"main path (IMDb, HYBRID/sparse, chains <= 2, parents <= 3): "
        f"{wall:.3f} s wall on {kind}")
    log("  stats: " + json.dumps({k: st[k] for k in (
        "joins", "rows_scanned", "ct_rows", "time_metadata",
        "time_positive", "time_negative", "peak_bytes")}))
    log(f"  max_memory_allocated: {peak} B; "
        f"learned edges: {sum(len(m.edges()) for m in models.values())}; "
        f"launches: {json.dumps(launches)}; K2 launches by regime: "
        f"{json.dumps(imdb_regimes)}; K1 launches by regime: "
        f"{json.dumps(imdb_ones_regimes)}")
    if any(launches[k] <= 0 for k in MAIN_PATH_KERNELS):
        fail(f"a kernel of the main path was not launched: {launches}")
    if any(ops.PLAIN_CALLS[k] for k in ops.KERNELS):
        fail(f"plain versions ran on the card: {ops.PLAIN_CALLS}")
    for m in models.values():
        if not np.isfinite(m.score):
            fail("a learned model has a non-finite score")
    check_positive_invariant(strategy, db, "IMDb")
    del strategy, models
    profile_main_path(db, discover_model, make_strategy)

    t0 = time.perf_counter()
    vg = paper_benchmark_db("VisualGenome", seed=0, scale=VG_SCALE)
    log(f"VisualGenome stand-in: {vg.total_rows} rows, {len(vg.relations)} "
        f"relationships (generated in {time.perf_counter() - t0:.1f} s)")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    sync()
    t0 = time.perf_counter()
    vg_strategy = make_strategy("HYBRID", executor="sparse")
    vg_strategy.prepare(vg, build_lattice(vg.schema, 3))
    sync()
    log(f"VisualGenome pre-counting (HYBRID/sparse, chains <= 3, "
        f"{len(vg_strategy.lattice)} lattice points): "
        f"{time.perf_counter() - t0:.3f} s wall; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} B; launches "
        f"{json.dumps(ops.LAUNCHES)}")
    if ops.LAUNCHES["segsum_rows"] <= 0:
        fail("the dense-message hop did not launch segsum_rows")
    if ops.LAUNCHES["hop_ids"] <= 0:
        fail("VisualGenome's hops did not launch the id kernel")
    if ops.ROW_REGIMES["direct"] <= 0:
        fail("the dense-message hop did not take K2's direct regime")
    log(f"  K2 launches by regime: {json.dumps(ops.ROW_REGIMES)}")
    check_positive_invariant(vg_strategy, vg, "VisualGenome")
    del vg_strategy
    # once more, keeping K2's largest call and its largest in the direct
    # regime (the dense-message hop)
    vg_spy = Spy(ops, ("segsum_rows",), tags=lambda name, args, kwargs: (
        ("direct",) if rows_plan(args[1].shape[0], args[1].shape[1], args[2],
                                 card_of(args[1].device)).regime == "direct"
        else ()))
    # (and the id kernel's largest leaf, dense and root calls)
    vg_ids_spy = IdsSpy(ops)
    make_strategy("HYBRID", executor="sparse").prepare(
        vg, build_lattice(vg.schema, 3))
    vg_ids_spy.remove()
    vg_spy.remove()
    vg_k2 = {key: k2_reading(ops, *vg_spy.big[big][1])
             for key, big in (("largest", "segsum_rows"), ("hop", "direct"))}
    for key, reading in vg_k2.items():
        log_k2(f"VisualGenome {key}", reading)
    vg_ids = ids_readings(ops, vg_ids_spy, "VisualGenome",
                          ("leaf", "dense", "root"))
    vg_ids_calls = vg_ids_spy.calls
    del vg_spy, vg_ids_spy

    # -- 4. kernels against their plain versions ------------------------------
    # (K1's largest call, and its largest in the privatised regime: an
    # entity histogram)
    spy = Spy(ops, COUNTING_KERNELS, tags=lambda name, args, kwargs: (
        ("segsum_ones/private",) if name == "segsum_ones" and ones_plan(
            args[0].shape[0], args[2], card_of(args[0].device)).regime
        == "private" else ()))
    ids_spy = IdsSpy(ops)
    discover_model(db, make_strategy("HYBRID", executor="sparse"),
                   **DISCOVERY)
    ids_spy.remove()
    spy.remove()
    del db
    rows = []
    imdb_ids = ids_readings(ops, ids_spy, "IMDb", ("leaf", "root"))
    rows.append(dict(
        name="hop_ids", route="cuda",
        source="src/repro_torch/kernels/csrc/segsum.cu", replaces=None,
        launches=launches["hop_ids"], **vg_ids["leaf"],
        visualgenome=dict(calls=vg_ids_calls, **vg_ids),
        imdb=dict(calls=ids_spy.calls, **imdb_ids)))
    del ids_spy
    reading = k1_reading(ops, *spy.big["segsum_ones"][1])
    log_k1("IMDb largest", reading)
    private = k1_reading(ops, *spy.big["segsum_ones/private"][1])
    log_k1("IMDb largest privatised", private)
    rows.append(dict(
        name="segsum_ones", route="cuda",
        source="src/repro_torch/kernels/csrc/segsum.cu",
        replaces="src/repro/kernels/segsum_kernel.py:103",
        launches=launches["segsum_ones"],
        launches_by_regime=imdb_ones_regimes, **reading,
        private=private))

    reading = k2_reading(ops, *spy.big["segsum_rows"][1])
    log_k2("IMDb", reading)
    rows.append(dict(
        name="segsum_rows", route="cuda",
        source="src/repro_torch/kernels/csrc/segsum.cu",
        replaces="src/repro/kernels/segsum_kernel.py:71",
        launches=launches["segsum_rows"],
        launches_by_regime=imdb_regimes, **reading,
        visualgenome=vg_k2))

    (x,) = spy.big["mobius"][1]
    bsz, height, d = x.shape
    k = height.bit_length() - 1
    got, want = ops.mobius(x), mobius_plain(x)
    err = float((got - want).abs().max())
    tmat = mobius_matrix(k).to(x.device)
    b_ms, b_by = bound_ms(8.0 * x.numel(), bsz * d * k * (height // 2))
    rows.append(dict(
        name="mobius", route="cuda",
        source="src/repro_torch/kernels/csrc/mobius.cu",
        replaces="src/repro/kernels/mobius_kernel.py:41",
        launches=launches["mobius"], max_abs_err=err,
        bound_ms=b_ms, bound_by=b_by,
        **timings(lambda: ops.mobius(x), lambda: mobius_plain(x),
                  lambda: torch.matmul(tmat, x)),
        scaling=k3_scaling_reading(ops),
        shape=f"B={bsz} 2^k={height} D={d}"))
    if err != 0.0:
        fail(f"mobius differs from its plain version by {err}")

    nijk, ess = spy.big["bdeu"][1]
    bsz, q, rr = nijk.shape
    got, want = ops.bdeu(nijk, ess), bdeu_plain(nijk, ess)
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=1e-4, atol=1e-2):
        fail(f"bdeu outside rtol=1e-4, atol=1e-2 of its plain version")
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        fail("bdeu is not bit-identical to its plain version")
    n_ops = bsz * ((q * rr + q) * LGAMMA_OPS + 4 * q * rr + 4 * q)
    b_ms, b_by = bound_ms(4.0 * nijk.numel() + 4.0 * bsz, n_ops)
    rows.append(dict(
        name="bdeu", route="cuda",
        source="src/repro_torch/kernels/csrc/bdeu.cu",
        replaces="src/repro/kernels/bdeu_kernel.py:40",
        launches=launches["bdeu"], max_abs_err=err,
        bound_ms=b_ms, bound_by=b_by,
        **timings(lambda: ops.bdeu(nijk, ess),
                  lambda: bdeu_plain(nijk, ess), None),
        scaling=k4_scaling_reading(ops),
        shape=f"B={bsz} q={q} r={rr}"))
    for row in rows:
        log_row(row)
    # the LM phase reads its memory with no earlier tensors held
    del spy, x, tmat, nijk, got, want

    # -- 5. card against CPU -------------------------------------------------
    uw = paper_benchmark_db("UW", seed=0, scale=UW_SCALE)
    for sname in ("HYBRID", "ONDEMAND"):
        for ex in ("sparse", "dense"):
            t0 = time.perf_counter()
            recorder = BatchRecorder()
            on_card, _ = discover_model(uw, make_strategy(sname, executor=ex))
            recorder.remove()
            on_cpu, _ = discover_model(
                uw, make_strategy(sname, executor=ex, device="cpu"),
                device="cpu")
            if edges_of(on_card) != edges_of(on_cpu):
                fail(f"UW {sname}/{ex}: card and CPU models differ:\n"
                     f"{edges_of(on_card)}\n{edges_of(on_cpu)}")
            batches = recorder.summary()
            if sname == "ONDEMAND" and batches["stacked"] == 0:
                fail(f"UW ONDEMAND/{ex}: no stacked group ran on the card")
            log(f"UW {sname}/{ex}: card and CPU models edge-identical "
                f"({sum(len(m.edges()) for m in on_card.values())} edges, "
                f"{time.perf_counter() - t0:.1f} s); positive_batch on the "
                f"card: {json.dumps(batches)}")
    del uw, on_card, on_cpu

    # -- 6. K5's path ---------------------------------------------------------
    rows.append(hist_phase(ops))

    # -- 7. K6's edge shapes, and the sliced route timed ----------------------
    edge_errs = k6_edge_phase(ops)
    sliced = k6_sliced_reading(ops)
    edge_errs["sliced"] = max(edge_errs.get("sliced", 0.0),
                              sliced["max_abs_err"])

    # -- 8. Qwen2.5-3B serving ------------------------------------------------
    rows.append(lm_phase(ops, kind, edge_errs))
    for row in rows[-2:]:
        log_row(row)

    # -- 9. K2's edge shapes --------------------------------------------------
    k2_edge_phase(ops)

    # -- 10. K4's and K1's edge shapes ----------------------------------------
    k1k4_edge_phase(ops)

    # -- 11. Nemotron-4-340B serving (hd 192: K6's mma.sync route) -----------
    k6_row = next(row for row in rows if row["name"] == "flash_attention")
    nemo = nemotron_phase(ops, smi)
    by_route = k6_row["max_abs_err_by_route"]
    by_route[nemo["route"]] = max(by_route.get(nemo["route"], 0.0),
                                  nemo["max_abs_err"])
    k6_row["max_abs_err"] = max(by_route.values())
    k6_row["nemotron"] = nemo
    k6_row["sliced"] = sliced

    # -- 12. ONDEMAND, PRECOUNT and tight-budget HYBRID on IMDb ---------------
    strategies = strategies_phase(ops, hybrid)
    for row in rows:
        if row["name"] in ("segsum_ones", "segsum_rows"):
            key = "k1" if row["name"] == "segsum_ones" else "k2"
            row["strategies"] = dict(
                launches={label: run["launches"][row["name"]]
                          for label, run in strategies["runs"].items()},
                launches_by_regime={
                    label: run[f"{key}_regimes"]
                    for label, run in strategies["runs"].items()},
                replay={k: {f: v[f] for f in (key, f"{key}_regimes")}
                        for k, v in strategies["replay"].items()
                        if isinstance(v, dict)})

    # -- 13. writes and delta count maintenance ------------------------------
    mutations = mutations_phase(ops)
    for row in rows:
        key = {"segsum_ones": "k1", "segsum_rows": "k2",
               "mobius": "k3"}.get(row["name"])
        if key is not None:
            row["mutations"] = dict(
                launches=mutations["launches"][key],
                by_write={w: {label: v[key] for label, v in runs.items()}
                          for w, runs in mutations["by_write"].items()})
            if key in mutations["launches_by_regime"]:
                row["mutations"]["launches_by_regime"] = \
                    mutations["launches_by_regime"][key]
        elif row["name"] == "bdeu":
            row["mutations"] = dict(rediscovery_launches=sum(
                r["rediscovery"]["k4"] for r in mutations["readings"]))

    # -- 14. served discovery ------------------------------------------------
    served = served_phase(ops, hybrid)
    for row in rows:
        key = {"segsum_ones": "k1", "segsum_rows": "k2", "mobius": "k3",
               "bdeu": "k4"}.get(row["name"])
        if key is not None:
            row["served"] = dict(
                launches=served["launches"]["a"][key],
                by_step={step: c[key]
                         for step, c in served["launches"].items()})
            if key in ("k1", "k2"):
                row["served"]["launches_by_regime"] =                     served["launches"]["a"][f"{key}_regimes"]

    # -- 15. IMDb in shards: router, writes, rebalance, tenancy ----------------
    sharded = sharded_phase(ops, served)
    for row in rows:
        key = {"segsum_ones": "k1", "segsum_rows": "k2", "mobius": "k3",
               "bdeu": "k4"}.get(row["name"])
        if key is not None:
            row["sharded"] = dict(
                launches=sharded["launches"]["b"][key],
                by_step={step: c[key]
                         for step, c in sharded["launches"].items()})
            if key in ("k1", "k2"):
                row["sharded"]["launches_by_regime"] = {
                    step: c[f"{key}_regimes"]
                    for step, c in sharded["launches"].items()}

    # -- 16. mesh sharding: ranks sharing the card -------------------------
    sharded_tables = sharded.pop("tables_a")
    mesh = mesh_phase(ops, hybrid, sharded_tables, vg, smi)
    for row in rows:
        key = {"segsum_ones": "k1", "segsum_rows": "k2", "mobius": "k3",
               "bdeu": "k4"}.get(row["name"])
        if key is not None:
            row["mesh"] = dict(
                launches=sum(r[key] for r in mesh["launches"]["b2"]),
                by_step={step: [r[key] for r in by_rank]
                         for step, by_rank in mesh["launches"].items()})

    # -- 17. the LM's training path ----------------------------------------
    k6_row["training"] = train_phase(ops, smi)

    # -- 18. multi-rank training and the sequence-sharded decode -----------
    k6_row["mesh_training"] = mesh_train_phase(
        ops, smi, k6_row["training"]["losses"][0])
    by_route = k6_row["mesh_training"]["q_offset"]["max_abs_err_by_route"]
    k6_row["max_abs_err"] = max(k6_row["max_abs_err"], *by_route.values())

    # -- 19. mixture-of-experts: Qwen3-30B-A3B, training, ranks, monitor ----
    moe = moe_phase(ops, smi)
    k6_row["moe"] = moe["k6"]
    by_route = k6_row["max_abs_err_by_route"]
    by_route[moe["k6"]["route"]] = max(by_route.get(moe["k6"]["route"], 0.0),
                                       moe["k6"]["max_abs_err"])
    k6_row["max_abs_err"] = max(k6_row["max_abs_err"],
                                moe["k6"]["max_abs_err"])
    for row in rows:
        key = {"segsum_ones": "segsum_ones", "segsum_rows": "segsum_rows",
               "mobius": "mobius"}.get(row["name"])
        if key is not None:
            row["moe_monitor"] = dict(launches={
                str(layer): m["launches"][key]
                for layer, m in moe["monitor"].items()})

    # -- 20. the sub-quadratic blocks: RWKV6-1.6B and Hymba-1.5B ----------
    subq = subq_phase(ops, smi)
    k6_row["subquadratic"] = subq
    by_route[subq["route"]] = max(by_route.get(subq["route"], 0.0),
                                  subq["max_abs_err"])
    k6_row["max_abs_err"] = max(k6_row["max_abs_err"], subq["max_abs_err"])

    # -- 21. Qwen2-VL-72B at full width: M-RoPE and embedding inputs --------
    vlm = vlm_phase(ops, smi)
    k6_row["vlm"] = vlm
    by_route[vlm["route"]] = max(by_route.get(vlm["route"], 0.0),
                                 vlm["max_abs_err"])
    k6_row["max_abs_err"] = max(k6_row["max_abs_err"], vlm["max_abs_err"])

    # -- 22. Whisper-base: the encoder-decoder, K6 non-causal ----------------
    whisper = whisper_phase(ops, smi)
    k6_row["whisper"] = whisper
    by_route[whisper["route"]] = max(by_route.get(whisper["route"], 0.0),
                                     whisper["max_abs_err"])
    k6_row["max_abs_err"] = max(k6_row["max_abs_err"],
                                whisper["max_abs_err"])

    # -- 23. the strategy comparison: the four strategies on UW ---------------
    compared = strategy_example_phase(ops, smi)
    for row in rows:
        if row["name"] in COUNTING_KERNELS:
            row["uw_strategies"] = {
                f"{name}/{executor}": run["launches"][row["name"]]
                for executor, runs in compared.items()
                for name, run in runs.items()}

    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(nvidia_smi())
    print(json.dumps({"kernels": [{k: v for k, v in row.items()
                                   if k != "shape"} for row in rows]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind, "count": count}}),
          flush=True)


if __name__ == "__main__":
    main()
