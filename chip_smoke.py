#!/usr/bin/env python3
"""Smoke-run the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--halvings K] [--seed S] [--lm-seeds S1,S2,...]

Phases, each reported on its own line(s):

1. device    -- the card's name and power limit (``nvidia-smi``).
Z. analysis  -- host only: the port's analyzer, ``python -m
                repro_torch.analysis``: its ``--self-test`` over the
                shared fixture corpus (every check passing), a scan of
                ``src/repro_torch`` (exit 0, 0 findings) and a scan of a
                temporary copy of ``serve/service.py`` with one nested
                acquisition inverted against the hierarchy (Z_FAULT:
                exit 1 and a ``lock-order`` finding); one JSON line.
2. build     -- compiles every CUDA kernel from the sources under
                ``src/repro_torch/csrc`` (one ``nvcc`` per source,
                started together) and prints the build seconds.
3. kernels   -- holds each kernel against its plain PyTorch version on
                the card.  spc_query exactly (integer outputs), each
                input in three ways: the gathered form (the fused
                kernel with identity ids), the warp kernel, and
                the index form (the rows written into an index and read
                by id): the TPU sweep shapes, hand-made rows with
                counts 2^24 + 1 and above 2^32, rows whose hubs repeat
                (the reference microbench's draw and a hand-made pair);
                then the index form on two [4097, 2048] indexes (hubs
                distinct, hubs repeating, a tenth of the rows full) at
                ids 0, n - 1, n and outside [0, n].  segment_matmul in both
                its designs (sorted and blocked, whichever the plan
                picks) on the TPU sweep (ids up to n + 5, then shifted
                to negatives) within rtol = atol = 1e-6 in float32 and
                1e-2 in bfloat16 against the float32 sum of the same
                values, at E = 0, and on one segment of 14329 edges
                (integer values: exact); two launches bitwise equal.
                embedding_bag within rtol = atol = 1e-6 in float32 (only
                the fp32 summation order differs) and 1e-2 in bfloat16
                against the float32 sum of the same bfloat16 rows: the
                TPU sweep shapes, the
                recsys shapes of ``configs/dien.py`` (vocab 100000,
                D = 18, 8 ids per bag, 512 x 4 and 262144 x 4 bags) and
                the re-rank's own bags, the packed design twice and the
                warp design all bitwise equal; at the recsys
                shapes both designs and ``F.embedding_bag`` timed in
                turn, K3_REPS rounds, beside the HBM bound and an L2
                reckoning from L2's rate measured on the card (PyTorch
                kernels over 16 MB that stays in L2: row sums and a
                copy; the faster); ids that
                count from the end (F1) through the kernel and the ops,
                exactly.  The main-path shapes are checked and timed
                after phase A2: spc_query's fused kernel on the first
                serve batch against the gathered route (gather, re-pad,
                warp kernel), the warp kernel alone and the plain merge,
                K1_REPS rounds in turn, and the card's time per call of
                the fused kernel, the warp kernel and the whole gathered
                route from a CUDA graph of K1_GRAPH_CALLS calls replayed
                back to back (``graph_ms``: no host work between the
                calls); embedding_bag's two designs and
                ``F.embedding_bag`` at the re-rank's bags, K3_REPS
                rounds, and both designs from a CUDA graph.
4. build     -- ``DynamicSPC(..., device="cuda", construct_batch=32,
                l_cap=None)`` on a power-law graph at the ``dspc``
                configuration's scale (n = 65536, m = 524288, weights
                proportional to i^-0.8), halved ``--halvings`` times
                (MAIN_HALVINGS = 1 by default: n 32768, m 262144).
K.  kernels   -- the kernel microbench entry point
                (``repro_torch.bench.kernels_bench``): spc_query at
                b = 4096 pairs of l = 64 labels and segment_matmul at
                e = 16384, n = 2048, d = 128 (the reference's defaults),
                then ``gather_scatter`` of 128 node features over the
                built graph's edge slots (E = 2m, N = n, dst unsorted).
                Outside the path, in both designs: that aggregation
                equal to the plain version bit for bit in float32 and
                bfloat16 (features rounded to multiples of 2^-6, so every
                sum is exact); on N(0, 1) messages two launches bitwise
                equal and within the fp32 summation bound of the float64
                sum at the design's depth; the BFS relaxation form (D =
                1, n + 1 segments) equal to the int64 ``edge_relax``.
                Then at each shape (the microbench and the graph's three)
                both designs and ``index_add_`` timed in turn, SEG_REPS
                rounds, and the card's busy time per call of the planned
                design and of ``index_add_`` from a profiler trace.
A1. analytics, pinned before the chunk -- attaches a ``SnapshotStore``,
                seeds ``TopKBetweenness`` (512 sampled pairs x all n
                candidates) and pins a snapshot, keeping a copy of it.
5. maintain  -- one ``apply_events`` chunk of MAINTAIN_EVENTS = 16
                events (8 inserts, 8 deletes from ``graph_stream``; the
                configuration's update_batch of 64 cut for the script's
                time limit); it publishes into the store.
6. serve     -- 64 batches of 1024 random pairs through
                ``QueryEngine(route="auto")`` (the kernel route on the
                card), then the same batches on the plain-torch merge
                route; both must agree.  Then 32 batches replayed under
                ``torch.profiler``: the card's busy time per batch, its
                idle share of the batch p50, and its us per batch by
                kernel.
6b. query_batch -- one batch of the configuration's query_batch =
                1048576 pairs through ``QueryEngine(route="auto")``,
                three times (one launch each): seconds, the peak
                device memory above the index, and the id copy and the
                kernel alone from CUDA events; held exactly against the
                gathered route run in slices of 1024 pairs (the gathered
                route is not run whole: its operands would take about
                69 GB).
A2. analytics after the chunk -- refreshes the maintainer (and times a
                full recompute on the same snapshot beside it), checks
                the pinned snapshot is byte-identical to its copy, counts
                shortest cycles through the top-betweenness vertex,
                recommends friends for the user with the largest label
                row and re-ranks them with a PNA forward pass (the
                ``configs/pna.py`` CONFIG width) over the ego net plus
                ``embedding_bag`` mean pooling of the common-friend ids.
7. oracles   -- ``plain_spc_bfs`` on the current graph equals the
                engine's (dist, count) for 8 sampled sources (after
                phases 4 and 5); the maintained betweenness equals the
                BFS pair dependencies from every pair endpoint (rtol =
                atol = 1e-9, after phases 4 and 5); cycle and
                recommendation counts equal those taken from the edge
                list; the card's re-rank equals the same forward on the
                CPU (rtol 1e-4, atol 1e-5).
S1. service  -- ``SPCService(spc=<phase 5's DynamicSPC>, route="auto",
                replicas=2, queue_size=8, update_batch=8,
                transport="dir", keep_published=3,
                async_checkpoint=True)`` over a fresh directory on the
                temporary or ``build/`` disk (16 GB free or it raises).
                One session submits SERVICE_EVENTS = 4 events, the
                first 4 of an 8-event ``graph_stream`` (two tickets of
                2; the configuration's 64-event chunk is cut to 8 for
                time, both in ``reduced``): seconds from submit to
                applied for each, 64 pinned batches of 1024 pairs timed
                idle and again while the second ticket's chunk applies,
                a read_your_writes read of every written pair equal to
                ``plain_spc_bfs`` after its write, 2 sources x n targets
                equal to ``plain_spc_bfs``, every batch on the kernel
                route.
S2. front door -- ``service.frontdoor()`` with the configuration's
                knobs (2 dispatchers, batches of 256, 4 live batches, a
                5 s deadline): 8 caller sessions, closed loop, 512
                single-pair requests each, every answer equal to a
                direct reader's at the version it pinned; qps, p50 / p99
                per request, coalesced batches and their mean fill
                (must exceed 1); then a writing session inserts one
                non-edge and reads it back as (1, 1) through
                read_your_writes.
S3. fleet    -- a second process on the same card (this script with
                ``--replica-of``, importing only the port) runs
                ``SPCService(role="replica", transport="dir",
                poll_interval_s=0.05)`` on the directory: it pulls the
                newest version (its load-and-stage seconds) and answers
                1024 pairs exactly as the updater at that version.
S4. restart  -- the updater's ``state_dict()`` saved with the port's
                checkpoint ``save`` and brought back with
                ``SPCService.from_checkpoint`` on the card:
                byte-identical, re-attached to the directory without a
                publish; one more event's version published through it,
                which the replica process answers at exactly as the
                restored updater, with no ``skipped_behind``: the
                staleness from the version's commit (``LATEST``'s
                mtime) to the replica's first answer at it.  The replica
                process exits and the directory is removed before L1.
D.  distributed -- one controller over a device mesh: every visible
                card, or ``DIST_SHARDS`` = 4 entries of the one card (an
                edge axis ``model`` for the updater, a data axis ``data``
                for serving); the mesh and whether its devices are
                distinct on a line of their own.  D1: a power-law graph
                of its own at DIST_HALVINGS = 3 halvings of the dspc
                CONFIG (n 8192, m 65536, in ``reduced``), built with
                phase 4's knobs on
                one device and by ``DynamicSPC(..., mesh=)``: the two
                ``state_dict()``s must be byte-identical.  One chunk of 8
                events from ``graph_stream`` through the sharded updater
                and the single-device engine: byte-identical states.
                Seconds and host syncs of both builds, and of each
                chunk.  D2: ``SnapshotStore(mesh=)`` and
                ``serve_from(mesh=)``: 64 batches of 1024 uniform pairs
                (host us per batch to the answers, p50 / p90), each equal
                to the single-device kernel route's, every one counted as
                ``sharded[data]:merge``; then
                ``SPCService.from_state_dict(mesh=, serve_mesh=,
                route="sharded")``: a ticket of 2 events (an insert and a
                delete) and a ``read_your_writes`` read equal to
                ``plain_spc_bfs``.
L1. LM params -- ``init_params`` of qwen2-1.5b (``configs/qwen2_1_5b.py``
                CONFIG with ``tp = 1``: the published 12 query heads, no
                mesh padding) at LM_LAYERS = 8 of its 28 layers (a cut
                for the script's time limit, in ``reduced``) in
                bfloat16, drawn from a CUDA generator seeded with
                ``--seed``.
L2. prefill  -- 16 prompts of 32768 random token ids (the
                ``decode_32k`` context; its global batch 128 cut to 16
                to fit one card), ``s_max = 32768 + 64``, prefilled 4 at
                a time (blockwise attention), each group's cache copied
                into the batch cache.
L3. decode   -- 64 greedy ``decode_step``s; every layer's decode
                attention runs on the flash_decode kernel.  Step latency
                from CUDA events, tokens/s from the host clock.  The
                last 4 steps are then replayed under ``torch.profiler``:
                the card's busy time per step and its idle share of the
                step p50, and from the same trace its top kernels by
                device ms per step.
L4. consistency -- as ``examples/serve_lm.py`` checks it: the first 2
                requests prefilled again with the 64 tokens fed to the
                decode steps (t = 32832, ragged against the 1024-key
                blocks); its last logits within a relative L2 error of
                LM_REL_TOL of the last decode step's (fp32), argmax agreement
                printed.  Controls: the fed tokens replayed from these
                requests' prompt cache on the port's route must pass the
                same limit, and two planted faults in place of decode
                attention must fail it: the reference's arithmetic
                (scores and probabilities rounded to bf16) and one span
                of the kernel at the main path's shape left out (the
                span comes from the kernel's own ``plan``).
M.  deepseek-v2-lite-16b -- ``configs/deepseek_v2_lite_16b.py`` CONFIG at
                full width and depth (27 layers, d_model 2048, 16 MLA
                heads, kv_lora 512, 64 routed top-6 + 2 shared experts of
                1408, vocab 102400), random bf16 weights from a CUDA
                generator (16.21 B parameters, 32.4 GB): ``decode_32k``'s
                context of 32768 kept, its batch of 128 cut to DS_BATCH
                (``reduced``), prefilled DS_GROUP at a time (blockwise),
                then DS_STEPS greedy decode steps (the absorbed MLA
                decode, the grouped fixed-capacity MoE).  Prefill s,
                tokens/s and peak memory; the share of routed
                assignments the capacity dropped in the prefill
                (:class:`DropCount`); decode step p50 / p90, tokens/s, the
                step's bound (every weight but the embedding and the
                cache read once); LM_TRACE_STEPS steps replayed under
                ``torch.profiler``: busy ms a step, idle share, top ops.
M-check      -- the same weights' first MCHECK_LAYERS layers in float32
                at the capacity factor e / k (no assignment can drop, so
                prefill and decode route alike): MCHECK_STEPS greedy
                steps after MCHECK_BATCH x MCHECK_PROMPT tokens (blockwise;
                ragged once the fed tokens are added), the last logits
                against a prefill of the same tokens, and layer 0's
                absorbed ``mla_decode`` against ``mla_train`` over the
                same prefix: both within a relative L2 of MCHECK_REL_TOL;
                the planted fault (the decode scores without the rope
                term of the cached positions) must miss it.
M2. deepseek-v2-236b -- at full width (128 heads with q_lora 1536, 160
                routed experts of 1536), depth 60 -> 2 (``reduced``):
                a prefill of 2 x 1024, 8 decode steps, and the same
                float32 no-drop check.  The bf16 prefill is run twice
                more and layer 0's MoE output must repeat bit for bit
                (:func:`moe_repeat`); twice more with the earlier
                ``scatter_add_`` un-dispatch in place of
                ``moe.undispatch`` as the control, whose reading is
                printed.
M3. dense family -- qwen2-7b and phi3-medium-14b CONFIG at full width and
                depth, tp 1 (28 / 4 and 40 / 10 heads): prompts of 4 x
                2048, 16 decode steps each, flash_decode launched
                exactly n_layers x 16 times on each path and held
                against its plain version on layer 0's served cache
                (atol 1e-3 + rtol 1e-2, two launches bitwise equal) at
                the served lengths and at ragged ones within the decode
                steps' (``flash_decode_served``).  Then at each
                one's ``decode_32k`` shape (B 16, S 32768, random bf16
                cache, every row full) flash_decode against its plain
                version (atol 1e-3 + rtol 1e-2, two launches bitwise
                equal) and timed beside SDPA (``enable_gqa``), FD_REPS
                rounds; and phi3 at the reference's tp 16 (48 padded
                heads, q padded to 50: a group of 5) held once.
G.  GNN family -- EGNN, NequIP and Equiformer-v2 (``configs/{egnn,
                nequip,equiformer_v2}.py`` CONFIG: 4 x 64; 5 x 32 at
                l_max 2; 12 x 128 at l_max 6, m_max 2, 8 heads), full
                width and depth, random float32 weights, forward only
                (``forward`` at molecule, ``node_forward`` elsewhere), at
                three ``GNN_SHAPES``: molecule (``molecule_batch(0, 128,
                30, 64, 16)``: 3840 nodes, 8192 edges, energies [128,
                1]); full_graph_sm (2708 nodes, 1433 features, 7
                classes; 10556 uniform pairs less self-loops in 10752
                edge slots, as ``gnn_host_args`` draws them); minibatch_lg
                (one ``NeighborSampler(synthetic_csr(232965, 492, 602,
                41), 1024, (15, 10))`` block: 169984 nodes, 168960 edge
                slots; the 1024 targets' logits).  As the reference's
                ``gnn_host_args`` and ``_gnn_adapt`` do, positions are
                drawn N(0, 1) from ``--seed`` where the graph has none
                (full_graph_sm, minibatch_lg), and d_in is the shape's
                feature width, n_out its classes (1 at molecule).  Each
                forward: GNN_REPS calls (GNN_REPS_LG at minibatch_lg)
                after one warm-up (CUDA events; p50), peak device
                memory, the reference's FLOP reckoning
                (``launch.steps._gnn_flops``); at minibatch_lg the host
                seconds of ``synthetic_csr`` and of one ``sample`` (the
                profiler
                traces of G, R and T were dropped for the script's time
                limit; PERF.md keeps their last readings).  Checks:
                EGNN and NequIP at molecule and full_graph_sm equal to the
                same module on the CPU, and Equiformer-v2's first
                GNN_CPU_MOLECULES molecules (disjoint graphs) equal to a
                CPU run on those alone, within rtol 1e-4 / atol 1e-5;
                every output within a relative L2 of GNN_ROT_TOL = 1e-3 of
                itself with the positions rotated (a seeded proper
                rotation), which Equiformer-v2 with its messages rotated
                back by ``Ds`` in place of their transposes must miss;
                two launches at molecule within 1e-4 / 1e-5.
R.  recsys   -- DIEN (``configs/dien.py`` CONFIG: 4M-item table, D 18,
                T 100, GRU 108, MLP 200-80), random float32 weights from
                a CUDA generator seeded from ``--seed``, batches from
                ``dien_batch``: ``forward`` at serve_p99 (B 512)
                R_P99_CALLS times (CUDA events: p50, p99), at serve_bulk
                (B 262144) R_BULK_CALLS times (seconds a call, examples/s,
                peak memory), and ``retrieval_scores`` of one user
                against retrieval_cand's 10^6 (item, cate) pairs drawn as
                ``dien_host_args`` draws them, R_RETRIEVAL_CALLS times.
                Checks: the serve_p99 logits and the retrieval scores
                equal the same module on the CPU (the same weights)
                within rtol R_RTOL / atol R_ATOL, two launches bitwise
                equal; two planted faults must miss that tolerance: the
                AUGRU with its attention replaced by 1 (on the logits),
                and a GRU that ignores ``hist_mask`` (on the retrieval
                scores of 8 users whose masks are reversed, padding
                first, held first without the fault: after
                ``dien_batch``'s prefix masks such a GRU changes no state
                the model reads).
T.  train    -- AdamW (``AdamWConfig()``, as ``steps.py:63``) through
                ``loop.run``.  DIEN at train_batch (65536): T_DIEN_STEPS
                steps (s/step, examples/s, peak memory); the first
                step's loss and every gradient on its first
                T_DIEN_CHECK_ROWS rows against the CPU within rtol
                T_DIEN_RTOL / atol T_DIEN_ATOL, which the loss without
                its aux term must miss; restart equivalence -- a run
                that fails after 2 steps (``FailAfter``) and resumes from
                its checkpoint in a fresh directory (``fleet_dir``) ends
                on the bits of an uninterrupted run, under
                ``torch.use_deterministic_algorithms`` (required) and
                without it (recorded).  qwen2-1.5b CONFIG at full width
                and depth, tp 1, bf16, ``remat`` on: train_4k's t 4096 at
                batch T_LM_BATCH (``reduced``: 256 -> T_LM_BATCH),
                T_LM_STEPS steps (s/step, tokens/s, peak memory, the
                share of the card's dense bf16 peak under the reference's
                ``launch.steps._lm_flops``), every loss
                finite and no step skipped;
                the check: its first T_CHECK_LAYERS layers in float32
                at T_CHECK_BATCH x T_CHECK_SEQ tokens, loss and every
                gradient on the card within a relative L2 of
                T_CHECK_REL_TOL of the CPU's, which the attention
                without its causal mask must miss, and ``remat`` on and
                off bitwise equal there.  EGNN, NequIP and
                Equiformer-v2 CONFIG at molecule: T_GNN_STEPS steps each
                (s/step), the first step's loss and gradients on the
                first GNN_CPU_MOLECULES molecules against the CPU at G's
                tolerances (in float64 where float32 does not resolve
                the CPU's own gradients to them).
X.  mesh     -- the mesh models over X_ENTRIES = 4 entries of ``cuda:0``
                (4 cards where the host has them: checked, not timed).
                X1: qwen2-7b CONFIG at full width and depth, tp 1, bf16,
                M3's 4 x 2048 prompts prefilled into a cache laid out
                over ``("model",)`` = 4 (``transformer.init_cache(...,
                mesh=)``, ``cache_seq`` -> ``model``: 4 sequence shards
                of 516 of s_max 2064), then 16 decode steps on the
                unsharded decode's greedy tokens: one flash_decode
                launch a layer, step and shard (28 x 16 x 4 = 1792),
                the shards merged by their log-sum-exps.  Every step's
                logits within a relative L2 of X_REL_TOL["X1"] of the
                unsharded decode's, which the planted fault (the shards
                averaged, no LSE rescale) must miss; a float32 2-layer
                control within X_F32_TOL; step p50 sharded and
                unsharded; K4's LSE output held on the first shard on
                both routes.  X2: deepseek-v2-236b at full width, 2
                layers, 2 x 1024, 8 steps over the same 4 shards (the
                absorbed MLA einsums a shard; no kernel), the same
                checks (its own limit X_REL_TOL["X2"]; its float32
                control at the no-drop capacity factor).  X3: DIEN
                CONFIG over ``("data", "model")`` = (2, 2): one AdamW
                step with the state laid out by ``state_specs`` (ZeRO)
                against the unplaced step from
                the same gradients (of X3_GRAD_BATCH examples), within
                PR 22's AdamW tolerance; the forward at serve_p99 and
                the retrieval at retrieval_cand on row-sharded tables
                (``table_rows`` -> ``model``) equal to the whole tables'
                bit for bit; each table's and moment's bytes a device.
                X5: X1's qwen2-7b at tp 4 (28 heads, none padded) on
                the tensor-parallel serve path: the weights placed by a
                prefill and a decode cell's ``arg_specs`` through
                ``TP_ONLY`` (``heads``, ``mlp``, ``vocab`` and
                ``experts`` -> ``model``), X1's prompts prefilled and
                its 16 fed tokens decoded through the cells'
                ``get_fn(mesh, TP_ONLY)`` on the sequence-sharded cache
                (one flash_decode launch a layer, step and cache shard:
                28 x 16 x 4); every step's logits within a relative L2
                of X_REL_TOL["X5"] of X1's unsharded decode (no
                unsharded run repeats), which the planted fault (each
                attention's partial outputs summed without the last
                entry's: its heads dropped) must miss;
                the float32 control against X1's; each entry's weight
                bytes against the shard shapes of ``resolve_tree``; the
                prefill's seconds and the step p50.  X6: the same for
                X2's deepseek-v2-236b (2 layers, 40 of its 160 experts
                an entry, its own limit), and the prefill run twice more:
                layer 0's MoE output bit for bit, its routing equal to
                ``route`` with the whole router bit for bit.
                X4: Equiformer-v2 CONFIG in float32 through the ring
                (``models/gnn/ring.py``: the node state in blocks over
                ``data``, every node-wise layer run block by block on
                the blocks' devices) over the (2, 2) mesh at
                full_graph_sm (X4_REPS calls) and minibatch_lg's sampled
                block (one call, X4_LG_LAYERS of its 12 layers): its node
                outputs against the local forward of the same inputs
                within X_F32_TOL relative L2, and in float64 (one more
                call of each) within G's rtol / atol, which float32 does
                not resolve at outputs near 0; ``bucket_edges`` dropping
                none, and the planted fault (model column 0's partial
                sums kept, no sum over ``model``) outside both; time and
                peak memory of the float32 calls.  X7-X10, FSDP over
                the (2, 2) mesh: the train cells' ``get_fn(mesh, FSDP_TP)``
                on arguments laid out by ``place_args`` (weights over
                ``data`` and ``model``, the batch over ``data``) against
                their ``get_fn()`` from the same random weights and
                batches.  X7: qwen2-1.5b CONFIG through train_4k, tp 16
                as the cell builds it (16 padded heads, 8 an entry),
                bf16, remat, X7_LAYERS of its 28 layers, batch 256 ->
                X7_BATCH x 4096 (``reduced``), X7_STEPS steps; each
                step's loss and grad norm and the updated parameters
                within X_REL_TOL["X7"] (relative), which the planted
                fault (one entry's heads dropped) must exceed; the step
                p50s, the peak memory and each entry's parameter and
                moment bytes.  X8: deepseek-v2-lite-16b CONFIG at full
                width, MCHECK_LAYERS of 27 layers, float32 at the no-drop
                capacity factor (no expert flips), X8_BATCH x X8_SEQ,
                one step within X8_REL_TOL, run twice bit for bit, the
                planted fault (one entry's experts dropped) beyond.  X9:
                DIEN CONFIG through train_batch at X3_GRAD_BATCH, tables
                over ``model``: one step in float32 (relative errors,
                timed) and in float64 (every updated parameter within
                X3_ADAMW_RTOL, as X4 holds its element-wise tolerance in
                float64), each table's and moment's bytes an entry.
                X10: the GNN train cells' edge-sharded step (the edges
                over ``("data", "model")``, nodes and weights replicated,
                the targets over ``data``; ``models/gnn/graph.py``'s
                ``EdgeShards``) for X10_CELLS: EGNN, PNA, NequIP and
                Equiformer-v2 at full_graph_sm (phase G's graph: 2708
                nodes, 10752 edge slots, 2688 an entry; d_feat 1433, 7
                classes), CONFIG width and depth, float32, two steps;
                EGNN at molecule (128 x 30 nodes, 8192 edges), one step;
                each one's loss, grad norm and parameters within
                X_REL_TOL["X10 <arch>"] of the one-device steps (whose
                outputs wait on the host meanwhile), which the planted
                fault (entry 3's edge partials left out of every
                cross-shard sum, max and min) must exceed; step p50s,
                peaks and the edge slots an entry.  Then, on meta, each
                entry's parameter and moment bytes of the five LM
                train_4k cells at full size on the (16, 16) production
                mesh.
B.  launch   -- the launch layer (``repro_torch.launch.steps``).  B1:
                every one of ``all_cells()``'s 44 cells built at full
                size on the meta device (nothing allocated), one line a
                cell: ``model_flops`` and the bytes of its abstract
                parameters, optimizer state and batch; then Equiformer-v2's
                ring bundle at ogb_products laid out over meta meshes of
                RING_GRIDS by its ``arg_specs``: the node state's, the
                node inputs' and the buckets' bytes a device.  B2: a cell of
                each family through ``make_bundle(...).get_fn()`` on the
                card at CONFIG width and depth: qwen2-1.5b decode_32k (28
                layers, tp 16 as the cell has it, random bf16 weights, a
                zero cache with lengths t // 2, its batch of 128 cut to
                B2_DECODE_BATCH in ``reduced``), B2_DECODE_STEPS greedy
                steps, one flash_decode launch a layer and step, the
                cache's rows written once a step; DIEN train_batch
                (65536) and EGNN molecule, B2_TRAIN_STEPS AdamW steps
                each, the arguments of the abstract ones' shapes; and,
                right after 3b, on the main path's graph and index, the
                dspc inc_update step of one random vertex pair that is no
                edge, then the dec_update step of the edge the cell's own
                host arguments delete (``edges[len(edges) // 2]`` of the
                main path's edge list; the next one still present if
                phase 5 deleted it), each event's seconds beside phase
                4's build, then B2_DSPC_SOURCES sources (both endpoints
                among them) against ``plain_spc_bfs``.  B3:
                ``python -m repro_torch.launch.train --arch dien`` 3
                steps into a directory, then 5 from it (``resumed from
                step 2``) beside an uninterrupted 5: the final
                checkpoints equal bit for bit.  B4 (after B2): B4a the
                dry run (``repro_torch.launch.dryrun``) on the pod16x16
                mesh of meta entries of B4_CELLS, a full-size cell of each
                family and Equiformer-v2's ring at ogb_products, one line
                a record; B4b one more step of B2's decode (after its
                checks), of T's qwen2-1.5b train step and of B2's EGNN
                molecule step, each counted on the card with real
                arguments and on meta copies of them: their FLOPs and
                bytes by op must be equal; B4c each step's measured time
                (B2's decode p50, T's s/step, B2's EGNN median) must be at
                least the count's bound, ``max(compute_term_s,
                memory_term_s)`` at the H100's data-sheet rates, printed
                as its roofline share beside the card's name and power
                limit; the planted fault, the bytes B4_FAULT_BYTES times
                over, must fail that check.
E.  examples -- the eight ``repro_torch.examples`` at the reference's CI
                settings (``--fast`` where it has one): seven in this
                process through ``main(argv)``, each one's own check
                held; ``fleet_spc`` as its replica and updater processes,
                in the background beside them and beside B3's processes.
Each phase's seconds are printed on a line of its own (``phase ...``),
and all of them together before the JSON lines.
flash_decode is held against its plain version (the KV heads expanded,
fp32 softmax) at the TPU sweep shapes and GQA groups in float32 (rtol =
atol = 2e-5, the TPU test's) and bfloat16 (1e-2 against the plain
version on the fp32 copies of the same inputs; both routes, the
planned one twice and bitwise equal) in phase 3.  At the main path's
shape (layer 0's cache after L3, after L4) it is held in bfloat16
within atol 1e-3 + rtol 1e-2 on the tensor-core route and on the
CUDA-core route (the output's RMS is about 0.009 there; the same check
must fail the plain version with its last span left out) and in
float32 on the same cache within 2e-5; then both routes and SDPA are
timed in turn, FD_REPS rounds; the planned route's kernels' device ms
per call come from the L3 trace.  The build prints each kernel
function's registers, shared memory and spills (``nvcc -Xptxas -v``)
and fails if a redesigned kernel (``REDESIGNED``: ``flash_decode_mma``,
``block_sums``, ``spc_query_fused``, ``embedding_bag_packed``) spills.

``--lm-seeds 0,1,...`` builds the kernels and then only reads L4 and its
controls for the first 2 requests of each seed (prefilled and decoded
as 2 requests), X1's and X2's sharded decode and plain-mean fault and
X5's and X6's tensor-parallel decode and their fault (one entry's heads
dropped) and X7's FSDP steps and the same fault from each seed,
prints them and exits.  ``--replica-of DIR --pairs
FILE`` is S3's second process.

Launches are counted for each main path on its own: the DSPC path
(phases 4, 5, 6 and the first call of 6b), the kernels path (K), the
analytics path (the timed steps of A1 and A2), the LM path (L2 and
L3; flash_decode exactly 8 x 64 times), the mesh path (the sharded
prefills and decodes, the placed AdamW step, the row-sharded DIEN
calls and the ring calls of X; flash_decode exactly 28 x 16 x 4 times,
all in X1), the tp path (X5's and X6's tensor-parallel prefills and
decodes; flash_decode exactly 28 x 16 x 4 times, all in X5), the fsdp
path (X7-X10's FSDP steps, which launch no kernel), the launch path (B2's cells: flash_decode exactly 28 x 16
times in the decode; the train cells and the dspc events launch none),
the examples path (E's in-process examples: spc_query in the DSPC
examples' serving, embedding_bag in analytics_spc's re-rank, flash_decode
in serve_lm's decode), one path for each
configuration of M, M2 and M3 (prefill and decode; flash_decode on the
two dense ones, no kernel on the deepseek ones: MLA decode is the
reference's einsums, the MoE un-dispatch a gather and adds, where the
reference scatter-adds), the gnn path (phase G, which launches no
kernel: the reference's GNNs aggregate with segment sums, not
segment_matmul), the recsys path (phase R's timed calls, no kernel:
DIEN's profile bags are gathered and averaged, not summed by
embedding_bag) and the train path (phase T's runs, no kernel: no
function of the reference has a custom VJP, so no Pallas kernel has a
backward), the service path (the ingest and serving of S1 and
the front-door traffic of S2; the service readers, the dispatchers and
the updater launch from their own threads) and the distributed path
(D's sharded build, chunk and serving, which launch no kernel: the
sharded relaxation is ``index_add_`` and the sharded query the merge
core, as on the reference) and the analysis path (phase Z, host only: no
kernel).  The launch counters are set to 0 just
before each of these phases and read just after it; the oracles, L4
and the kernel checks run outside them and count nowhere.  Each path must have launched each of its kernels
(``PATH_KERNELS``).  The line before the last is a JSON object with one
entry per kernel (its time on the card, its plain version's time, its
bound, one library call's time where there is one, its launches on the
main paths, also by path); the last line is ``{"ok": true, "device":
{...}}``.  Any failure raises and exits non-zero.  Without a CUDA
device, or without the repository's sources beside it, the script exits
1 and prints no result.

Plain products run in full float32 where they are float32
(``allow_tf32`` off for matmuls and cuDNN), as XLA's on the reference.
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W): HBM
# bytes/s and the dense bf16 tensor-core rate.
from repro_torch.launch.mesh import HBM_BW as HBM_BYTES_PER_S  # noqa: E402
from repro_torch.launch.mesh import \
    PEAK_FLOPS_BF16 as BF16_DENSE_OPS_PER_S  # noqa: E402
#: 32-bit scalar operations per second outside the tensor cores (the
#: fp32 rate; integer compares and adds issue at no more than it).
SCALAR_OPS_PER_S = 67e12

KERNEL_SOURCES = {
    "spc_query": ("src/repro_torch/csrc/spc_query.cu",
                  "src/repro/kernels/spc_query/kernel.py:38"),
    "segment_matmul": ("src/repro_torch/csrc/segment_matmul.cu",
                       "src/repro/kernels/segment_matmul/kernel.py:34"),
    "embedding_bag": ("src/repro_torch/csrc/embedding_bag.cu",
                      "src/repro/kernels/embedding_bag/kernel.py:29"),
    "flash_decode": ("src/repro_torch/csrc/flash_decode.cu",
                     "src/repro/kernels/flash_decode/kernel.py:32"),
}

#: The kernel functions redesigned for the card, which must not spill.
REDESIGNED = ("flash_decode_mma", "block_sums", "spc_query_fused",
              "embedding_bag_packed")

#: The kernels each main path must launch.
PATH_KERNELS = {"dspc": ("spc_query",), "kernels": ("spc_query",
                                                    "segment_matmul"),
                "analytics": ("embedding_bag",), "lm": ("flash_decode",),
                "service": ("spc_query",),
                # the sharded relax is index_add_, the sharded query the
                # merge core, as on the reference: no kernel of its own
                "distributed": (),
                "qwen2-7b": ("flash_decode",),
                "phi3-medium-14b": ("flash_decode",),
                # MLA decode is the reference's absorbed einsums (one
                # latent head, K width 576 != V width 512: outside any
                # Pallas kernel there too) and the MoE un-dispatch a
                # gather and adds (the reference's is its own scatter-add,
                # not segment_matmul): no kernel of the port on these paths
                "deepseek-v2-lite-16b": (), "deepseek-v2-236b": (),
                # the reference's GNNs aggregate with jax.ops.segment_sum /
                # segment_max and plain einsums, not segment_matmul: the
                # port's index_add_ / scatter_reduce_, no kernel
                "gnn": (),
                # DIEN takes + means its profile bags (dien.py:136-147),
                # which embedding_bag (a sum) does not compute; no
                # function of the reference has a custom VJP, so a
                # training step runs no Pallas kernel: no kernel
                "recsys": (), "train": (),
                # phase X: qwen2-7b's sequence-sharded decode, one launch
                # a shard (MLA's shards, ZeRO, DIEN's tables and the ring
                # launch none)
                "mesh": ("flash_decode",),
                # phase X7-X10: the FSDP train steps (no function of the
                # reference has a custom VJP: no kernel, as on "train")
                "fsdp": (),
                # phase X5 / X6: the tensor-parallel serve path (qwen2-7b's
                # decode on the sequence-sharded cache, one launch a
                # shard; deepseek-v2-236b's MLA and MoE launch none)
                "tp": ("flash_decode",),
                # phase B2: the decode_32k cell's decode (DIEN's and
                # EGNN's train steps and the dspc events launch none)
                "launch": ("flash_decode",),
                # phase E: the DSPC examples' serving, analytics_spc's
                # re-rank pooling and serve_lm's decode
                "examples": ("spc_query", "embedding_bag", "flash_decode"),
                # phase Z: the analyzer, a scan of the sources on the host
                "analysis": ()}

#: The segment_matmul sweep of tests/kernels/test_kernels.py (e, n, d),
#: inputs drawn as that test draws them (ids in [0, n + 5): some dropped).
SEG_SWEEP = ((100, 30, 16), (1000, 128, 64), (513, 65, 8), (64, 300, 4))
#: The longest segment of the dspc CONFIG graph (vertex degree 14329):
#: one segment of this many edges is checked on its own.
SEG_LONG = 14329
#: The width of the node features the kernels path aggregates.
SEG_FEATURES = 128
#: Rounds in which both segment_matmul designs and index_add_ are timed
#: in turn at each shape, and back-to-back calls traced for the card's
#: busy time per call.
SEG_REPS, SEG_TRACE_CALLS = 3, 20

#: spc_query: the vertices (and pairs) of the synthetic L = 2048
#: indexes its index form is checked on; rounds in which the fused
#: kernel, the gathered route (gather, re-pad, warp kernel), the warp kernel
#: alone and the plain merge are timed in turn at the main path's shape,
#: calls in the CUDA graph that gives the card's time per call; serve
#: batches replayed under the profiler; the slices in which the
#: configuration's query_batch is checked against the gathered route.
K1_SYNTH_N, K1_REPS, K1_GRAPH_CALLS = 4096, 3, 20
SERVE_TRACE_BATCHES, QUERY_SLICE = 32, 1024
#: Rounds in which embedding_bag's two designs and F.embedding_bag are
#: timed in turn; the bytes of the tensor that probes L2's read rate.
K3_REPS, L2_PROBE_BYTES = 3, 16 << 20
#: The TPU sweep of tests/kernels/test_kernels.py (b, s, v, d), and the
#: recsys shapes of configs/dien.py: vocab 100000, D = 18, 8 ids per
#: bag, 4 bags per example at serve_p99 (512) and serve_bulk (262144).
BAG_SWEEP = ((4, 3, 16, 128), (32, 20, 1000, 16), (7, 1, 64, 32))
BAG_RECSYS = (("serve_p99", 512 * 4), ("serve_bulk", 262144 * 4))
RECSYS_VOCAB, RECSYS_DIM, RECSYS_BAG = 100_000, 18, 8

#: flash_decode checks (b, h, kvh, s, d): the TPU sweep of
#: tests/kernels/test_kernels.py as b = BH rows of one head each, then
#: GQA groups of 4, 6 (qwen2-1.5b at tp = 1) and 12 (two head chunks).
DECODE_SWEEP = ((4, 1, 1, 64, 32), (8, 1, 1, 1024, 128), (3, 1, 1, 100, 64),
                (16, 1, 1, 333, 16), (2, 8, 2, 64, 32),
                (3, 12, 2, 2000, 128), (2, 12, 1, 700, 64))
#: The LM path: decode_32k's context, the requests decoded together
#: (its global batch of 128 cut to fit one card) and prefilled together,
#: decode steps, the layers run (28 cut to 8 for the script's time
#: limit), the requests L4 prefills again, and its limit on the relative
#: L2 logit error: midway between the port's largest reading (0.01313)
#: and the smaller planted fault's smallest (bf16 scores, 0.01617) on an
#: H100 over seeds 0-3 (``--lm-seeds``) at these 8 layers.
LM_PROMPT, LM_BATCH, LM_GROUP, LM_STEPS, LM_LAYERS = 32768, 16, 4, 64, 8
LM_CHECK, LM_REL_TOL = 2, 1.465e-2
#: Decode steps replayed under the profiler for the device-busy time,
#: and the kernels of a step reported by device time.
LM_TRACE_STEPS, LM_TOP_KERNELS = 4, 8
#: flash_decode at the main path's shape in bfloat16: |got - want| <=
#: MAIN_ATOL + MAIN_RTOL |want| (the output's RMS is about 0.009 there).
MAIN_RTOL, MAIN_ATOL = 1e-2, 1e-3
#: Rounds in which flash_decode's two routes and SDPA are timed in turn at
#: the main path's shape.
FD_REPS = 3
#: The service phases (S1-S4): events per ingest chunk (the configuration's
#: update_batch of 64 cut to 8 for time, listed in ``reduced``), S1's
#: events (the first of an 8-event stream, two tickets of half; cut for
#: the script's time limit, in ``reduced``), serve
#: batches timed idle and under ingest and their pairs, front-door
#: callers and their single-pair requests, the bound on every wait, and
#: the free disk the fleet's directory needs (up to 5 published snapshots
#: of about 2.15 GB and a state checkpoint of about 2.2 GB).
SERVICE_CHUNK, SERVICE_EVENTS = 8, 4
SERVICE_BATCHES, SERVICE_PAIRS = 64, 1024
FD_CALLERS, FD_REQUESTS = 8, 512
SERVICE_WAIT_S, FLEET_DISK_BYTES = 600.0, 16 * 10 ** 9
#: Phase D: mesh entries on a single card (an edge axis and a data axis
#: of 4 entries of cuda:0), events in its chunk, serve batches and their
#: pairs, and the halvings of the dspc CONFIG's n and m for its own
#: graph (n 8192, m 65536: its single-device build, which it is held
#: against, takes a few seconds; 3 halvings, not 2, for the script's
#: time limit).
DIST_SHARDS, DIST_EVENTS, DIST_BATCHES, DIST_PAIRS = 4, 8, 64, 1024
DIST_HALVINGS = 3
#: Phase M: deepseek-v2-lite-16b CONFIG at full width and depth on
#: decode_32k's context, its global batch of 128 cut to DS_BATCH
#: requests (the MLA cache is 31104 B a token: 4.1 GB at 4; 8 until
#: PR 24, cut for the script's time limit), prefilled
#: DS_GROUP at a time (the blockwise float32 scores of a group are the
#: peak's largest part), DS_STEPS greedy decode steps.
DS_BATCH, DS_GROUP, DS_STEPS = 4, 2, 64
#: M-check (and M2's check), in float32 with the no-drop capacity factor
#: e / k: the layers kept, the requests and their prompt (blockwise, and
#: ragged against prefill_block_k once the fed tokens are added), the
#: decode steps, the prefix over which the absorbed decode is held
#: against mla_train, and the limit on the relative L2 error of both.
#: Float32 rounding reads about 1e-6 at SMOKE on the CPU and about 3e-6
#: on the card; whether a bfloat16 run would miss the limit is not
#: measured (bfloat16 rounds at 2^-8 a value).
MCHECK_LAYERS, MCHECK_BATCH, MCHECK_PROMPT, MCHECK_STEPS = 2, 2, 8192, 8
MCHECK_PREFIX, MCHECK_REL_TOL = 1024, 1e-3
#: Phase M2: deepseek-v2-236b at full width, depth 60 -> MCHECK_LAYERS
#: (its 239 B parameters need about 479 GB in bfloat16); prompt
#: M2_BATCH x M2_PROMPT, M2_STEPS decode steps.
M2_BATCH, M2_PROMPT, M2_STEPS = 2, 1024, 8
#: Phase M3: qwen2-7b and phi3-medium-14b at full width and depth, tp 1:
#: prompts, decode steps, and the requests of the random decode_32k cache
#: K4 is held and timed on; phi3's tp 16 group of 5 is held on the
#: first FD_GROUP5_ROWS requests of it.
M3_BATCH, M3_PROMPT, M3_STEPS = 4, 2048, 16
FD_FAMILY_BATCH, FD_GROUP5_ROWS = 16, 4
#: Phase G: the equivariant GNN family, each at its CONFIG width and depth
#: in float32, on three GNN_SHAPES; timed calls after one warm-up; the
#: tolerance of the card-against-CPU and two-launch checks (phase 7's
#: re-rank's); the limit on the relative L2 change of the outputs when the
#: positions are rotated; the molecules of Equiformer-v2's CPU check (a
#: CPU run of all 128 would take about 1.9 TFLOP).
GNN_ARCHS = ("egnn", "nequip", "equiformer-v2")
GNN_SHAPE_NAMES = ("molecule", "full_graph_sm", "minibatch_lg")
GNN_REPS, GNN_RTOL, GNN_ATOL, GNN_ROT_TOL = 5, 1e-4, 1e-5, 1e-3
#: Timed calls at minibatch_lg (5 until PR 24; cut for the time limit).
GNN_REPS_LG = 3
GNN_CPU_MOLECULES = 8
#: Phase R: DIEN's timed calls at serve_p99, serve_bulk and
#: retrieval_cand, and the tolerance of the card against the CPU.
R_P99_CALLS, R_BULK_CALLS, R_RETRIEVAL_CALLS = 64, 3, 20
R_RTOL, R_ATOL = 1e-4, 1e-5
#: Phase T: DIEN's steps at train_batch, the rows of its first step held
#: against the CPU and their tolerance; qwen2-1.5b's batch at train_4k's
#: t (its global batch of 256 cut to fit one card: logits of [4096,
#: 151936] take 1.24 GB a sequence in bf16) and steps; the layers, batch
#: and t of its float32 check and the limit on the relative L2 error of
#: the loss and of each gradient; the GNNs' steps at molecule.
T_DIEN_STEPS, T_DIEN_CHECK_ROWS, T_DIEN_RTOL, T_DIEN_ATOL = 4, 1024, 1e-4, 1e-6
T_LM_BATCH, T_LM_STEPS = 4, 4
T_CHECK_LAYERS, T_CHECK_BATCH, T_CHECK_SEQ, T_CHECK_REL_TOL = 2, 2, 512, 1e-3
T_GNN_STEPS = 3
#: Phase X (the mesh models): the mesh's entries and X3's and X4's
#: ("data", "model") grid over them; X1 is M3's qwen2-7b workload, X2
#: M2's deepseek-v2-236b one; the layers and requests of their float32
#: controls and its limit; each one's limit on the relative L2 error of
#: the sharded decode's logits against the unsharded decode's: midway
#: between the port's largest reading and the plain-mean fault's
#: smallest over seeds 0-3 (``--lm-seeds``) on an H100 (X1: 0.01834 and
#: 0.1128; X2: 0.08117 and 0.1540, where an expert flips); X5's and X6's
#: likewise for the tensor-parallel decode against the same unsharded
#: one and its fault, one entry's heads dropped (X5: 0.01980 and 1.1646;
#: X6: 0.08879 and 0.8778; with PR 25's fault, entry 0's partial only,
#: 0.7058 and 0.6779); X7's for the FSDP steps' loss, grad norm and
#: parameters against the one-device steps, and the same fault (0.01011
#: and 0.05499); X10's for each GNN cell's edge-sharded steps likewise,
#: and one entry's edge partials dropped (EGNN 1.254e-7 and 0.2866, PNA
#: 5.237e-5 and 0.06765, NequIP 8.269e-8 and 8.32e-5, Equiformer-v2
#: 2.313e-7 and 0.007662, EGNN at molecule 1.362e-6 and 0.004716); the
#: tolerance of K4's LSE output; the sharded decode steps traced; X3's
#: gradient batch and AdamW tolerance (PR 22's: rtol 1e-6, atol 1e-6
#: times each leaf's largest magnitude); X4's timed calls at
#: full_graph_sm (after one untimed call).
X_ENTRIES, X_GRID = 4, (2, 2)
X1_BATCH, X1_PROMPT, X1_STEPS = 4, 2048, 16
X2_BATCH, X2_PROMPT, X2_STEPS = 2, 1024, 8
X_CHECK_LAYERS, X_CHECK_BATCH, X_F32_TOL = 2, 2, 1e-4
X_REL_TOL = {"X1": 6.557e-2, "X2": 1.176e-1, "X5": 5.922e-1,
             "X6": 4.833e-1, "X7": 3.255e-2, "X10 egnn": 1.433e-1,
             "X10 pna": 3.385e-2, "X10 nequip": 4.164e-5,
             "X10 equiformer-v2": 3.831e-3, "X10 egnn molecule": 2.359e-3}
X_LSE_ATOL, X_TRACE_STEPS = 1e-3, 2
X3_GRAD_BATCH, X3_ADAMW_RTOL = 4096, 1e-6
X4_REPS = 3
#: X7-X9 (FSDP, over X_GRID): X7 qwen2-1.5b through train_4k at X7_LAYERS
#: of its 28 layers (as phase L), its global batch of 256 cut to X7_BATCH
#: (two sequences a data row), X7_STEPS AdamW steps; X8 deepseek-v2-lite
#: at MCHECK_LAYERS of 27 layers in float32 at the no-drop capacity
#: factor, X8_BATCH x X8_SEQ, one step, within X8_REL_TOL; X9 DIEN at
#: X3_GRAD_BATCH within X3_ADAMW_RTOL.
X7_LAYERS, X7_BATCH, X7_STEPS = 8, 4, 2
X8_BATCH, X8_SEQ, X8_REL_TOL = 2, 1024, 1e-3
#: X10 (the GNN train cells' edge-sharded step over X_GRID): each cell at
#: CONFIG width and depth in float32 and its AdamW steps; its limit is
#: X_REL_TOL["X10 <arch>"] (" molecule" after EGNN's molecule cell's).
X10_CELLS = (("egnn", "full_graph_sm", 2), ("pna", "full_graph_sm", 2),
             ("nequip", "full_graph_sm", 2),
             ("equiformer-v2", "full_graph_sm", 2), ("egnn", "molecule", 1))
#: X4's layers at minibatch_lg (CONFIG's 12 until PR 24; cut for the
#: script's time limit: the ring's one call there took 24.6 s at 12
#: layers, 8.2 s at 4, on an H100).
X4_LG_LAYERS = 4
#: B1's ("data", "model") grids for Equiformer-v2's ring at ogb_products.
RING_GRIDS = ((4, 1), (2, 2))
#: Phases 4 onwards: the halvings of the dspc CONFIG's n and m by default
#: (cut for the script's time limit: the whole script took 928.0 s with
#: none on an H100, phase 4's build alone 173.1 s at full scale).
MAIN_HALVINGS = 1
#: Phase 5: the events of its one chunk (half inserts, half deletes): the
#: configuration's update_batch of 64 cut for the script's time limit (the
#: 64-event chunk took 324-373 s on an H100, host-bound at ~1.2 ms a BFS
#: level's sync).
MAINTAIN_EVENTS = 16
#: Phase B (the launch layer): B2's decode cell (qwen2-1.5b decode_32k at
#: 28 layers) cut from its global batch of 128 to B2_DECODE_BATCH (a zero
#: cache of 128 x 32768 tokens would take about 120 GB), its steps; the
#: steps of the DIEN and EGNN train cells; the sources checked after each
#: dspc event.
B2_DECODE_BATCH, B2_DECODE_STEPS, B2_TRAIN_STEPS = 16, 16, 3
B2_DSPC_SOURCES = 8
#: Phase Z's planted fault: ``SPCService.stats()`` takes ``service.cond``
#: (rank 3) around its ``service.reader_lock`` (rank 2) block, an
#: inversion of the declared hierarchy, in a copy of the module.
Z_FAULT = ("src/repro_torch/serve/service.py",
           "        with self._reader_lock:\n"
           "            engines = list(self._engines)",
           "        with self._cond, self._reader_lock:\n"
           "            engines = list(self._engines)")


def log(msg: str) -> None:
    print(msg, flush=True)


def ptxas_usage(log: str) -> list:
    """Each kernel function's registers, spills and static shared memory
    as ``nvcc -Xptxas -v`` printed them in ``log``: a list of
    ``{"function", "registers", "spill_stores", "spill_loads",
    "smem"}``, the function's name read out of its mangled name with its
    template arguments (``flash_decode_mma<128>``)."""
    import re
    out = []
    for part in log.split("Compiling entry function '")[1:]:
        mangled, info = part.split("'", 1)
        info = info.split("Compile time", 1)[0]
        m = re.search(r"_cu_[0-9a-f]{8}(\d+)([A-Za-z_]\w*)", mangled)
        name, args = mangled, ""
        if m:
            name = m.group(2)[:int(m.group(1))]
            args = m.group(2)[int(m.group(1)):]
        if args.startswith("I"):
            targs = re.findall(r"L[ib](\d+)E|13__nv_(bfloat16)|(?<=[IE])f",
                               args.split("EEv", 1)[0])
            name += "<" + ", ".join(i or ("bf16" if t else "float")
                                    for i, t in targs) + ">"

        def num(pattern):
            found = re.search(pattern, info)
            return int(found.group(1)) if found else 0
        out.append({"function": name,
                    "registers": num(r"Used (\d+) registers"),
                    "spill_stores": num(r"(\d+) bytes spill stores"),
                    "spill_loads": num(r"(\d+) bytes spill loads"),
                    "smem": num(r"(\d+) bytes smem")})
    return out


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` back-to-back
    calls, from CUDA events (after ``warmup`` calls)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def power_law_edges(n: int, m: int, seed: int) -> list:
    """m distinct undirected edges, endpoints drawn with weights
    proportional to i^-0.8 (the weights of
    ``repro_torch.data.random_graph_edges``), drawn in bulk."""
    rng = np.random.default_rng(seed)
    w = 1.0 / (np.arange(1, n + 1) ** 0.8)
    cdf = np.cumsum(w / w.sum())
    keys = np.empty(0, dtype=np.int64)
    while keys.shape[0] < m:
        k = 2 * (m - keys.shape[0]) + 1024
        ab = np.minimum(np.searchsorted(cdf, rng.random((k, 2))), n - 1)
        lo, hi = ab.min(axis=1), ab.max(axis=1)
        fresh = (lo * n + hi)[lo != hi]
        allk = np.concatenate([keys, fresh])
        _, first = np.unique(allk, return_index=True)
        keys = allk[np.sort(first)]          # first occurrences, in order
    keys = np.sort(keys[:m])
    return list(zip((keys // n).tolist(), (keys % n).tolist()))


def sweep_rows(b: int, l_cap: int, n: int, rng, device):
    """Kernel-ready rows: sorted distinct hubs per row, s side padded
    with n, t side with n + 1, pad dist INF, pad cnt 0."""
    import torch
    INF = 1 << 28
    out = []
    for pad in (n, n + 1):
        hub = np.full((b, l_cap), pad, dtype=np.int32)
        dist = np.full((b, l_cap), INF, dtype=np.int32)
        cnt = np.zeros((b, l_cap), dtype=np.int64)
        for r in range(b):
            k = int(rng.integers(0, l_cap + 1))
            hub[r, :k] = np.sort(rng.choice(n, size=k, replace=False))
            dist[r, :k] = rng.integers(0, 12, k)
            cnt[r, :k] = rng.integers(1, 9, k)
        out += [hub, dist, cnt]
    return tuple(torch.from_numpy(x).to(device) for x in out)


def big_count_rows(device):
    """Hand-made rows whose counts are 2^24 + 1 and above 2^32 (the
    fp32 TPU kernel rounds the first; the second overflows int32)."""
    import torch
    INF = 1 << 28
    n = 3
    big24, big32 = 2 ** 24 + 1, 2 ** 33 + 3
    # row 2: all three common hubs tie at distance 4
    hub_s = [[0, n, n, n], [0, 1, n, n], [0, 1, 2, n]]
    dist_s = [[0, INF, INF, INF], [1, 0, INF, INF], [2, 3, 4, INF]]
    cnt_s = [[1, 0, 0, 0], [big24, 1, 0, 0], [big32, 5, 1, 0]]
    hub_t = [[0, 1, n + 1, n + 1], [0, 2, n + 1, n + 1], [0, 1, 2, n + 1]]
    dist_t = [[1, 0, INF, INF], [2, 0, INF, INF], [2, 1, 0, INF]]
    cnt_t = [[big24, 1, 0, 0], [7, 1, 0, 0], [3, 1, 1, 0]]
    rows = (hub_s, dist_s, cnt_s, hub_t, dist_t, cnt_t)
    dts = (torch.int32, torch.int32, torch.int64) * 2
    want = ([1, 3, 4], [big24, big24 * 7, big32 * 3 + 5 + 1])
    return (tuple(torch.tensor(r, dtype=dt, device=device)
                  for r, dt in zip(rows, dts)), want)


def repeated_hub_rows(device):
    """One hand-made pair whose hubs repeat on both sides at two
    distances (rows sorted by hub only), and its (dist, count) worked
    out by hand over the L x L table.  Hub 2: s at (dist 2, cnt 5) and
    (1, 2), t at (3, 3) and (1, 4): sums 5, 3, 4 and 2 (2 x 4 = 8).  Hub
    7: s at (0, 1) and (3, 7), t at (INF, 6), (4, 2) and (2, 5): sums
    4, 2 (1 x 5 = 5), 7 and 5.  So (2, 8 + 5).  Taking only the first t
    entry of each hub gives (4, 6); stopping a run at its INF entry
    gives (2, 8)."""
    import torch
    INF = 1 << 28
    n = 10
    hub_s, dist_s, cnt_s = [2, 2, 5, 7, 7, n], [2, 1, 0, 0, 3, INF], \
        [5, 2, 3, 1, 7, 0]
    hub_t, dist_t, cnt_t = [2, 2, 4, 7, 7, 7], [3, 1, 0, INF, 4, 2], \
        [3, 4, 9, 6, 2, 5]
    rows = (hub_s, dist_s, cnt_s, hub_t, dist_t, cnt_t)
    dts = (torch.int32, torch.int32, torch.int64) * 2
    return (tuple(torch.tensor([r], dtype=dt, device=device)
                  for r, dt in zip(rows, dts)), ([2], [13]))


def spc_query_work(rows):
    """(bytes, operations) that the spc_query function needs on these
    rows.  Bytes: both hub rows in full (where a row's labels end is only
    known by reading it), dist and cnt of either side only at the common
    hubs (4 + 4 + 8 + 8 bytes each), and the outputs (4 + 8 bytes per
    pair).  Operations: a sorted merge, one compare per real label of
    either row, plus an add, a compare, a multiply and an add per common
    hub."""
    import torch
    INF = 1 << 28
    hub_s, dist_s, _, hub_t, dist_t, _ = rows
    b, l_cap = hub_s.shape
    pos = torch.searchsorted(hub_t, hub_s).clamp_(max=l_cap - 1)
    common = int((hub_t.gather(1, pos) == hub_s).sum())   # pads never match
    real = int((dist_s < INF).sum() + (dist_t < INF).sum())
    nbytes = (hub_s.numel() * hub_s.element_size()
              + hub_t.numel() * hub_t.element_size()
              + 24 * common + b * (4 + 8))
    return nbytes, real + 4 * common, common


def spc_query_index_work(idx, s, t, rows):
    """(bytes, operations, common hubs) that the spc_query function needs
    for the pairs (s, t) when it reads the rows from the index by id:
    the ids (8 + 8 bytes a pair); the real hubs of each distinct row
    queried, once, plus the pad after them where the row is not full
    (where the row ends); dist and cnt at the common hubs (24 bytes
    each); the outputs (12 bytes a pair).  ``rows`` are the same pairs'
    gathered rows (``prep_rows``), on which the common hubs and the
    operations are counted as :func:`spc_query_work` counts them."""
    import torch
    from repro_torch.kernels.spc_query.ops import wrap_ids
    queried = torch.unique(torch.cat([wrap_ids(idx, s), wrap_ids(idx, t)]))
    real = (idx.hub[queried] < idx.n).sum(dim=1)
    hub_bytes = 4 * int((real + (real < idx.l_cap).long()).sum())
    _, ops, common = spc_query_work(rows)
    b = rows[0].shape[0]
    return 16 * b + hub_bytes + 24 * common + 12 * b, ops, common


def rows_as_index(rows, n: int):
    """Gathered [B, L] rows whose real hubs lie below ``n`` as an index:
    the s rows, then the t rows, then pad rows, the pads (hubs from n
    on) rewritten to the index's own pad hub m = max(n, 2 B), which is
    above every real hub.  Returns (SPCIndex with m + 1 rows, s ids, t
    ids): the index form of the same pairs."""
    import torch
    from repro_torch.core.labels import SPCIndex
    INF = 1 << 28
    hub_s, dist_s, cnt_s, hub_t, dist_t, cnt_t = rows
    b, l_cap = hub_s.shape
    m = max(n, 2 * b)
    dev = hub_s.device
    extra = m + 1 - 2 * b
    hub = torch.cat([hub_s, hub_t, torch.full((extra, l_cap), m,
                                              dtype=torch.int32,
                                              device=dev)])
    hub = torch.where(hub >= n, m, hub).contiguous()
    dist = torch.cat([dist_s, dist_t, torch.full((extra, l_cap), INF,
                                                 dtype=torch.int32,
                                                 device=dev)])
    cnt = torch.cat([cnt_s, cnt_t, torch.zeros((extra, l_cap),
                                               dtype=torch.int64,
                                               device=dev)])
    idx = SPCIndex(hub=hub, dist=dist.contiguous(), cnt=cnt.contiguous(),
                   size=(hub < m).sum(dim=1, dtype=torch.int32),
                   cnt_sum=cnt.sum(dim=1),
                   overflow=torch.zeros((), dtype=torch.int32, device=dev),
                   n=m)
    ids = torch.arange(b, dtype=torch.int64, device=dev)
    return idx, ids, ids + b


def synthetic_index(n: int, l_cap: int, rng, device, repeat: bool = False):
    """An SPCIndex [n + 1, l_cap] padded as the index pads it (hub n, dist
    INF, cnt 0): each row's real length uniform over [0, l_cap], a tenth
    of the rows full; hubs sorted, distinct (n >= l_cap) or, with
    ``repeat``, drawn with replacement from the first min(64, n) hubs
    (a real hub lies below the pad hub n)."""
    from repro_torch.core.labels import index_from_numpy
    INF = 1 << 28
    hub = np.full((n + 1, l_cap), n, dtype=np.int32)
    dist = np.full((n + 1, l_cap), INF, dtype=np.int32)
    cnt = np.zeros((n + 1, l_cap), dtype=np.int64)
    size = np.zeros(n + 1, dtype=np.int32)
    size[:n] = rng.integers(0, l_cap + 1, n)
    size[:n][rng.random(n) < 0.1] = l_cap
    for v in range(n):
        k = int(size[v])
        hub[v, :k] = np.sort(rng.integers(0, min(64, n), k) if repeat
                             else rng.choice(n, size=k, replace=False))
        dist[v, :k] = rng.integers(0, 12, k)
        cnt[v, :k] = rng.integers(1, 9, k)
    return index_from_numpy(n, hub, dist, cnt, size, device=device)


def index_ids(n: int, b: int, rng, device):
    """int64 ids s, t [b] uniform over [0, n], the first pairs at ids 0,
    n - 1, n and outside [0, n] (-1, -(n + 1), -(n + 5), n + 3)."""
    import torch
    s, t = rng.integers(0, n + 1, b), rng.integers(0, n + 1, b)
    odd = np.asarray([0, n - 1, n, -1, -(n + 1), -(n + 5), n + 3])
    k = min(b, odd.size)
    s[:k], t[:k] = odd[:k], odd[::-1][:k]
    return (torch.from_numpy(s).to(device), torch.from_numpy(t).to(device))


def index_plain(idx, s, t):
    """The index form's plain version on the index's device: the rows
    gathered under the reference's gather rule, t re-padded, the L x L
    table with int64 counts."""
    from repro_torch.kernels.spc_query.ops import prep_rows
    from repro_torch.kernels.spc_query.ref import spc_query_ref
    return spc_query_ref(*prep_rows(idx, s, t))


def gathered_route(idx, s, t):
    """The serve route before the fused kernel: gather the six [B, L] operands,
    re-pad hub_t, then the warp kernel."""
    import torch
    from repro_torch.core.query import gather_rows
    from repro_torch.kernels.spc_query.kernel import _warp_cuda
    hub_s, dist_s, cnt_s = gather_rows(idx, s)
    hub_t, dist_t, cnt_t = gather_rows(idx, t)
    hub_t = torch.where(hub_t == idx.n, idx.n + 1, hub_t)
    return _warp_cuda(hub_s, dist_s, cnt_s, hub_t, dist_t, cnt_t)


def check_equal(tag, got, want):
    """Exact equality of (dist, count) tensors; returns max |diff|."""
    import torch
    err = 0
    for g, w in zip(got, want):
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"{tag}: {g.dtype}{tuple(g.shape)} vs "
                                 f"{w.dtype}{tuple(w.shape)}")
        if g.numel():
            err = max(err, int((g.to(torch.int64)
                                - w.to(torch.int64)).abs().max()))
    if err:
        raise AssertionError(f"{tag}: kernel and plain version differ "
                             f"(max |diff| {err})")
    return err


def oracle(svc, engine, sources, tag):
    """plain_spc_bfs from each source == the engine's answers to all v."""
    oracle_on(svc.graph, svc.index, engine, sources, tag)


class PathLaunches:
    """Kernel launches on each main path.  ``with launches.path(name):``
    sets every wrapper's count to 0 just before the enclosed phase and
    adds what it reads just after to that path's tally; launches made
    outside such a block (oracles, kernel checks) count nowhere."""

    def __init__(self, counters):
        self.counters = counters                 # kernel name -> counter
        self.by_path = {p: dict.fromkeys(counters, 0) for p in PATH_KERNELS}

    @contextlib.contextmanager
    def path(self, name):
        for c in self.counters.values():
            c.count = 0
        yield
        for k, c in self.counters.items():
            self.by_path[name][k] += c.count

    def check(self):
        """Raise unless every path launched each of its kernels."""
        for p, kernels in PATH_KERNELS.items():
            for k in kernels:
                if self.by_path[p][k] == 0:
                    raise AssertionError(f"kernel {k} never launched on "
                                         f"the {p} path")

    def of(self, kernel):
        """(launches over the main paths, launches by path)."""
        by = {p: c[kernel] for p, c in self.by_path.items()}
        return sum(by.values()), by


def bag_inputs(b: int, s: int, v: int, d: int, rng, device):
    """ids int32 [b, s] uniform over [0, v) and a float32 table
    [v + 1, d] whose last row is zero (the shape the ops wrapper hands
    the kernel)."""
    import torch
    ids = torch.from_numpy(rng.integers(0, v, (b, s)).astype(np.int32))
    table = rng.standard_normal((v + 1, d)).astype(np.float32)
    table[v] = 0.0
    return ids.to(device), torch.from_numpy(table).to(device)


def wrapped_id_rows(device):
    """F1's smallest input: a table of V = 4 rows [1, 2] .. [7, 8] plus
    the zero row, and ids that count from the end (-3 reads row 2, -5 row
    0, -1 the zero row), one past the table (4) and below -(V + 1) (-6,
    -10^6: the zero row in the port, F2).  Returns (ids int32 [6, 1],
    table float32 [5, 2], the rows the bags must give)."""
    import torch
    table = torch.tensor([[1, 2], [3, 4], [5, 6], [7, 8], [0, 0]],
                         dtype=torch.float32, device=device)
    ids = torch.tensor([[-3], [-1], [-5], [4], [-6], [-10 ** 6]],
                       dtype=torch.int32, device=device)
    return ids, table, [[5, 6], [0, 0], [1, 2], [0, 0], [0, 0], [0, 0]]


def embedding_bag_work(ids, table):
    """(bytes, operations, distinct rows) that the embedding_bag function
    needs on these inputs.  Bytes: the ids, each distinct table row the
    bags touch once, and the output.  Operations: one add per id and
    column."""
    import torch
    b, s = ids.shape
    v1, d = table.shape
    wrapped = torch.where(ids < 0, ids + v1, ids)        # from the end
    rows = torch.where((wrapped >= 0) & (wrapped < v1 - 1), wrapped, v1 - 1)
    distinct = int(torch.unique(rows).numel())
    elem = table.element_size()
    nbytes = ids.numel() * ids.element_size() + (distinct + b) * d * elem
    return nbytes, b * s * d, distinct


def segment_sweep_inputs(e: int, n: int, d: int, device):
    """float32 vals [e, d] ~ N(0, 1) and int32 dst [e] over [0, n + 5)
    (ids from n on are dropped), drawn as TestSegmentMatmul draws them."""
    import torch
    r = np.random.default_rng(e + n)
    vals = torch.from_numpy(r.standard_normal((e, d)).astype(np.float32))
    dst = torch.from_numpy(r.integers(0, n + 5, e).astype(np.int32))
    return vals.to(device), dst.to(device)


def sequential_plain(vals, dst, n: int):
    """segment_matmul's plain version on the CPU copy of the inputs,
    moved back: there ``index_add_`` adds in index order, the same float32
    sums on every run, where on the card its atomics add in an order that
    changes from run to run."""
    from repro_torch.kernels.segment_matmul.ref import segment_matmul_ref
    return segment_matmul_ref(vals.cpu(), dst.cpu(), n).to(vals.device)


def quantized_features(n: int, d: int, rng, device):
    """float32 [n, d]: N(0, 1) rounded to multiples of 2^-6 and clipped
    to [-4, 4].  Every partial sum of fewer than 2^16 such values is a
    multiple of 2^-6 below 2^18, exact in float32 in any order, and the
    values stay multiples of 2^-6 in bfloat16; so a kernel that sums them
    must equal its plain version bit for bit."""
    import torch
    x = np.clip(np.round(rng.standard_normal((n, d)) * 64) / 64, -4, 4)
    return torch.from_numpy(x.astype(np.float32)).to(device)


def segment_matmul_work(vals, dst, n: int):
    """(bytes, operations, longest segment) that the segment_matmul
    function needs on these inputs.  Bytes: each kept row of vals once,
    dst once and the output once.  Operations: one add per kept edge and
    column."""
    import torch
    keep = (dst >= 0) & (dst < n)
    kept = int(keep.sum())
    d, elem = vals.shape[1], vals.element_size()
    nbytes = kept * d * elem + dst.numel() * dst.element_size() + n * d * elem
    longest = int(torch.bincount(dst[keep].long()).max()) if kept else 0
    return nbytes, kept * d, longest


def check_summation_bound(tag, got, vals, dst, n: int, design: str):
    """Float32 segment sums ``got`` against the float64 sums of the same
    values, within the forward error bound of float32 summation at the
    depth of the segment_matmul ``design`` that summed them (the most
    adds a term passes through, ``summation_depth``): |got - sum| <=
    depth x 2^-24 x sum |x| per entry.  Returns the largest
    |got - sum|."""
    import torch
    from repro_torch.kernels.segment_matmul.kernel import summation_depth
    keep = (dst >= 0) & (dst < n)
    ids, x = dst[keep].long(), vals[keep].double()
    d = vals.shape[1]
    truth = torch.zeros((n, d), dtype=torch.float64,
                        device=vals.device).index_add_(0, ids, x)
    abs_sum = torch.zeros_like(truth).index_add_(0, ids, x.abs())
    longest = int(torch.bincount(ids).max()) if ids.numel() else 0
    depth = summation_depth(design, longest)
    diff = (got.double() - truth).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    if not bool((diff <= depth * 2.0 ** -24 * abs_sum).all()):
        raise AssertionError(f"{tag}: max |diff| {err} from the float64 "
                             f"sum, beyond {depth} x 2^-24 x sum |x|")
    return err


def decode_inputs(b, h, kvh, s, d, rng, device):
    """float32 q [b, h, d], k and v [b, s, kvh, d] N(0, 1) and int32
    lengths uniform over [1, s], with the last row's length 0 when
    b > 2 (it must give zeros)."""
    import torch
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               for shape in ((b, h, d), (b, s, kvh, d), (b, s, kvh, d)))
    lengths = rng.integers(1, s + 1, b).astype(np.int32)
    if b > 2:
        lengths[-1] = 0
    return tuple(x.to(device) for x in (q, k, v, torch.from_numpy(lengths)))


def flash_decode_work(q, k, lengths):
    """(bytes, operations) that the flash_decode function needs on these
    inputs.  Bytes: the K and V rows of each KV head within its row's
    length, each read once however many query heads share it, plus q,
    the output and the lengths.  Operations: 4 D per query head and
    valid position (a multiply and an add for q . k and for p . v)."""
    b, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    valid = int(lengths.clamp(0, s).sum())
    nbytes = (2 * valid * kvh * d * k.element_size()
              + 2 * q.numel() * q.element_size()
              + lengths.numel() * lengths.element_size())
    return nbytes, 4 * valid * h * d


def hold_flash_decode(q, k, v, lens, label: str):
    """flash_decode launched twice through its wrapper on bf16 ``q`` [B,
    H, D], ``k``, ``v`` [B, S, KVH, D] and ``lens``: bitwise equal, and
    within MAIN_RTOL / MAIN_ATOL of its plain version on the float32
    copies.  Returns (the output, the plain output, max |diff|, relative
    L2)."""
    import torch
    from repro_torch.kernels.flash_decode.ops import decode_attention
    from repro_torch.kernels.flash_decode.ref import decode_attention_ref
    got = decode_attention(q, k, v, lens)
    if not torch.equal(got, decode_attention(q, k, v, lens)):
        raise AssertionError(f"flash_decode {label}: two launches differ")
    want = decode_attention_ref(q.float(), k.float(), v.float(), lens)
    err = check_close(f"flash_decode {label} (bf16)", got, want, MAIN_RTOL,
                      MAIN_ATOL)
    return got, want, err, rel_l2(got, want)


def flash_decode_row(q, k, v, lens, label: str, route: str, calls: int,
                     plain_reps: int, extra=None):
    """flash_decode at one shape, every row of ``lens`` equal: held as
    :func:`hold_flash_decode` does, SDPA (``enable_gqa``, the cache cut
    to the length) held against the same plain output; then the kernel
    (``route``), the functions of ``extra`` ({name: function}) and SDPA
    timed in turn, FD_REPS rounds of ``calls`` calls, the plain version
    over ``plain_reps``, and the bound.  Returns (the row, the plain
    output)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode import kernel as FD
    from repro_torch.kernels.flash_decode.ops import decode_attention
    from repro_torch.kernels.flash_decode.ref import decode_attention_ref
    _, want, err, rel = hold_flash_decode(q, k, v, lens, label)
    b, h, d = q.shape
    kvh, length = k.shape[2], int(lens[0])
    if lens.tolist() != [length] * b:
        raise AssertionError(f"flash_decode {label}: unequal lengths "
                             f"{lens.tolist()}")
    ks = k[:, :length].transpose(1, 2).contiguous()    # [B, KVH, L, D]
    vs = v[:, :length].transpose(1, 2).contiguous()

    def sdpa():
        return F.scaled_dot_product_attention(q[:, :, None], ks, vs,
                                              enable_gqa=True)
    check_close(f"F.scaled_dot_product_attention {label}", sdpa()[:, :, 0],
                want, MAIN_RTOL, MAIN_ATOL)
    fns = {route: lambda: decode_attention(q, k, v, lens), **(extra or {}),
           "sdpa": sdpa}
    reps = {key: [] for key in fns}
    for _ in range(FD_REPS):
        for key, fn in fns.items():
            reps[key].append(cuda_ms(fn, calls))
    plain_ms = cuda_ms(lambda: decode_attention_ref(q, k, v, lens),
                       plain_reps, warmup=1)
    # every row at one length: the window the kernel reads is that length
    ops, nbytes = FD.cost(b, h, kvh, length, d, q.dtype)
    bound, by = bound_ms(nbytes, ops)
    row = {"shape": {"B": b, "H": h, "KVH": kvh, "S": int(k.shape[1]),
                     "D": d, "lengths": length, "group": h // kvh,
                     "dtype": "bfloat16"},
           "design": route, "max_abs_err": err, "rel_l2": rel,
           "ms": float(np.median(reps[route])), "ms_rounds": reps[route],
           "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
           "bytes": nbytes, "library_ms": float(np.median(reps["sdpa"])),
           "library_ms_rounds": reps["sdpa"]}
    row.update({f"{key}_ms": reps[key] for key in extra or {}})
    return row, want


def prefill_in_groups(params, cfg, prompts, s_max: int, group: int):
    """``prefill`` the requests ``group`` at a time and copy each group's
    cache into one batch cache.  Returns (logits [B, Vpad], cache)."""
    import torch
    from repro_torch.models import transformer as tf
    b = prompts.shape[0]
    cache = tf.init_cache(cfg, b, s_max, device=prompts.device)
    logits = []
    for lo in range(0, b, group):
        lg, part = tf.prefill(params, prompts[lo:lo + group], cfg, s_max)
        cache["lengths"][lo:lo + group] = part.pop("lengths")
        for name, c in part.items():                   # [L, b, ...]
            cache[name][:, lo:lo + group] = c
        logits.append(lg)
        del part
    return torch.cat(logits), cache


def greedy_decode(params, cfg, cache, token, steps: int):
    """``steps`` greedy ``decode_step``s, feeding ``token`` int32 [B]
    first.  Returns (the fed tokens [B, steps], the last step's logits,
    the cache, each step's device ms from CUDA events -- empty off the
    card)."""
    import torch
    from repro_torch.models import transformer as tf
    events = ([torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
              if token.is_cuda else [])
    fed = []
    if events:
        events[0].record()
    for i in range(steps):
        fed.append(token)
        logits, cache = tf.decode_step(params, cache, token, cfg)
        token = logits.argmax(dim=-1).to(torch.int32)
        if events:
            events[i + 1].record()
    if events:
        torch.cuda.synchronize()
    ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    return torch.stack(fed, dim=1), logits, cache, ms


def rel_l2(got, want) -> float:
    """||got - want|| / ||want|| in float32."""
    got, want = got.float(), want.float()
    return float((got - want).norm() / want.norm())


def decode_consistency(params, cfg, prompts, fed, last_logits, s_max: int):
    """Prefill the prompts followed by the fed tokens and compare its
    last logits with the last decode step's: (relative L2 error in
    float32, rows whose argmax agrees, the prefill's logits)."""
    import torch
    from repro_torch.models import transformer as tf
    full = torch.cat([prompts, fed.to(prompts.dtype)], dim=1)
    want, _ = tf.prefill(params, full, cfg, s_max)
    agree = int((last_logits.argmax(-1) == want.argmax(-1)).sum())
    return rel_l2(last_logits, want), agree, want


def bf16_score_attention(q, k, v, lengths):
    """A planted fault for L4: decode attention as the reference's
    ``gqa_decode`` computes it, with the scores and the probabilities
    rounded to the cache's dtype around a float32 softmax."""
    import torch
    b, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    qg = q.to(k.dtype).reshape(b, kvh, h // kvh, d)
    scores = torch.einsum("bkgd,bskd->bkgs", qg, k) / float(np.sqrt(d))
    valid = torch.arange(s, device=k.device) < lengths[:, None]
    scores = scores.float().masked_fill(~valid[:, None, None], -1e30)
    probs = torch.softmax(scores, dim=-1).to(k.dtype)
    ctx = torch.einsum("bkgs,bskd->bkgd", probs, v)
    return ctx.reshape(b, h, d).to(q.dtype)


def drop_span_attention(span: int):
    """A planted fault for L4: decode attention that leaves out the
    cache's first ``span`` positions, as a kernel that lost one span."""
    from repro_torch.kernels.flash_decode.ref import decode_attention_ref

    def attend(q, k, v, lengths):
        return decode_attention_ref(q, k[:, span:], v[:, span:],
                                    (lengths - span).clamp(min=0))
    return attend


def replay_decode(params, cfg, cache, fed, start: int, swap=None):
    """Feed ``fed`` [B, steps] through ``decode_step`` from ``cache``
    taken back to length ``start`` (its later positions are written
    again), with the functions of ``swap`` ({name: function}) in place
    of those names of ``repro_torch.models.attention`` (a planted
    fault).  Returns the last step's logits."""
    import torch
    from repro_torch.models import attention as A
    from repro_torch.models import transformer as tf
    cache = dict(cache, lengths=torch.full_like(cache["lengths"], start))
    saved = {name: getattr(A, name) for name in swap or {}}
    for name, fn in (swap or {}).items():
        setattr(A, name, fn)
    try:
        for i in range(fed.shape[1]):
            logits, cache = tf.decode_step(params, cache, fed[:, i], cfg)
    finally:
        for name, fn in saved.items():
            setattr(A, name, fn)
    return logits


class DropCount:
    """Routed assignments (``assigned``) and those the capacity dropped
    (``dropped``, a count kept on the activations' device, so counting
    waits for nothing), summed over the MoE dispatches made inside
    :meth:`watch`, which wraps ``repro_torch.models.moe.route`` for the
    while (as :func:`replay_decode` swaps functions in)."""

    def __init__(self) -> None:
        self.assigned, self.dropped = 0, 0

    @contextlib.contextmanager
    def watch(self):
        from repro_torch.models import moe as M
        route = M.route

        def counted(*args, **kwargs):
            r = route(*args, **kwargs)
            self.assigned += r.keep.numel()
            self.dropped = self.dropped + (~r.keep).sum()
            return r
        M.route = counted
        try:
            yield self
        finally:
            M.route = route

    def share(self) -> float:
        """Dropped over assigned (0.0 before any dispatch)."""
        return int(self.dropped) / self.assigned if self.assigned else 0.0


def lm_fault_span(cfg, sms: int) -> int:
    """The span of S that one flash_decode CTA covers when the LM path's
    LM_BATCH requests decode on a card of ``sms`` SMs (the kernel's own
    ``plan``): the planted faults leave out one."""
    from repro_torch.kernels.flash_decode.kernel import plan
    return plan(LM_BATCH, cfg.n_kv_heads, cfg.padded_heads,
                LM_PROMPT + LM_STEPS, cfg.d_head, cfg.act_dtype,
                sms).split_len


def lm_consistency(params, cfg, prompts, fed, last_logits, cache,
                   s_max: int, span: int) -> dict:
    """L4 and its controls for the requests of ``prompts``: the decode's
    last logits against a prefill of prompt + fed tokens (``decode``,
    ``argmax``), then the fed tokens again from these requests' ``cache``
    on the port's route (``replay``) and with two planted faults in
    place of decode attention (``bf16_scores``, ``drop_span``: the
    first ``span`` positions left out), each as a relative L2 error
    against the same prefill."""
    rel, agree, want = decode_consistency(params, cfg, prompts, fed,
                                          last_logits, s_max)
    t = prompts.shape[1]
    out = {"decode": rel, "argmax": agree,
           "replay": rel_l2(replay_decode(params, cfg, cache, fed, t), want)}
    for name, attend in (("bf16_scores", bf16_score_attention),
                         ("drop_span", drop_span_attention(span))):
        out[name] = rel_l2(replay_decode(
            params, cfg, cache, fed, t, {"decode_attention": attend}), want)
    return out


def check_l4(l4: dict) -> None:
    """L4's limit must pass the port's decode, and its replay from the
    prompts' cache, and fail both planted faults."""
    for key in ("decode", "replay"):
        if not l4[key] <= LM_REL_TOL:
            raise AssertionError(f"L4: {key} logits differ from a prefill "
                                 f"of the same tokens by {l4[key]:.4g} "
                                 f"(relative L2), beyond {LM_REL_TOL}")
    for key in ("bf16_scores", "drop_span"):
        if not l4[key] > LM_REL_TOL:
            raise AssertionError(f"L4: the limit {LM_REL_TOL} passes the "
                                 f"planted fault {key} ({l4[key]:.4g})")


def lm_config():
    """The LM path's configuration: qwen2-1.5b's CONFIG at tp 1 (the
    published 12 query heads; the reference's pads them to 16 for a
    16-way model axis), LM_LAYERS of its 28 layers."""
    import dataclasses
    from repro_torch.configs.qwen2_1_5b import CONFIG as QWEN_CONFIG
    return dataclasses.replace(QWEN_CONFIG, tp=1, n_layers=LM_LAYERS)


def lm_prompts(cfg, seed: int, device):
    """The LM path's LM_BATCH prompts of LM_PROMPT token ids from
    ``seed``."""
    return lm_prompt_ids(LM_BATCH, LM_PROMPT, cfg.vocab, seed + 2, device)


def lm_seed_readings(seeds, card: str) -> int:
    """``--lm-seeds``: L4 and its controls for the first LM_CHECK
    requests of each seed, with the parameters and prompts the main run
    draws from that seed (prefilled and decoded as LM_CHECK requests),
    then X1's and X2's sharded decode and its plain-mean fault, each with
    the main run's inputs from that seed (untraced, without the float32
    control).  Prints one line per reading and a JSON object of all;
    checks nothing."""
    import gc
    import torch
    from repro_torch.models import transformer as tf
    cfg = lm_config()
    s_max = LM_PROMPT + LM_STEPS
    span = lm_fault_span(cfg, torch.cuda.get_device_properties(
        0).multi_processor_count)
    readings = {}
    for seed in seeds:
        t0 = time.monotonic()
        params = tf.init_params(
            cfg, generator=torch.Generator("cuda").manual_seed(seed))
        prompts = lm_prompts(cfg, seed, "cuda")[:LM_CHECK]
        logits, cache = tf.prefill(params, prompts, cfg, s_max)
        fed, last, cache, _ = greedy_decode(
            params, cfg, cache, logits.argmax(dim=-1).to(torch.int32),
            LM_STEPS)
        readings[seed] = lm_consistency(params, cfg, prompts, fed, last,
                                        cache, s_max, span)
        log(f"L4 seed {seed}: {json.dumps(readings[seed])} "
            f"({time.monotonic() - t0:.3f} s on {card})")
        del params, logits, cache, fed, last
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps({"l4_seeds": readings, "limit": LM_REL_TOL,
                      "drop_span": span, "x_seeds": x_seed_readings(
                          seeds, card), "x_limit": X_REL_TOL,
                      "card": card}), flush=True)
    return 0


def x_seed_readings(seeds, card: str, device="cuda") -> dict:
    """X1's and X2's sharded decode and its plain-mean fault, then X5's
    and X6's tensor-parallel decode and their fault (one entry's heads
    dropped), then X7's FSDP steps and the same fault, from each seed,
    with the main run's inputs from that seed (untraced, without the
    float32 controls): {tag: {seed: readings}}."""
    import dataclasses
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((X_ENTRIES,), ("model",), mesh_devices(device))
    grid = make_mesh(X_GRID, ("data", "model"), mesh_devices(device))
    out = {}
    for seed in seeds:
        for tag in ("X1", "X2"):
            t0 = time.monotonic()
            _, cfg, params, prompts, steps = x_decode_case(tag, seed, device)
            ref = {}
            n = sharded_decode_check(params, cfg, prompts, steps, mesh,
                                     PathLaunches({}), trace=False, keep=ref)
            out.setdefault(tag, {})[seed] = {
                k: n[k] for k in ("sharded", "fault_plain_mean", "argmax")}
            tp = tp_check(params, dataclasses.replace(
                cfg, tp=mesh.shape["model"]), prompts, steps, mesh, ref,
                PathLaunches({}))
            out.setdefault(TP_TAG[tag], {})[seed] = {
                k: tp[k] for k in ("rel_l2", "fault_heads_dropped",
                                   "argmax")}
            log(f"{tag} and {TP_TAG[tag]} seed {seed}: "
                f"{json.dumps(out[tag][seed])}, "
                f"{json.dumps(out[TP_TAG[tag]][seed])} "
                f"({time.monotonic() - t0:.3f} s on {card})")
            del params, prompts, n, ref, tp
            release(device)
        t0 = time.monotonic()
        n = x7_case(seed, grid, PathLaunches({}), device)
        out.setdefault("X7", {})[seed] = {
            k: n[k] for k in ("rel", "fault", "loss", "grad_norm", "params")}
        log(f"X7 seed {seed}: {json.dumps(out['X7'][seed])} "
            f"({time.monotonic() - t0:.3f} s on {card})")
        x10_seed_readings(seed, grid, card, device, out)
    return out


def x10_seed_readings(seed: int, grid, card: str, device, out: dict) -> None:
    """X10's cells and their fault from ``seed`` into ``out[tag][seed]``."""
    for arch, shape, steps in X10_CELLS:
        t0 = time.monotonic()
        tag = x10_tag(arch, shape)
        n = x10_case(arch, shape, steps, seed, grid, PathLaunches({}),
                     device)
        out.setdefault(tag, {})[seed] = {
            k: n[k] for k in ("rel", "fault", "loss", "grad_norm", "params")}
        log(f"{tag} seed {seed}: {json.dumps(out[tag][seed])} "
            f"({time.monotonic() - t0:.3f} s on {card})")


def zero_rope_decode(decode):
    """A planted fault for the M-check: ``decode`` (``mla_decode``) with
    the rope term of every cached position left out of the scores (it
    reads a zero rope-key cache, into which only the new token's own
    rope key is written)."""
    import torch

    def faulty(p, x, cache_ckv, cache_kr, lengths, cfg):
        return decode(p, x, cache_ckv, torch.zeros_like(cache_kr), lengths,
                      cfg)
    return faulty


def float32_layers(params, n_layers: int) -> dict:
    """The first ``n_layers`` layers of ``params`` with the embedding,
    the final norm and the head, as new float32 tensors (the same
    weights, widened)."""
    def widen(tree, layered):
        if isinstance(tree, dict):
            return {k: widen(v, layered) for k, v in tree.items()}
        return (tree[:n_layers] if layered else tree).float()
    return {k: widen(v, k == "layers") for k, v in params.items()}


def no_drop_float32(cfg, n_layers: int):
    """``cfg`` cut to ``n_layers`` in float32 with the capacity factor
    e / k, at which no routed assignment drops: prefill and decode then
    route every token alike, so their logits may differ by rounding
    only."""
    import dataclasses
    import torch
    from repro_torch.models.moe import no_drop_capacity_factor
    return dataclasses.replace(
        cfg, n_layers=n_layers, param_dtype=torch.float32,
        act_dtype=torch.float32,
        moe_capacity_factor=no_drop_capacity_factor(cfg))


def mla_moe_check(params, cfg, prompts, steps: int) -> dict:
    """M-check (module doc) for an MLA + MoE configuration, with
    ``params`` and ``cfg`` in float32 at the no-drop capacity factor
    (:func:`no_drop_float32`): ``steps`` greedy decode steps after a
    prefill of ``prompts``, their last logits against a prefill of
    prompt + fed tokens (``decode``, ``argmax``); the same tokens
    replayed with the planted fault :func:`zero_rope_decode`
    (``no_rope``); and layer 0's absorbed ``mla_decode`` of token
    MCHECK_PREFIX over a cache of the tokens before it against
    ``mla_train``'s output there (``absorbed``; an earlier token where
    prompt and fed tokens are fewer), each a relative L2 error.  Raises
    unless ``decode`` and ``absorbed`` are within MCHECK_REL_TOL and
    ``no_rope`` beyond it."""
    import torch
    from repro_torch.models import attention as A
    from repro_torch.models.common import rms_norm
    from repro_torch.models import transformer as tf
    b, t = prompts.shape
    s_max = t + steps
    logits, cache = tf.prefill(params, prompts, cfg, s_max)
    fed, last, cache, _ = greedy_decode(
        params, cfg, cache, logits.argmax(dim=-1).to(torch.int32), steps)
    rel, agree, want = decode_consistency(params, cfg, prompts, fed, last,
                                          s_max)
    out = {"decode": rel, "argmax": agree, "no_rope": rel_l2(replay_decode(
        params, cfg, cache, fed, t,
        {"mla_decode": zero_rope_decode(A.mla_decode)}), want)}
    del cache
    tokens = torch.cat([prompts, fed.to(prompts.dtype)], dim=1)
    n = min(MCHECK_PREFIX, tokens.shape[1] - 1)
    attn = {k: v[0] for k, v in params["layers"]["attn"].items()}
    x = rms_norm(params["layers"]["ln1"][0],
                 params["embed"][tokens[:, :n + 1]].to(cfg.act_dtype))
    pos = torch.arange(n + 1, dtype=torch.int32,
                       device=x.device).expand(b, n + 1)
    full, (ckv, kr) = A.mla_train(attn, x, cfg, pos)
    c1, c2 = torch.zeros_like(ckv), torch.zeros_like(kr)
    c1[:, :n], c2[:, :n] = ckv[:, :n], kr[:, :n]
    got, _, _ = A.mla_decode(attn, x[:, n:], c1, c2,
                             torch.full((b,), n, dtype=torch.int32,
                                        device=x.device), cfg)
    out["absorbed"] = rel_l2(got[:, 0], full[:, n])
    for key in ("decode", "absorbed"):
        if not out[key] <= MCHECK_REL_TOL:
            raise AssertionError(f"M-check ({cfg.name}): {key} differs by "
                                 f"{out[key]:.4g} (relative L2), beyond "
                                 f"{MCHECK_REL_TOL}")
    if not out["no_rope"] > MCHECK_REL_TOL:
        raise AssertionError(f"M-check ({cfg.name}): the limit "
                             f"{MCHECK_REL_TOL} passes the planted fault "
                             f"no_rope ({out['no_rope']:.4g})")
    return out


def lm_prompt_ids(b: int, t: int, vocab: int, seed: int, device):
    """int32 [b, t] token ids uniform over the vocabulary, from ``seed``."""
    import torch
    ids = np.random.default_rng(seed).integers(0, vocab, (b, t))
    return torch.from_numpy(ids.astype(np.int32)).to(device)


def serve_lm(params, cfg, prompts, steps: int, group: int, counts,
             path: str) -> dict:
    """The serving path on the card inside ``counts.path(path)``: prefill
    ``prompts`` ``group`` at a time, then ``steps`` greedy decode steps,
    the MoE drops counted over the prefill.  Returns the numbers, the
    fed tokens, the last logits and the cache."""
    import torch
    b, t = prompts.shape
    cuda = prompts.is_cuda

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def peak(reset=False):
        if not cuda:
            return 0
        if reset:
            torch.cuda.reset_peak_memory_stats()
        return torch.cuda.max_memory_allocated()
    peak(reset=True)
    drops = DropCount()
    with counts.path(path):
        sync()
        t0 = time.monotonic()
        with drops.watch():
            logits, cache = prefill_in_groups(params, cfg, prompts,
                                              t + steps, group)
        sync()
        prefill_s = time.monotonic() - t0
        prefill_peak = peak()
        dropped, assigned = int(drops.dropped), drops.assigned
        peak(reset=True)
        t0 = time.monotonic()
        fed, last, cache, step_ms = greedy_decode(
            params, cfg, cache, logits.argmax(dim=-1).to(torch.int32), steps)
        sync()
        decode_s = time.monotonic() - t0
    if not (torch.isfinite(logits).all() and torch.isfinite(last).all()):
        raise AssertionError(f"{path}: non-finite logits")
    if tuple(last.shape) != (b, cfg.padded_vocab) or \
            cache["lengths"].tolist() != [t + steps] * b:
        raise AssertionError(f"{path}: logits {tuple(last.shape)}, lengths "
                             f"{cache['lengths'].tolist()}")
    numbers = {
        "requests": b, "prompt": t, "steps": steps, "prefill_group": group,
        "prefill_s": prefill_s, "prefill_tokens_per_s": b * t / prefill_s,
        "prefill_peak_bytes": prefill_peak,
        "decode_s": decode_s,
        "decode_step_ms_p50": float(np.percentile(step_ms or [0], 50)),
        "decode_step_ms_p90": float(np.percentile(step_ms or [0], 90)),
        "decode_tokens_per_s": b * steps / decode_s,
        "decode_peak_bytes": peak(),
        "cache_bytes": sum(c.numel() * c.element_size()
                           for name, c in cache.items() if name != "lengths")}
    if assigned:
        numbers.update(prefill_routed=assigned, prefill_dropped=dropped,
                       prefill_drop_share=dropped / assigned)
    return numbers, fed, last, cache


def trace_decode(params, cfg, cache, fed, numbers: dict) -> str:
    """The last LM_TRACE_STEPS of ``fed`` replayed under the profiler
    (outside every path: the replay counts nowhere), from :func:`serve_lm`'s
    ``cache`` and ``numbers``, to which it adds the card's busy ms a
    step, its idle share of the step p50 and the top LM_TOP_KERNELS
    kernels by device ms a step.  Returns a line that says so."""
    s_max = numbers["prompt"] + numbers["steps"]
    busy_ms, span_ms, by_kernel = device_trace(lambda: replay_decode(
        params, cfg, cache, fed[:, -LM_TRACE_STEPS:],
        s_max - LM_TRACE_STEPS), LM_TRACE_STEPS)
    numbers.update(
        decode_busy_ms_per_step=busy_ms and busy_ms / LM_TRACE_STEPS,
        decode_idle_share=busy_ms and 1 - busy_ms / LM_TRACE_STEPS / (
            numbers["decode_step_ms_p50"]),
        decode_step_ms_by_kernel=dict(sorted(
            by_kernel.items(), key=lambda kv: -kv[1])[:LM_TOP_KERNELS]))
    if not busy_ms:
        return "the profiler saw no device event; busy time not measured"
    return (f"{LM_TRACE_STEPS} steps replayed under torch.profiler, the "
            f"card busy {busy_ms:.3f} ms of {span_ms:.3f} ms from its first "
            f"to its last device event; busy "
            f"{numbers['decode_busy_ms_per_step']:.3f} ms a step, idle "
            f"share {numbers['decode_idle_share']:.4f} of the step p50; "
            f"device ms a step by kernel (the top {LM_TOP_KERNELS}): "
            f"{json.dumps(numbers['decode_step_ms_by_kernel'])}")


def release(device) -> None:
    """Free what the last phase left (and the card's cached blocks)."""
    import gc
    import torch
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def deepseek_phases(counts, card: str, seed: int, device="cuda") -> dict:
    """Phases M, M-check and M2 (module doc).  Returns their numbers;
    raises on any failed check."""
    import dataclasses
    import torch
    from repro_torch.configs.common import LM_SHAPES
    from repro_torch.configs.deepseek_v2_236b import CONFIG as BIG
    from repro_torch.configs.deepseek_v2_lite_16b import CONFIG as LITE
    from repro_torch.models import transformer as tf
    ctx = LM_SHAPES["decode_32k"].dims
    out = {}
    # -- M. deepseek-v2-lite-16b at full width and depth --------------------
    cfg = LITE
    reduced = [f"global_batch {ctx['global_batch']}->{DS_BATCH}"]
    log(f"M reduced: {json.dumps(reduced)} (context {ctx['seq_len']} kept)")
    t0 = time.monotonic()
    params = tf.init_params(
        cfg, generator=torch.Generator(device).manual_seed(seed + 7),
        device=device)
    pbytes = tf.param_bytes(params)
    log(f"M params: {cfg.name}: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.padded_heads} MLA heads (kv_lora "
        f"{cfg.kv_lora}, rope {cfg.qk_rope_dim}), {cfg.moe_experts} routed "
        f"top-{cfg.moe_top_k} + {cfg.moe_shared} shared experts of "
        f"{cfg.moe_d_ff}, vocab {cfg.padded_vocab}; {cfg.param_count()} "
        f"parameters, {pbytes} bytes in {cfg.param_dtype} "
        f"({time.monotonic() - t0:.2f} s on {card})")
    prompts = lm_prompt_ids(DS_BATCH, ctx["seq_len"], cfg.vocab, seed + 11,
                            device)
    m, fed, last, cache = serve_lm(params, cfg, prompts, DS_STEPS, DS_GROUP,
                                   counts, "deepseek-v2-lite-16b")
    trace = trace_decode(params, cfg, cache, fed, m)
    # a step reads every weight but the embedding once, and the cache
    step_bytes = pbytes - tf.param_bytes(params["embed"]) + m["cache_bytes"]
    m.update(param_bytes=pbytes, reduced=reduced,
             decode_bound_ms=bound_ms(step_bytes, 0)[0])
    log(f"M prefill: {DS_BATCH} x {ctx['seq_len']} tokens in groups of "
        f"{DS_GROUP}: {m['prefill_s']:.3f} s "
        f"({m['prefill_tokens_per_s']:.1f} tokens/s), peak "
        f"{m['prefill_peak_bytes']} B; capacity dropped "
        f"{m['prefill_dropped']} of {m['prefill_routed']} routed "
        f"assignments (share {m['prefill_drop_share']:.5f}) on {card}")
    log(f"M decode: {DS_STEPS} steps x {DS_BATCH} requests: "
        f"{m['decode_s']:.3f} s, step p50 {m['decode_step_ms_p50']:.3f} ms "
        f"p90 {m['decode_step_ms_p90']:.3f} ms, "
        f"{m['decode_tokens_per_s']:.1f} tokens/s, peak "
        f"{m['decode_peak_bytes']} B, MLA cache {m['cache_bytes']} B; bound "
        f"{m['decode_bound_ms']:.3f} ms a step ({step_bytes} B) on {card}")
    log(f"M trace: {trace} on {card}")
    out["deepseek-v2-lite-16b"] = m
    # -- M-check: the same weights, two layers, float32, no drops -----------
    del cache, fed, last
    small = float32_layers(params, MCHECK_LAYERS)
    del params
    release(device)
    t0 = time.monotonic()
    check_cfg = no_drop_float32(cfg, MCHECK_LAYERS)
    check = mla_moe_check(small, check_cfg,
                          prompts[:MCHECK_BATCH, :MCHECK_PROMPT],
                          MCHECK_STEPS)
    check.update(layers=MCHECK_LAYERS, prompt=MCHECK_PROMPT,
                 steps=MCHECK_STEPS, limit=MCHECK_REL_TOL,
                 capacity_factor=check_cfg.moe_capacity_factor)
    m["check"] = check
    log(f"M-check: {cfg.name} at full width, {MCHECK_LAYERS} layers, "
        f"float32, capacity factor e / k = "
        f"{check_cfg.moe_capacity_factor:.4f}: decode of "
        f"{MCHECK_STEPS} steps after {MCHECK_BATCH} x {MCHECK_PROMPT} "
        f"tokens vs a prefill of the same tokens, relative L2 "
        f"{check['decode']:.4g} (limit {MCHECK_REL_TOL}), argmax "
        f"{check['argmax']}/{MCHECK_BATCH}; absorbed mla_decode vs "
        f"mla_train at position {MCHECK_PREFIX}: {check['absorbed']:.4g}; "
        f"planted fault (rope term left out of the decode scores) "
        f"{check['no_rope']:.4g} ({time.monotonic() - t0:.3f} s on {card})")
    del small
    release(device)
    # -- M2. deepseek-v2-236b at full width, depth cut ---------------------
    cfg = dataclasses.replace(BIG, n_layers=MCHECK_LAYERS)
    reduced = [f"n_layers {BIG.n_layers}->{MCHECK_LAYERS}",
               f"decode_32k -> {M2_BATCH} x {M2_PROMPT} tokens, "
               f"{M2_STEPS} steps"]
    t0 = time.monotonic()
    params = tf.init_params(
        cfg, generator=torch.Generator(device).manual_seed(seed + 17),
        device=device)
    log(f"M2 params: {cfg.name}: {cfg.n_layers} of {BIG.n_layers} layers, "
        f"d_model {cfg.d_model}, {cfg.padded_heads} MLA heads (q_lora "
        f"{cfg.q_lora}), {cfg.moe_experts} routed top-{cfg.moe_top_k} + "
        f"{cfg.moe_shared} shared experts of {cfg.moe_d_ff}; "
        f"{tf.param_bytes(params)} bytes ({time.monotonic() - t0:.2f} s on "
        f"{card}); reduced {json.dumps(reduced)}")
    prompts = lm_prompt_ids(M2_BATCH, M2_PROMPT, cfg.vocab, seed + 19, device)
    m2, fed, last, cache = serve_lm(params, cfg, prompts, M2_STEPS, M2_BATCH,
                                    counts, "deepseek-v2-236b")
    m2.update(reduced=reduced, param_bytes=tf.param_bytes(params))
    del cache, fed, last
    m2["moe_repeat"] = moe_repeat(params, cfg, prompts, M2_PROMPT + M2_STEPS,
                                  M2_BATCH)
    rep = m2["moe_repeat"]

    def said(r):
        return ("repeats bit for bit" if r["repeats"] else
                f"does not repeat ({r['differing']} values differ)")
    log(f"M2 repeat: the prefill twice in one process, layer 0's MoE output "
        f"({rep['port']['elements']} bf16 values) {said(rep['port'])}; with "
        f"the scatter_add_ un-dispatch (the control) it "
        f"{said(rep['scatter_add'])} on {card}")
    if not rep["port"]["repeats"]:
        raise AssertionError(f"M2: the MoE prefill does not repeat bit for "
                             f"bit: {rep['port']}")
    params = float32_layers(params, MCHECK_LAYERS)
    release(device)
    t0 = time.monotonic()
    check = mla_moe_check(params, no_drop_float32(cfg, MCHECK_LAYERS),
                          prompts, M2_STEPS)
    check.update(limit=MCHECK_REL_TOL)
    m2["check"] = check
    log(f"M2: prefill {M2_BATCH} x {M2_PROMPT} tokens {m2['prefill_s']:.3f} "
        f"s (drop share {m2['prefill_drop_share']:.5f}), {M2_STEPS} decode "
        f"steps p50 {m2['decode_step_ms_p50']:.3f} ms; no-drop float32 "
        f"check: decode vs prefill {check['decode']:.4g}, absorbed vs "
        f"mla_train {check['absorbed']:.4g} (limit {MCHECK_REL_TOL}), "
        f"planted fault {check['no_rope']:.4g} "
        f"({time.monotonic() - t0:.3f} s) on {card}")
    out["deepseek-v2-236b"] = m2
    del params
    release(device)
    return out


def scatter_undispatch(gathered, st, k: int):
    """The un-dispatch before ``moe.undispatch``: a ``scatter_add_`` of
    each sorted assignment's row onto its token (atomics on the card, in
    no fixed order); :func:`moe_repeat`'s control."""
    g, n, d = gathered.shape
    return gathered.new_zeros((g, n // k, d)).scatter_add_(
        1, st[..., None].expand(-1, -1, d), gathered)


def moe_repeat(params, cfg, prompts, s_max: int, group: int) -> dict:
    """Phase M2's prefill run twice in one process; layer 0's MoE output
    (the first ``moe_dispatch`` return of each run) compared bit for
    bit, with the port's un-dispatch (``moe.undispatch``) and, as a
    control, with :func:`scatter_undispatch` in its place.  Returns
    {"port": {"repeats", "differing", "elements"}, "scatter_add": ...}."""
    import torch
    from repro_torch.models import moe as M
    dispatch, undispatch = M.moe_dispatch, M.undispatch

    def twice():
        firsts = []
        for _ in range(2):
            seen = []

            def recorded(*args, **kwargs):
                out = dispatch(*args, **kwargs)
                if not seen:
                    seen.append(out[0].clone())
                return out
            M.moe_dispatch = recorded
            try:
                prefill_in_groups(params, cfg, prompts, s_max, group)
            finally:
                M.moe_dispatch = dispatch
            firsts.append(seen[0])
        a, b = firsts
        return {"repeats": bool(torch.equal(a, b)),
                "differing": int((a != b).sum()), "elements": a.numel()}
    out = {"port": twice()}
    M.undispatch = scatter_undispatch
    try:
        out["scatter_add"] = twice()
    finally:
        M.undispatch = undispatch
    return out


def dense_family_phase(counts, card: str, seed: int, sms: int,
                       device="cuda") -> dict:
    """Phase M3 (module doc): qwen2-7b and phi3-medium-14b at full width
    and depth, tp 1, served on the card (flash_decode launched exactly
    n_layers x steps times on each path) and flash_decode held against
    its plain version on layer 0's served cache, at the served lengths
    and at ragged ones within the decode steps'; then held and timed
    beside SDPA at each configuration's decode_32k shape on a random
    cache of FD_FAMILY_BATCH requests; and phi3's tp 16 group of 5.
    Returns {config name: numbers}."""
    import dataclasses
    import torch
    from repro_torch.configs.common import LM_SHAPES
    from repro_torch.configs.phi3_medium_14b import CONFIG as PHI3
    from repro_torch.configs.qwen2_7b import CONFIG as QWEN7
    from repro_torch.kernels.flash_decode import kernel as FD
    from repro_torch.models import transformer as tf
    ctx = LM_SHAPES["decode_32k"].dims["seq_len"]
    out = {}
    for path, base in (("qwen2-7b", QWEN7), ("phi3-medium-14b", PHI3)):
        cfg = dataclasses.replace(base, tp=1)
        b, h, kvh, d = M3_BATCH, cfg.padded_heads, cfg.n_kv_heads, cfg.d_head
        t0 = time.monotonic()
        params = tf.init_params(
            cfg, generator=torch.Generator(device).manual_seed(seed + 13),
            device=device)
        init_s = time.monotonic() - t0
        prompts = lm_prompt_ids(b, M3_PROMPT, cfg.vocab, seed + 23, device)
        n, _, _, cache = serve_lm(params, cfg, prompts, M3_STEPS, b, counts,
                                  path)
        launched = counts.by_path[path]["flash_decode"]
        want = cfg.n_layers * M3_STEPS      # (the CPU route launches none)
        if launched != (want if torch.device(device).type == "cuda" else 0):
            raise AssertionError(f"{base.name}: flash_decode launched "
                                 f"{launched} times, want {want}")
        n.update(param_bytes=tf.param_bytes(params), init_s=init_s,
                 flash_decode_launches=launched)
        log(f"M3 {base.name} at tp 1 ({cfg.n_layers} layers, {h} query / "
            f"{kvh} KV heads, a group of {h // kvh}; {n['param_bytes']} "
            f"parameter bytes): prefill {b} x {M3_PROMPT} tokens "
            f"{n['prefill_s']:.3f} s, {M3_STEPS} decode steps p50 "
            f"{n['decode_step_ms_p50']:.3f} ms, flash_decode launched "
            f"{launched} times on {card}")
        del params, prompts
        # K4 on layer 0's served cache, at the served lengths and at
        # lengths as ragged as the decode steps' (prompt + 1 .. + steps)
        gen = torch.Generator(device).manual_seed(seed + 29)
        k0, v0 = cache["k"][0], cache["v"][0]
        lens = cache["lengths"].clone()
        q = torch.randn((b, h, d), generator=gen, device=device).to(
            torch.bfloat16)
        served = {}
        for key, at in (("served", lens), ("ragged", lens - torch.arange(
                b, dtype=lens.dtype, device=lens.device) * (M3_STEPS // b))):
            served[key] = hold_flash_decode(
                q, k0, v0, at, f"on {base.name}'s served cache at lengths "
                f"{at.tolist()}")[2]
        served.update(shape=[b, h, kvh, int(k0.shape[1]), d],
                      route=FD.plan(b, kvh, h, int(k0.shape[1]), d,
                                    torch.bfloat16, sms).route)
        n["flash_decode_served"] = served
        log(f"M3 flash_decode on {base.name}'s served cache (layer 0, "
            f"{json.dumps(served)}): == plain within rtol {MAIN_RTOL} atol "
            f"{MAIN_ATOL}, two launches bitwise equal, on {card}")
        del cache, k0, v0, q, lens
        release(device)
        # K4 at decode_32k's shape on a random cache
        b = FD_FAMILY_BATCH
        q, k, v = (torch.randn(shape, generator=gen, device=device).to(
            torch.bfloat16) for shape in ((b, h, d), (b, ctx, kvh, d),
                                          (b, ctx, kvh, d)))
        lens = torch.full((b,), ctx, dtype=torch.int32, device=device)
        route = FD.plan(b, kvh, h, ctx, d, torch.bfloat16, sms).route
        row, _ = flash_decode_row(q, k, v, lens,
                                  f"({route}) at {base.name}'s decode_32k "
                                  f"shape", route, 50, 3)
        row.update(launches=launched,
                   served_max_abs_err=max(served["served"],
                                          served["ragged"]))
        if base is PHI3:
            # the reference's tp = 16: 48 padded q heads over 10 KV heads,
            # q padded to 10 x 5 = 50 as gqa_decode pads it
            pad = -(-base.padded_heads // kvh) * kvh
            r = FD_GROUP5_ROWS
            q5 = torch.randn((r, pad, d), generator=gen,
                             device=device).to(torch.bfloat16)
            row["group5_max_abs_err"] = hold_flash_decode(
                q5, k[:r], v[:r], lens[:r],
                f"at phi3's tp 16 group of {pad // kvh}")[2]
            row["group5_shape"] = [r, pad, kvh, ctx, d]
        n["flash_decode"] = row
        log(f"M3 flash_decode at {base.name}'s decode_32k shape "
            f"{json.dumps(row['shape'])}: {route} "
            f"{json.dumps(row['ms_rounds'])} ms, SDPA "
            f"{json.dumps(row['library_ms_rounds'])} ms in {FD_REPS} "
            f"rounds; median {row['ms']:.5f} ms "
            f"({row['bytes'] / row['ms'] / 1e6:.1f} GB/s), plain "
            f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.5f} ms "
            f"({row['bytes']} B, {row['bound_by']}); == plain within rtol "
            f"{MAIN_RTOL} atol {MAIN_ATOL} (max |diff| "
            f"{row['max_abs_err']:.3g}, relative L2 {row['rel_l2']:.3g})"
            + (f"; tp 16 group of 5 max |diff| "
               f"{row['group5_max_abs_err']:.3g}" if base is PHI3 else "")
            + f" on {card}")
        out[path] = n
        del q, k, v, lens
        release(device)
    return out


def mesh_devices(device) -> list:
    """Phase X's X_ENTRIES mesh entries: that many cards where the host
    has them (checked, not timed: the timed run is on one card), else
    X_ENTRIES entries of ``device``."""
    import torch
    if torch.device(device).type == "cuda" and \
            torch.cuda.device_count() >= X_ENTRIES:
        return [f"cuda:{i}" for i in range(X_ENTRIES)]
    return [device] * X_ENTRIES


def plain_mean_merge(parts, out_dtype):
    """X1's and X2's planted fault: the cache shards' partial outputs
    averaged, without the log-sum-exp rescale."""
    return (sum(o.float() for o, _ in parts) / len(parts)).to(out_dtype)


@contextlib.contextmanager
def merged_by_plain_mean():
    from repro_torch.models import attention as A
    merge = A.merge_by_lse
    A.merge_by_lse = plain_mean_merge
    try:
        yield
    finally:
        A.merge_by_lse = merge


def decode_steps(params, cfg, cache, token, steps: int, fed=None,
                 step=None):
    """``steps`` decode steps from ``token`` int32 [B]: greedy, or the
    tokens of ``fed`` [B, steps] when given (the same inputs on two
    caches), each through ``step(params, cache, token)`` (default:
    ``transformer.decode_step``).  Returns (fed, every step's logits
    float32 [steps, B, V], the cache, each step's device ms from CUDA
    events -- empty off the card)."""
    import torch
    from repro_torch.models import transformer as tf
    cuda = token.is_cuda
    events = ([torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
              if cuda else [])
    if events:
        events[0].record()
    toks, logits = [], []
    for i in range(steps):
        if fed is not None:
            token = fed[:, i]
        toks.append(token)
        lg, cache = (step(params, cache, token) if step else
                     tf.decode_step(params, cache, token, cfg))
        logits.append(lg.float())
        token = lg.argmax(dim=-1).to(torch.int32)
        if events:
            events[i + 1].record()
    if events:
        torch.cuda.synchronize()
    ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    return torch.stack(toks, dim=1), torch.stack(logits), cache, ms


def sharded_decode_check(params, cfg, prompts, steps: int, mesh, counts,
                         fault: bool = True, trace: bool = True,
                         keep: dict | None = None) -> dict:
    """X1 / X2 for one configuration: the unsharded prefill and greedy
    decode (outside every path), then the same prompts prefilled into a
    cache laid out over ``mesh`` and decoded on the same tokens inside
    ``counts.path("mesh")``; every step's logits against the unsharded
    ones as a relative L2 error (``sharded``), and with ``fault`` the
    planted fault (:func:`merged_by_plain_mean`) replayed the same way
    outside the path.  Also the prefill's logits (the same forward:
    equal bit for bit) and the step p50s; with ``trace`` (and ``fault``,
    on the card) the last sharded steps traced.  ``keep`` receives the
    unsharded run (``first`` logits, ``token``, ``fed``, ``want``), the
    reference X5 and X6 are held to."""
    import torch
    from repro_torch.models import transformer as tf
    b, t = prompts.shape
    s_max = t + steps
    first, cache = tf.prefill(params, prompts, cfg, s_max)
    token = first.argmax(dim=-1).to(torch.int32)
    fed, want, cache, ms0 = decode_steps(params, cfg, cache, token, steps)
    del cache
    if keep is not None:
        keep.update(first=first, token=token, fed=fed, want=want)
    with counts.path("mesh"):
        got_first, placed = tf.prefill(params, prompts, cfg, s_max,
                                       mesh=mesh)
        _, got, placed, ms1 = decode_steps(params, cfg, placed, token, steps,
                                           fed)
    n1 = tf.cache_names(cfg)[0]
    out = {"requests": b, "prompt": t, "steps": steps,
           "shards": len(placed[n1].blocks),
           "shard_positions": [bd[2][1] - bd[2][0]
                               for _, bd, _ in placed[n1].blocks],
           "prefill_equal": bool(torch.equal(got_first, first)),
           "sharded": rel_l2(got, want),
           "argmax": int((got[-1].argmax(-1) == want[-1].argmax(-1)).sum()),
           "step_ms_p50": float(np.percentile(ms1 or [0], 50)),
           "unsharded_step_ms_p50": float(np.percentile(ms0 or [0], 50))}
    if not (torch.isfinite(got).all() and out["prefill_equal"]):
        raise AssertionError(f"X ({cfg.name}): sharded logits not finite, "
                             f"or its prefill differs from the unsharded one")
    if fault and trace and prompts.is_cuda:
        # the last steps replayed under the profiler (outside the path)
        busy, _, by = device_trace(lambda: replay_decode(
            params, cfg, placed, fed[:, -X_TRACE_STEPS:],
            s_max - X_TRACE_STEPS), X_TRACE_STEPS)
        out.update(busy_ms_per_step=busy and busy / X_TRACE_STEPS,
                   idle_share=busy and 1 - busy / X_TRACE_STEPS
                   / out["step_ms_p50"],
                   step_ms_by_kernel=dict(sorted(
                       by.items(), key=lambda kv: -kv[1])[:LM_TOP_KERNELS]))
    del placed, got
    if fault:
        _, placed = tf.prefill(params, prompts, cfg, s_max, mesh=mesh)
        with merged_by_plain_mean():
            _, bad, placed, _ = decode_steps(params, cfg, placed, token,
                                             steps, fed)
        out["fault_plain_mean"] = rel_l2(bad, want)
        del placed, bad
    out["cache_placed"] = placed_cache_line(tf, cfg, mesh, b, s_max)
    return out


def placed_cache_line(tf, cfg, mesh, b: int, s_max: int) -> dict:
    """The cache's layout over ``mesh`` (no tensor made): its spec and
    each shard's positions."""
    from repro_torch import sharding as SH
    from repro_torch.launch.mesh import block_bounds
    n1 = tf.cache_names(cfg)[0]
    shape = tuple(tf.abstract_cache(cfg, b, s_max)[n1].shape)
    sh = SH.resolve(tf.cache_specs(cfg)[n1], SH.FSDP_TP, mesh)
    parts = sh.parts(len(shape))
    return {"spec": [list(e) if isinstance(e, tuple) else e
                     for e in sh.spec],
            "seq_bounds": [list(block_bounds(shape, parts, (0, 0, i, 0, 0)
                                             [:len(shape)])[2])
                           for i in range(parts[2])]}


def tp_cells(cfg, b: int, s_max: int):
    """X5's and X6's prefill and decode cells (``launch.steps.lm_bundle``)
    of ``cfg``'s architecture at ``cfg`` (its ``tp`` the mesh's model
    size), their prefill_32k and decode_32k shapes cut to ``b`` requests
    and a context of ``s_max``."""
    import dataclasses
    from repro_torch.configs import get
    from repro_torch.configs.common import ShapeSpec
    from repro_torch.launch import steps as S
    spec = dataclasses.replace(get(cfg.name.removesuffix("-smoke")),
                               config=cfg)
    dims = dict(global_batch=b, seq_len=s_max)
    return (S.lm_bundle(spec, ShapeSpec("prefill_32k", "prefill", dims),
                        False),
            S.lm_bundle(spec, ShapeSpec("decode_32k", "decode", dims), False))


def entry_weight_bytes(placed, cfg, mesh) -> dict:
    """The weight bytes each mesh entry holds of a placed tree, against
    the shard shapes ``resolve_tree(param_specs, TP_ONLY)`` gives the
    abstract parameters; raises where they differ."""
    import math
    from repro_torch import sharding as SH
    from repro_torch.launch.mesh import local_tree
    from repro_torch.models import transformer as tf
    shardings = SH.resolve_tree(tf.param_specs(cfg), SH.TP_ONLY, mesh)
    abstract = tf.init_params(cfg, device="meta")

    def want(tree, sh):
        if isinstance(tree, dict):
            return sum(want(tree[k], sh[k]) for k in tree)
        parts = sh.parts(tree.dim())
        return math.prod(n // p for n, p in zip(tree.shape, parts)) * \
            tree.element_size()
    got = [tree_bytes(local_tree(placed, e)) for e in range(mesh.size)]
    expected = want(abstract, shardings)
    if got != [expected] * mesh.size:
        raise AssertionError(f"X TP ({cfg.name}): entries hold {got} weight "
                             f"bytes, the shard shapes {expected} each")
    return {"by_entry": got, "whole": tree_bytes(abstract)}


def tp_moe_checks(prefill, placed, toks, router0) -> dict:
    """X6: the tensor-parallel prefill run twice; layer 0's MoE output
    (the first ``moe_dispatch_tp`` return of each run) compared bit for
    bit (as :func:`moe_repeat`), and its routing (the first ``route``
    call) against ``route`` with layer 0's whole router on the same
    tokens, every field bit for bit."""
    import torch
    from repro_torch.models import moe as M
    dispatch, route = M.moe_dispatch_tp, M.route
    firsts, routes = [], []
    for _ in range(2):
        outs, seen = [], []

        def recorded(*args):
            out = dispatch(*args)
            if not outs:
                outs.append(out.clone())
            return out

        def routed(router, tokens, cfg):
            r = route(router, tokens, cfg)
            if not seen:
                seen.append((tokens.clone(), r, cfg))
            return r
        M.moe_dispatch_tp, M.route = recorded, routed
        try:
            prefill(placed, toks)
        finally:
            M.moe_dispatch_tp, M.route = dispatch, route
        firsts.append(outs[0])
        routes.append(seen[0])
    a, b = firsts
    tokens, r, cfg = routes[0]
    want = route(router0.to(tokens.device), tokens, cfg)
    return {"repeats": bool(torch.equal(a, b)),
            "differing": int((a != b).sum()), "elements": a.numel(),
            "route_equal": all(x == y if f == "cap" else
                               bool(torch.equal(x, y))
                               for f, x, y in zip(r._fields, r, want))}


def place_consuming(tree: dict, shardings: dict, specs: dict) -> dict:
    """``launch.mesh.place_tree`` leaf by leaf, each whole leaf dropped
    from ``tree`` once placed: the card holds one leaf twice at a time,
    not the tree (deepseek-v2-236b's two float32 layers take 35 GB)."""
    from repro_torch.launch.mesh import place_tree
    out = {}
    for k in list(tree):
        if isinstance(tree[k], dict):
            out[k] = place_consuming(tree[k], shardings[k], specs[k])
        else:
            out[k] = place_tree(tree.pop(k), shardings[k], specs[k])
    return out


def tp_check(params, cfg, prompts, steps: int, mesh, ref: dict, counts,
             fault: bool = True, moe_checks: bool = False,
             consume: bool = False) -> dict:
    """X5 / X6 for one configuration: ``params`` (the unsharded run's;
    ``cfg`` at ``tp`` = the mesh's model size) placed by a prefill cell's
    ``arg_specs`` through ``TP_ONLY`` (:func:`tp_cells`), then the
    prefill and the decode steps on ``ref``'s tokens through the cells'
    ``get_fn(mesh, TP_ONLY)`` inside ``counts.path("tp")``: every step's
    logits against ``ref``'s (:func:`sharded_decode_check`'s unsharded
    run) as a relative L2 error (``tp``), the prefill's seconds, the
    step p50, each entry's weight bytes; with ``fault`` the planted
    fault (:func:`one_entry_heads_dropped`) replayed outside the path; with
    ``moe_checks`` :func:`tp_moe_checks`; with ``consume`` the weights
    are placed by :func:`place_consuming`, which empties ``params``."""
    import torch
    from repro_torch import sharding as SH
    b, t = prompts.shape
    pre, dec = tp_cells(cfg, b, t + steps)
    router0 = params["layers"]["ffn"]["router"][0] if moe_checks else None
    t0 = time.monotonic()
    if consume:
        spec = pre.arg_specs[0]
        placed = place_consuming(params, SH.resolve_tree(
            spec, SH.TP_ONLY, mesh), spec)
        toks = pre.place_args((placed, prompts), mesh, SH.TP_ONLY)[1]
    else:
        placed, toks = pre.place_args((params, prompts), mesh, SH.TP_ONLY)
    cuda = prompts.is_cuda
    if cuda:
        torch.cuda.synchronize()
    place_s = time.monotonic() - t0
    prefill = pre.get_fn(mesh, SH.TP_ONLY)
    decode = dec.get_fn(mesh, SH.TP_ONLY)
    t0 = time.monotonic()
    with counts.path("tp"):
        first, cache = prefill(placed, toks)
        if cuda:
            torch.cuda.synchronize()
        prefill_s = time.monotonic() - t0
        _, got, cache, ms = decode_steps(placed, cfg, cache, ref["token"],
                                         steps, ref["fed"], step=decode)
    out = {"tp": cfg.tp, "place_s": place_s, "prefill_s": prefill_s,
           "prefill_rel_l2": rel_l2(first, ref["first"]),
           "rel_l2": rel_l2(got, ref["want"]),
           "argmax": int((got[-1].argmax(-1) ==
                          ref["want"][-1].argmax(-1)).sum()),
           "step_ms_p50": float(np.percentile(ms or [0], 50)),
           "weight_bytes": entry_weight_bytes(placed, cfg, mesh)}
    if not torch.isfinite(got).all():
        raise AssertionError(f"X TP ({cfg.name}): logits not finite")
    del cache, got
    if fault:
        with one_entry_heads_dropped():
            _, cache = prefill(placed, toks)
            _, bad, cache, _ = decode_steps(placed, cfg, cache, ref["token"],
                                            steps, ref["fed"], step=decode)
        out["fault_heads_dropped"] = rel_l2(bad, ref["want"])
        del cache, bad
    if moe_checks:
        out.update(tp_moe_checks(prefill, placed, toks, router0))
        if not (out["repeats"] and out["route_equal"]):
            raise AssertionError(f"X6 ({cfg.name}): the tensor-parallel "
                                 f"prefill does not repeat bit for bit, or "
                                 f"its routing differs from the whole "
                                 f"router's: {json.dumps(out)}")
    return out


def check_x_tp(tag: str, n: dict, f32: dict) -> None:
    """X5 / X6: the tensor-parallel logits within X_REL_TOL[tag] of the
    unsharded decode's, the float32 control within X_F32_TOL, the
    planted fault beyond X_REL_TOL[tag]."""
    limit = X_REL_TOL[tag]
    if not n["rel_l2"] <= limit:
        raise AssertionError(f"{tag}: tensor-parallel logits differ by "
                             f"{n['rel_l2']:.4g} (relative L2), beyond "
                             f"{limit}")
    if not f32["rel_l2"] <= X_F32_TOL:
        raise AssertionError(f"{tag}: the float32 control differs by "
                             f"{f32['rel_l2']:.4g}, beyond {X_F32_TOL}")
    if not n["fault_heads_dropped"] > limit:
        raise AssertionError(f"{tag}: the limit {limit} passes the planted "
                             f"fault (one entry's heads dropped: "
                             f"{n['fault_heads_dropped']:.4g})")


def check_x_decode(tag: str, n: dict) -> None:
    """X1 / X2: the sharded decode within its X_REL_TOL of the unsharded
    one, the float32 control within X_F32_TOL, the planted fault beyond
    that X_REL_TOL."""
    limit = X_REL_TOL[tag]
    if not n["sharded"] <= limit:
        raise AssertionError(f"{tag}: sharded decode logits differ by "
                             f"{n['sharded']:.4g} (relative L2), beyond "
                             f"{limit}")
    if not n["f32"]["sharded"] <= X_F32_TOL:
        raise AssertionError(f"{tag}: the float32 control differs by "
                             f"{n['f32']['sharded']:.4g}, beyond {X_F32_TOL}")
    if not n["fault_plain_mean"] > limit:
        raise AssertionError(f"{tag}: the limit {limit} passes the "
                             f"planted fault (a plain mean of the shards: "
                             f"{n['fault_plain_mean']:.4g})")


def hold_lse(placed_k, placed_v, lengths, h: int, seed: int) -> dict:
    """flash_decode's LSE output on layer 0 of the first shard of a
    served cache, on both routes, against its plain version on float32
    copies: outputs within MAIN_RTOL / MAIN_ATOL, LSEs within
    X_LSE_ATOL, the same outputs as without the LSE (bit for bit)."""
    import torch
    from repro_torch.kernels.flash_decode import kernel as FD
    from repro_torch.kernels.flash_decode.ref import decode_attention_ref
    key, bounds, k0 = placed_k.blocks[0]
    k0, v0 = k0[0], placed_v.shards[key][0]
    lo, hi = bounds[2]
    local = (lengths.to(k0.device) - lo).clamp(0, hi - lo).to(torch.int32)
    local[-1] = 0                              # a row past the shard
    b, _, kvh, d = k0.shape
    q = torch.randn((b, h, d), generator=torch.Generator(
        k0.device).manual_seed(seed), device=k0.device).to(k0.dtype)
    want, want_lse = decode_attention_ref(q.float(), k0.float(), v0.float(),
                                          local, return_lse=True)
    out = {"shape": [b, h, kvh, hi - lo, d]}
    for route, fn in (("planned", FD.flash_decode_cuda),
                      ("simt", FD._simt_cuda)):
        got, lse = fn(q, k0, v0, local, return_lse=True)
        plain = fn(q, k0, v0, local)
        torch.cuda.synchronize()
        if not torch.equal(got, plain):
            raise AssertionError(f"X flash_decode ({route}): the output "
                                 f"with the LSE differs from the one without")
        if not torch.equal(torch.isinf(lse), torch.isinf(want_lse)):
            raise AssertionError(f"X flash_decode ({route}): -inf LSEs at "
                                 f"other rows than the plain version's")
        fin = torch.isfinite(want_lse)
        out[route] = {
            "max_abs_err": check_close(f"X flash_decode ({route}) output",
                                       got.float(), want, MAIN_RTOL,
                                       MAIN_ATOL),
            "lse_max_abs_err": check_close(
                f"X flash_decode ({route}) LSE", lse[fin], want_lse[fin],
                0.0, X_LSE_ATOL)}
    return out


def x_decode_case(tag: str, seed: int, device):
    """X1's or X2's configuration (the published one, and as run), its
    parameters and prompts drawn from ``seed``, and its decode steps."""
    import dataclasses
    import torch
    from repro_torch.configs.deepseek_v2_236b import CONFIG as BIG
    from repro_torch.configs.qwen2_7b import CONFIG as QWEN7
    from repro_torch.models import transformer as tf
    base, layers, (b, t, steps), gseed = {
        "X1": (QWEN7, QWEN7.n_layers, (X1_BATCH, X1_PROMPT, X1_STEPS), 13),
        "X2": (BIG, MCHECK_LAYERS, (X2_BATCH, X2_PROMPT, X2_STEPS), 17)}[tag]
    cfg = dataclasses.replace(base, tp=1, n_layers=layers)
    params = tf.init_params(
        cfg, generator=torch.Generator(device).manual_seed(seed + gseed),
        device=device)
    prompts = lm_prompt_ids(b, t, cfg.vocab, seed + gseed + 6, device)
    return base, cfg, params, prompts, steps


#: The tensor-parallel check of each sharded decode's configuration.
TP_TAG = {"X1": "X5", "X2": "X6"}


def x_decode_phases(counts, card: str, seed: int, mesh,
                    device="cuda") -> dict:
    """X1 and X2, each followed by its tensor-parallel check, X5 and X6
    (module doc).  Returns {config name: numbers}, X5's and X6's under
    ``"tp"``."""
    import dataclasses
    import torch
    from repro_torch.models import transformer as tf
    out = {}
    cuda = torch.device(device).type == "cuda"
    for tag in ("X1", "X2"):
        t0 = time.monotonic()
        base, cfg, params, prompts, steps = x_decode_case(tag, seed, device)
        b, t = prompts.shape
        before = counts.by_path["mesh"]["flash_decode"]
        ref, ref32 = {}, {}
        n = sharded_decode_check(params, cfg, prompts, steps, mesh, counts,
                                 keep=ref)
        n["flash_decode_launches"] = \
            counts.by_path["mesh"]["flash_decode"] - before
        if tag == "X1":
            _, placed = tf.prefill(params, prompts, cfg, t + steps,
                                   mesh=mesh)
            n["flash_decode_lse"] = hold_lse(
                placed["k"], placed["v"], placed["lengths"] + steps,
                cfg.padded_heads, seed + 31) if prompts.is_cuda else None
            del placed
        t1 = time.monotonic()
        tp_cfg = dataclasses.replace(cfg, tp=mesh.shape["model"])
        before = counts.by_path["tp"]["flash_decode"]
        tp = tp_check(params, tp_cfg, prompts, steps, mesh, ref, counts,
                      moe_checks=cfg.is_moe)
        tp["flash_decode_launches"] = \
            counts.by_path["tp"]["flash_decode"] - before
        del ref
        release(device)
        tp["seconds"] = time.monotonic() - t1
        check_cfg = (dataclasses.replace(cfg, n_layers=X_CHECK_LAYERS,
                                         param_dtype=torch.float32,
                                         act_dtype=torch.float32)
                     if not cfg.is_moe else
                     no_drop_float32(cfg, X_CHECK_LAYERS))
        params = float32_layers(params, X_CHECK_LAYERS)
        release(device)
        n["f32"] = sharded_decode_check(params, check_cfg,
                                        prompts[:X_CHECK_BATCH], steps, mesh,
                                        PathLaunches({}), fault=False,
                                        keep=ref32)
        t1 = time.monotonic()
        tp["f32"] = tp_check(params, dataclasses.replace(check_cfg,
                                                         tp=tp_cfg.tp),
                             prompts[:X_CHECK_BATCH], steps, mesh, ref32,
                             PathLaunches({}), fault=False, consume=True)
        tp["seconds"] += time.monotonic() - t1
        n.update(reduced=[f"n_layers {base.n_layers}->{cfg.n_layers}"]
                 if cfg.n_layers != base.n_layers else [],
                 limit=X_REL_TOL[tag], f32_limit=X_F32_TOL,
                 seconds=time.monotonic() - t0, tp=tp)
        tp.update(limit=X_REL_TOL[TP_TAG[tag]], f32_limit=X_F32_TOL)
        del params, prompts, ref32
        release(device)
        # one launch a layer, step and shard of positions on the card;
        # none for MLA (plain einsums) or on the CPU's plain route
        want = cfg.n_layers * steps * sum(hi > lo for lo, hi in n[
            "cache_placed"]["seq_bounds"]) if cfg.attn != "mla" and \
            cuda else 0
        for path, got in (("mesh", n["flash_decode_launches"]),
                          ("tp", tp["flash_decode_launches"])):
            if got != want:
                raise AssertionError(f"{tag} ({cfg.name}): flash_decode "
                                     f"launched {got} times on the {path} "
                                     f"path, want {want}")
        log(f"{tag} {cfg.name} ({cfg.n_layers} layers, tp 1, "
            f"{cfg.act_dtype}): {b} x {t} tokens, {steps} steps, the cache "
            f"{json.dumps(n['cache_placed'])} over {mesh}; logits vs the "
            f"unsharded decode of the same tokens: relative L2 "
            f"{n['sharded']:.4g} (limit {X_REL_TOL[tag]}), argmax "
            f"{n['argmax']}/{b}; planted fault (a plain mean of the shards) "
            f"{n['fault_plain_mean']:.4g}; float32 {X_CHECK_LAYERS}-layer "
            f"control {n['f32']['sharded']:.4g} (limit {X_F32_TOL}); step "
            f"p50 sharded {n['step_ms_p50']:.3f} ms, unsharded "
            f"{n['unsharded_step_ms_p50']:.3f} ms; flash_decode launched "
            f"{n['flash_decode_launches']} times on the mesh path"
            + (f"; traced: busy {n['busy_ms_per_step']:.3f} ms a sharded "
               f"step, idle share {n['idle_share']:.4f}, device ms a step "
               f"by kernel {json.dumps(n['step_ms_by_kernel'])}"
               if n.get("busy_ms_per_step") else "")
            + (f"; its LSE output {json.dumps(n['flash_decode_lse'])}"
               if n.get("flash_decode_lse") else "")
            + f" ({n['seconds']:.1f} s on {card})")
        log(f"{TP_TAG[tag]} {cfg.name} tensor-parallel (tp {tp['tp']}: heads"
            f", mlp, vocab and experts over {mesh}, TP_ONLY) through the "
            f"cells' get_fn(mesh, TP_ONLY), the same {b} x {t} tokens and "
            f"{steps} steps on the sequence-sharded cache: logits vs the "
            f"unsharded decode relative L2 {tp['rel_l2']:.4g} (limit "
            f"{tp['limit']}), the prefill's {tp['prefill_rel_l2']:.4g}, "
            f"argmax {tp['argmax']}/{b}; planted fault (one entry's heads "
            f"dropped) {tp['fault_heads_dropped']:.4g}; float32 "
            f"{X_CHECK_LAYERS}-layer control {tp['f32']['rel_l2']:.4g} "
            f"(limit {X_F32_TOL}); prefill {tp['prefill_s']:.3f} s, step p50 "
            f"{tp['step_ms_p50']:.3f} ms; weight bytes an entry "
            f"{json.dumps(tp['weight_bytes'])} (placed in "
            f"{tp['place_s']:.2f} s); flash_decode launched "
            f"{tp['flash_decode_launches']} times on the tp path"
            + (f"; layer 0's MoE repeats bit for bit: {tp['repeats']} "
               f"({tp['differing']} of {tp['elements']} differ), route "
               f"equal to the whole router's: {tp['route_equal']}"
               if "repeats" in tp else "")
            + f" ({tp['seconds']:.1f} s on {card})")
        check_x_decode(tag, n)
        check_x_tp(TP_TAG[tag], tp, tp["f32"])
        out[cfg.name] = n
    return out


def zero_phase(counts, card: str, seed: int, grid_mesh,
               device="cuda") -> dict:
    """X3 (module doc): DIEN's CONFIG; one AdamW step from the same
    gradients with the state laid out over ``grid_mesh`` (ZeRO) and
    unplaced; the forward at serve_p99 and the retrieval at
    retrieval_cand on row-sharded tables against the whole tables."""
    import torch
    from repro_torch.configs.common import RECSYS_SHAPES
    from repro_torch.configs.dien import CONFIG
    from repro_torch.models import dien as D
    from repro_torch.train import optimizer as O
    from repro_torch.train.checkpoint import flatten
    from repro_torch.train.loop import value_and_grad
    cfg = CONFIG
    dims = {k: s.dims for k, s in RECSYS_SHAPES.items()}
    t0 = time.monotonic()
    params = D.init_params(cfg, generator=torch.Generator(device).manual_seed(
        seed + 61), device=device)
    rows = dien_inputs(cfg, 1, X3_GRAD_BATCH, seed, device)
    _, grads = value_and_grad(D.make_train_loss(cfg), params, rows)
    del rows
    ocfg = O.AdamWConfig()
    want, _, want_stats = O.apply(params, grads, O.init(params, ocfg), ocfg)
    specs = O.state_specs(D.param_specs(cfg))
    state = O.place_state(O.init(params, ocfg), specs, grid_mesh)
    with counts.path("mesh"):
        got, state, stats = O.apply(params, grads, state, ocfg)
    del grads
    err = 0.0
    names = [k for k, _ in _leaf_names(params)]
    for name, a, w in zip(names, flatten(got)[0], flatten(want)[0]):
        floor = float(w.abs().max())
        err = max(err, check_close(f"X3 AdamW {name}: placed vs unplaced",
                                   a, w, X3_ADAMW_RTOL,
                                   X3_ADAMW_RTOL * floor))
    out = {"adamw_max_abs_err": err,
           "grad_norm": [float(want_stats["grad_norm"]),
                         float(stats["grad_norm"])],
           "bytes_by_device": {}}
    for part in ("mu", "nu"):
        tree = getattr(state, part)
        for name in D.TABLES:
            out["bytes_by_device"][f"{part}.{name}"] = {
                str(k): v for k, v in tree[name].nbytes_by_device().items()}
    placed = D.place_params(params, grid_mesh)
    for name in D.TABLES:
        out["bytes_by_device"][name] = {
            str(k): v for k, v in placed[name].nbytes_by_device().items()}
        out["bytes_by_device"][name + "_whole"] = \
            params[name].numel() * params[name].element_size()
    del want, got, state
    b = dims["serve_p99"]["batch"]
    batch = dien_inputs(cfg, 0, b, seed, device)
    n = dims["retrieval_cand"]["n_candidates"]
    user = dien_inputs(cfg, 2, dims["retrieval_cand"]["batch"], seed, device)
    r = np.random.default_rng(seed)
    cand = tensors({"item": r.integers(0, cfg.n_items, (n,)).astype(np.int32),
                    "cate": r.integers(0, cfg.n_cates, (n,)).astype(np.int32)},
                   device)
    cuda = torch.device(device).type == "cuda"
    with torch.inference_mode():
        logits, ms0 = timed_calls(lambda: D.forward(params, batch, cfg), 3,
                                  cuda)
        scores, rms0 = timed_calls(
            lambda: D.retrieval_scores(params, user, cand, cfg), 3, cuda)
        with counts.path("mesh"):
            got_logits, ms1 = timed_calls(
                lambda: D.forward(placed, batch, cfg), 3, cuda)
            got_scores, rms1 = timed_calls(
                lambda: D.retrieval_scores(placed, user, cand, cfg), 3, cuda)
    out.update(serve_p99_equal=bool(torch.equal(got_logits, logits)),
               retrieval_equal=bool(torch.equal(got_scores, scores)),
               serve_p99_ms=[float(np.median(ms1)), float(np.median(ms0))],
               retrieval_ms=[float(np.median(rms1)), float(np.median(rms0))],
               seconds=time.monotonic() - t0)
    log(f"X3 DIEN over {grid_mesh}: one AdamW step with the state laid out "
        f"(ZeRO) vs unplaced, max |diff| {err:.3g} (rtol {X3_ADAMW_RTOL}, "
        f"atol {X3_ADAMW_RTOL} x each leaf's largest magnitude), grad norm "
        f"{json.dumps(out['grad_norm'])}; row-sharded tables: serve_p99 "
        f"logits equal bit for bit: {out['serve_p99_equal']}, retrieval of "
        f"{n} candidates: {out['retrieval_equal']}; ms sharded / whole: "
        f"forward {json.dumps(out['serve_p99_ms'])}, retrieval "
        f"{json.dumps(out['retrieval_ms'])}; bytes a device "
        f"{json.dumps(out['bytes_by_device'])} ({out['seconds']:.1f} s on "
        f"{card})")
    if not (out["serve_p99_equal"] and out["retrieval_equal"]):
        raise AssertionError("X3: DIEN on row-sharded tables differs from "
                             "the whole tables")
    del params, placed, batch, user, cand
    release(device)
    return out


def _leaf_names(tree, prefix=""):
    """(dotted name, leaf) of a tree, in ``flatten``'s order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_names(tree[k], f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from _leaf_names(x, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


@contextlib.contextmanager
def ring_column_zero_only():
    """X4's planted fault: the ring keeps model column 0's partial
    numerator and denominator instead of summing over ``model``."""
    from repro_torch.models.gnn import ring as RG
    psum = RG._psum
    RG._psum = lambda parts, dev: parts[0].to(dev)
    try:
        yield
    finally:
        RG._psum = psum


def ring_phase(counts, card: str, seed: int, grid_mesh,
               device="cuda") -> dict:
    """X4 (module doc): Equiformer-v2's CONFIG through the ring at
    full_graph_sm (X4_REPS calls) and minibatch_lg's sampled block (one
    call, X4_LG_LAYERS layers), timed in float32 and held against the
    local forward of the same inputs twice: in float32 within X_F32_TOL
    relative L2 (X1's float32 control), and in float64 (the ring's
    accumulators widened with it) within G's rtol / atol.  Float32 does
    not resolve that element-wise tolerance here: the outputs reach ~11
    and some lie near 0, where two float32 summation orders differ by
    1.3-1.6e-5 on an H100 against atol 1e-5 (as ``gnn_against_cpu``
    holds EGNN in float64).  The planted fault at full_graph_sm must miss
    both."""
    import dataclasses
    import torch
    from repro_torch.models.gnn import ring as RG
    cuda = torch.device(device).type == "cuda"
    p_data, p_model = (grid_mesh.shape["data"], grid_mesh.shape["model"])
    out = {}
    for shape, reps in (("full_graph_sm", X4_REPS), ("minibatch_lg", 1)):
        inp = gnn_shape_inputs(shape, seed, device)
        batch = inp["batch"]
        n_node = batch.n_node
        model = gnn_model("equiformer-v2", inp["d_in"], inp["n_out"],
                          seed + 47 + GNN_ARCHS.index("equiformer-v2"),
                          device, n_layers=X4_LG_LAYERS
                          if shape == "minibatch_lg" else None)
        live = batch.edge_mask.cpu().numpy()
        snd = batch.senders.cpu().numpy()[live]
        rcv = batch.receivers.cpu().numpy()[live]
        t0 = time.monotonic()
        src_b, dst_b, n_loc, dropped = RG.bucket_edges(snd, rcv, n_node,
                                                       p_data, p_model)
        bucket_s = time.monotonic() - t0
        nodes, pos, _ = RG.blocked_layout(
            batch.nodes[:n_node].cpu().numpy(), inp["pos"], n_node, p_data)
        nodes, pos = (torch.from_numpy(x).to(device) for x in (nodes, pos))
        src_b, dst_b = (torch.from_numpy(x).to(device)
                        for x in (src_b, dst_b))

        def ring(m):
            dt = m.cfg.dtype
            x = RG.forward_ring(m, nodes.to(dt), pos.to(dt), src_b, dst_b,
                                grid_mesh)
            return m.head(RG.unblock(x, n_node, p_data)[..., 0])[
                :inp["rows"]]
        with torch.inference_mode():
            want = gnn_output(model, batch, inp)
            if cuda:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                resident = torch.cuda.memory_allocated()
            if reps > 1:
                ring(model)                     # one untimed call first
            with counts.path("mesh"):
                got, ms = timed_calls(lambda: ring(model), reps, cuda)
            peak = torch.cuda.max_memory_allocated() if cuda else 0
            t0 = time.monotonic()
            wide = gnn_cast(model, torch.float64, device)
            want64 = gnn_output(wide, dataclasses.replace(
                batch, nodes=batch.nodes.double(), pos=batch.pos.double()),
                inp)
            got64 = ring(wide)
            f64_s = time.monotonic() - t0
        n = {"n_node": n_node, "live_edges": int(live.sum()),
             "bucket_cap": int(src_b.shape[-1]), "dropped": int(dropped),
             "bucket_host_s": bucket_s, "ms": ms,
             "ms_p50": float(np.median(ms)), "peak_bytes": peak,
             "resident_bytes": resident if cuda else 0,
             "rel_l2": rel_l2(got, want),
             "f32_max_abs_err": float((got.double() - want.double())
                                      .abs().max()),
             "max_abs_output": float(want64.abs().max()),
             "precision": "float64", "float64_check_s": f64_s,
             "max_abs_err": check_close(f"X4 ring at {shape} vs the local "
                                        f"forward in float64", got64,
                                        want64, GNN_RTOL, GNN_ATOL)}
        if not n["rel_l2"] <= X_F32_TOL:
            raise AssertionError(f"X4 ring at {shape} vs the local forward "
                                 f"in float32: relative L2 "
                                 f"{n['rel_l2']:.4g}, beyond {X_F32_TOL}")
        if dropped:
            raise AssertionError(f"X4: bucket_edges dropped {dropped} edges "
                                 f"at {shape}")
        if shape == "full_graph_sm":
            with torch.inference_mode(), ring_column_zero_only():
                bad, bad64 = ring(model), ring(wide)
            n["fault_column_zero_rel_l2"] = rel_l2(bad, want)
            n["fault_column_zero_max_abs_err"] = float(
                (bad64 - want64).abs().max())
            if n["fault_column_zero_rel_l2"] <= X_F32_TOL or \
                    torch.allclose(bad64, want64, rtol=GNN_RTOL,
                                   atol=GNN_ATOL):
                raise AssertionError("X4: the planted fault (no sum over "
                                     "model) passes the ring's check")
        out[shape] = n
        log(f"X4 Equiformer-v2 ring over {grid_mesh} at {shape} (N "
            f"{n_node}, {n['live_edges']} live edges in buckets of "
            f"{n['bucket_cap']}, {dropped} dropped, bucketed in "
            f"{bucket_s:.3f} s on the host): p50 {n['ms_p50']:.3f} ms of "
            f"{json.dumps([round(t, 3) for t in ms])}, peak {peak} B "
            f"(resident {n['resident_bytes']} B); vs the local forward in "
            f"float32 relative L2 {n['rel_l2']:.3g} (limit {X_F32_TOL}), "
            f"max |diff| {n['f32_max_abs_err']:.3g}; in float64 max |diff| "
            f"{n['max_abs_err']:.3g} (rtol {GNN_RTOL}, atol {GNN_ATOL}, "
            f"outputs up to {n['max_abs_output']:.4g}; {f64_s:.1f} s)"
            + (f"; planted fault (model column 0 only) relative L2 "
               f"{n['fault_column_zero_rel_l2']:.3g}, max |diff| "
               f"{n['fault_column_zero_max_abs_err']:.3g}"
               if "fault_column_zero_max_abs_err" in n else "")
            + f" on {card}")
        del inp, batch, model, wide, nodes, pos, src_b, dst_b, got, want
        del got64, want64
        release(device)
    return out


@contextlib.contextmanager
def one_entry_heads_dropped():
    """X5's, X6's and X7's planted fault: each attention's partial outputs
    summed without the last model entry's, whose heads are dropped."""
    from repro_torch.models import attention as A
    psum = A.psum
    A.psum = lambda parts, device: psum(parts[:-1], device)
    try:
        yield
    finally:
        A.psum = psum


@contextlib.contextmanager
def one_entry_experts_dropped(per_entry: int):
    """X8's planted fault: the last model entry's ``per_entry`` experts'
    outputs dropped before the un-dispatch adds them."""
    import torch
    from repro_torch.models import moe as M
    combine = M._combine

    def dropped(out_e, r, rows, cfg):
        kept = torch.cat([out_e[:-per_entry],
                          torch.zeros_like(out_e[-per_entry:])])
        return combine(kept, r, rows, cfg)
    M._combine = dropped
    try:
        yield
    finally:
        M._combine = combine


@contextlib.contextmanager
def one_entry_edges_dropped(entry: int = X_ENTRIES - 1):
    """X10's planted fault: mesh entry ``entry``'s edge partials left out
    of every cross-shard reduction (sum, max, min) of the GNNs' edge
    shards."""
    from repro_torch.models.gnn.graph import EdgeShards
    saved = {k: getattr(EdgeShards, k) for k in ("sum", "max", "min")}

    def dropping(reduce):
        return lambda self, parts: reduce(
            self, [p for i, p in enumerate(parts) if i != entry])
    for k, reduce in saved.items():
        setattr(EdgeShards, k, dropping(reduce))
    try:
        yield
    finally:
        for k, reduce in saved.items():
            setattr(EdgeShards, k, reduce)


def x10_tag(arch: str, shape: str) -> str:
    return f"X10 {arch}" + (" molecule" if shape == "molecule" else "")


def x10_inputs(arch: str, shape: str, seed: int, device):
    """X10's cell (``launch.steps``) at ``configs/<arch>.py``'s CONFIG and
    its arguments: random weights from a CPU generator seeded from
    ``seed``, a fresh AdamW state, phase G's graph of the shape
    (:func:`gnn_shape_inputs`; PNA's without positions) and labels drawn
    from ``seed``: classes at full_graph_sm, N(0, 1) targets at
    molecule."""
    import dataclasses
    import importlib
    import torch
    from repro_torch.configs import get
    from repro_torch.launch import steps as S
    from repro_torch.train import optimizer as O
    mod = importlib.import_module(
        f"repro_torch.configs.{arch.replace('-', '_')}")
    spec = dataclasses.replace(get(arch), config=mod.CONFIG)
    bundle = S.gnn_bundle(spec, spec.shapes[shape], False)
    inp = gnn_shape_inputs(shape, seed, device)
    batch = inp["batch"]
    if arch == "pna":
        batch = dataclasses.replace(batch, pos=None)
    batch_a, labels_a = bundle.abstract_args[2]
    if (batch.n_node, batch.n_edge) != (batch_a.n_node, batch_a.n_edge):
        raise AssertionError(f"X10 {arch}/{shape}: the graph has "
                             f"{batch.n_node} nodes in {batch.n_edge} edge "
                             f"slots, the cell {batch_a.n_node} in "
                             f"{batch_a.n_edge}")
    rng = np.random.default_rng(seed + 89)
    labels = (rng.integers(0, inp["n_out"], labels_a.shape).astype(np.int32)
              if labels_a.dtype == torch.int32 else
              rng.normal(size=labels_a.shape).astype(np.float32))
    params = S.gnn_params(spec, spec.shapes[shape], seed + 97, smoke=False,
                          device=device)
    return bundle, (params, O.init(params, O.AdamWConfig()),
                    (batch, torch.from_numpy(labels).to(device)))


def x10_case(arch: str, shape: str, steps: int, seed: int, mesh, counts,
             device="cuda") -> dict:
    """X10 (module doc): ``steps`` AdamW steps of the cell through
    ``get_fn()``, then, the one-device outputs moved off the card,
    through ``get_fn(mesh, FSDP_TP)`` on ``place_args`` arguments (inside
    ``counts.path("fsdp")``), then again with one entry's edge partials
    dropped."""
    import torch
    from repro_torch import sharding as SH
    bundle, args = x10_inputs(arch, shape, seed, device)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    want_p, _, want_stats, ms_one = fsdp_steps(bundle.get_fn(), args[0],
                                               args[1], [args[2]] * steps)
    peak_one = torch.cuda.max_memory_allocated() if cuda else 0
    # the card holds one run at a time: the reference run's parameters
    # wait on the host
    want_p = {k: v.cpu() for k, v in want_p.items()}
    placed = bundle.place_args(args, mesh, SH.FSDP_TP)
    del args
    release(device)
    step = bundle.get_fn(mesh, SH.FSDP_TP)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    with counts.path("fsdp"):
        got_p, _, got_stats, ms = fsdp_steps(step, placed[0], placed[1],
                                             [placed[2]] * steps)
    senders = placed[2][0].senders
    out = {"steps": steps, "n_node": placed[2][0].n_node,
           "edge_slots": senders.shape[0],
           "edges_by_entry": [int(senders.shard(e).shape[0])
                              for e in range(mesh.size)],
           "step_ms": ms, "step_ms_p50": float(np.median(ms)),
           "one_device_step_ms": ms_one,
           "one_device_step_ms_p50": float(np.median(ms_one)),
           "peak_bytes": torch.cuda.max_memory_allocated() if cuda else 0,
           "one_device_peak_bytes": peak_one}
    out.update(fsdp_reading(got_p, got_stats, want_p, want_stats))
    if not all(np.isfinite(x) for st in got_stats for x in st):
        raise AssertionError(f"{x10_tag(arch, shape)}: the sharded step's "
                             f"loss or grad norm is not finite: {got_stats}")
    del got_p
    release(device)
    with one_entry_edges_dropped():
        bad_p, _, bad_stats, _ = fsdp_steps(step, placed[0], placed[1],
                                            [placed[2]] * steps)
    out["fault"] = fsdp_reading(bad_p, bad_stats, want_p, want_stats)["rel"]
    del bad_p, placed, want_p
    release(device)
    return out


def x10_phase(counts, card: str, seed: int, mesh, device="cuda") -> dict:
    """X10 (module doc): each of X10_CELLS against its limit."""
    out = {}
    for arch, shape, steps in X10_CELLS:
        tag = x10_tag(arch, shape)
        t0 = time.monotonic()
        n = x10_case(arch, shape, steps, seed, mesh, counts, device)
        n["seconds"] = time.monotonic() - t0
        out[f"{arch}/{shape}"] = n
        log(f"{tag} {arch}/{shape} edge-sharded over {mesh} (CONFIG, "
            f"float32; {n['edge_slots']} edge slots, "
            f"{json.dumps(n['edges_by_entry'])} an entry; {steps} steps) vs "
            f"the one-device step: loss "
            f"{json.dumps(n['loss'])}, grad norm {json.dumps(n['grad_norm'])}, "
            f"parameters {n['params']:.4g} (relative; limit "
            f"{X_REL_TOL[tag]}), planted fault (entry {X_ENTRIES - 1}'s edge "
            f"partials dropped) {n['fault']:.4g}; step p50 "
            f"{n['step_ms_p50']:.3f} ms (sharded) vs "
            f"{n['one_device_step_ms_p50']:.3f} ms (one device), peak "
            f"{n['peak_bytes']} B vs {n['one_device_peak_bytes']} B; "
            f"{n['seconds']:.3f} s on {card}")
        check_fsdp(tag, n, X_REL_TOL[tag])
    return out


def fsdp_bundle(cfg, kind: str, dims: dict):
    """The train cell (``launch.steps``) of ``cfg``'s architecture at
    ``cfg``, its shape cut to ``dims``."""
    import dataclasses
    from repro_torch.configs import get
    from repro_torch.configs.common import ShapeSpec
    from repro_torch.launch import steps as S
    spec = dataclasses.replace(get(cfg.name.removesuffix("-smoke")),
                               config=cfg)
    build = S.dien_bundle if kind == "recsys_train" else S.lm_bundle
    return build(spec, ShapeSpec("fsdp", kind, dims), False)


def fsdp_steps(step, params, state, batches, place=None) -> tuple:
    """``step`` over ``batches`` from (params, state), each batch laid out
    by ``place`` first where given: (params, state, each step's loss and
    grad norm, each step's ms by the host clock to a synchronise)."""
    import torch
    stats, ms = [], []
    for batch in batches:
        if place is not None:
            batch = place(batch)
        t0 = time.monotonic()
        params, state, st = step(params, state, batch)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        ms.append((time.monotonic() - t0) * 1e3)
        stats.append((float(st["loss"]), float(st["grad_norm"])))
    return params, state, stats, ms


def fsdp_reading(got_params, got_stats, want_params, want_stats) -> dict:
    """The FSDP steps against the one-device steps: each step's loss and
    grad norm as relative errors, the updated parameters (every leaf, as
    one vector) as a relative L2 error, and the largest of them."""
    import torch
    from repro_torch.launch.mesh import Placed, gather
    from repro_torch.train.checkpoint import flatten
    diff = norm = 0.0
    for g, w in zip(flatten(got_params)[0], flatten(want_params)[0]):
        g = gather(g, w.device) if isinstance(g, Placed) else g
        diff += float(torch.sum((g.double() - w.double()) ** 2))
        norm += float(torch.sum(w.double() ** 2))
    out = {"loss": [abs(g[0] - w[0]) / abs(w[0])
                    for g, w in zip(got_stats, want_stats)],
           "grad_norm": [abs(g[1] - w[1]) / abs(w[1])
                         for g, w in zip(got_stats, want_stats)],
           "params": (diff / norm) ** 0.5}
    out["rel"] = max(out["loss"] + out["grad_norm"] + [out["params"]])
    return out


def entry_bytes(placed, mesh) -> list:
    """Each mesh entry's bytes of a placed tree."""
    from repro_torch.launch.mesh import local_tree
    return [tree_bytes(local_tree(placed, e)) for e in range(mesh.size)]


def fsdp_lm_case(tag: str, cfg, dims: dict, steps: int, seed: int, mesh,
                 counts, device, fault, repeat: bool = False) -> dict:
    """X7 / X8: ``steps`` AdamW steps of ``cfg``'s train cell from the
    same random weights and ``lm_batch`` batches through the one-device
    ``get_fn()`` and through ``get_fn(mesh, FSDP_TP)`` on arguments laid
    out by ``place_args`` (inside ``counts.path("fsdp")``), then again
    under the planted ``fault``; with ``repeat`` the sharded steps once
    more, which must give the same bits."""
    import torch
    from repro_torch import sharding as SH
    from repro_torch.data.pipelines import lm_batch
    from repro_torch.models import transformer as tf
    from repro_torch.train import optimizer as O
    from repro_torch.train.checkpoint import flatten
    bundle = fsdp_bundle(cfg, "train", dims)
    b, t = dims["global_batch"], dims["seq_len"]
    params = tf.init_params(cfg, generator=torch.Generator(
        device).manual_seed(seed + 79), device=device)
    state = O.init(params, O.AdamWConfig())
    batches = [tensors(lm_batch(s, b, t, cfg.vocab, seed=seed), device)
               for s in range(steps)]
    want_p, _, want_stats, ms_one = fsdp_steps(bundle.get_fn(), params,
                                               state, batches)
    placed = bundle.place_args((params, state, batches[0]), mesh,
                               SH.FSDP_TP)[:2]
    del params, state
    release(device)

    def place(batch):
        return bundle.place_args((placed[0], placed[1], batch), mesh,
                                 SH.FSDP_TP)[2]
    step = bundle.get_fn(mesh, SH.FSDP_TP)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    with counts.path("fsdp"):
        got_p, got_s, got_stats, ms = fsdp_steps(step, *placed, batches,
                                                 place)
    out = {"reduced": [], "batch": b, "seq": t, "steps": steps,
           "step_ms": ms, "step_ms_p50": float(np.median(ms)),
           "one_device_step_ms": ms_one,
           "one_device_step_ms_p50": float(np.median(ms_one)),
           "peak_bytes": torch.cuda.max_memory_allocated() if cuda else 0,
           "param_bytes_by_entry": entry_bytes(got_p, mesh),
           "moment_bytes_by_entry": entry_bytes(
               (got_s.mu, got_s.nu, got_s.err), mesh)}
    out.update(fsdp_reading(got_p, got_stats, want_p, want_stats))
    if not all(np.isfinite(x) for s in got_stats for x in s):
        raise AssertionError(f"{tag}: the FSDP step's loss or grad norm is "
                             f"not finite: {got_stats}")
    # the repeat is held against a host copy: the card holds the placed
    # arguments, the one-device parameters and one run at a time
    kept = [{k: x.cpu() for k, x in leaf.shards.items()}
            for leaf in flatten(got_p)[0]] if repeat else None
    del got_p, got_s
    release(device)
    if repeat:
        again_p, _, again_stats, _ = fsdp_steps(step, *placed, batches,
                                                place)
        out["repeats"] = again_stats == got_stats and all(
            torch.equal(x.cpu(), k[key]) for leaf, k in zip(
                flatten(again_p)[0], kept) for key, x in leaf.shards.items())
        del again_p, kept
        release(device)
    with fault():
        bad_p, _, bad_stats, _ = fsdp_steps(step, *placed, batches, place)
    out["fault"] = fsdp_reading(bad_p, bad_stats, want_p, want_stats)["rel"]
    del bad_p, placed, want_p
    release(device)
    return out


def x7_case(seed: int, mesh, counts, device="cuda") -> dict:
    """X7 (module doc): qwen2-1.5b through train_4k over ``mesh``."""
    import dataclasses
    from repro_torch.configs.common import LM_SHAPES
    from repro_torch.configs.qwen2_1_5b import CONFIG
    dims = LM_SHAPES["train_4k"].dims
    cfg = dataclasses.replace(CONFIG, n_layers=min(X7_LAYERS,
                                                   CONFIG.n_layers))
    out = fsdp_lm_case("X7", cfg, dict(seq_len=dims["seq_len"],
                                       global_batch=X7_BATCH), X7_STEPS,
                       seed, mesh, counts, device, one_entry_heads_dropped)
    out["reduced"] = [f"n_layers {CONFIG.n_layers}->{cfg.n_layers}",
                      f"global_batch {dims['global_batch']}->{X7_BATCH}"]
    out["tp"] = cfg.tp
    return out


def x8_case(seed: int, mesh, counts, device="cuda") -> dict:
    """X8 (module doc): deepseek-v2-lite-16b in float32 at the no-drop
    capacity factor over ``mesh``."""
    from repro_torch.configs.deepseek_v2_lite_16b import CONFIG
    cfg = no_drop_float32(CONFIG, min(MCHECK_LAYERS, CONFIG.n_layers))
    per_entry = cfg.moe_experts // mesh.shape["model"]
    out = fsdp_lm_case(
        "X8", cfg, dict(seq_len=X8_SEQ, global_batch=X8_BATCH), 1, seed,
        mesh, counts, device, lambda: one_entry_experts_dropped(per_entry),
        repeat=True)
    out["reduced"] = [f"n_layers {CONFIG.n_layers}->{cfg.n_layers}",
                      "float32, capacity factor e / k (no drops)",
                      f"train_4k 256 x 4096 -> {X8_BATCH} x {X8_SEQ}"]
    return out


def x9_case(seed: int, mesh, counts, device="cuda") -> dict:
    """X9 (module doc): DIEN's train_batch over ``mesh``, one FSDP step
    against one one-device step from the same weights and batch: in
    float32 (the cell; timed) by the relative errors of
    :func:`fsdp_reading`, and in float64 (its weights widened) every
    updated parameter within X3's element-wise AdamW tolerance.  Float32
    does not resolve that tolerance on the leaves that start at zero (the
    biases: after one step all update, ``lr`` times ``g / (|g| + eps)``,
    where two summation orders of a gradient near ``eps`` move it by
    more than ``X3_ADAMW_RTOL`` of ``lr``), as X4 holds its element-wise
    tolerance in float64."""
    import dataclasses
    import torch
    from repro_torch import sharding as SH
    from repro_torch.configs.common import RECSYS_SHAPES
    from repro_torch.configs.dien import CONFIG
    from repro_torch.models import dien as D
    from repro_torch.train import optimizer as O
    from repro_torch.train.checkpoint import flatten
    out = {"reduced": [f"batch {RECSYS_SHAPES['train_batch'].dims['batch']}"
                       f"->{X3_GRAD_BATCH}"], "rtol": X3_ADAMW_RTOL,
           "bytes_by_entry": {}}
    batch = dien_inputs(CONFIG, 3, X3_GRAD_BATCH, seed, device)
    params = D.init_params(CONFIG, generator=torch.Generator(
        device).manual_seed(seed + 83), device=device)
    for dtype in (torch.float32, torch.float64):
        cfg = dataclasses.replace(CONFIG, dtype=dtype)
        bundle = fsdp_bundle(cfg, "recsys_train", dict(batch=X3_GRAD_BATCH))
        p0 = O.tree_map(lambda x: x.to(dtype), params)
        state = O.init(p0, O.AdamWConfig())
        want_p, _, want_stats, ms_one = fsdp_steps(bundle.get_fn(), p0,
                                                   state, [batch])
        placed = bundle.place_args((p0, state, batch), mesh, SH.FSDP_TP)
        step = bundle.get_fn(mesh, SH.FSDP_TP)
        if dtype == torch.float32:
            with counts.path("fsdp"):
                got_p, got_s, got_stats, ms = fsdp_steps(
                    step, placed[0], placed[1], [placed[2]])
            out.update(fsdp_reading(got_p, got_stats, want_p, want_stats),
                       step_ms=ms, one_device_step_ms=ms_one)
            for name in D.TABLES:
                by = out["bytes_by_entry"]
                by[name] = entry_bytes(got_p[name], mesh)
                for part in ("mu", "nu"):
                    by[f"{part}.{name}"] = entry_bytes(
                        getattr(got_s, part)[name], mesh)
                by[name + "_whole"] = tree_bytes(want_p[name])
        else:
            got_p = fsdp_steps(step, placed[0], placed[1], [placed[2]])[0]
            err = 0.0
            for (name, w), a in zip(_leaf_names(want_p), flatten(got_p)[0]):
                err = max(err, check_close(
                    f"X9 DIEN {name} in float64: FSDP vs one device",
                    gather_whole(a, w.device), w, X3_ADAMW_RTOL,
                    X3_ADAMW_RTOL * float(w.abs().max())))
            out["float64_max_abs_err"] = err
        del p0, state, placed, got_p, want_p
        release(device)
    del params, batch
    release(device)
    return out


def gather_whole(x, device):
    from repro_torch.launch.mesh import Placed, gather
    return gather(x, device) if isinstance(x, Placed) else x


def fsdp_entry_bytes() -> dict:
    """Each entry's parameter and moment bytes of the five LM train_4k
    cells at full size on the production mesh, (16, 16) ("data",
    "model"), laid out through ``FSDP_TP`` over meta devices (nothing
    allocated), beside the whole parameters' bytes."""
    from repro_torch import sharding as SH
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import PRODUCTION_MODEL_AXIS, make_mesh
    p = PRODUCTION_MODEL_AXIS
    mesh = make_mesh((p, p), ("data", "model"), ["meta"] * (p * p))
    out = {}
    for arch in ("qwen2-1.5b", "qwen2-7b", "phi3-medium-14b",
                 "deepseek-v2-lite-16b", "deepseek-v2-236b"):
        bundle = S.make_bundle(arch, "train_4k")
        params, state, _ = bundle.place_args(bundle.abstract_args, mesh,
                                             SH.FSDP_TP)
        per = [entry_bytes(params, mesh), entry_bytes(
            (state.mu, state.nu, state.err), mesh)]
        if any(len(set(x)) != 1 for x in per):
            raise AssertionError(f"X FSDP bytes ({arch}): entries differ")
        out[arch] = {"param_bytes_by_entry": per[0][0],
                     "moment_bytes_by_entry": per[1][0],
                     "param_bytes_whole": tree_bytes(bundle.abstract_args[0])}
    return out


def check_fsdp(tag: str, n: dict, limit: float) -> None:
    """X7 / X8: the FSDP steps within ``limit`` of the one-device steps,
    the planted fault beyond it (and X8's repeat bit for bit)."""
    if not n["rel"] <= limit:
        raise AssertionError(f"{tag}: the FSDP step differs from the "
                             f"one-device step by {n['rel']:.4g}, beyond "
                             f"{limit}: {json.dumps(n)}")
    if not n["fault"] > limit:
        raise AssertionError(f"{tag}: the limit {limit} passes the planted "
                             f"fault ({n['fault']:.4g})")
    if n.get("repeats") is False:
        raise AssertionError(f"{tag}: two FSDP steps from the same "
                             f"arguments differ")


def fsdp_phase(counts, card: str, seed: int, device="cuda") -> dict:
    """X7-X10 (module doc) over X_GRID's mesh of X_ENTRIES entries, and
    the five LM cells' bytes an entry on the production mesh (meta)."""
    from repro_torch.launch.mesh import make_mesh
    grid_mesh = make_mesh(X_GRID, ("data", "model"), mesh_devices(device))
    t0 = time.monotonic()
    out = {"X7": x7_case(seed, grid_mesh, counts, device)}
    check_fsdp("X7", out["X7"], X_REL_TOL["X7"])
    n = out["X7"]
    log(f"X7 qwen2-1.5b FSDP over {grid_mesh} (tp {n['tp']}, bf16, remat; "
        f"{n['batch']} x {n['seq']}, {n['steps']} steps; reduced "
        f"{json.dumps(n['reduced'])}) vs the one-device step: loss "
        f"{json.dumps(n['loss'])}, grad norm {json.dumps(n['grad_norm'])}, "
        f"parameters {n['params']:.4g} (relative; limit {X_REL_TOL['X7']}), "
        f"planted fault (one entry's heads dropped) {n['fault']:.4g}; step "
        f"p50 {n['step_ms_p50']:.3f} ms (FSDP) vs "
        f"{n['one_device_step_ms_p50']:.3f} ms (one device), peak "
        f"{n['peak_bytes']} B; bytes an entry: parameters "
        f"{json.dumps(n['param_bytes_by_entry'])}, moments "
        f"{json.dumps(n['moment_bytes_by_entry'])} on {card}")
    out["X8"] = x8_case(seed, grid_mesh, counts, device)
    n = out["X8"]
    log(f"X8 deepseek-v2-lite-16b FSDP over {grid_mesh} (reduced "
        f"{json.dumps(n['reduced'])}) vs the one-device step: loss "
        f"{json.dumps(n['loss'])}, grad norm {json.dumps(n['grad_norm'])}, "
        f"parameters {n['params']:.4g} (relative; limit {X8_REL_TOL}), "
        f"repeats bit for bit: {n['repeats']}, planted fault (one entry's "
        f"experts dropped) {n['fault']:.4g}; step {n['step_ms_p50']:.3f} ms "
        f"vs {n['one_device_step_ms_p50']:.3f} ms, peak {n['peak_bytes']} B"
        f" on {card}")
    check_fsdp("X8", n, X8_REL_TOL)
    out["X9"] = x9_case(seed, grid_mesh, counts, device)
    n = out["X9"]
    log(f"X9 DIEN FSDP over {grid_mesh} (tables over model, batch over "
        f"data; reduced {json.dumps(n['reduced'])}) vs the one-device step: "
        f"float32 loss {json.dumps(n['loss'])}, grad norm "
        f"{json.dumps(n['grad_norm'])}, parameters {n['params']:.4g} "
        f"(relative); float64 parameters max |diff| "
        f"{n['float64_max_abs_err']:.3g} (rtol {n['rtol']}, atol "
        f"{n['rtol']} x each leaf's largest magnitude); step ms "
        f"{json.dumps(n['step_ms'])} vs {json.dumps(n['one_device_step_ms'])}"
        f"; bytes an entry {json.dumps(n['bytes_by_entry'])} on {card}")
    out["X10"] = x10_phase(counts, card, seed, grid_mesh, device)
    out["production_bytes"] = fsdp_entry_bytes()
    log(f"X FSDP bytes an entry of the LM train_4k cells at full size on "
        f"the (16, 16) production mesh (meta): "
        f"{json.dumps(out['production_bytes'])}")
    if any(counts.by_path["fsdp"].values()):
        raise AssertionError(f"X7-X10 launched a kernel of the port: "
                             f"{counts.by_path['fsdp']}")
    out["seconds"] = time.monotonic() - t0
    return out


def mesh_phase(counts, card: str, seed: int, device="cuda") -> dict:
    """Phase X (module doc): X1-X4 over a mesh of X_ENTRIES entries.
    Returns the numbers; raises on any failed check."""
    from repro_torch.launch.mesh import make_mesh
    devices = mesh_devices(device)
    seq_mesh = make_mesh((X_ENTRIES,), ("model",), devices)
    grid_mesh = make_mesh(X_GRID, ("data", "model"), devices)
    log(f"X meshes: {seq_mesh} (the decode caches' sequence axis), "
        f"{grid_mesh} (DIEN, AdamW, the ring)")
    t0 = time.monotonic()
    out = {"decode": x_decode_phases(counts, card, seed, seq_mesh, device)}
    t1 = time.monotonic()
    out["zero"] = zero_phase(counts, card, seed, grid_mesh, device)
    t2 = time.monotonic()
    out["ring"] = ring_phase(counts, card, seed, grid_mesh, device)
    out["seconds"] = {"decode": t1 - t0, "zero": t2 - t1,
                      "ring": time.monotonic() - t2}
    return out


def random_rotation(seed: int) -> np.ndarray:
    """A proper rotation (det +1), float64 [3, 3], from the QR of a
    seeded Gaussian matrix."""
    q, r = np.linalg.qr(np.random.default_rng(seed).standard_normal((3, 3)))
    q = q * np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q


def gnn_shape_inputs(shape: str, seed: int, device) -> dict:
    """One of phase G's graphs (module doc) on ``device``: ``batch``,
    ``pos`` (numpy [N, 3], rotated for the invariance check),
    ``arrays`` (``from_numpy``'s arguments, to place the graph again on
    the CPU; None at minibatch_lg, sampled straight onto the card),
    ``d_in``, ``n_out``, ``node_level``, ``rows`` (the output rows held:
    the targets at minibatch_lg), ``host_s`` (host seconds of the
    sampler)."""
    from repro_torch.configs.common import GNN_SHAPES
    from repro_torch.data.pipelines import molecule_batch
    from repro_torch.models.gnn import sampler as SA
    from repro_torch.models.gnn.graph import from_numpy
    dims = GNN_SHAPES[shape].dims
    out = {"host_s": {}}
    if shape == "molecule":
        mol = molecule_batch(0, dims["batch"], dims["n_nodes"],
                             dims["n_edges"], dims["d_feat"], seed=seed)
        out["arrays"] = {k: mol[k] for k in ("node_feat", "senders",
                                             "receivers", "pos", "graph_id",
                                             "n_graph")}
        out.update(d_in=dims["d_feat"], n_out=1, node_level=False,
                   rows=dims["batch"])
    elif shape == "full_graph_sm":
        # gnn_host_args' draw: uniform pairs, self-loops removed, in an
        # edge capacity rounded up to a multiple of 512
        n, e = dims["n_nodes"], dims["n_edges"]
        rng = np.random.default_rng(seed)
        s, r = rng.integers(0, n, e), rng.integers(0, n, e)
        keep = s != r
        out["arrays"] = dict(
            node_feat=rng.normal(size=(n, dims["d_feat"])).astype(np.float32),
            senders=s[keep].astype(np.int32),
            receivers=r[keep].astype(np.int32),
            pos=rng.normal(size=(n, 3)).astype(np.float32),
            e_cap=-(-e // 512) * 512)
        out.update(d_in=dims["d_feat"], n_out=dims["n_classes"],
                   node_level=True, rows=n)
    else:
        t0 = time.monotonic()
        csr = SA.synthetic_csr(dims["n_nodes"],
                               round(dims["n_edges"] / dims["n_nodes"]),
                               dims["d_feat"], dims["n_classes"], seed=seed)
        out["host_s"]["synthetic_csr"] = time.monotonic() - t0
        sampler = SA.NeighborSampler(csr, dims["batch_nodes"],
                                     dims["fanout"], seed=seed)
        t0 = time.monotonic()
        batch, _, _ = sampler.sample(0, device=device)
        out["host_s"]["sample"] = time.monotonic() - t0
        out["csr_edges"] = int(csr.indptr[-1])
        del csr
        # the sampler emits no positions: N(0, 1) from the seed, as
        # gnn_host_args draws them
        out["pos"] = np.random.default_rng(seed).normal(
            size=(batch.n_node, 3)).astype(np.float32)
        out.update(arrays=None, batch=with_positions(batch, out["pos"]),
                   d_in=dims["d_feat"], n_out=dims["n_classes"],
                   node_level=True, rows=dims["batch_nodes"])
        return out
    out["pos"] = out["arrays"]["pos"]
    out["batch"] = from_numpy(**out["arrays"], device=device)
    return out


def with_positions(batch, pos: np.ndarray):
    """``batch`` with node positions ``pos`` [N, 3] (the dump row 0)."""
    import dataclasses
    import torch
    p = np.zeros((batch.n_node + 1, 3), np.float32)
    p[:batch.n_node] = pos
    return dataclasses.replace(
        batch, pos=torch.from_numpy(p).to(batch.nodes.device))


def gnn_model(arch: str, d_in: int, n_out: int, seed: int, device,
              n_layers: int | None = None):
    """``arch``'s CONFIG (``configs/<arch>.py``) with the shape's input
    width and outputs (``_gnn_adapt``'s convention), random weights from a
    CPU generator seeded ``seed``; ``n_layers`` cuts its depth."""
    import dataclasses
    import importlib
    import torch
    from repro_torch.models.gnn.egnn import EGNN
    from repro_torch.models.gnn.equiformer_v2 import EquiformerV2
    from repro_torch.models.gnn.nequip import NequIP
    mod = importlib.import_module(
        f"repro_torch.configs.{arch.replace('-', '_')}")
    cfg = dataclasses.replace(mod.CONFIG, d_in=d_in, n_out=n_out,
                              n_layers=min(n_layers or mod.CONFIG.n_layers,
                                           mod.CONFIG.n_layers))
    cls = {"egnn": EGNN, "nequip": NequIP, "equiformer-v2": EquiformerV2}
    return cls[arch](cfg, generator=torch.Generator().manual_seed(seed),
                     device=device)


def gnn_output(model, batch, inp):
    """The output phase G holds: graph outputs at molecule, the node
    logits (of the targets at minibatch_lg) elsewhere."""
    if inp["node_level"]:
        return model.node_forward(batch)[:inp["rows"]]
    return model(batch)[0]


def timed_calls(fn, calls: int, cuda: bool):
    """(last output, ms of each of ``calls`` calls): CUDA events on the
    card, the host clock elsewhere."""
    import torch
    ms = []
    for _ in range(calls):
        if cuda:
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            out = fn()
            b.record()
            torch.cuda.synchronize()
            ms.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            out = fn()
            ms.append(1e3 * (time.perf_counter() - t0))
    return out, ms


@contextlib.contextmanager
def messages_rotated_back_with_ds():
    """Phase G's planted fault: Equiformer-v2 rotates its messages back
    to the global frame with ``Ds`` in place of their transposes."""
    from repro_torch.models.gnn import equiformer_v2 as EQ
    inverse = EQ.inverse_wigner
    EQ.inverse_wigner = lambda Ds: Ds
    try:
        yield
    finally:
        EQ.inverse_wigner = inverse


def gnn_phase(counts, card: str, seed: int, device="cuda") -> dict:
    """Phase G (module doc): EGNN, NequIP and Equiformer-v2 at their
    CONFIG widths and depths in float32 at molecule, full_graph_sm and
    minibatch_lg; inside ``counts.path("gnn")``, which must launch no
    kernel of the port.  Returns {shape: {arch: numbers}}; raises on any
    failed check."""
    import torch
    from repro_torch.launch.steps import _gnn_flops
    cuda = torch.device(device).type == "cuda"
    rot = random_rotation(seed + 43)
    out = {}
    for shape in GNN_SHAPE_NAMES:
        inp = gnn_shape_inputs(shape, seed, device)
        batch = inp["batch"]
        rot_batch = with_positions(batch, inp["pos"] @ rot.T)
        host = dict(inp["host_s"])
        if host:
            log(f"G {shape}: synthetic_csr ({inp['csr_edges']} edges) "
                f"{host['synthetic_csr']:.3f} s, one sample "
                f"{host['sample']:.3f} s on the host")
        out[shape] = {"n_node": batch.n_node, "n_edge": batch.n_edge,
                      "live_edges": int(batch.edge_mask.sum()),
                      "host_s": host}
        for i, arch in enumerate(GNN_ARCHS):
            model = gnn_model(arch, inp["d_in"], inp["n_out"], seed + 47 + i,
                              device)
            n = {"params": sum(p.numel() for p in model.parameters()),
                 "flops": _gnn_flops(arch, model.cfg, batch.n_edge,
                                    batch.n_node)}

            def run(b=batch):
                return gnn_output(model, b, inp)
            with torch.inference_mode(), counts.path("gnn"):
                if cuda:
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    resident = torch.cuda.memory_allocated()
                first, _ = timed_calls(run, 1, cuda)
                got, ms = timed_calls(run, GNN_REPS_LG if shape ==
                                      "minibatch_lg" else GNN_REPS, cuda)
                if cuda:
                    n.update(peak_bytes=torch.cuda.max_memory_allocated(),
                             resident_bytes=resident)
                rotated = run(rot_batch)
            rows = (inp["rows"], inp["n_out"])
            if tuple(got.shape) != rows or not torch.isfinite(got).all():
                raise AssertionError(f"G {arch} at {shape}: output "
                                     f"{tuple(got.shape)}, want {rows}, "
                                     f"finite")
            n.update(ms=ms, ms_p50=float(np.median(ms)),
                     rotation_rel_l2=rel_l2(rotated, got))
            n["tflop_per_s"] = n["flops"] / n["ms_p50"] / 1e9
            if n["rotation_rel_l2"] > GNN_ROT_TOL:
                raise AssertionError(
                    f"G {arch} at {shape}: rotated positions move the "
                    f"output by {n['rotation_rel_l2']} (limit {GNN_ROT_TOL})")
            if shape == "molecule":
                n["two_launches_max_abs_err"] = check_close(
                    f"G {arch} at {shape}: two launches", got, first,
                    GNN_RTOL, GNN_ATOL)
            if arch != "equiformer-v2" and inp["arrays"] is not None:
                n["cpu"] = gnn_against_cpu(model, inp["arrays"], inp, got,
                                           f"G {arch} at {shape}")
            elif shape == "molecule":
                a = inp["arrays"]
                k = GNN_CPU_MOLECULES
                nk = int(np.searchsorted(a["graph_id"], k))
                ek = int(np.searchsorted(a["graph_id"][a["senders"]], k))
                few = dict(a, node_feat=a["node_feat"][:nk],
                           pos=a["pos"][:nk], senders=a["senders"][:ek],
                           receivers=a["receivers"][:ek],
                           graph_id=a["graph_id"][:nk], n_graph=k)
                n["cpu"] = gnn_against_cpu(
                    model, few, dict(inp, rows=k), got[:k],
                    f"G {arch} at {shape}, first {k} molecules")
                with torch.inference_mode(), messages_rotated_back_with_ds():
                    n["fault_rotation_rel_l2"] = rel_l2(run(rot_batch),
                                                        run())
                if n["fault_rotation_rel_l2"] <= GNN_ROT_TOL:
                    raise AssertionError(
                        f"G: the planted fault (messages rotated back with "
                        f"Ds) passes the rotation check: "
                        f"{n['fault_rotation_rel_l2']}")
            out[shape][arch] = n
            log(f"G {arch} at {shape} (N {batch.n_node}, E {batch.n_edge}, "
                f"{n['params']} parameters): forward p50 {n['ms_p50']:.3f} "
                f"ms of {json.dumps([round(t, 3) for t in ms])}, "
                f"{n['tflop_per_s']:.2f} TFLOP/s of the reference's "
                f"{n['flops']:.4g}, peak {n.get('peak_bytes', 0)} B "
                f"(resident {n.get('resident_bytes', 0)} B); rotation "
                f"{n['rotation_rel_l2']:.3g} (limit {GNN_ROT_TOL})"
                + (f", planted fault {n['fault_rotation_rel_l2']:.3g}"
                   if "fault_rotation_rel_l2" in n else "")
                + (f"; card vs CPU in {n['cpu']['precision']} max |diff| "
                   f"{n['cpu']['max_abs_err']:.3g} (float32 "
                   f"{n['cpu']['f32_max_abs_err']:.3g}; the CPU's float32 "
                   f"vs float64 {n['cpu']['cpu_f32_vs_f64']:.3g}, outputs "
                   f"up to {n['cpu']['max_abs_output']:.4g})"
                   if "cpu" in n else "")
                + (f"; two launches {n['two_launches_max_abs_err']:.3g}"
                   if "two_launches_max_abs_err" in n else "")
                + f" on {card}")
            del model, first, got, rotated, run
            release(device)
        del inp, batch, rot_batch
        release(device)
    if any(counts.by_path["gnn"].values()):
        raise AssertionError(f"the gnn path launched a kernel of the port: "
                             f"{counts.by_path['gnn']}")
    return out


def gnn_cast(model, dtype, device):
    """A copy of a GNN module with its parameters in ``dtype`` on
    ``device`` (its CG and index buffers built anew there)."""
    import dataclasses
    import torch
    copy = type(model)(dataclasses.replace(model.cfg, dtype=dtype),
                       generator=torch.Generator().manual_seed(0),
                       device=device)
    copy.load_state_dict(model.state_dict())
    return copy


def gnn_against_cpu(model, arrays: dict, inp: dict, card_out,
                    tag: str) -> dict:
    """The card's float32 output ``card_out`` for the graph of
    ``arrays`` against the same module's on the CPU (its parameters
    copied), within GNN_RTOL / GNN_ATOL.

    Where float32 does not resolve the output to that tolerance -- the
    CPU's own float32 output misses it against a float64 run of the
    same module (EGNN at full_graph_sm: its random-weight coordinate
    updates grow to ~5e6) -- the card and the CPU are held in float64
    instead, the float32 readings printed beside.  Returns the readings;
    raises when the comparison held misses."""
    import torch
    from repro_torch.models.gnn.graph import from_numpy
    wide = dict(arrays, node_feat=arrays["node_feat"].astype(np.float64),
                pos=arrays["pos"].astype(np.float64))
    with torch.inference_mode():
        want = gnn_output(gnn_cast(model, torch.float32, "cpu"),
                          from_numpy(**arrays, device="cpu"), inp)
        exact = gnn_output(gnn_cast(model, torch.float64, "cpu"),
                           from_numpy(**wide, device="cpu"), inp)
    got = card_out.cpu().double()
    out = {"f32_max_abs_err": float((got - want.double()).abs().max()),
           "cpu_f32_vs_f64": float((want.double() - exact).abs().max()),
           "max_abs_output": float(exact.abs().max())}
    if torch.allclose(want.double(), exact, rtol=GNN_RTOL, atol=GNN_ATOL):
        out["precision"] = "float32"
        out["max_abs_err"] = check_close(f"{tag}: card vs CPU", card_out.cpu(),
                                         want, GNN_RTOL, GNN_ATOL)
        return out
    dev = card_out.device
    with torch.inference_mode():
        card64 = gnn_output(gnn_cast(model, torch.float64, dev),
                            from_numpy(**wide, device=dev), inp)
    out["precision"] = "float64"
    out["max_abs_err"] = check_close(
        f"{tag}: card vs CPU in float64 (float32 resolves the output to "
        f"{out['cpu_f32_vs_f64']:.3g} only)", card64.cpu(), exact, GNN_RTOL,
        GNN_ATOL)
    return out


# -- R and T: DIEN serving, one-card training ---------------------------------
def tensors(batch: dict, device) -> dict:
    """A numpy batch as tensors on ``device``."""
    import torch
    return {k: torch.from_numpy(np.asarray(v)).to(device)
            for k, v in batch.items()}


def dien_inputs(cfg, step: int, b: int, seed: int, device) -> dict:
    """``dien_batch(step, b, ...)`` of ``cfg`` as tensors on ``device``."""
    from repro_torch.data.pipelines import dien_batch
    return tensors(dien_batch(step, b, cfg.seq_len, cfg.n_items, cfg.n_cates,
                              cfg.n_profile_vocab, cfg.profile_bags,
                              cfg.bag_size, seed=seed), device)


def on_cpu(tree):
    """A tree of tensors copied to the CPU."""
    from repro_torch.train.optimizer import tree_map
    return tree_map(lambda x: x.detach().cpu(), tree)


@contextlib.contextmanager
def augru_attention_one():
    """Phase R's first planted fault: the AUGRU's attention replaced by
    1 (the evolution layer a plain GRU)."""
    import torch
    from repro_torch.models import dien as D
    run = D.run_augru
    D.run_augru = lambda p, xs, att, mask: run(
        p, xs, torch.ones_like(att), mask)
    try:
        yield
    finally:
        D.run_augru = run


@contextlib.contextmanager
def gru_ignores_mask():
    """Phase R's second planted fault: the extractor GRU steps through
    the padded positions of every history."""
    import torch
    from repro_torch.models import dien as D
    run = D.run_gru
    D.run_gru = lambda p, xs, mask: run(
        p, xs, torch.ones_like(mask))
    try:
        yield
    finally:
        D.run_gru = run


def misses(tag, fn, want, rtol, atol) -> float:
    """max |fn() - want| of a planted fault, which must miss rtol /
    atol."""
    import torch
    got = fn().detach().cpu().double()
    err = float((got - want.double()).abs().max())
    if torch.allclose(got, want.double(), rtol=rtol, atol=atol):
        raise AssertionError(f"{tag}: the planted fault passes the check "
                             f"(max |diff| {err})")
    return err


def recsys_phase(counts, card: str, seed: int, device="cuda") -> dict:
    """Phase R (module doc): DIEN's CONFIG serving at serve_p99,
    serve_bulk and retrieval_cand, inside ``counts.path("recsys")``,
    which must launch no kernel of the port.  Returns the numbers;
    raises on any failed check."""
    import torch
    from repro_torch.configs.common import RECSYS_SHAPES
    from repro_torch.configs.dien import CONFIG
    from repro_torch.models import dien as D
    from repro_torch.train.checkpoint import flatten
    cuda = torch.device(device).type == "cuda"
    cfg = CONFIG
    gen = torch.Generator(device).manual_seed(seed + 61)
    params = D.init_params(cfg, generator=gen, device=device)
    host = on_cpu(params)
    out = {"params": sum(x.numel() for x in flatten(params)[0])}
    dims = {k: s.dims for k, s in RECSYS_SHAPES.items()}
    # serve_p99: p50 / p99 of forward calls, held against the CPU
    b = dims["serve_p99"]["batch"]
    batch = dien_inputs(cfg, 0, b, seed, device)
    with torch.inference_mode(), counts.path("recsys"):
        first = D.forward(params, batch, cfg)
        got, ms = timed_calls(lambda: D.forward(params, batch, cfg),
                              R_P99_CALLS, cuda)
    cpu_batch = {k: v.cpu() for k, v in batch.items()}
    with torch.inference_mode():
        want = D.forward(host, cpu_batch, cfg)
        if not torch.equal(first, got):
            raise AssertionError("R serve_p99: two launches differ")
        err = check_close("R serve_p99: card vs CPU", got.cpu(), want,
                          R_RTOL, R_ATOL)
        faults = {}
        with augru_attention_one():
            faults["augru_attention_one"] = misses(
                "R: AUGRU attention 1", lambda: D.forward(params, batch, cfg),
                want, R_RTOL, R_ATOL)
    out["serve_p99"] = {"batch": b, "ms_p50": float(np.percentile(ms, 50)),
                        "ms_p99": float(np.percentile(ms, 99)),
                        "ms_mean": float(np.mean(ms)), "calls": len(ms),
                        "max_abs_err": err, "max_abs_logit":
                        float(want.abs().max()), "faults": faults}
    log(f"R serve_p99 (B {b}): forward p50 {out['serve_p99']['ms_p50']:.3f} "
        f"ms, p99 {out['serve_p99']['ms_p99']:.3f} ms over {len(ms)} calls; "
        f"card vs CPU max |diff| {err:.3g} (rtol {R_RTOL}, atol {R_ATOL}; "
        f"logits up to {out['serve_p99']['max_abs_logit']:.3g}), two "
        f"launches bitwise equal; planted fault {json.dumps(faults)} on "
        f"{card}")
    late = {k: v[:8].clone() for k, v in batch.items()}
    del batch, cpu_batch, first, got, want
    release(device)
    # serve_bulk: seconds a call, examples/s, peak memory
    b = dims["serve_bulk"]["batch"]
    t0 = time.monotonic()
    batch = dien_inputs(cfg, 1, b, seed, device)
    host_s = time.monotonic() - t0
    with torch.inference_mode(), counts.path("recsys"):
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated()
        bulk, ms = timed_calls(lambda: D.forward(params, batch, cfg),
                               R_BULK_CALLS, cuda)
    if tuple(bulk.shape) != (b,) or not torch.isfinite(bulk).all():
        raise AssertionError(f"R serve_bulk: logits {tuple(bulk.shape)}, "
                             f"want ({b},), finite")
    out["serve_bulk"] = {"batch": b, "s_per_call": [t / 1e3 for t in ms],
                         "examples_per_s": b / (np.median(ms) / 1e3),
                         "batch_host_s": host_s}
    if cuda:
        out["serve_bulk"].update(
            peak_bytes=torch.cuda.max_memory_allocated(),
            resident_bytes=resident)
    log(f"R serve_bulk (B {b}): {json.dumps(out['serve_bulk'])} on {card}")
    del batch, bulk
    release(device)
    # retrieval_cand: one user against n candidates drawn as
    # dien_host_args draws them
    n = dims["retrieval_cand"]["n_candidates"]
    user = dien_inputs(cfg, 2, dims["retrieval_cand"]["batch"], seed, device)
    r = np.random.default_rng(seed)
    cand = tensors({"item": r.integers(0, cfg.n_items, (n,)).astype(np.int32),
                    "cate": r.integers(0, cfg.n_cates, (n,)).astype(np.int32)},
                   device)
    with torch.inference_mode(), counts.path("recsys"):
        scores, ms = timed_calls(
            lambda: D.retrieval_scores(params, user, cand, cfg),
            R_RETRIEVAL_CALLS, cuda)
    faults = {}
    with torch.inference_mode():
        want = D.retrieval_scores(host, {k: v.cpu() for k, v in user.items()},
                                  {k: v.cpu() for k, v in cand.items()}, cfg)
        err = check_close("R retrieval_cand: card vs CPU", scores.cpu(),
                          want, R_RTOL, R_ATOL)
        # dien_batch's masks are prefixes, after which a GRU that ignores
        # the mask changes no state the model reads (the attention masks
        # the padded steps out, the AUGRU's weight there is 0, retrieval
        # reads the last valid state).  The mask shows where the padding
        # comes first: 8 serve_p99 users with their masks reversed,
        # scored against the same candidates, first without the fault.
        late["hist_mask"] = late["hist_mask"].flip(-1)
        cpu_late = {k: v.cpu() for k, v in late.items()}
        cpu_cand = {k: v.cpu() for k, v in cand.items()}
        want_late = D.retrieval_scores(host, cpu_late, cpu_cand, cfg)
        err = max(err, check_close(
            "R retrieval, masks reversed: card vs CPU",
            D.retrieval_scores(params, late, cand, cfg).cpu(), want_late,
            R_RTOL, R_ATOL))
        with gru_ignores_mask():
            faults["gru_ignores_mask"] = misses(
                "R: GRU without hist_mask (masks reversed)",
                lambda: D.retrieval_scores(params, late, cand, cfg),
                want_late, R_RTOL, R_ATOL)
    out["retrieval_cand"] = {"n_candidates": n,
                             "ms_p50": float(np.median(ms)),
                             "ms": ms, "max_abs_err": err,
                             "max_abs_score": float(want.abs().max()),
                             "faults": faults}
    log(f"R retrieval_cand ({n} candidates): p50 "
        f"{out['retrieval_cand']['ms_p50']:.3f} ms; card vs CPU max |diff| "
        f"{err:.3g} (scores up to "
        f"{out['retrieval_cand']['max_abs_score']:.3g}); planted fault "
        f"{json.dumps(faults)} on {card}")
    del params, host, user, cand, scores, want, late
    release(device)
    if any(counts.by_path["recsys"].values()):
        raise AssertionError(f"the recsys path launched a kernel of the "
                             f"port: {counts.by_path['recsys']}")
    return out


@contextlib.contextmanager
def deterministic():
    """``torch.use_deterministic_algorithms(True)`` (and the cuBLAS
    workspace setting it asks for) over the enclosed block."""
    import torch
    env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)
        if env is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = env


def timed_run(params, loss_fn, data_fn, steps: int, device, **loop_kw):
    """``loop.run`` for ``steps`` AdamW steps: (params, state, history,
    seconds of each step, peak device bytes).  A step's seconds run from
    its ``data_fn`` call to the next step's (the loop reads each step's
    loss before it goes on), the last to the run's return."""
    import torch
    from repro_torch.train import loop as L
    from repro_torch.train.optimizer import AdamWConfig
    marks = []

    def data(step):
        marks.append(time.monotonic())
        return data_fn(step)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    fail = loop_kw.pop("fail_after", None)
    kw = dict(log_every=1)
    kw.update(loop_kw)
    try:
        p, st, hist = L.run(params, loss_fn, data, AdamWConfig(),
                            L.LoopConfig(total_steps=steps, **kw),
                            fail_after=fail)
    finally:
        marks.append(time.monotonic())
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    return p, st, hist, list(np.diff(marks)), peak


def grads_against(tag, card, cpu, rtol, atol) -> float:
    """Every gradient leaf of ``card`` within rtol / atol of ``cpu``'s;
    returns the largest |diff|."""
    from repro_torch.train.checkpoint import flatten
    return max(check_close(f"{tag} ({i})", a.detach().cpu(), b, rtol, atol)
               for i, (a, b) in enumerate(zip(flatten(card)[0],
                                              flatten(cpu)[0])))


def leaf_rel_l2(card, cpu) -> float:
    """The largest relative L2 error of a leaf of ``card`` against
    ``cpu`` (0 for a leaf that is zero in both)."""
    from repro_torch.train.checkpoint import flatten
    worst = 0.0
    for a, b in zip(flatten(card)[0], flatten(cpu)[0]):
        a, b = a.detach().cpu().double(), b.double()
        d, n = float((a - b).norm()), float(b.norm())
        worst = max(worst, d / n if n else d)
    return worst


def same_bits(a_tree, b_tree) -> bool:
    import torch
    from repro_torch.train.checkpoint import flatten
    return all(torch.equal(a, b) for a, b in zip(flatten(a_tree)[0],
                                                 flatten(b_tree)[0]))


def max_leaf_diff(a_tree, b_tree) -> float:
    from repro_torch.train.checkpoint import flatten
    return max(float((a.double() - b.double()).abs().max())
               for a, b in zip(flatten(a_tree)[0], flatten(b_tree)[0]))


def step_numbers(hist, step_s, peak: int, items: int) -> dict:
    """s/step (the median after the first), items/s and the history."""
    steady = step_s[1:] or step_s
    s = float(np.median(steady))
    return {"s_per_step": s, "step_s": step_s, "items_per_s": items / s,
            "peak_bytes": peak, "loss": [h["loss"] for h in hist],
            "grad_norm": [h["grad_norm"] for h in hist],
            "skipped": int(sum(h["skipped"] for h in hist))}


def dien_train(counts, card: str, seed: int, device) -> dict:
    """Phase T's DIEN part (module doc)."""
    import dataclasses
    import shutil
    import torch
    from repro_torch.configs.common import RECSYS_SHAPES
    from repro_torch.configs.dien import CONFIG
    from repro_torch.models import dien as D
    from repro_torch.train import loop as L
    cfg = CONFIG
    b = RECSYS_SHAPES["train_batch"].dims["batch"]
    gen = torch.Generator(device).manual_seed(seed + 67)
    params = D.init_params(cfg, generator=gen, device=device)
    loss_fn = D.make_train_loss(cfg)
    t0 = time.monotonic()
    batches = [dien_inputs(cfg, s, b, seed, device)
               for s in range(T_DIEN_STEPS)]
    host_s = time.monotonic() - t0
    out = {"batch": b, "batches_host_s": host_s}
    # the first step on T_DIEN_CHECK_ROWS rows against the CPU
    rows = {k: v[:T_DIEN_CHECK_ROWS] for k, v in batches[0].items()}
    host = on_cpu(params)
    cpu_rows = {k: v.cpu() for k, v in rows.items()}
    loss, grads = L.value_and_grad(loss_fn, params, rows)
    want_loss, want = L.value_and_grad(loss_fn, host, cpu_rows)
    err = max(check_close("T dien first-step loss: card vs CPU", loss.cpu(),
                          want_loss, T_DIEN_RTOL, T_DIEN_ATOL),
              grads_against("T dien first-step gradients: card vs CPU",
                            grads, want, T_DIEN_RTOL, T_DIEN_ATOL))
    no_aux = D.make_train_loss(dataclasses.replace(cfg, aux_weight=0.0))
    fault = misses("T dien: the loss without its aux term",
                   lambda: L.value_and_grad(no_aux, params, rows)[0],
                   want_loss, T_DIEN_RTOL, T_DIEN_ATOL)
    out["check"] = {"rows": T_DIEN_CHECK_ROWS, "max_abs_err": err,
                    "loss": float(want_loss), "fault_no_aux": fault}
    del grads, want, host, rows, cpu_rows
    release(device)

    def data(step):
        return batches[step]
    with counts.path("train"):
        p_a, _, hist, step_s, peak = timed_run(params, loss_fn, data,
                                               T_DIEN_STEPS, device)
    out.update(step_numbers(hist, step_s, peak, b))
    if not all(np.isfinite(out["loss"])) or out["skipped"]:
        raise AssertionError(f"T dien: losses {out['loss']}, "
                             f"{out['skipped']} steps skipped")
    log(f"T dien (B {b}): {out['s_per_step']:.4f} s/step of "
        f"{json.dumps([round(t, 4) for t in step_s])}, "
        f"{out['items_per_s']:.1f} examples/s, peak {peak} B, losses "
        f"{json.dumps(out['loss'])}; first step on {T_DIEN_CHECK_ROWS} rows "
        f"card vs CPU max |diff| {err:.3g} (rtol {T_DIEN_RTOL}, atol "
        f"{T_DIEN_ATOL}), without the aux term {fault:.3g} on {card}")
    # restart equivalence: FailAfter(2), then a resume from the
    # checkpoint, against an uninterrupted run
    restart = {}
    for mode in ("deterministic", "default"):
        ctx = deterministic() if mode == "deterministic" else \
            contextlib.nullcontext()
        d = fleet_dir()
        with ctx:
            t0 = time.monotonic()
            if mode == "deterministic":
                whole = p_det = timed_run(params, loss_fn, data,
                                          T_DIEN_STEPS, device)[0]
            else:
                whole = p_a
            try:
                timed_run(params, loss_fn, data, T_DIEN_STEPS, device,
                          ckpt_dir=d, ckpt_every=1,
                          fail_after=L.FailAfter(2))
                raise AssertionError("T dien: FailAfter(2) did not fail")
            except RuntimeError as e:
                if "injected failure" not in str(e):
                    raise
            resumed = timed_run(params, loss_fn, data, T_DIEN_STEPS, device,
                                ckpt_dir=d, ckpt_every=1)[0]
        restart[mode] = {"bitwise": same_bits(resumed, whole),
                         "max_abs_diff": max_leaf_diff(resumed, whole),
                         "s": time.monotonic() - t0}
        shutil.rmtree(d, ignore_errors=True)
        del whole, resumed
        release(device)
    # the uninterrupted runs with and without the setting
    restart["default_run_equals_deterministic_run"] = same_bits(p_a, p_det)
    restart["default_vs_deterministic_max_abs_diff"] = max_leaf_diff(p_a,
                                                                     p_det)
    out["restart"] = restart
    log(f"T dien restart equivalence (FailAfter(2), resume): "
        f"{json.dumps(restart)} on {card}")
    if not restart["deterministic"]["bitwise"]:
        raise AssertionError(f"T dien: the resumed run differs from the "
                             f"uninterrupted one under deterministic "
                             f"algorithms: {restart['deterministic']}")
    del params, p_a, p_det, batches
    release(device)
    return out


def gqa_train_without_mask(p, x, cfg, positions):
    """T's planted fault: ``gqa_train`` attending to every position,
    later ones included (no causal mask)."""
    import torch
    from repro_torch.models import attention as A
    b, t, _ = x.shape
    hq, dh = cfg.padded_heads, cfg.d_head
    q, k, v = A._proj_qkv_gqa(p, x, cfg, positions)
    k_full, v_full = A._expand_kv(k, cfg), A._expand_kv(v, cfg)
    scores = torch.einsum("bthd,bshd->bhts", q, k_full) / float(np.sqrt(dh))
    probs = torch.softmax(scores.float(), dim=-1).to(x.dtype)
    ctx = torch.einsum("bhts,bshd->bthd", probs, v_full).reshape(b, t, hq * dh)
    return ctx @ p["wo"], (k, v)


@contextlib.contextmanager
def causal_mask_dropped():
    """T's planted fault in place of ``attention.gqa_train``."""
    from repro_torch.models import attention as A
    train = A.gqa_train
    A.gqa_train = gqa_train_without_mask
    try:
        yield
    finally:
        A.gqa_train = train


def lm_train(counts, card: str, seed: int, device) -> dict:
    """Phase T's qwen2-1.5b part (module doc)."""
    import dataclasses
    import torch
    from repro_torch.configs.common import LM_SHAPES
    from repro_torch.configs.qwen2_1_5b import CONFIG
    from repro_torch.data.pipelines import lm_batch
    from repro_torch.launch.steps import _lm_flops
    from repro_torch.models import transformer as tf
    from repro_torch.train import loop as L
    cfg = dataclasses.replace(CONFIG, tp=1)
    dims = LM_SHAPES["train_4k"].dims
    t, b = dims["seq_len"], T_LM_BATCH
    out = {"reduced": [f"global_batch {dims['global_batch']}->{b}"],
           "seq": t, "batch": b, "remat": cfg.remat}
    gen = torch.Generator(device).manual_seed(seed + 71)
    params = tf.init_params(cfg, generator=gen, device=device)
    batches = [tensors(lm_batch(s, b, t, cfg.vocab, seed=seed), device)
               for s in range(T_LM_STEPS)]
    with counts.path("train"):
        p_run, _, hist, step_s, peak = timed_run(
            params, tf.make_train_loss(cfg), lambda s: batches[s],
            T_LM_STEPS, device)
    del p_run
    release(device)
    if torch.device(device).type == "cuda":     # B4b: one step, counted
        from repro_torch.train import optimizer as opt
        out["b4"] = counted_against_meta(
            "qwen2-1.5b/train_4k", L.make_train_step_fn(
                tf.make_train_loss(cfg), opt.AdamWConfig()),
            (params, opt.init(params, opt.AdamWConfig()), batches[0]),
            device)
        release(device)
    out.update(step_numbers(hist, step_s, peak, b * t))
    out["flops_per_step"] = _lm_flops(cfg, b * t, t, train=True)
    out["bf16_peak_share"] = (out["flops_per_step"] / out["s_per_step"]
                              / BF16_DENSE_OPS_PER_S)
    if not all(np.isfinite(out["loss"])) or out["skipped"]:
        raise AssertionError(f"T qwen2-1.5b: losses {out['loss']}, "
                             f"{out['skipped']} steps skipped")
    log(f"T qwen2-1.5b (CONFIG, tp 1, bf16, remat; {b} x {t}, reduced "
        f"{json.dumps(out['reduced'])}): {out['s_per_step']:.4f} s/step of "
        f"{json.dumps([round(x, 4) for x in step_s])}, "
        f"{out['items_per_s']:.1f} tokens/s, {out['bf16_peak_share']:.4f} "
        f"of the dense bf16 peak by the reference's reckoning "
        f"({out['flops_per_step']:.4g} a step), peak {peak} B, losses "
        f"{json.dumps(out['loss'])} on {card}")
    # the check: the first layers in float32 against the CPU
    small = dataclasses.replace(cfg, n_layers=T_CHECK_LAYERS,
                                param_dtype=torch.float32,
                                act_dtype=torch.float32)
    p32 = float32_layers(params, T_CHECK_LAYERS)
    del params, batches
    release(device)
    host = on_cpu(p32)
    batch = tensors(lm_batch(0, T_CHECK_BATCH, T_CHECK_SEQ, cfg.vocab,
                             seed=seed + 1), device)
    cpu_batch = {k: v.cpu() for k, v in batch.items()}
    loss_fn = tf.make_train_loss(small)
    loss, grads = L.value_and_grad(loss_fn, p32, batch)
    want_loss, want = L.value_and_grad(loss_fn, host, cpu_batch)

    def reading(l, g):
        return max(abs(float(l) - float(want_loss)) / abs(float(want_loss)),
                   leaf_rel_l2(g, want))
    check = {"rel_l2": reading(loss, grads), "loss": float(want_loss)}
    with causal_mask_dropped():
        check["fault_no_causal_mask"] = reading(
            *L.value_and_grad(loss_fn, p32, batch))
    with deterministic():
        on = L.value_and_grad(loss_fn, p32, batch)
        off = L.value_and_grad(tf.make_train_loss(dataclasses.replace(
            small, remat=False)), p32, batch)
    check["remat_bitwise"] = bool(torch.equal(on[0], off[0])
                                  and same_bits(on[1], off[1]))
    out["check"] = check
    log(f"T qwen2-1.5b check ({T_CHECK_LAYERS} layers, float32, "
        f"{T_CHECK_BATCH} x {T_CHECK_SEQ}): loss and gradients card vs CPU "
        f"relative L2 {check['rel_l2']:.3g} (limit {T_CHECK_REL_TOL}), "
        f"without the causal mask {check['fault_no_causal_mask']:.3g}; "
        f"remat on and off bitwise equal: {check['remat_bitwise']} on {card}")
    if check["rel_l2"] > T_CHECK_REL_TOL:
        raise AssertionError(f"T qwen2-1.5b: card vs CPU {check['rel_l2']}")
    if check["fault_no_causal_mask"] <= T_CHECK_REL_TOL:
        raise AssertionError("T qwen2-1.5b: the planted fault (no causal "
                             "mask) passes the check")
    if not check["remat_bitwise"]:
        raise AssertionError("T qwen2-1.5b: remat on and off differ")
    del p32, host, grads, want, on, off
    release(device)
    return out


def gnn_train(counts, card: str, seed: int, device) -> dict:
    """Phase T's GNN part (module doc)."""
    import importlib
    import torch
    from repro_torch.configs.common import GNN_SHAPES
    from repro_torch.data.pipelines import molecule_batch
    from repro_torch.models.gnn.graph import from_numpy
    from repro_torch.train import loop as L
    dims = GNN_SHAPES["molecule"].dims
    mol = molecule_batch(0, dims["batch"], dims["n_nodes"], dims["n_edges"],
                         dims["d_feat"], seed=seed)
    keys = ("node_feat", "senders", "receivers", "pos", "graph_id",
            "n_graph")
    arrays = {k: mol[k] for k in keys}
    batch = from_numpy(**arrays, device=device)
    target = torch.from_numpy(mol["targets"]).to(device)
    k = GNN_CPU_MOLECULES
    nk = int(np.searchsorted(arrays["graph_id"], k))
    ek = int(np.searchsorted(arrays["graph_id"][arrays["senders"]], k))
    few = dict(arrays, node_feat=arrays["node_feat"][:nk],
               pos=arrays["pos"][:nk], senders=arrays["senders"][:ek],
               receivers=arrays["receivers"][:ek],
               graph_id=arrays["graph_id"][:nk], n_graph=k)
    out = {}
    for i, arch in enumerate(GNN_ARCHS):
        mod = importlib.import_module(
            f"repro_torch.models.gnn.{arch.replace('-', '_')}")
        model = gnn_model(arch, dims["d_feat"], 1, seed + 73 + i, device)
        params = {n: p.detach() for n, p in model.named_parameters()}
        loss_fn = mod.make_loss(model)
        with counts.path("train"):
            _, _, hist, step_s, peak = timed_run(
                params, loss_fn, lambda s: (batch, target), T_GNN_STEPS,
                device)
        n = step_numbers(hist, step_s, peak, dims["batch"])
        # the first step on the first k molecules against the CPU
        inputs = (from_numpy(**few, device=device), target[:k])
        first = L.value_and_grad(loss_fn, params, inputs)
        n["check"] = gnn_grads_against_cpu(model, mod, few, target[:k].cpu(),
                                           first, f"T {arch}")
        out[arch] = n
        log(f"T {arch} (molecule, {dims['batch']} x {dims['n_nodes']}): "
            f"{n['s_per_step']:.4f} s/step of "
            f"{json.dumps([round(x, 4) for x in step_s])}, peak {peak} B, "
            f"losses {json.dumps(n['loss'])}; first step on {k} molecules "
            f"card vs CPU in {n['check']['precision']} max |diff| "
            f"{n['check']['max_abs_err']:.3g} (float32 "
            f"{n['check']['f32_max_abs_err']:.3g}; the CPU's float32 vs "
            f"float64 {n['check']['cpu_f32_vs_f64']:.3g}) on {card}")
        if not all(np.isfinite(n["loss"])) or n["skipped"]:
            raise AssertionError(f"T {arch}: losses {n['loss']}")
        del model, params, first
        release(device)
    return out


def gnn_grads_against_cpu(model, mod, arrays, target, card, tag) -> dict:
    """The card's float32 loss and gradients ``card`` of ``model`` on the
    graph of ``arrays`` against the same module's on the CPU, at G's
    tolerances; in float64 on both where the CPU's float32 misses its
    own float64 (as ``gnn_against_cpu`` holds the forward)."""
    import torch
    from repro_torch.models.gnn.graph import from_numpy
    from repro_torch.train import loop as L
    from repro_torch.train.checkpoint import flatten
    wide = dict(arrays, node_feat=arrays["node_feat"].astype(np.float64),
                pos=arrays["pos"].astype(np.float64))

    def run(dtype, device, arr, tgt):
        m = gnn_cast(model, dtype, device)
        params = {n: p.detach() for n, p in m.named_parameters()}
        return L.value_and_grad(mod.make_loss(m), params,
                                (from_numpy(**arr, device=device),
                                 tgt.to(device=device, dtype=dtype)))

    def flat(lg):
        return torch.cat([lg[0].reshape(1).double().cpu()] +
                         [g.detach().reshape(-1).double().cpu()
                          for g in flatten(lg[1])[0]])
    want = flat(run(torch.float32, "cpu", arrays, target))
    exact = flat(run(torch.float64, "cpu", wide, target))
    got = flat(card)
    out = {"f32_max_abs_err": float((got - want).abs().max()),
           "cpu_f32_vs_f64": float((want - exact).abs().max()),
           "max_abs": float(exact.abs().max())}
    if torch.allclose(want, exact, rtol=GNN_RTOL, atol=GNN_ATOL):
        out["precision"] = "float32"
        out["max_abs_err"] = check_close(f"{tag}: card vs CPU", got, want,
                                         GNN_RTOL, GNN_ATOL)
        return out
    card64 = flat(run(torch.float64, card[0].device, wide, target))
    out["precision"] = "float64"
    out["max_abs_err"] = check_close(
        f"{tag}: card vs CPU in float64 (float32 resolves the CPU's "
        f"gradients to {out['cpu_f32_vs_f64']:.3g} only)", card64, exact,
        GNN_RTOL, GNN_ATOL)
    return out


def train_phase(counts, card: str, seed: int, device="cuda") -> dict:
    """Phase T (module doc): DIEN at train_batch, qwen2-1.5b at train_4k
    (cut), the GNNs at molecule; the train path must launch no kernel of
    the port."""
    out = {"dien": dien_train(counts, card, seed, device),
           "qwen2-1.5b": lm_train(counts, card, seed, device),
           "gnn": gnn_train(counts, card, seed, device)}
    if any(counts.by_path["train"].values()):
        raise AssertionError(f"the train path launched a kernel of the "
                             f"port: {counts.by_path['train']}")
    return out


def l2_rate(device, calls: int = 50):
    """(bytes/s, {probe: bytes/s}): the rate at which PyTorch kernels move
    a float32 tensor of L2_PROBE_BYTES that stays in the 50 MB L2 from
    call to call, from each kernel's device time in a ``torch.profiler``
    trace.  Probes: sums of rows of 1024 (reads), and a copy into a
    second such tensor (its reads and writes counted).  The faster is a
    lower bound on L2's rate (neither need reach it)."""
    import torch
    x = torch.randn(L2_PROBE_BYTES // 4, device=device)
    y = torch.empty_like(x)
    probes = {"row sums": (lambda: x.view(-1, 1024).sum(dim=1),
                           L2_PROBE_BYTES),
              "copy": (lambda: y.copy_(x), 2 * L2_PROBE_BYTES)}
    rates = {}
    for name, (fn, nbytes) in probes.items():
        fn()
        by = device_trace(lambda: [fn() for _ in range(calls)], calls)[2]
        rates[name] = nbytes / (max(by.values()) * 1e-3)
    return max(rates.values()), rates


def sector_bytes(ids, table):
    """Bytes of the 32-byte L2 sectors that embedding_bag's row reads
    span, each slot's row once per occurrence (the table's rows laid out
    from an address aligned to 32 bytes)."""
    import torch
    v1, d = table.shape
    rb = d * table.element_size()
    wrapped = torch.where(ids < 0, ids + v1, ids).long()
    rows = torch.where((wrapped >= 0) & (wrapped < v1 - 1), wrapped, v1 - 1)
    start = rows * rb
    return 32 * int(((start + rb - 1) // 32 - start // 32 + 1).sum())


def device_events(fn, expect=None, tries: int = 5):
    """The device events (kernels, copies; no annotations) of ``fn()`` in
    a ``torch.profiler`` trace.  On this card the tracer has now and then
    returned a trace with none of them, so the trace is taken again, up
    to ``tries`` times, until it holds some -- or, with ``expect`` (a
    kernel-name prefix, a count), exactly that many of those kernels.
    [] when no trace does."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)
                  and not e.name.startswith("ProfilerStep")]
        if expect is None and events or expect is not None and sum(
                kernel_name(e.name).startswith(expect[0])
                for e in events) == expect[1]:
            return events
    return []


def device_trace(fn, per: int = 1, expect=None):
    """(ms the card was busy, ms from its first device event's start to
    its last's end, {kernel name: device ms / per}) while ``fn()`` ran,
    from one ``torch.profiler`` trace (:func:`device_events`): busy is
    the union of the device events' intervals, ``per`` the steps ``fn``
    makes.  (None, None, {}) when no trace holds the device events."""
    events = device_events(fn, expect)
    if not events:
        return None, None, {}
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, (lo, hi) = 0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy, lo = busy + hi - lo, a
        hi = max(hi, b)
    busy += hi - lo
    by_kernel = {}
    for e in events:
        name = kernel_name(e.name)
        by_kernel[name] = by_kernel.get(name, 0.0) + (
            e.time_range.end - e.time_range.start) / 1e3 / per
    return (busy / 1e3, (max(b for _, b in spans) - spans[0][0]) / 1e3,
            by_kernel)


def kernel_name(raw: str) -> str:
    """A kernel's name as a trace shows it, without its return type,
    anonymous namespaces and parameters: ``flash_decode_mma<128>``."""
    name = raw.replace("(anonymous namespace)::", "").replace("void ", "")
    return name.split("(")[0]


def graph_ms(fn, calls: int = 20, reps: int = 20) -> float:
    """Device ms per call of ``fn()``: ``calls`` calls captured in one CUDA
    graph, the graph replayed ``reps`` times between CUDA events.  The
    replays run the calls' kernels back to back with no host work between
    them, so a call that is host-bound back to back (a small kernel behind
    its wrapper's Python) shows what the card spends on it."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    ms = cuda_ms(graph.replay, reps) / calls
    del graph
    return ms


def check_close(tag, got, want, rtol, atol):
    """allclose in float64 on the card; returns max |got - want|."""
    import torch
    if got.shape != want.shape:
        raise AssertionError(f"{tag}: shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)}")
    g, w = got.double(), want.double()
    if not torch.isfinite(g).all():
        raise AssertionError(f"{tag}: non-finite output")
    err = float((g - w).abs().max()) if g.numel() else 0.0
    if not torch.allclose(g, w, rtol=rtol, atol=atol):
        raise AssertionError(f"{tag}: max |diff| {err} beyond rtol {rtol}, "
                             f"atol {atol}")
    return err


def bound_ms(nbytes: int, ops: int, ops_per_s: float = SCALAR_OPS_PER_S):
    """(bound ms, what bounds it): the larger of bytes over the memory
    rate and operations over the peak rate."""
    bytes_ms, ops_ms = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / ops_per_s
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def live_edges(graph):
    """Live directed edge slots (src, dst) of the card's edge list."""
    src, dst = graph.src[:graph.m2].long(), graph.dst[:graph.m2].long()
    live = src != graph.n
    return src[live], dst[live]


def bfs_betweenness(graph, pairs_s, pairs_t):
    """Pair dependencies of every vertex, float64 [n], from one
    ``plain_spc_bfs`` per distinct pair endpoint (no labels): the
    oracle of the maintained betweenness."""
    import torch
    from repro_torch.core.bfs import plain_spc_bfs
    n = graph.n
    rows = {int(u): plain_spc_bfs(graph, int(u))
            for u in np.unique(np.concatenate([pairs_s, pairs_t]))}
    vs = torch.arange(n, device=graph.device)
    bc = torch.zeros(n, dtype=torch.float64, device=graph.device)
    for s, t in zip(pairs_s.tolist(), pairs_t.tolist()):
        ds, cs = rows[s].dist[:n].long(), rows[s].cnt[:n]
        dt, ct = rows[t].dist[:n].long(), rows[t].cnt[:n]
        d_st = int(ds[t])
        if d_st >= (1 << 28):
            continue
        on = (ds + dt == d_st) & (vs != s) & (vs != t)
        bc += torch.where(on, cs.double() * ct.double() / float(cs[t]), 0.0)
    return bc


def edge_list_cycles(graph, v: int):
    """(triangles, quadrilaterals) through ``v`` counted from the edge
    list: edges inside N(v), and C(c[x], 2) over x != v where c[x] is
    the number of neighbours of v adjacent to x."""
    import torch
    src, dst = live_edges(graph)
    nb = torch.zeros(graph.n, dtype=torch.bool, device=src.device)
    nb[dst[src == v]] = True
    tri = int((nb[src] & nb[dst]).sum()) // 2
    c = torch.bincount(dst[nb[src]], minlength=graph.n)
    c[v] = 0
    return tri, int((c * (c - 1) // 2).sum())


def edge_list_recommend(graph, u: int, k: int):
    """Top-k (vertex, common-friend count) of ``u`` from the edge list,
    by count desc, id asc."""
    import torch
    src, dst = live_edges(graph)
    nb = torch.zeros(graph.n, dtype=torch.bool, device=src.device)
    nb[dst[src == u]] = True
    c = torch.bincount(dst[nb[src]], minlength=graph.n)
    c[nb] = 0
    c[u] = 0
    cand = c.nonzero()[:, 0].cpu().numpy()
    score = c.cpu().numpy()[cand]
    order = np.lexsort((cand, -score))[:k]
    return [(int(cand[i]), int(score[i])) for i in order]


def ego_batch(view, u, candidates, d_in, device):
    """Padded GraphBatch over {u} + N(u) + candidates, features from the
    pinned snapshot only (the glue of examples/analytics_spc.py)."""
    from repro_torch.analytics import neighbors
    from repro_torch.models.gnn.graph import from_numpy
    nbrs = neighbors(view.index, u)
    sub = np.unique(np.concatenate([[u], nbrs, candidates]))
    local = {int(v): i for i, v in enumerate(sub)}
    senders, receivers = [], []
    for v in sub:
        for w in neighbors(view.index, int(v)):
            if int(w) in local:             # keep edges inside the ego net
                senders.append(local[int(v)])
                receivers.append(local[int(w)])
    feats = view.recommendation_features(u, sub)[:, :d_in]
    batch = from_numpy(feats.astype(np.float32),
                       np.asarray(senders, dtype=np.int64),
                       np.asarray(receivers, dtype=np.int64), device=device)
    return batch, sub, local


def common_friend_bags(view, u, cand):
    """int32 [C, width] common-friend ids of each candidate, padded with
    the id n (width at least 1)."""
    ids = [view.common_neighbor_ids(u, int(x)) for x in cand]
    width = max(max(len(i) for i in ids), 1)
    padded = np.full((len(cand), width), view.n, dtype=np.int32)
    for row, i in zip(padded, ids):
        row[:len(i)] = i
    return padded


def rerank(view, u, recs, pna, table):
    """Section 3 of examples/analytics_spc.py on the port: PNA node
    scores over the ego net plus the mean-pooled embeddings of each
    candidate's common friends.  Runs where ``pna`` and ``table`` lie.
    Returns (candidates, model scores float64 [C], ego-net size)."""
    import torch
    from repro_torch.kernels.embedding_bag.ops import embedding_bag
    dev = table.device
    cand = np.asarray([r.vertex for r in recs])
    batch, sub, local = ego_batch(view, u, cand, pna.cfg.d_in, dev)
    with torch.no_grad():
        node_scores = pna(batch)[:, 0]
    bags = torch.from_numpy(common_friend_bags(view, u, cand)).to(dev)
    pooled = embedding_bag(bags, table, mode="mean", pad_id=view.n)
    rows = torch.as_tensor([local[int(x)] for x in cand], device=dev)
    model = node_scores[rows] + pooled.mean(dim=1)
    return cand, model.double().cpu().numpy(), len(sub)


def fleet_dir() -> str:
    """A fresh directory for the fleet phases' publication directory and
    state checkpoint, on whichever of the temporary directory and the
    checkout's git-ignored ``build/`` has more free disk; raises when
    even that holds less than FLEET_DISK_BYTES."""
    import shutil
    import tempfile
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    free = {d: shutil.disk_usage(d).free
            for d in (tempfile.gettempdir(), build)}
    base = max(free, key=free.get)
    if free[base] < FLEET_DISK_BYTES:
        raise RuntimeError(
            f"the fleet phases need {FLEET_DISK_BYTES} B of free disk for "
            f"up to 5 published snapshots and a state checkpoint; the most "
            f"free is {free[base]} B under {base}")
    log(f"fleet: free disk {json.dumps(free)} B; using {base}")
    return tempfile.mkdtemp(prefix="chip_smoke_fleet_", dir=base)


def percentiles_us(seconds) -> dict:
    us = 1e6 * np.asarray(seconds)
    return {"p50": float(np.percentile(us, 50)),
            "p90": float(np.percentile(us, 90)),
            "p99": float(np.percentile(us, 99)), "n": int(us.size)}


def replica_main(pub_dir: str, pairs_path: str, device: str) -> int:
    """The fleet's second process (S3, S4): ``SPCService(role="replica",
    transport="dir", publish_dir=pub_dir, poll_interval_s=0.05)`` on the
    same card, importing only the port.  It pulls the newest version,
    answers the pairs of ``pairs_path`` and prints one JSON line
    (version, pull seconds, wall time of the answer, the answers' file,
    the puller's counts); then for each ``follow V`` line on its input
    it waits for version V, answers at once and prints the same; it
    exits on ``exit``."""
    import torch
    from repro_torch.serve import SPCService
    pairs = np.load(pairs_path)
    s, t = pairs["s"], pairs["t"]
    t0 = time.monotonic()
    rep = SPCService(role="replica", transport="dir", publish_dir=pub_dir,
                     poll_interval_s=0.05, wait_timeout=SERVICE_WAIT_S,
                     device=device)
    rep.start()
    pull_s = time.monotonic() - t0
    reader = rep.reader("pinned")

    def answer(extra):
        d, c = reader(s, t)
        d, c = d.cpu().numpy(), c.cpu().numpy()
        wall = time.time()
        out = os.path.join(os.path.dirname(pairs_path),
                           f"replica_v{reader.last_version}.npz")
        np.savez(out, dist=d, cnt=c)
        print(json.dumps({"version": reader.last_version,
                          "answered_wall": wall, "out": out,
                          "replica": rep.stats()["replica"],
                          "routes": dict(reader.engine.stats.snapshot()
                                         .routes), **extra}), flush=True)

    answer({"pull_s": pull_s, "device": (
        torch.cuda.get_device_name(0) if device == "cuda" else device)})
    for line in sys.stdin:
        cmd = line.split()
        if cmd and cmd[0] == "exit":
            break
        if cmd and cmd[0] == "follow":
            want = int(cmd[1])
            deadline = time.monotonic() + SERVICE_WAIT_S
            while rep.version is None or rep.version < want:
                if time.monotonic() > deadline:
                    raise TimeoutError(f"replica never reached v{want}")
                time.sleep(0.001)
            answer({})
    rep.close()
    return 0


class ReplicaProcess:
    """``python3 chip_smoke.py --replica-of DIR --pairs FILE`` as a
    child process (see :func:`replica_main`): JSON replies are read off
    its output by a thread, so every wait is bounded."""

    def __init__(self, pub_dir: str, pairs_path: str, device: str) -> None:
        import queue
        import threading
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--replica-of",
             pub_dir, "--pairs", pairs_path, "--replica-device", device],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        self.lines = queue.Queue()
        threading.Thread(target=self._pump, daemon=True).start()

    def _pump(self) -> None:
        for line in self.proc.stdout:
            self.lines.put(line)
        self.lines.put(None)

    def reply(self, timeout: float = SERVICE_WAIT_S) -> dict:
        while True:
            line = self.lines.get(timeout=timeout)
            if line is None:
                raise RuntimeError(f"the replica process exited with "
                                   f"{self.proc.wait()} before replying")
            if line.startswith("{"):
                return json.loads(line)
            log(f"  replica: {line.rstrip()}")

    def send(self, cmd: str) -> None:
        self.proc.stdin.write(cmd + "\n")
        self.proc.stdin.flush()

    def close(self) -> None:
        self.send("exit")
        rc = self.proc.wait(timeout=120)
        if rc != 0:
            raise RuntimeError(f"the replica process exited with {rc}")

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=60)


def absent_pair(svc, reader, rng, min_dist: int = 2):
    """A non-edge (a, b) whose endpoints are at least ``min_dist`` apart
    (so its insertion provably changes the answer to (1, 1))."""
    from repro_torch.core.graph import edge_set
    present = edge_set(svc.graph)
    while True:
        a, b = sorted(int(x) for x in rng.integers(0, svc.n, 2))
        if a != b and (a, b) not in present and \
                int(reader([a], [b])[0][0]) >= min_dist:
            return a, b


def check_pairs_bfs(svc, reader, pairs, tag) -> None:
    """``reader``'s answers to ``pairs`` equal ``plain_spc_bfs`` on the
    updater's current graph."""
    from repro_torch.core.bfs import plain_spc_bfs
    s = np.asarray([a for a, _ in pairs])
    t = np.asarray([b for _, b in pairs])
    d, c = (x.cpu().numpy() for x in reader(s, t))
    for k, (a, b) in enumerate(pairs):
        res = plain_spc_bfs(svc.graph, int(a))
        want = (int(res.dist[b]), int(res.cnt[b]))
        if (int(d[k]), int(c[k])) != want:
            raise AssertionError(f"{tag}: ({a}, {b}) answered "
                                 f"({int(d[k])}, {int(c[k])}), BFS {want}")


def timed_batches(reader, batches):
    """Host seconds of each batch from the call to its answers on the
    host (what a caller waits for)."""
    out = []
    for s, t in batches:
        t0 = time.monotonic()
        d, c = reader(s, t)
        d.cpu(), c.cpu()
        out.append(time.monotonic() - t0)
    return out


def service_phases(svc, counts, seed: int, card: str,
                   device: str = "cuda") -> dict:
    """S1-S4 (module doc) over phase 5's ``DynamicSPC`` ``svc``: the
    service, the front door, the fleet's replica process and the
    restart, with the replica and the restored updater on ``device``
    (the CPU only in the tests).  Returns their numbers; raises on any
    failed check."""
    import shutil
    import threading
    import torch
    from repro_torch.configs.dspc import CONFIG
    from repro_torch.core.bfs import plain_spc_bfs
    from repro_torch.core.graph import edge_set
    from repro_torch.data.pipelines import graph_stream
    from repro_torch.serve import SPCService
    from repro_torch.train import checkpoint as C
    n = svc.n
    rng = np.random.default_rng(seed + 17)
    root = fleet_dir()
    pub_dir = os.path.join(root, "published")
    latest = os.path.join(pub_dir, "LATEST")
    out, replica = {}, None
    knobs = dict(route=CONFIG.route, replicas=CONFIG.replicas,
                 queue_size=CONFIG.queue_size, update_batch=SERVICE_CHUNK,
                 transport="dir", publish_dir=pub_dir, keep_published=3,
                 async_checkpoint=True, wait_timeout=SERVICE_WAIT_S)
    try:
        # -- S1. the service ---------------------------------------------
        t0 = time.monotonic()
        service = SPCService(spc=svc, **knobs)
        service.store.wait()
        out["attach_publish_s"] = time.monotonic() - t0
        v0 = service.version
        shown = {k: v for k, v in knobs.items() if k != "publish_dir"}
        written = sum(os.path.getsize(os.path.join(pub_dir, f"step_{v0:09d}",
                                                    x))
                      for x in ("arrays.npz", "manifest.json"))
        log(f"S1 service: SPCService(spc=<phase 5's DynamicSPC>, "
            f"{json.dumps(shown)}) published v{v0} through the directory in "
            f"{out['attach_publish_s']:.3f} s (the index off the card and "
            f"{written} B written)")
        service.start()
        sess = service.session()
        # the first SERVICE_EVENTS events of an 8-event stream: a stream
        # of 4 draws other events, and a delete runs from ~1 s to over
        # 60 s with its affected hubs
        half = SERVICE_EVENTS // 2
        events = graph_stream(sorted(edge_set(svc.graph)), n, 4, 4,
                              seed=seed + 7)[:SERVICE_EVENTS]
        pinned, rw = service.reader("pinned"), sess.reader()
        batches = [(rng.integers(0, n, SERVICE_PAIRS),
                    rng.integers(0, n, SERVICE_PAIRS))
                   for _ in range(SERVICE_BATCHES)]
        applied_s, overlap = [], 0
        with counts.path("service"):
            t0 = time.monotonic()
            t1 = sess.submit(events[:half])
            service.wait_for_ticket(t1)
            applied_s.append(time.monotonic() - t0)
            timed_batches(pinned, batches[:2])           # warm-up
            idle_s = timed_batches(pinned, batches)
            t0 = time.monotonic()
            t2 = sess.submit(events[half:])
            busy_s = []
            for s, t in batches:
                busy_s += timed_batches(pinned, [(s, t)])
                overlap += service.applied < t2
            service.wait_for_ticket(t2)
            applied_s.append(time.monotonic() - t0)
            t0 = time.monotonic()
            service.drain()
            out["write_left_after_apply_s"] = time.monotonic() - t0
            rw([0], [1])
        if rw.last_version < service.ticket_version(t2):
            raise AssertionError(f"read_your_writes pinned v{rw.last_version}"
                                 f" below its ticket's v"
                                 f"{service.ticket_version(t2)}")
        check_pairs_bfs(svc, rw, [(a, b) for _, a, b in events],
                        "S1 read_your_writes")
        t0 = time.monotonic()
        targets = np.arange(n)
        for src in rng.choice(n, size=2, replace=False):
            res = plain_spc_bfs(svc.graph, int(src))
            d, c = pinned(np.full(n, src), targets)
            if not (torch.equal(d, res.dist[:n]) and
                    torch.equal(c, res.cnt[:n])):
                raise AssertionError(f"S1: the service's answers from "
                                     f"{src} differ from plain_spc_bfs")
        routes = {}
        for v in service.stats()["serve"]:
            for r, k in v.routes.items():
                routes[r] = routes.get(r, 0) + k
        if set(routes) != {"kernel" if device == "cuda" else "merge"}:
            raise AssertionError(f"S1: the service's readers took {routes}")
        out.update({
            "tickets": [t1, t2], "versions": [service.ticket_version(t1),
                                              service.ticket_version(t2)],
            "submit_to_applied_s": applied_s,
            "serve_idle_us": percentiles_us(idle_s),
            "serve_under_ingest_us": percentiles_us(busy_s),
            "batches_during_the_chunk": int(overlap),
            "reader_routes": routes})
        log(f"S1 service: tickets {t1}, {t2} ({half} events each, chunks of "
            f"{SERVICE_CHUNK}) applied {applied_s[0]:.3f}, {applied_s[1]:.3f} "
            f"s after submit (v{out['versions'][0]}, v{out['versions'][1]}); "
            f"the last directory write settled "
            f"{out['write_left_after_apply_s']:.3f} s after its apply; "
            f"serve batches of {SERVICE_PAIRS} pairs, host us "
            f"to the answers: idle p50 {out['serve_idle_us']['p50']:.1f} p90 "
            f"{out['serve_idle_us']['p90']:.1f}, under ingest p50 "
            f"{out['serve_under_ingest_us']['p50']:.1f} p90 "
            f"{out['serve_under_ingest_us']['p90']:.1f} ({overlap} of "
            f"{SERVICE_BATCHES} batches ended while the chunk applied); "
            f"read_your_writes saw its write (v{rw.last_version}); 2 sources "
            f"x {n} targets equal to plain_spc_bfs "
            f"({time.monotonic() - t0:.3f} s); routes {routes}; K1 launched "
            f"{counts.by_path['service']['spc_query']} times on the service "
            f"path on {card}")

        # -- S2. the front door ------------------------------------------
        version = service.version
        direct = service.reader(at_version=version)
        fd_pairs = [(rng.integers(0, n, FD_REQUESTS),
                     rng.integers(0, n, FD_REQUESTS))
                    for _ in range(FD_CALLERS)]
        got = [[None] * FD_REQUESTS for _ in range(FD_CALLERS)]
        want = [list(zip(*(x.cpu().tolist() for x in direct(*fd_pairs[i]))))
                for i in range(FD_CALLERS)]
        lat = [[] for _ in range(FD_CALLERS)]
        errors = []
        a, b = absent_pair(svc, direct, rng)    # the writer's insert
        door = service.frontdoor(dispatchers=CONFIG.dispatchers,
                                 max_batch=CONFIG.frontdoor_batch,
                                 max_live_batches=CONFIG.max_live_batches,
                                 deadline_s=CONFIG.deadline_s)

        def caller(i):
            fsess = door.session()
            try:
                for k, (a, b) in enumerate(zip(*fd_pairs[i])):
                    t0 = time.monotonic()
                    got[i][k] = fsess.query(int(a), int(b))
                    lat[i].append(time.monotonic() - t0)
            except BaseException as e:
                errors.append(e)

        with counts.path("service"):
            with door:
                threads = [threading.Thread(target=caller, args=(i,))
                           for i in range(FD_CALLERS)]
                t0 = time.monotonic()
                for th in threads:
                    th.start()
                for th in threads:
                    th.join(timeout=SERVICE_WAIT_S)
                wall = time.monotonic() - t0
                if errors or any(th.is_alive() for th in threads):
                    raise AssertionError(f"S2: front-door callers failed: "
                                         f"{errors[:3]}")
                fd_stats = door.stats()
                if service.version != version:
                    raise AssertionError("S2: the version moved under the "
                                         "read-only traffic")
                wsess = door.session("read_your_writes")
                t0 = time.monotonic()
                ticket = wsess.submit([("+", a, b)])
                answer = wsess.query(a, b, deadline=SERVICE_WAIT_S)
                ryw_s = time.monotonic() - t0
        if service.ticket_version(ticket) is None or answer != (1, 1):
            raise AssertionError(f"S2: the writing session read ({a}, {b}) "
                                 f"as {answer} after inserting it")
        for i in range(FD_CALLERS):
            if got[i] != want[i]:
                raise AssertionError(f"S2: caller {i}'s answers differ from "
                                     f"a direct reader's at v{version}")
        if fd_stats["mean_fill"] <= 1:
            raise AssertionError(f"S2: the front door did not coalesce: "
                                 f"{fd_stats}")
        service.drain()
        all_lat = [x for row in lat for x in row]
        out["frontdoor"] = {
            "callers": FD_CALLERS, "requests_each": FD_REQUESTS,
            "qps": FD_CALLERS * FD_REQUESTS / wall, "wall_s": wall,
            "request_us": percentiles_us(all_lat), **fd_stats,
            "writer_submit_to_answer_s": ryw_s, "version": version}
        log(f"S2 front door: {FD_CALLERS} callers x {FD_REQUESTS} single-pair "
            f"requests in {wall:.3f} s, {out['frontdoor']['qps']:.1f} qps, "
            f"per request p50 {out['frontdoor']['request_us']['p50']:.1f} us "
            f"p99 {out['frontdoor']['request_us']['p99']:.1f} us; "
            f"{fd_stats['batches']} coalesced batches, mean fill "
            f"{fd_stats['mean_fill']:.2f}, max fill {fd_stats['max_fill']}; "
            f"every answer equal to a direct reader's at v{version}; the "
            f"writing session read its insert of ({a}, {b}) as (1, 1) "
            f"{ryw_s:.3f} s after its submit (v"
            f"{service.ticket_version(ticket)}); K1 launched "
            f"{counts.by_path['service']['spc_query']} times on the service "
            f"path (S1 and S2) on {card}")
        out["service_launches"] = counts.by_path["service"]["spc_query"]

        # -- S3. the fleet: a replica process on the same card -----------
        pairs_path = os.path.join(root, "pairs.npz")
        s3, t3 = (rng.integers(0, n, SERVICE_PAIRS) for _ in range(2))
        np.savez(pairs_path, s=s3, t=t3)
        version = service.version
        committed = os.stat(latest).st_mtime
        t0 = time.monotonic()
        replica = ReplicaProcess(pub_dir, pairs_path, device)
        first = replica.reply()
        started_s = time.monotonic() - t0
        d, c = (x.cpu().numpy() for x in
                service.reader(at_version=version)(s3, t3))
        check_replica(first, version, d, c, "S3")
        out["replica_pull"] = {
            "version": first["version"], "pull_s": first["pull_s"],
            "process_start_to_answer_s": started_s,
            "commit_to_first_answer_s": first["answered_wall"] - committed,
            "routes": first["routes"]}
        log(f"S3 fleet: a replica process on {first['device']} pulled v"
            f"{first['version']} (load and stage) in {first['pull_s']:.3f} s "
            f"and answered {SERVICE_PAIRS} pairs exactly as the updater at "
            f"that version ({started_s:.3f} s from its start; "
            f"{out['replica_pull']['commit_to_first_answer_s']:.3f} s after "
            f"the version's commit, its start included); routes "
            f"{first['routes']} on {card}")

        # -- S4. restart from a checkpoint --------------------------------
        service.close()
        state = service.state_dict()
        ckpt_dir = os.path.join(root, "state")
        t0 = time.monotonic()
        C.save(ckpt_dir, int(state["version"]), state)
        save_s = time.monotonic() - t0
        t0 = time.monotonic()
        restored = SPCService.from_checkpoint(ckpt_dir, n, device=device,
                                              **knobs)
        if device == "cuda":
            torch.cuda.synchronize()
        restore_s = time.monotonic() - t0
        if restored.store.publishes or C.latest_step(pub_dir) != version:
            raise AssertionError("S4: the restored service re-published "
                                 "history")
        again = restored.state_dict()
        if sorted(again) != sorted(state) or any(
                again[k].dtype != state[k].dtype or
                again[k].tobytes() != state[k].tobytes() for k in state):
            raise AssertionError("S4: state_dict() after the restore is not "
                                 "byte-identical to the saved one")
        del service, state, again
        want_v = version + 1
        replica.send(f"follow {want_v}")
        restored.start()
        a, b = absent_pair(restored.spc, restored.reader(), rng)
        t0 = time.monotonic()
        ticket = restored.submit([("+", a, b)])
        restored.wait_for_ticket(ticket)
        apply_s = time.monotonic() - t0
        restored.drain()
        committed = os.stat(latest).st_mtime
        follow = replica.reply()
        d, c = (x.cpu().numpy() for x in
                restored.reader(at_version=want_v)(s3, t3))
        check_replica(follow, want_v, d, c, "S4")
        rstats = follow["replica"]
        if rstats["skipped_behind"] or rstats["errors"]:
            raise AssertionError(f"S4: the replica skipped or failed: "
                                 f"{rstats}")
        replica.close()
        replica = None
        restored.close()
        out["restart"] = {
            "save_s": save_s, "restore_s": restore_s,
            "submit_to_applied_s": apply_s,
            "staleness_s": follow["answered_wall"] - committed,
            "version": want_v, "replica": rstats}
        log(f"S4 restart: state_dict() saved by the port's checkpoint in "
            f"{save_s:.3f} s, SPCService.from_checkpoint on {device} in "
            f"{restore_s:.3f} s, byte-identical; v{want_v} applied "
            f"{apply_s:.3f} s after its submit, and the replica process "
            f"answered at it {out['restart']['staleness_s']:.3f} s after its "
            f"commit (the staleness), exactly as the updater; replica "
            f"{json.dumps(rstats)} on {card}")
        del restored
    finally:
        if replica is not None:
            replica.kill()
        shutil.rmtree(root, ignore_errors=True)
    return out


def check_replica(reply: dict, version: int, d, c, tag: str) -> None:
    """The replica process answered at ``version`` exactly (d, c)."""
    if reply["version"] != version:
        raise AssertionError(f"{tag}: the replica answered at v"
                             f"{reply['version']}, not v{version}")
    got = np.load(reply["out"])
    if not (np.array_equal(got["dist"], d) and np.array_equal(got["cnt"], c)):
        raise AssertionError(f"{tag}: the replica's answers at v{version} "
                             f"differ from the updater's")


def same_state(got: dict, want: dict) -> bool:
    """Two state dicts hold the same keys, dtypes, shapes and bytes."""
    return sorted(got) == sorted(want) and all(
        got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        and np.array_equal(got[k], want[k]) for k in want)


def distributed_phase(edges, n: int, build_kw: dict, counts, seed: int,
                      card: str, device: str = "cuda") -> dict:
    """Phase D (module doc) on the graph ``edges`` of its own: the
    single-device build it is held against (``build_kw`` its
    ``DynamicSPC`` knobs, outside every path), the edge-sharded build of
    the same graph, one chunk through both engines, the mesh-staged
    store served through the sharded route, and ``SPCService`` over both
    meshes.  Returns the numbers; raises on any failed check."""
    import torch
    from repro_torch.core import bfs as B
    from repro_torch.core.dynamic import DynamicSPC
    from repro_torch.core.graph import edge_set
    from repro_torch.data.pipelines import graph_stream
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serve import QueryEngine, SnapshotStore, SPCService
    if device == "cuda" and torch.cuda.device_count() > 1:
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    else:
        devices = [device] * DIST_SHARDS
    edge_mesh = make_mesh((len(devices),), ("model",), devices)
    serve_mesh = make_mesh((len(devices),), ("data",), devices)
    distinct = edge_mesh.distinct_devices

    def sync():
        for d in distinct:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    log(f"D mesh: {edge_mesh} for the updater (edge axis 'model'), "
        f"{serve_mesh} for serving (batch axis 'data'); {len(devices)} "
        f"entries on {len(distinct)} distinct device(s): "
        f"{'distinct' if len(distinct) == len(devices) else 'repeated'}")
    out = {"entries": len(devices), "distinct_devices": len(distinct),
           "n": n, "m": len(edges)}
    # -- D1. the single-device build, then the sharded one ------------------
    syncs0 = B.frontier_syncs.count
    sync()
    t0 = time.monotonic()
    single = DynamicSPC(n, edges, device=device, **build_kw)
    sync()
    single_build = {"s": time.monotonic() - t0,
                    "syncs": B.frontier_syncs.count - syncs0}
    state = single.state_dict()
    out["single_build"] = single_build
    syncs0 = B.frontier_syncs.count
    sync()
    t0 = time.monotonic()
    with counts.path("distributed"):
        dist = DynamicSPC(n, edges, mesh=edge_mesh, device=device, **build_kw)
        sync()
    out["build_s"] = time.monotonic() - t0
    out["build_syncs"] = B.frontier_syncs.count - syncs0
    relax = dist._updater.multi_relax_fn
    if not same_state(dist.state_dict(), state):
        raise AssertionError("D1: the sharded build's state_dict() differs "
                             "from the single-device build's")
    log(f"D1 build (n {n}, m {len(edges)}): {out['build_s']:.3f} s over "
        f"{len(devices)} edge shards (one device: {single_build['s']:.3f} "
        f"s), host syncs {out['build_syncs']} (one device: "
        f"{single_build['syncs']}), "
        f"{relax.reductions} level reductions, {relax.placements} edge "
        f"placement(s); state_dict() byte-identical on {card}")
    # -- D1. one chunk through the sharded and the single-device engine ----
    del state
    events = graph_stream(edges, n, DIST_EVENTS // 2, DIST_EVENTS // 2,
                          seed=seed + 23)
    chunk = {}
    for tag, spc in (("sharded", dist), ("single", single)):
        syncs0 = B.frontier_syncs.count
        sync()
        t0 = time.monotonic()
        with (counts.path("distributed") if tag == "sharded"
              else contextlib.nullcontext()):
            spc.apply_events(events, batch_size=DIST_EVENTS)
            sync()
        chunk[tag] = {"s": time.monotonic() - t0,
                      "syncs": B.frontier_syncs.count - syncs0}
    if not same_state(dist.state_dict(), single.state_dict()):
        raise AssertionError("D1: the chunk left the sharded and the "
                             "single-device states different")
    out["chunk"] = chunk
    log(f"D1 chunk of {len(events)} events: sharded "
        f"{chunk['sharded']['s']:.3f} s ({chunk['sharded']['syncs']} host "
        f"syncs), single device "
        f"{chunk['single']['s']:.3f} s ({chunk['single']['syncs']} host "
        f"syncs); state_dict() byte-identical on {card}")
    del single
    # -- D2. the mesh-staged store through the sharded route ---------------
    store = SnapshotStore(dist.index, version=dist.version, mesh=serve_mesh)
    eng = QueryEngine()
    serve = eng.serve_from(store, mesh=serve_mesh)
    rng = np.random.default_rng(seed + 29)
    batches = [(rng.integers(0, n, DIST_PAIRS), rng.integers(0, n, DIST_PAIRS))
               for _ in range(DIST_BATCHES)]
    secs, outs = [], []
    with counts.path("distributed"):
        serve(*batches[0])                                  # warm-up
        sync()
        for s, t in batches:
            t0 = time.monotonic()
            outs.append(serve(s, t))
            sync()
            secs.append(time.monotonic() - t0)
    routes = dict(eng.stats.snapshot().routes)
    if routes != {"sharded[data]:merge": DIST_BATCHES + 1}:
        raise AssertionError(f"D2: the sharded engine counted {routes}")
    single_route = QueryEngine(route="auto")
    for (s, t), (d, c) in zip(batches, outs):
        d0, c0 = single_route.query_batch(dist.index, s, t)
        if not (torch.equal(d, d0) and torch.equal(c, c0)):
            raise AssertionError("D2: the sharded route differs from the "
                                 "single-device route")
    out["serve_us"] = percentiles_us(secs)
    out["serve_routes"] = routes
    out["single_device_routes"] = dict(single_route.stats.snapshot().routes)
    log(f"D2 serve: {DIST_BATCHES} batches of {DIST_PAIRS} pairs through "
        f"serve_from(mesh=) over a mesh-staged SnapshotStore, host us per "
        f"batch p50 {out['serve_us']['p50']:.1f} p90 "
        f"{out['serve_us']['p90']:.1f}; routes {json.dumps(routes)}; equal "
        f"to the single-device route "
        f"{json.dumps(out['single_device_routes'])} on {card}")
    now = dist.state_dict()
    del outs, serve, eng, store, dist
    # -- D2. SPCService over both meshes ------------------------------------
    t0 = time.monotonic()
    service = SPCService.from_state_dict(
        n, now, mesh=edge_mesh, serve_mesh=serve_mesh, route="sharded",
        device=device, wait_timeout=SERVICE_WAIT_S)
    restore_s = time.monotonic() - t0
    del now
    with service:
        spc = service.spc
        reader = service.reader()
        a, b = absent_pair(spc, reader, rng)
        present = sorted(edge_set(spc.graph))
        c_, d_ = present[int(rng.integers(0, len(present)))]
        sess = service.session()
        t0 = time.monotonic()
        sess.submit([("+", a, b), ("-", c_, d_)])
        ryw = sess.reader("read_your_writes")
        d, c = ryw([a], [b])
        apply_s = time.monotonic() - t0
        if (int(d[0]), int(c[0])) != (1, 1):
            raise AssertionError(f"D2 service: the written edge ({a}, {b}) "
                                 f"reads ({int(d[0])}, {int(c[0])})")
        check_pairs_bfs(spc, ryw, [(a, b), (c_, d_), (a, c_), (b, d_)],
                        "D2 service")
        view = ryw.engine.stats.snapshot()
        out["service"] = {"restore_s": restore_s,
                          "submit_to_read_s": apply_s,
                          "version": ryw.last_version,
                          "routes": dict(view.routes)}
    if set(out["service"]["routes"]) != {"sharded[data]:merge"}:
        raise AssertionError(f"D2 service: routes {out['service']['routes']}")
    log(f"D2 service: SPCService.from_state_dict(mesh=, serve_mesh=, "
        f"route='sharded') in {restore_s:.3f} s; a ticket of 2 events read "
        f"back through read_your_writes {apply_s:.3f} s after its submit "
        f"(v{out['service']['version']}), equal to plain_spc_bfs; routes "
        f"{json.dumps(out['service']['routes'])} on {card}")
    return out


# -------------------------------------------------------------------------
# Z. the analyzer
# -------------------------------------------------------------------------
def run_analyzer(*argv: str) -> tuple:
    """``python -m repro_torch.analysis *argv`` from the checkout's root:
    (exit code, lines of its output)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (SRC, os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", *argv], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=300)
    return proc.returncode, proc.stdout.splitlines()


def scan_summary(lines: list) -> tuple:
    """(files, findings) from the analyzer's last line, ``N files
    scanned, K findings``."""
    words = lines[-1].split() if lines else []
    if words[1:3] != ["files", "scanned,"] or words[4:5] != ["findings"]:
        raise AssertionError(f"analyzer summary: {lines[-1:]}")
    return int(words[0]), int(words[3])


def analysis_phase() -> dict:
    """Phase Z (module doc): the self-test, the port's scan and the
    planted fault, each through the CLI.  Raises on any miss."""
    import tempfile
    from repro_torch.analysis import rules
    t0 = time.monotonic()
    checks = 2 * len(rules.RULE_DOCS)
    code, lines = run_analyzer("--self-test")
    if code != 0 or lines[-1:] != [
            f"self-test: {checks} fixture checks, 0 failures"]:
        raise AssertionError(f"Z self-test: exit {code}: {lines}")
    code, lines = run_analyzer("src/repro_torch")
    files, findings = scan_summary(lines)
    if code != 0 or findings:
        raise AssertionError(f"Z src/repro_torch: exit {code}: {lines}")
    path, old, new = Z_FAULT
    with open(os.path.join(ROOT, path), encoding="utf-8") as fh:
        source = fh.read()
    if source.count(old) != 1:
        raise AssertionError(f"Z fault: {path} no longer has {old!r}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_z_") as tmp:
        copy = os.path.join(tmp, os.path.basename(path))
        with open(copy, "w", encoding="utf-8") as fh:
            fh.write(source.replace(old, new))
        fault_code, fault_lines = run_analyzer(copy)
    fault_rules = sorted({line.split()[1] for line in fault_lines[:-1]})
    if fault_code != 1 or "lock-order" not in fault_rules:
        raise AssertionError(f"Z fault: exit {fault_code}: {fault_lines}")
    out = {"phase": "analysis", "files": files, "findings": findings,
           "self_test_checks": checks, "fault_rule": "lock-order",
           "fault_rules": fault_rules,
           "fault_findings": scan_summary(fault_lines)[1],
           "seconds": time.monotonic() - t0}
    log(json.dumps(out))
    return out


# -------------------------------------------------------------------------
# B. the launch layer; E. the examples
# -------------------------------------------------------------------------
class Laps:
    """Each phase's seconds: :meth:`lap` logs the time since the last lap
    (or the start) under the phase's name."""

    def __init__(self, start: float) -> None:
        self.start = self.last = start
        self.seconds: dict = {}

    def lap(self, name: str) -> float:
        now = time.monotonic()
        self.seconds[name] = now - self.last
        log(f"phase {name}: {now - self.last:.1f} s (at "
            f"{now - self.start:.1f} s)")
        self.last = now
        return self.seconds[name]


def tree_tensors(tree):
    """The tensors of a tree of dicts (in key order), lists, tuples, named
    tuples and dataclasses (``GraphBatch``, ``Graph``, ``SPCIndex``)."""
    import dataclasses
    import torch
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_tensors(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tree_tensors(v)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from tree_tensors(getattr(tree, f.name))


def tree_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_tensors(tree))


def cell_sizes(bundle, family: str, kind: str) -> dict:
    """The bytes of a bundle's parameters, optimizer state and batch
    (every other argument: tokens, caches, graphs, indexes, pairs)."""
    args = bundle.abstract_args
    if family == "dspc":
        parts = ((), (), args)
    elif kind in ("train", "recsys_train", "full_graph", "sampled",
                  "molecule"):
        parts = (args[0], args[1], args[2:])
    else:
        parts = (args[0], (), args[1:])
    return dict(zip(("param_bytes", "opt_bytes", "batch_bytes"),
                    (tree_bytes(p) for p in parts)))


def cells_phase() -> list:
    """B1: every cell of ``launch.steps.all_cells()`` built at full size
    on the meta device; one line each with its ``model_flops`` and the
    bytes of its abstract parameters, optimizer state and batch."""
    from repro_torch.configs import get
    from repro_torch.launch import steps as S
    rows = []
    for arch, shape in S.all_cells():
        t0 = time.monotonic()
        bundle = S.make_bundle(arch, shape)
        spec = get(arch)
        on = {x.device.type for x in tree_tensors(bundle.abstract_args)}
        if on != {"meta"}:
            raise AssertionError(f"B1 {bundle.name}: leaves on {on}")
        rows.append({"cell": bundle.name, "model_flops": bundle.model_flops,
                     **cell_sizes(bundle, spec.family,
                                  spec.shapes[shape].kind),
                     "notes": bundle.notes, "s": time.monotonic() - t0})
        log(f"B1 {json.dumps(rows[-1])}")
    if len(rows) != 44:
        raise AssertionError(f"B1: {len(rows)} cells, not 44")
    return rows


def ring_layout_bytes(grids=RING_GRIDS) -> dict:
    """B1's ``ogb_products`` line: Equiformer-v2's ring bundle at that
    shape (``launch.steps.equiformer_ring_bundle``) for each ``("data",
    "model")`` grid, its abstract arguments laid out by its ``arg_specs``
    through ``TP_ONLY`` over a mesh of meta devices (nothing allocated):
    per mesh entry the node state (the float32 node irreps of its block,
    which ``forward_ring`` keeps on that entry), the node inputs (features,
    positions, labels) and the edge buckets, against the node state of
    all nodes on one device."""
    from repro_torch import sharding as SH
    from repro_torch.configs import get
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import make_mesh
    spec = get("equiformer-v2")
    shape = spec.shapes["ogb_products"]
    out = {}
    for p_data, p_model in grids:
        bundle = S.equiformer_ring_bundle(spec, shape, p_data, p_model)
        mesh = make_mesh((p_data, p_model), ("data", "model"),
                         ["meta"] * (p_data * p_model))
        _, _, batch = bundle.place_args(bundle.abstract_args, mesh,
                                        SH.TP_ONLY)
        nodes, pos, src_b, dst_b, labels = batch
        if any(t.device.type != "meta" for x in batch
               for t in x.shards.values()):
            raise AssertionError("B1 ring: a shard off the meta device")
        c = spec.config
        irreps = c.d_hidden * (c.l_max + 1) ** 2 * 4

        def entry(x, e):
            return x.shard(e).numel() * x.shard(e).element_size()
        out[f"{p_data}x{p_model}"] = {
            "n_pad": nodes.shape[0], "bucket_cap": src_b.shape[-1],
            "node_state_bytes": nodes.shard(0).shape[0] * irreps,
            "node_input_bytes": entry(nodes, 0) + entry(pos, 0) +
            entry(labels, 0),
            "bucket_bytes": entry(src_b, 0) + entry(dst_b, 0),
            "node_state_whole_bytes": nodes.shape[0] * irreps}
    return out


def same_layout(tag, got, want) -> None:
    """Concrete arguments of the abstract arguments' shapes and dtypes."""
    got, want = list(tree_tensors(got)), list(tree_tensors(want))
    if len(got) != len(want):
        raise AssertionError(f"{tag}: {len(got)} leaves, abstract "
                             f"{len(want)}")
    for g, w in zip(got, want):
        if tuple(g.shape) != tuple(w.shape) or g.dtype != w.dtype:
            raise AssertionError(f"{tag}: {g.dtype}{tuple(g.shape)} where "
                                 f"the abstract leaf is "
                                 f"{w.dtype}{tuple(w.shape)}")


#: B4a: the pod16x16 dry runs, one full-size cell a family and the ring
#: at ogb_products (the faster cell of each family: B4 stays within a
#: minute of host time).
B4_CELLS = (("qwen2-1.5b", "decode_32k", ""), ("egnn", "molecule", ""),
            ("dien", "retrieval_cand", ""), ("dspc", "query_batch", ""),
            ("equiformer-v2", "ogb_products", "ring"))
#: B4c's planted fault: the counted bytes this many times over.
B4_FAULT_BYTES = 1000


def dry_runs(cells=B4_CELLS, out_dir=None) -> list:
    """B4a: ``launch.dryrun.run_cell`` of each cell on the pod16x16 mesh of
    meta entries (nothing placed on the card), written to a fresh
    directory; each record's line and its figures."""
    import tempfile
    from repro_torch.launch import dryrun as D
    out_dir = out_dir or tempfile.mkdtemp(prefix="dryrun-")
    rows = []
    for arch, shape, variant in cells:
        rec = D.run_cell(arch, shape, multi_pod=False, variant=variant,
                         out_dir=out_dir, force=True)
        log(f"B4a {D.line(rec)}")
        if rec["status"] != "ok":
            raise AssertionError(f"B4a {arch}/{shape}: {rec['status']} "
                                 f"{rec.get('error', '')[:300]}")
        rows.append({k: rec[k] for k in (
            "arch", "shape", "mesh", "dry_s", "flops_per_device",
            "bytes_per_device", "collective_wire_bytes_per_device",
            "compute_term_s", "memory_term_s", "collective_term_s",
            "dominant_term", "fits")} | {"memory": rec["memory"]})
    return rows


def meta_like(tree):
    """``tree`` with each tensor an empty one of its shape and dtype on
    the meta device."""
    import torch
    from repro_torch.launch.mesh import map_tree
    return map_tree(lambda _, x: torch.empty_like(x, device="meta"), tree)


def counted_against_meta(tag: str, step, args, device) -> dict:
    """B4b: one ``step`` on ``args`` on the card under the dry run's count
    (``launch.dryrun.count_step``) and one on meta copies of them: their
    FLOPs and bytes by op must be equal.  Returns the count's figures and
    its bound, ``max(compute_term_s, memory_term_s)`` (the H100's
    data-sheet rates)."""
    import torch
    from repro_torch.launch import dryrun as D
    _, on_meta, meta_s = D.count_step(step, meta_like(args), 1, "meta")
    _, on_card, card_s = D.count_step(step, args, 1, device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    for what in ("flops_by_op", "bytes_by_op"):
        got, want = ({k: v for k, v in getattr(x, what).items() if v}
                     for x in (on_card, on_meta))
        if got != want:
            diff = {k: (got.get(k), want.get(k)) for k in set(got) | set(want)
                    if got.get(k) != want.get(k)}
            raise AssertionError(f"B4b {tag}: {what} on the card differ from "
                                 f"the meta count: {json.dumps(diff)[:600]}")
    t = D.terms(on_meta, np.zeros(1), np.zeros(1), 0.0, 1)
    row = {"flops": t["flops_per_device"], "bytes": t["bytes_per_device"],
           "compute_term_s": t["compute_term_s"],
           "memory_term_s": t["memory_term_s"],
           "bound_s": max(t["compute_term_s"], t["memory_term_s"]),
           "count_s": {"meta": meta_s, "card": card_s}}
    log(f"B4b {tag}: FLOPs and bytes by op equal on the card and on meta: "
        f"{json.dumps(row)}")
    return row


def roofline_share(tag: str, row: dict, measured_s: float,
                   power: str) -> float:
    """B4c: the step's measured seconds must be at least its counted bound;
    bound / measured is its roofline share."""
    if measured_s < row["bound_s"]:
        raise AssertionError(f"B4c {tag}: measured {measured_s:.6g} s is "
                             f"below the bound {row['bound_s']:.6g} s")
    share = row["bound_s"] / measured_s
    log(f"B4c {tag}: bound {row['bound_s']:.6g} s "
        f"({'compute' if row['compute_term_s'] >= row['memory_term_s'] else 'memory'}), "
        f"measured {measured_s:.6g} s, roofline share {share:.4g} on {power}")
    return share


def roofline_phase(launch: dict, train: dict, power: str) -> dict:
    """B4c over B4b's counts: each step's share, then the planted fault
    (the bytes B4_FAULT_BYTES times over), which must fail the check."""
    steps = {"qwen2-1.5b/decode_32k": (
        launch["decode"]["b4"], launch["decode"]["step_ms_p50"] / 1e3),
        "qwen2-1.5b/train_4k": (train["qwen2-1.5b"]["b4"],
                                train["qwen2-1.5b"]["s_per_step"]),
        "egnn/molecule": (launch["train"]["egnn/molecule"]["b4"],
                          float(np.median(launch["train"]["egnn/molecule"][
                              "step_s"])))}
    out = {}
    for tag, (row, measured) in steps.items():
        out[tag] = {"share": roofline_share(tag, row, measured, power),
                    "measured_s": measured, **row}
        fault = dict(row, memory_term_s=row["memory_term_s"] *
                     B4_FAULT_BYTES)
        fault["bound_s"] = max(fault["compute_term_s"],
                               fault["memory_term_s"])
        try:
            roofline_share(f"{tag} (planted fault: bytes x "
                           f"{B4_FAULT_BYTES})", fault, measured, power)
        except AssertionError as e:
            log(f"B4c {tag}: the planted fault fails the check: {e}")
        else:
            raise AssertionError(f"B4c {tag}: the planted fault passes")
    return out


def launch_decode(counts, card: str, seed: int, device="cuda",
                  smoke: bool = False) -> dict:
    """B2's LM cell: ``make_bundle("qwen2-1.5b", "decode_32k").get_fn()``
    at CONFIG width and depth (tp 16 as the cell has it), random bf16
    weights, on a zero cache of the cell's context with ``lengths = t //
    2`` (``lm_host_args``' convention), its global batch cut to
    B2_DECODE_BATCH (``reduced``), B2_DECODE_STEPS greedy steps; on the
    card one flash_decode launch a layer and step."""
    import torch
    from repro_torch.configs import get
    from repro_torch.launch import steps as S
    from repro_torch.models import transformer as tf
    arch, shape = "qwen2-1.5b", "decode_32k"
    dev = torch.device(device)
    bundle = S.make_bundle(arch, shape, smoke=smoke)
    cfg = get(arch).smoke if smoke else get(arch).config
    _, cache_a, _ = bundle.abstract_args
    b_cell, s_max = cache_a["lengths"].shape[0], cache_a["k"].shape[2]
    b = min(B2_DECODE_BATCH, b_cell)
    params = tf.init_params(cfg, generator=torch.Generator(dev).manual_seed(
        seed), device=dev)
    same_layout(f"B2 {bundle.name} parameters", params,
                bundle.abstract_args[0])
    cache = tf.init_cache(cfg, b, s_max, device=dev)
    start = s_max // 2
    cache["lengths"].fill_(start)
    # the cell's cache but for its batch, which is cut
    same_layout(f"B2 {bundle.name} cache", cache_a,
                tf.abstract_cache(cfg, b_cell, s_max))
    same_layout(f"B2 {bundle.name} cache", cache,
                tf.abstract_cache(cfg, b, s_max))
    token = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, b).astype(np.int32)).to(dev)
    decode = bundle.get_fn()
    cuda = dev.type == "cuda"
    fd = counts.counters["flash_decode"]
    ms = []
    with torch.no_grad(), counts.path("launch"):
        for _ in range(B2_DECODE_STEPS):
            if cuda:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
            logits, cache = decode(params, cache, token)
            token = logits.argmax(dim=-1).to(torch.int32)
            if cuda:
                ev[1].record()
                ev[1].synchronize()
                ms.append(ev[0].elapsed_time(ev[1]))
        launched = fd.count
    want = cfg.n_layers * B2_DECODE_STEPS if cuda else 0
    if launched != want:
        raise AssertionError(f"B2 {bundle.name}: flash_decode launched "
                             f"{launched} times, not {want}")
    end = start + B2_DECODE_STEPS
    if not (bool(torch.isfinite(logits).all())
            and tuple(logits.shape) == (b, cfg.padded_vocab)
            and bool((cache["lengths"] == end).all())):
        raise AssertionError(f"B2 {bundle.name}: logits {logits.shape} "
                             f"not finite, or lengths "
                             f"{cache['lengths'].tolist()} != {end}")
    # every layer wrote each step's rows, and nothing past them
    k = cache["k"]
    written = k[:, :, start:end].abs().amax(dim=(1, 3, 4)) > 0
    if not bool(written.all()) or bool(k[:, :, end:end + 1].any()):
        raise AssertionError(f"B2 {bundle.name}: the cache rows "
                             f"[{start}, {end}) were not all written, or "
                             f"row {end} was")
    out = {"cell": bundle.name, "layers": cfg.n_layers,
           "padded_heads": cfg.padded_heads, "batch": b,
           "context": s_max, "lengths": [start, end],
           "steps": B2_DECODE_STEPS, "flash_decode_launches": launched,
           "model_flops_cell": bundle.model_flops,
           "reduced": [f"global_batch {b_cell}->{b}"]}
    if ms:
        out.update(step_ms_p50=float(np.median(ms)),
                   step_ms_p90=float(np.percentile(ms, 90)),
                   tokens_per_s=1e3 * b / float(np.median(ms)),
                   peak_bytes=torch.cuda.max_memory_allocated())
        # B4b, after the checks: one more step, counted (not timed)
        with torch.no_grad():
            out["b4"] = counted_against_meta(bundle.name, decode,
                                             (params, cache, token), dev)
    del params, cache, logits
    release(dev)
    return out


def timed_steps(step, params, state, data_at, steps: int):
    """``steps`` train steps from ``step``: (params, state, losses,
    seconds a step, skipped); each batch is drawn before its step's
    clock starts, and the loss is read after each (one sync)."""
    losses, secs, skipped = [], [], 0
    for i in range(steps):
        batch = data_at(i)
        t0 = time.monotonic()
        params, state, stats = step(params, state, batch)
        losses.append(float(stats["loss"]))
        secs.append(time.monotonic() - t0)
        skipped += int(stats["skipped"])
    return params, state, losses, secs, skipped


def launch_train_cells(counts, card: str, seed: int, device="cuda",
                       smoke: bool = False) -> dict:
    """B2's train cells through ``make_bundle(...).get_fn()``: DIEN at
    train_batch (65536) and EGNN at molecule (128 molecules of 30
    atoms), CONFIG width and depth, random float32 weights, AdamW
    (``AdamWConfig()``), B2_TRAIN_STEPS steps each on batches drawn
    anew each step; the concrete arguments of the abstract ones'
    shapes and dtypes, every loss finite, no step skipped."""
    import dataclasses
    import torch
    from repro_torch.configs import get
    from repro_torch.data.pipelines import molecule_batch
    from repro_torch.launch import steps as S
    from repro_torch.models import dien
    from repro_torch.models.gnn.egnn import EGNN
    from repro_torch.models.gnn.graph import from_numpy
    from repro_torch.train import optimizer as opt
    dev = torch.device(device)
    out = {}
    with counts.path("launch"):
        spec = get("dien")
        bundle = S.make_bundle("dien", "train_batch", smoke=smoke)
        cfg = spec.smoke if smoke else spec.config
        b = bundle.abstract_args[2]["label"].shape[0]
        params = dien.init_params(cfg, generator=torch.Generator(
            dev).manual_seed(seed), device=dev)
        state = opt.init(params, opt.AdamWConfig())
        batch0 = dien_inputs(cfg, 0, b, seed, dev)
        same_layout(f"B2 {bundle.name}", (params, state, batch0),
                    bundle.abstract_args)
        _, state, losses, secs, skipped = timed_steps(
            bundle.get_fn(), params, state,
            lambda i: batch0 if i == 0 else dien_inputs(cfg, i, b, seed, dev),
            B2_TRAIN_STEPS)
        out[bundle.name] = {"batch": b, "losses": losses, "step_s": secs,
                            "skipped": skipped, "step": int(state.step),
                            "model_flops": bundle.model_flops}
        del params, state, batch0
        release(dev)

        spec = get("egnn")
        bundle = S.make_bundle("egnn", "molecule", smoke=smoke)
        batch_a, labels_a = bundle.abstract_args[2]
        g = batch_a.n_graph
        d_feat = batch_a.nodes.shape[1]
        cfg = dataclasses.replace(spec.smoke if smoke else spec.config,
                                  d_in=d_feat, n_out=1)
        model = EGNN(cfg, generator=torch.Generator().manual_seed(seed),
                     device=dev)
        params = {k: p.detach() for k, p in model.named_parameters()}
        state = opt.init(params, opt.AdamWConfig())

        def data_at(i):
            mol = molecule_batch(i, g, batch_a.n_node // g,
                                 batch_a.n_edge // g, d_feat, seed=seed)
            gb = from_numpy(mol["node_feat"], mol["senders"],
                            mol["receivers"], pos=mol["pos"],
                            graph_id=mol["graph_id"], n_graph=g,
                            e_cap=batch_a.n_edge, device=dev)
            target = np.random.default_rng((seed, i)).normal(
                size=tuple(labels_a.shape)).astype(np.float32)
            return gb, torch.from_numpy(target).to(dev)

        same_layout(f"B2 {bundle.name}", (params, state, data_at(0)),
                    bundle.abstract_args)
        _, state, losses, secs, skipped = timed_steps(
            bundle.get_fn(), params, state, data_at, B2_TRAIN_STEPS)
        out[bundle.name] = {"batch": g, "losses": losses, "step_s": secs,
                            "skipped": skipped, "step": int(state.step),
                            "model_flops": bundle.model_flops}
        if dev.type == "cuda":      # B4b: one more step, counted
            out[bundle.name]["b4"] = counted_against_meta(
                bundle.name, bundle.get_fn(), (params, opt.init(
                    params, opt.AdamWConfig()), data_at(0)), dev)
        del params, state, model
        release(dev)
    for name, row in out.items():
        if not (np.isfinite(row["losses"]).all() and row["skipped"] == 0
                and row["step"] == B2_TRAIN_STEPS):
            raise AssertionError(f"B2 {name}: {json.dumps(row)}")
    return out


def oracle_on(graph, index, engine, sources, tag: str) -> None:
    """plain_spc_bfs from each source == the engine's answers on
    ``index`` to every vertex of ``graph``."""
    import torch
    from repro_torch.core.bfs import plain_spc_bfs
    n = graph.n
    t0 = time.monotonic()
    targets = np.arange(n)
    for s in sources:
        res = plain_spc_bfs(graph, int(s))
        d, c = engine.query_batch(index, np.full(n, s), targets)
        if not (torch.equal(d, res.dist[:n]) and torch.equal(c, res.cnt[:n])):
            bad = int(((d != res.dist[:n]) | (c != res.cnt[:n])).nonzero()[0])
            raise AssertionError(
                f"oracle {tag}: source {s} target {bad}: engine "
                f"({int(d[bad])}, {int(c[bad])}) vs BFS "
                f"({int(res.dist[bad])}, {int(res.cnt[bad])})")
    log(f"oracle[{tag}]: {len(sources)} sources x {n} targets equal to "
        f"plain_spc_bfs ({time.monotonic() - t0:.3f} s)")


def launch_dspc_events(graph, index, engine, counts, edges, seed: int,
                       build_s: float) -> dict:
    """B2's dspc cells on the main path's graph and index: the
    ``inc_update`` step (``inc_spc``) of one random vertex pair that is
    not an edge, then the ``dec_update`` step (``dec_spc``) of the edge
    that the cell's host arguments delete, ``edges[len(edges) // 2]`` of
    the graph's edge list (or the next one still in ``graph``), through
    ``make_bundle(...).get_fn()``; each event's seconds beside phase 4's
    rebuild; after each, B2_DSPC_SOURCES sources (both endpoints among
    them) answered exactly as ``plain_spc_bfs``."""
    import torch
    from repro_torch.core import graph as G
    from repro_torch.launch import steps as S
    dev = graph.device
    rng = np.random.default_rng(seed + 41)
    present = G.edge_set(graph)
    while True:
        a, b = (int(x) for x in rng.integers(0, graph.n, 2))
        if a != b and (min(a, b), max(a, b)) not in present:
            break
    i = len(edges) // 2
    while (min(map(int, edges[i])), max(map(int, edges[i]))) not in present:
        i += 1
    g0 = G.ensure_capacity(graph, 2)
    out, states, state = {}, [], (g0, index)
    with counts.path("launch"):
        for shape, edge in (("inc_update", (a, b)),
                            ("dec_update", tuple(map(int, edges[i])))):
            bundle = S.make_bundle("dspc", shape)
            step = bundle.get_fn()
            if dev.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.monotonic()
            state = step(*state, *(torch.tensor(x, dtype=torch.int32)
                                   for x in edge))
            if dev.type == "cuda":
                torch.cuda.synchronize()
            secs = time.monotonic() - t0
            states.append((bundle, edge, state))
            out[bundle.name] = {"edge": list(edge), "s": secs,
                                "rebuild_over_event": build_s / secs,
                                "entries": state[1].total_entries(),
                                "model_flops": bundle.model_flops}
    # the checks, outside the path: their queries count nowhere
    for bundle, (u, v), (g1, idx1) in states:
        if int(idx1.overflow):
            raise AssertionError(f"B2 {bundle.name}: {int(idx1.overflow)} "
                                 f"label writes lost (l_cap {idx1.l_cap})")
        has = G.has_edge(g1, u, v)
        if has != bundle.name.endswith("inc_update"):
            raise AssertionError(f"B2 {bundle.name}: edge ({u}, {v}) "
                                 f"present {has}")
        others = rng.choice(graph.n, size=B2_DSPC_SOURCES - 2, replace=False)
        oracle_on(g1, idx1, engine, [u, v, *others.tolist()],
                  f"B2 {bundle.name} ({u}, {v})")
    return out


def train_cli_phase(device="cuda") -> dict:
    """B3: ``python -m repro_torch.launch.train --arch dien`` (one device:
    the SMOKE fallback): 3 steps into a checkpoint directory, then 5
    steps from it (``resumed from step 2``), beside an uninterrupted
    5-step run; the two final checkpoints equal bit for bit, and the step
    lines' losses too."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (SRC, os.environ.get("PYTHONPATH")) if p))

    def start(steps, d):
        return subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch",
             "dien", "--steps", str(steps), "--ckpt-dir",
             os.path.join(tmp, d), "--device", str(device)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=ROOT)

    def finish(proc, what):
        out, err = proc.communicate(timeout=600)
        if proc.returncode:
            raise AssertionError(f"B3 {what}: exit {proc.returncode}: "
                                 f"{err[-2000:]}")
        return out.splitlines()

    def losses(lines):
        return [ln.split("(")[0] for ln in lines if " loss " in ln]

    def final(d):
        from repro_torch.train import checkpoint as ckpt
        path = os.path.join(tmp, d)
        step = ckpt.latest_step(path)
        with np.load(os.path.join(path, f"step_{step:09d}",
                                  "arrays.npz")) as z:
            return step, [z[k] for k in sorted(z.files, key=int)]

    t0 = time.monotonic()
    try:
        first, whole = start(3, "resumed"), start(5, "whole")
        lines = {"first": finish(first, "3 steps"),
                 "whole": finish(whole, "5 steps")}
        lines["second"] = finish(start(5, "resumed"), "resume to 5")
        (sa, xa), (sb, xb) = final("resumed"), final("whole")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if "[train] resumed from step 2" not in lines["second"]:
        raise AssertionError(f"B3: no resume line in {lines['second']}")
    if not all(any("falling back to --smoke" in ln for ln in v)
               for v in lines.values()):
        raise AssertionError("B3: a run did not fall back to --smoke")
    if losses(lines["first"]) + losses(lines["second"]) != \
            losses(lines["whole"]):
        raise AssertionError(f"B3: losses {lines}")
    if not (sa == sb == 4 and len(xa) == len(xb) and all(
            x.dtype == y.dtype and x.tobytes() == y.tobytes()
            for x, y in zip(xa, xb))):
        raise AssertionError("B3: the resumed run's final state differs "
                             "from the uninterrupted run's")
    return {"s": time.monotonic() - t0, "leaves": len(xa),
            "losses": losses(lines["whole"]), "bitwise": True}


def in_background(fn, *args):
    """Start ``fn(*args)`` on a thread; returns ``join()``, which waits
    for it and returns its result or raises its exception."""
    import threading
    box = {}

    def run():
        try:
            box["out"] = fn(*args)
        except BaseException as e:       # re-raised by join()
            box["err"] = e

    th = threading.Thread(target=run, daemon=True)
    th.start()

    def join():
        th.join()
        if "err" in box:
            raise box["err"]
        return box["out"]
    return join


#: E: the in-process examples at the reference's CI settings, and the
#: check each one's output (or result) must pass.
EXAMPLES = (
    ("quickstart", (), lambda r, out: r is True and "MISMATCH" not in out),
    ("dynamic_stream", ("--fast",),
     lambda r, out: "restored replica answers identically: OK" in out),
    ("serve_spc", ("--fast",),
     lambda r, out: "read its own write" in out and "coalesced" in out),
    ("analytics_spc", ("--fast",), lambda r, out: "model re-rank" in out),
    ("gnn_molecule", (), lambda r, out: out.rstrip().endswith("done.")),
    ("serve_lm", (), lambda r, out: r[0] == r[1]),
    ("train_lm", (), lambda r, out: r[1] < r[0]),
)


def examples_phase(counts, device="cuda") -> dict:
    """E: the eight examples (``repro_torch.examples``) on ``device``:
    seven in this process through ``main(argv)``, their launches counted
    on the examples path, and ``fleet_spc`` as its own replica and
    updater processes (started first, in the background)."""
    import contextlib
    import importlib
    import io
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip_smoke_examples_")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (SRC, os.environ.get("PYTHONPATH")) if p))
    out = {}
    t_fleet = time.monotonic()
    fleet = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.examples.fleet_spc", "--fast",
         "--device", str(device), "--dir", os.path.join(tmp, "fleet")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=ROOT)
    try:
        with counts.path("examples"):
            for name, argv, check in EXAMPLES:
                mod = importlib.import_module(f"repro_torch.examples.{name}")
                argv = list(argv) + ["--device", str(device)]
                if name == "train_lm":
                    argv += ["--ckpt-dir", os.path.join(tmp, "lm")]
                buf = io.StringIO()
                t0 = time.monotonic()
                with contextlib.redirect_stdout(buf):
                    result = mod.main(argv)
                secs = time.monotonic() - t0
                text = buf.getvalue()
                if not check(result, text):
                    raise AssertionError(f"E {name}: its check failed:\n"
                                         f"{text[-3000:]}")
                out[name] = {"s": secs, "last": text.splitlines()[-1]}
                log(f"E {name}: {secs:.2f} s; {out[name]['last']}")
        text, _ = fleet.communicate(timeout=600)
        if fleet.returncode or "fleet demo OK" not in text:
            raise AssertionError(f"E fleet_spc: exit {fleet.returncode}:\n"
                                 f"{text[-3000:]}")
        out["fleet_spc"] = {"s": time.monotonic() - t_fleet,
                            "last": text.splitlines()[-1]}
        log(f"E fleet_spc: {out['fleet_spc']['s']:.2f} s (background); "
            f"{out['fleet_spc']['last']}")
    finally:
        if fleet.poll() is None:
            fleet.kill()
            fleet.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--halvings", type=int, default=MAIN_HALVINGS,
                    help="halve the dspc CONFIG's n and m this many times")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lm-seeds", default="",
                    help="comma-separated seeds: build the kernels, then "
                         "only read L4 and its controls for the first "
                         f"{LM_CHECK} requests of each seed and exit")
    ap.add_argument("--replica-of", default="", help=argparse.SUPPRESS)
    ap.add_argument("--pairs", default="", help=argparse.SUPPRESS)
    ap.add_argument("--replica-device", default="cuda",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    start = time.monotonic()
    laps = Laps(start)

    import torch
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    if args.replica_of:       # S3's second process (the CPU in the tests)
        return replica_main(args.replica_of, args.pairs,
                            args.replica_device)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 1
    import dataclasses
    import gc
    import torch.nn.functional as F
    from repro_torch.analytics import AnalyticsEngine, CycleCount
    from repro_torch.bench import kernels_bench as KB
    from repro_torch.configs.common import LM_SHAPES
    from repro_torch.configs.dspc import CONFIG
    from repro_torch.configs.pna import CONFIG as PNA_CONFIG
    from repro_torch.configs.qwen2_1_5b import CONFIG as QWEN_CONFIG
    from repro_torch.core import bfs as B
    from repro_torch.core.dynamic import DynamicSPC
    from repro_torch.core.graph import INF
    from repro_torch.core.query import merge_rows
    from repro_torch.data.pipelines import graph_stream
    from repro_torch.kernels import common
    from repro_torch.kernels.embedding_bag import kernel as EB
    from repro_torch.kernels.embedding_bag.ops import embedding_bag
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
    from repro_torch.kernels.flash_decode import kernel as FD
    from repro_torch.kernels.flash_decode.ref import decode_attention_ref
    from repro_torch.kernels.segment_matmul import kernel as SM
    from repro_torch.kernels.segment_matmul.ops import gather_scatter
    from repro_torch.kernels.segment_matmul.ref import segment_matmul_ref
    from repro_torch.kernels.spc_query import kernel as K
    from repro_torch.kernels.spc_query.ops import prep_rows
    from repro_torch.kernels.spc_query.ref import spc_query_ref
    from repro_torch.models import transformer as tf
    from repro_torch.models.gnn.pna import PNA
    from repro_torch.serve.engine import QueryEngine

    # plain float32 products in full float32, as XLA's on the reference
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)

    # -- 1. device --------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    log(f"device: {kind} (count {count}); torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    counts = PathLaunches({"spc_query": K.launches,
                           "segment_matmul": SM.launches,
                           "embedding_bag": EB.launches,
                           "flash_decode": FD.launches})

    # -- Z. analysis (host only) ---------------------------------------------
    with counts.path("analysis"):
        analysis_phase()
    laps.lap("Z analysis")

    # -- 2. build ------------------------------------------------------------
    t0 = time.monotonic()
    secs = common.build(list(KERNEL_SOURCES))
    log(f"build: {', '.join(f'{k} {v:.2f} s' for k, v in secs.items())} "
        f"(wall {time.monotonic() - t0:.2f} s)")
    for name, text in common.build_logs.items():
        for line in text.strip().splitlines():
            log(f"  nvcc[{name}]: {line.strip()}")
    usage = {name: ptxas_usage(text)
             for name, text in common.build_logs.items()}
    for name, funcs in usage.items():
        log(f"ptxas[{name}]: " + "; ".join(
            f"{f['function']} {f['registers']} registers, smem {f['smem']} "
            f"B, spills {f['spill_stores']}/{f['spill_loads']} B"
            for f in funcs))
    spilled = [f["function"] for funcs in usage.values() for f in funcs
               if f["function"].startswith(REDESIGNED)
               and f["spill_stores"] + f["spill_loads"]]
    if spilled:
        raise AssertionError(f"the redesigned kernels spill: {spilled}")
    if args.lm_seeds:
        return lm_seed_readings([int(x) for x in args.lm_seeds.split(",")],
                                card)

    laps.lap("2 kernel build")

    # -- 3a. kernels vs plain on synthetic inputs -------------------------
    # spc_query exactly: each input in the gathered form (the fused kernel
    # with identity ids), through the warp kernel, and in the index
    # form (the rows written into an index, read by id)
    max_err = 0
    k1_inputs = []
    for b, l_cap in ((4, 8), (130, 16), (256, 32), (17, 128)):
        n_hub = max(50, 2 * l_cap)
        k1_inputs.append((f"sweep({b},{l_cap})",
                          sweep_rows(b, l_cap, n_hub, rng, dev), n_hub, None))
    rows, want = big_count_rows(dev)
    k1_inputs.append(("big counts", rows, 3, want))
    # hubs that repeat within a row: the reference microbench's own draw
    # (hubs below 500), and a hand-made pair
    k1_inputs.append(("microbench rows (repeated hubs)",
                      tuple(torch.from_numpy(x).to(dev)
                            for x in KB.query_inputs()), 500, None))
    rows, want = repeated_hub_rows(dev)
    k1_inputs.append(("repeated hubs", rows, 10, want))
    for tag, rows, n_hub, want in k1_inputs:
        plain = spc_query_ref(*rows)
        idx, s_ids, t_ids = rows_as_index(rows, n_hub)
        for form, got in (
                ("gathered", K.spc_query_cuda(*rows)),
                ("warp", K._warp_cuda(*rows)),
                ("index", K.spc_query_index_cuda(idx.hub, idx.dist, idx.cnt,
                                                 s_ids, t_ids)),
                ("index plain", index_plain(idx, s_ids, t_ids))):
            torch.cuda.synchronize()
            max_err = max(max_err, check_equal(f"{tag} {form}", got, plain))
            if want is not None and [got[0].tolist(),
                                     got[1].tolist()] != list(want):
                raise AssertionError(f"{tag} {form}: {got} != {want}")
    log(f"kernels: spc_query == plain on the sweep, on counts "
        f"{k1_inputs[4][3][1]} and on rows with repeated hubs (the "
        f"microbench draw; hand-made: {k1_inputs[-1][3]}), in the gathered "
        f"form, the warp kernel and the index form (exact)")
    # the index form on [n + 1, 2048] indexes with pads, whole rows and
    # hubs distinct or repeating, at ids outside [0, n] too
    synth_rng = np.random.default_rng(args.seed + 5)
    for repeat in (False, True):
        idx = synthetic_index(K1_SYNTH_N, 2048, synth_rng, dev, repeat)
        s_ids, t_ids = index_ids(idx.n, K1_SYNTH_N, synth_rng, dev)
        got = K.spc_query_index_cuda(idx.hub, idx.dist, idx.cnt, s_ids,
                                     t_ids)
        torch.cuda.synchronize()
        max_err = max(max_err, check_equal(
            f"index (n {idx.n}, L 2048, repeat {repeat})", got,
            index_plain(idx, s_ids, t_ids)))
    del idx, s_ids, t_ids
    log(f"kernels: spc_query index form == plain on two [{K1_SYNTH_N + 1}, "
        f"2048] indexes (hubs distinct, hubs repeating; a tenth of the rows "
        f"full) at {K1_SYNTH_N} pairs with ids 0, n - 1, n, -1, -(n + 1), "
        f"-(n + 5), n + 3 (exact)")

    # both designs on every input, whichever the plan picks
    seg_designs = {"sorted": SM._sorted_cuda, "blocked": SM._blocked_cuda}
    seg_err, seg_err16 = 0.0, 0.0
    for e, n_seg, d in SEG_SWEEP:
        vals, dst = segment_sweep_inputs(e, n_seg, d, dev)
        for (tag, ids), (design, run) in itertools.product(
                (("", dst), (" negative ids", dst - 5)), seg_designs.items()):
            tag = f"segment_matmul {(e, n_seg, d)}{tag} {design}"
            got = run(vals, ids, n_seg)
            again = run(vals, ids, n_seg)
            torch.cuda.synchronize()
            seg_err = max(seg_err, check_close(
                f"{tag} f32", got, sequential_plain(vals, ids, n_seg),
                1e-6, 1e-6))
            if not torch.equal(got, again):
                raise AssertionError(f"{tag}: two launches differ")
            vals16 = vals.to(torch.bfloat16)
            got16 = run(vals16, ids, n_seg)
            torch.cuda.synchronize()
            if got16.dtype != torch.bfloat16:
                raise AssertionError(f"segment_matmul bf16 gave {got16.dtype}")
            seg_err16 = max(seg_err16, check_close(
                f"{tag} bf16", got16.float(),
                segment_matmul_ref(vals16.float(), ids, n_seg), 1e-2, 1e-2))
    for design, run in seg_designs.items():
        empty = run(vals[:0], dst[:0], 7)
        torch.cuda.synchronize()
        if empty.shape != (7, vals.shape[1]) or empty.any():
            raise AssertionError(f"segment_matmul {design} with E = 0: "
                                 f"{empty}")
    # one segment of SEG_LONG edges among others, ids shuffled; integer
    # values, so every order of summation gives the same floats
    seg_rng = np.random.default_rng(args.seed + 4)
    long_ids = np.concatenate([np.full(SEG_LONG, 7),
                               seg_rng.integers(-3, 40, 3000)])
    long_dst = torch.from_numpy(seg_rng.permutation(long_ids)
                                .astype(np.int32))
    long_vals = torch.from_numpy(seg_rng.integers(
        -8, 9, (long_ids.size, 64)).astype(np.float32))
    long_dst, long_vals = long_dst.to(dev), long_vals.to(dev)
    for (design, run), x in itertools.product(
            seg_designs.items(), (long_vals, long_vals.to(torch.bfloat16))):
        got = run(x, long_dst, 32)
        again = run(x, long_dst, 32)
        torch.cuda.synchronize()
        if not (torch.equal(got, segment_matmul_ref(x, long_dst, 32))
                and torch.equal(got, again)):
            raise AssertionError(f"segment_matmul {design}: a segment of "
                                 f"{SEG_LONG} edges ({x.dtype}) differs "
                                 f"from plain")
    log(f"kernels: segment_matmul == plain in both designs on the TPU "
        f"sweep, with negative ids, unsorted, at E = 0 and with a segment of "
        f"{SEG_LONG} edges (f32 max |diff| {seg_err:.3g}, bf16 "
        f"{seg_err16:.3g} against the f32 sum; the long segment exact); two "
        f"launches bitwise equal")

    # the packed design (the route) and the warp design on each
    # input: within the tolerances of the plain version, and equal to each
    # other bit for bit (both add each column's rows in slot order)
    l2, l2_probes = l2_rate(dev)
    log(f"L2: PyTorch kernels over a {L2_PROBE_BYTES} B float32 tensor that "
        f"stays in L2 move, in TB/s: "
        f"{json.dumps({k: v / 1e12 for k, v in l2_probes.items()})} (each "
        f"kernel's device time); the fastest, {l2 / 1e12:.3f} TB/s, is the "
        f"L2 rate of the reckoning below on {card}")
    bag_err, bag_shapes = 0.0, []
    for tag, (b, s, v, d) in ([(f"sweep{shape}", shape)
                               for shape in BAG_SWEEP]
                              + [(name, (b, RECSYS_BAG, RECSYS_VOCAB,
                                         RECSYS_DIM))
                                 for name, b in BAG_RECSYS]):
        ids, table = bag_inputs(b, s, v, d, rng, dev)
        truth = embedding_bag_ref(ids, table)
        table16 = table.to(torch.bfloat16)
        for x in (table, table16):
            got, again = EB.embedding_bag_cuda(ids, x), EB.embedding_bag_cuda(
                ids, x)
            old = EB._warp_cuda(ids, x)
            torch.cuda.synchronize()
            if x.dtype == torch.float32:
                bag_err = max(bag_err, check_close(
                    f"embedding_bag {tag} f32", got, truth, 1e-6, 1e-6))
            else:
                check_close(f"embedding_bag {tag} bf16", got,
                            embedding_bag_ref(ids, x.float()), 1e-2, 1e-2)
            if not (torch.equal(got, again) and torch.equal(got, old)):
                raise AssertionError(f"embedding_bag {tag} {x.dtype}: two "
                                     f"launches, or the two designs, differ")
        if tag.startswith("sweep"):
            continue
        lib = F.embedding_bag(ids, table, mode="sum")
        check_close(f"F.embedding_bag {tag}", lib, truth, 1e-5, 1e-5)
        bag_calls = {"packed": lambda: EB.embedding_bag_cuda(ids, table),
                     "warp": lambda: EB._warp_cuda(ids, table),
                     "library": lambda: F.embedding_bag(ids, table,
                                                        mode="sum")}
        bag_reps = {k: [] for k in bag_calls}
        for _ in range(K3_REPS):
            for k, fn in bag_calls.items():
                bag_reps[k].append(cuda_ms(fn, 50))
        bag_device = {k: graph_ms(bag_calls[k]) for k in ("packed", "warp")}
        nbytes, ops, distinct = embedding_bag_work(ids, table)
        bound, by = bound_ms(nbytes, ops)
        # every slot's row read once per occurrence, from L2, in sectors
        l2_bytes = sector_bytes(ids, table)
        bag_shapes.append({
            "shape": tag, "bags": b, "ids_per_bag": s, "rows": v + 1,
            "dim": d, "distinct_rows": distinct,
            "design": EB.plan(d, table.dtype, table.data_ptr())._asdict(),
            "ms": float(np.median(bag_reps["packed"])),
            "ms_rounds": bag_reps["packed"], "warp_ms": bag_reps["warp"],
            "device_ms": bag_device,
            "bf16_ms": cuda_ms(lambda: EB.embedding_bag_cuda(ids, table16),
                               50),
            "plain_ms": cuda_ms(lambda: embedding_bag_ref(ids, table), 10),
            "library_ms": float(np.median(bag_reps["library"])),
            "library_ms_rounds": bag_reps["library"],
            "bound_ms": bound, "bound_by": by, "bytes": nbytes,
            "l2_sector_bytes": l2_bytes,
            "l2_bound_ms": 1e3 * (l2_bytes / l2 + (nbytes - distinct * d
                                  * table.element_size()) / HBM_BYTES_PER_S)})
        log(f"embedding_bag {tag}: {json.dumps(bag_shapes[-1])} on {card}")
    log(f"kernels: embedding_bag == plain on the sweep and the recsys "
        f"shapes (f32 max |diff| {bag_err:.3g}; bf16 within 1e-2)")
    # F1: ids in [-(V + 1), -1] read from the end, as the reference reads
    # them; below that the zero row (F2)
    ids, table, want = wrapped_id_rows(dev)
    for tag, got in (("kernel", EB.embedding_bag_cuda(ids, table)),
                     ("ops", embedding_bag(ids, table[:-1]))):
        torch.cuda.synchronize()
        if got.tolist() != want or not torch.equal(
                got, embedding_bag_ref(ids, table)):
            raise AssertionError(f"embedding_bag {tag} on ids "
                                 f"{ids[:, 0].tolist()}: {got.tolist()} != "
                                 f"{want}")
    log(f"kernels: embedding_bag (kernel and ops) reads ids "
        f"{ids[:, 0].tolist()} of a 4-row table as rows {want} (exact)")

    dec_rng = np.random.default_rng(args.seed + 3)
    dec_err = dec_err16 = 0.0
    for b, h, kvh, s_len, d in DECODE_SWEEP:
        tag = f"flash_decode {(b, h, kvh, s_len, d)}"
        q, k, v, lengths = decode_inputs(b, h, kvh, s_len, d, dec_rng, dev)
        got = FD.flash_decode_cuda(q, k, v, lengths)
        torch.cuda.synchronize()
        dec_err = max(dec_err, check_close(
            f"{tag} f32", got, decode_attention_ref(q, k, v, lengths), 2e-5,
            2e-5))
        if b > 2 and got[-1].any():
            raise AssertionError(f"{tag}: the row of length 0 is not zero")
        q16, k16, v16 = (x.to(torch.bfloat16) for x in (q, k, v))
        want16 = decode_attention_ref(q16.float(), k16.float(), v16.float(),
                                      lengths)
        # the planned route (the tensor cores at D 64 and 128), twice, and
        # the CUDA-core route
        got16 = FD.flash_decode_cuda(q16, k16, v16, lengths)
        again = FD.flash_decode_cuda(q16, k16, v16, lengths)
        simt16 = FD._simt_cuda(q16, k16, v16, lengths)
        torch.cuda.synchronize()
        if not torch.equal(got16, again):
            raise AssertionError(f"{tag} bf16: two launches differ")
        for route, out in (("planned", got16), ("simt", simt16)):
            dec_err16 = max(dec_err16, check_close(
                f"{tag} bf16 {route}", out, want16, 1e-2, 1e-2))
            if b > 2 and out[-1].any():
                raise AssertionError(f"{tag} bf16 {route}: the row of "
                                     f"length 0 is not zero")
    log(f"kernels: flash_decode == plain on the TPU sweep and GQA groups "
        f"(f32 max |diff| {dec_err:.3g}, bf16 {dec_err16:.3g} on both "
        f"routes; rows of length 0 give zeros; two launches bitwise equal) "
        f"on {card}")

    laps.lap("3a kernel checks")

    # -- 4. main paths: build --------------------------------------------------
    n, m = CONFIG.n >> args.halvings, CONFIG.m >> args.halvings
    reduced = ([f"n {CONFIG.n}->{n}", f"m {CONFIG.m}->{m}"]
               if args.halvings else []) + [
        f"5 maintain chunk {CONFIG.update_batch}->{MAINTAIN_EVENTS} events",
        f"service update_batch {CONFIG.update_batch}->{SERVICE_CHUNK} (S1-S4 "
        f"only)",
        # the script's time limit (phase X10)
        f"S1 events 8->{SERVICE_EVENTS} (the first {SERVICE_EVENTS} of "
        f"the same stream, two tickets of {SERVICE_EVENTS // 2})",
        f"D halvings 2->{DIST_HALVINGS}",
        # the script's time limit (PR 24 added phases B and E)
        f"M deepseek-v2-lite-16b global_batch 128->{DS_BATCH} (8 until "
        f"PR 24)",
        f"G minibatch_lg timed calls {GNN_REPS}->{GNN_REPS_LG}",
        f"X4 minibatch_lg n_layers 12->{X4_LG_LAYERS}",
        "B2 dspc/dec_update deletes the cell's edge, edges[m // 2], not a "
        "uniformly random one (whose delete runs from ~1 s to over 60 s "
        "with its affected hubs)",
        f"B2 qwen2-1.5b decode_32k global_batch 128->{B2_DECODE_BATCH}"]
    t0 = time.monotonic()
    edges = power_law_edges(n, m, args.seed)
    log(f"graph: n={n} m={len(edges)} power-law w~i^-0.8 "
        f"({time.monotonic() - t0:.2f} s on the host)")
    log(f"reduced: {json.dumps(reduced)}")
    B.frontier_syncs.count = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    # phase D builds its own graph with the same knobs, on one device and
    # edge-sharded
    build_kw = dict(l_cap=None, construct_batch=CONFIG.construct_batch,
                    vertex_order=CONFIG.vertex_order)
    t0 = time.monotonic()
    with counts.path("dspc"):
        svc = DynamicSPC(n, edges, device="cuda", **build_kw)
        torch.cuda.synchronize()
    build_s = time.monotonic() - t0
    log(f"build: {build_s:.3f} s, l_cap {svc.index.l_cap}, "
        f"{svc.index_entries()} label entries "
        f"(max {int(svc.index.size.max())}/row), {svc.index_bytes()} index "
        f"bytes, label regrows {svc.stats.label_regrows}, host syncs "
        f"{B.frontier_syncs.count}, max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} B")
    engine = QueryEngine(route="auto")
    sources = rng.choice(n, size=8, replace=False)
    oracle(svc, engine, sources, "after build")

    laps.lap("4 build")

    # -- K. the kernel microbench path, then K2 at the graph's shape -------
    g_src, g_dst = live_edges(svc.graph)
    g_dst32 = g_dst.to(torch.int32)
    feats = quantized_features(n, SEG_FEATURES, seg_rng, dev)
    t0 = time.monotonic()
    with counts.path("kernels"):
        q_row, = KB.query_kernel_vs_plain(seed=args.seed)
        s_row, = KB.segment_matmul_vs_segment_sum(seed=args.seed)
        agg = gather_scatter(feats, g_src, g_dst, n)
        torch.cuda.synchronize()
    kernels_s = time.monotonic() - t0
    msgs = torch.index_select(feats, 0, g_src)
    g_longest = segment_matmul_work(msgs, g_dst32, n)[2]
    if g_longest >= 1 << 16:
        raise AssertionError(f"a segment of {g_longest} edges: sums of the "
                             f"quantized features are no longer exact")
    if not torch.equal(agg, segment_matmul_ref(msgs, g_dst32, n)):
        raise AssertionError("gather_scatter at the graph's shape differs "
                             "from the plain version (exact sums)")
    msgs16 = msgs.to(torch.bfloat16)
    # N(0, 1) messages: the order of summation shows in the floats
    normal = torch.randn(msgs.shape, generator=torch.Generator(
        "cuda").manual_seed(args.seed), device=dev)
    # the BFS relaxation form: D = 1, counts of a random frontier, n + 1
    # segments
    cnt = torch.from_numpy(seg_rng.integers(1, 5, n + 1)).to(dev)
    frontier = torch.from_numpy(seg_rng.random(n + 1) < 0.5).to(dev)
    frontier[n] = False
    relax = torch.where(frontier[g_src], cnt[g_src], 0).float()[:, None]
    relaxed = B.edge_relax(g_src, g_dst, cnt, frontier)
    # both designs at the graph's shapes (the plan picks the sorted one):
    # the quantized features exactly in f32 and bf16; the N(0, 1) messages
    # bit for bit across two launches and within the error bound of fp32
    # summation of the float64 sum; the relaxation equal to the int64
    # edge_relax
    g_err = 0.0
    for design, run in seg_designs.items():
        for x in (msgs, msgs16):
            if not torch.equal(run(x, g_dst32, n),
                               segment_matmul_ref(x, g_dst32, n)):
                raise AssertionError(f"segment_matmul {design} {x.dtype} at "
                                     f"the graph's shape differs from the "
                                     f"plain version (exact sums)")
        got = run(normal, g_dst32, n)
        again = run(normal, g_dst32, n)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"segment_matmul {design}: two launches at "
                                 f"the graph's shape differ")
        g_err = max(g_err, check_summation_bound(
            f"segment_matmul {design} at the graph's shape", got, normal,
            g_dst32, n, design))
        got = run(relax, g_dst32, n + 1)
        torch.cuda.synchronize()
        if not torch.equal(got[:, 0].long(), relaxed):
            raise AssertionError(f"segment_matmul {design} differs from "
                                 f"edge_relax on the graph's relaxation")
    del got, again
    # the times of both designs, index_add_ and the plain version at each
    # shape, SEG_REPS rounds in turn; the card's busy time per call of the
    # planned design and of index_add_ from a trace of back-to-back calls
    mb_vals, mb_dst = (torch.from_numpy(x).to(dev)
                       for x in KB.segment_inputs(seed=args.seed))
    seg_shapes = []
    for tag, x, n_seg, ids, order in (
            ("microbench", mb_vals, s_row["nodes"], mb_dst, "sorted"),
            ("graph f32", normal, n, g_dst32, "graph slots (unsorted)"),
            ("graph bf16", msgs16, n, g_dst32, "graph slots (unsorted)"),
            ("relaxation", relax, n + 1, g_dst32, "graph slots (unsorted)")):
        ids64 = ids.long()
        design = SM.plan(x.shape[0], n_seg, x.shape[1], x.dtype)
        calls = {"sorted": lambda: SM._sorted_cuda(x, ids, n_seg),
                 "blocked": lambda: SM._blocked_cuda(x, ids, n_seg),
                 "index_add_": lambda: torch.zeros(
                     (n_seg, x.shape[1]), dtype=x.dtype,
                     device=dev).index_add_(0, ids64, x)}
        reps = {k: [] for k in calls}
        for _ in range(SEG_REPS):
            for k, fn in calls.items():
                reps[k].append(cuda_ms(fn, 50))
        busy = {k: device_trace(lambda: [calls[k]() for _ in range(
            SEG_TRACE_CALLS)])[0] for k in (design, "index_add_")}
        nbytes, _, longest = segment_matmul_work(x, ids, n_seg)
        seg_shapes.append({
            "shape": tag, "edges": x.shape[0], "nodes": n_seg,
            "d": x.shape[1], "dtype": str(x.dtype).split(".")[-1],
            "dst": order, "longest_segment": longest, "design": design,
            "ms": float(np.median(reps[design])),
            "sorted_ms": reps["sorted"], "blocked_ms": reps["blocked"],
            "device_ms": busy[design] and busy[design] / SEG_TRACE_CALLS,
            "plain_ms": cuda_ms(lambda: segment_matmul_ref(x, ids, n_seg),
                                20),
            "library_ms": float(np.median(reps["index_add_"])),
            "index_add_ms": reps["index_add_"],
            "library_device_ms": busy["index_add_"] and busy[
                "index_add_"] / SEG_TRACE_CALLS,
            "sort_ms": cuda_ms(lambda: torch.sort(ids, stable=True), 50),
            "bytes": nbytes})
        if tag == "microbench":
            seg_shapes[-1].update(bench_ms=s_row["kernel_ms"],
                                  bench_index_add_ms=s_row["index_add_ms"])
    seg_shapes[-1]["edge_relax_ms"] = cuda_ms(
        lambda: B.edge_relax(g_src, g_dst, cnt, frontier), 50)
    for row in seg_shapes:
        row["bound_ms"], row["bound_by"] = bound_ms(
            row["bytes"], row["edges"] * row["d"])
        log(f"segment_matmul {row['shape']}: {json.dumps(row)} on {card}")
    log(f"kernels path: {kernels_s:.3f} s; spc_query microbench "
        f"{json.dumps(q_row)}; gather_scatter over {g_src.numel()} edge "
        f"slots x {SEG_FEATURES} into {n} segments equal to plain (exact, "
        f"f32 and bf16, both designs); N(0, 1) max |diff| {g_err:.3g} from "
        f"the float64 sum; relaxation equal to edge_relax; on {card}")
    del (g_src, g_dst, g_dst32, feats, agg, msgs, msgs16, normal, relax, cnt,
         frontier, relaxed, mb_vals, mb_dst, x, ids, ids64, calls)
    gc.collect()
    torch.cuda.empty_cache()

    laps.lap("K kernels path")

    # -- A1. analytics pinned before the chunk ----------------------------------
    store = svc.attach_store()
    ana = AnalyticsEngine.from_config(store, CONFIG)
    pairs = ana.sample_pairs()
    t0 = time.monotonic()
    with counts.path("analytics"):
        maint = ana.betweenness_maintainer(pairs)
        pinned = ana.pin()
    seed_s = time.monotonic() - t0
    frozen = {f.name: getattr(pinned.index, f.name).clone()
              for f in dataclasses.fields(pinned.index) if f.name != "n"}
    log(f"analytics: store v{store.version}; TopKBetweenness over "
        f"{len(pairs[0])} pairs x {n} candidates seeded in {seed_s:.3f} s "
        f"(top 3 {maint.top(3)})")
    t0 = time.monotonic()
    bc_err = check_close(
        "betweenness after build", torch.from_numpy(maint.scores()).to(dev),
        bfs_betweenness(svc.graph, *pairs), 1e-9, 1e-9)
    log(f"oracle[betweenness after build]: equal to the BFS pair "
        f"dependencies of {len(np.unique(np.concatenate(pairs)))} "
        f"endpoints (max |diff| {bc_err:.3g}; "
        f"{time.monotonic() - t0:.3f} s)")

    laps.lap("A1 analytics")

    # -- 5. maintain --------------------------------------------------------
    half = MAINTAIN_EVENTS // 2
    events = graph_stream(edges, n, half, half, seed=args.seed)
    syncs0 = B.frontier_syncs.count
    regrows0 = svc.stats.label_regrows
    torch.cuda.synchronize()
    t0 = time.monotonic()
    with counts.path("dspc"):
        svc.apply_events(events, batch_size=CONFIG.update_batch)
        torch.cuda.synchronize()
    st = svc.stats.snapshot()
    log(f"maintain: {len(events)} events in {st.batches} chunk(s), "
        f"{time.monotonic() - t0:.3f} s, inserts {st.inserts}, deletions "
        f"{st.deletions}, label regrows {st.label_regrows - regrows0}, edge "
        f"regrows {st.edge_regrows}, host syncs {B.frontier_syncs.count - syncs0}, "
        f"l_cap {svc.index.l_cap}, store v{store.version}")
    oracle(svc, engine, sources, "after events")

    laps.lap("5 maintain")

    # -- 6. serve -----------------------------------------------------------
    batches = [(rng.integers(0, n, 1024), rng.integers(0, n, 1024))
               for _ in range(64)]
    served, serve_us = {}, {}
    for route in ("auto", "merge"):
        eng = QueryEngine(route=route)
        evs = [torch.cuda.Event(enable_timing=True) for _ in range(65)]
        outs = []
        with counts.path("dspc"):
            eng.query_batch(svc.index, *batches[0])      # warm-up
            torch.cuda.synchronize()
            t0 = time.monotonic()
            evs[0].record()
            for k, (s, t) in enumerate(batches):
                outs.append(eng.query_batch(svc.index, s, t))
                evs[k + 1].record()
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
        us = [1e3 * evs[k].elapsed_time(evs[k + 1]) for k in range(64)]
        served[route] = outs
        log(f"serve[{route}]: routes {dict(eng.stats.snapshot().routes)}, "
            f"per-batch us p50 {np.percentile(us, 50):.1f} p90 "
            f"{np.percentile(us, 90):.1f} max {max(us):.1f}, "
            f"{64 * 1024 / wall:.1f} qps ({wall:.4f} s)")
        if route == "auto" and dict(eng.stats.routes) != {"kernel": 65}:
            raise AssertionError(f"auto did not take the kernel route: "
                                 f"{eng.stats.routes}")
        serve_us[route] = us
    for (d0, c0), (d1, c1) in zip(served["auto"], served["merge"]):
        if not (torch.equal(d0, d1) and torch.equal(c0, c1)):
            raise AssertionError("serve: kernel and merge routes differ")
    log("serve: kernel and merge routes agree on all 64 batches")
    # the card's busy time per batch, batches replayed under the profiler
    # (outside the path: the replay counts nowhere)
    eng = QueryEngine(route="auto")
    replay = batches[:SERVE_TRACE_BATCHES]

    def serve_replay():
        for s, t in replay:
            eng.query_batch(svc.index, s, t)
    serve_busy, serve_span, serve_kernels = device_trace(
        serve_replay, len(replay), ("spc_query_fused", len(replay)))
    serve_p50 = float(np.percentile(serve_us["auto"], 50))
    serve = {"batch_us_p50": serve_p50,
             "batch_us_p90": float(np.percentile(serve_us["auto"], 90)),
             "merge_batch_us_p50": float(np.percentile(serve_us["merge"],
                                                        50)),
             "busy_us_per_batch": serve_busy and 1e3 * serve_busy
             / len(replay),
             "idle_share": serve_busy and 1 - 1e3 * serve_busy / len(replay)
             / serve_p50,
             "device_us_per_batch_by_kernel": {
                 k: 1e3 * v for k, v in serve_kernels.items()}}
    log("serve trace: " + (
        f"{len(replay)} batches replayed under torch.profiler, the card busy "
        f"{serve_busy:.4f} ms of {serve_span:.4f} ms from its first to its "
        f"last device event; busy {serve['busy_us_per_batch']:.2f} us per "
        f"batch, idle share {serve['idle_share']:.4f} of the batch p50 "
        f"{serve_p50:.1f} us; by kernel, us per batch: "
        f"{json.dumps(serve['device_us_per_batch_by_kernel'])}"
        if serve_busy else "the profiler saw no device event; busy time "
        "not measured") + f" on {card}")

    laps.lap("6 serve")

    # -- 6b. one batch of the configuration's query_batch pairs -------------
    qb = CONFIG.query_batch
    big_s, big_t = rng.integers(0, n, qb), rng.integers(0, n, qb)
    eng = QueryEngine(route="auto")
    torch.cuda.synchronize()
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    big_secs, d_big, c_big = [], None, None
    for k in range(3):
        d_big = c_big = None                # one batch's answers at a time
        launched = K.launches.count
        t0 = time.monotonic()
        with counts.path("dspc") if k == 0 else contextlib.nullcontext():
            d_big, c_big = eng.query_batch(svc.index, big_s, big_t)
            torch.cuda.synchronize()
        big_secs.append(time.monotonic() - t0)
        if k and K.launches.count != launched + 1:
            raise AssertionError(f"a batch of {qb} pairs made "
                                 f"{K.launches.count - launched} launches")
    big_peak = torch.cuda.max_memory_allocated() - base_mem
    # the card's part of such a batch: the id copy and the kernel, timed
    # apart with CUDA events
    big_ids = np.stack([big_s, big_t])
    s_big, t_big = torch.from_numpy(big_ids).to(dev)
    big_kernels = {
        "ids_to_device": cuda_ms(lambda: torch.from_numpy(big_ids).to(dev),
                                 5),
        "spc_query_fused": cuda_ms(lambda: K.spc_query_index_cuda(
            svc.index.hub, svc.index.dist, svc.index.cnt, s_big, t_big), 5)}
    del s_big, t_big
    # against the gathered route, QUERY_SLICE pairs at a time
    wrong = torch.zeros((), dtype=torch.int64, device=dev)
    for lo in range(0, qb, QUERY_SLICE):
        sl = slice(lo, lo + QUERY_SLICE)
        d0, c0 = gathered_route(svc.index,
                                torch.from_numpy(big_s[sl]).to(dev),
                                torch.from_numpy(big_t[sl]).to(dev))
        wrong += (d0 != d_big[sl]).sum() + (c0 != c_big[sl]).sum()
    if int(wrong) or d_big.shape != (qb,) or c_big.dtype != torch.int64:
        raise AssertionError(f"the batch of {qb} pairs differs from the "
                             f"gathered route in {int(wrong)} answers")
    big = {"pairs": qb, "s": big_secs, "qps": qb / min(big_secs),
           "peak_bytes_above_index": big_peak,
           "device_ms": big_kernels,
           "connected": int((d_big < INF).sum())}
    log(f"serve[{qb} pairs]: one QueryEngine(route='auto') batch in "
        f"{', '.join(f'{x:.4f}' for x in big_secs)} s (3 calls, one launch "
        f"each), {big['qps']:.1f} qps, peak device memory {big_peak} B above "
        f"the index; the id copy and the kernel alone "
        f"{json.dumps(big_kernels)} ms; "
        f"equal to the gathered route run in slices of "
        f"{QUERY_SLICE} (exact); {big['connected']} pairs connected on "
        f"{card}")
    del d_big, c_big, d0, c0, big_s, big_t

    laps.lap("6b query_batch")

    # -- A2. analytics after the chunk --------------------------------------
    cfg = dataclasses.replace(PNA_CONFIG, d_in=4)
    pna = PNA(cfg, generator=torch.Generator().manual_seed(args.seed),
              device=dev)
    table = torch.from_numpy(np.random.default_rng(args.seed + 1)
                             .standard_normal((n, 8)).astype(np.float32))
    table_dev = table.to(dev)
    inc0 = maint.incremental_refreshes
    step_s = {}
    with counts.path("analytics"):
        t0 = time.monotonic()
        maint.refresh()
        step_s["refresh"] = time.monotonic() - t0
        view = ana.pin()
        hot = maint.top(1)[0][0]
        t0 = time.monotonic()
        cyc = view.cycles_through_vertex(hot)
        step_s["cycles"] = time.monotonic() - t0
        u = int(view.index.size[:n].argmax())
        t0 = time.monotonic()
        recs = view.recommend(u)
        step_s["recommend"] = time.monotonic() - t0
        t0 = time.monotonic()
        cand, model, sub_n = rerank(view, u, recs, pna, table_dev)
        step_s["rerank"] = time.monotonic() - t0

    how = "incremental" if maint.incremental_refreshes > inc0 else "full"
    log(f"analytics: refresh to v{maint.version} in {step_s['refresh']:.3f} s, "
        f"{how}, last_changed {maint.last_changed} of {n} rows (top 3 "
        f"{maint.top(3)})")
    if maint.version != store.version:
        raise AssertionError(f"maintainer at v{maint.version}, store at "
                             f"v{store.version}")
    t0 = time.monotonic()
    full = view.betweenness(pairs=pairs)
    full_s = time.monotonic() - t0
    full_err = check_close("refresh vs full recompute",
                           torch.from_numpy(maint.scores()),
                           torch.from_numpy(full), 1e-9, 1e-9)
    log(f"analytics: a full recompute on the same snapshot takes "
        f"{full_s:.3f} s ({full_s / step_s['refresh']:.2f}x the refresh); "
        f"max |diff| {full_err:.3g}")
    for name, want in frozen.items():
        if not torch.equal(getattr(pinned.index, name), want):
            raise AssertionError(f"pinned snapshot v{pinned.version}: "
                                 f"{name} changed after the chunk")
    log(f"analytics: snapshot v{pinned.version} pinned before the chunk is "
        f"byte-identical after it")
    t0 = time.monotonic()
    bc_err = max(bc_err, check_close(
        "betweenness after events", torch.from_numpy(maint.scores()).to(dev),
        bfs_betweenness(svc.graph, *pairs), 1e-9, 1e-9))
    log(f"oracle[betweenness after events]: equal to the BFS pair "
        f"dependencies (max |diff| so far {bc_err:.3g}; "
        f"{time.monotonic() - t0:.3f} s)")

    tri, quad = edge_list_cycles(svc.graph, hot)
    want_cyc = (CycleCount(3, tri, True, 4, tri, quad) if tri else
                CycleCount(4, quad, True, 4, 0, quad) if quad else
                CycleCount(INF, 0, False, 4, 0, 0))
    if cyc != want_cyc:
        raise AssertionError(f"cycles through {hot}: {cyc} != edge list "
                             f"{want_cyc}")
    degree = int((live_edges(svc.graph)[0] == hot).sum())
    log(f"analytics: cycles through vertex {hot} (degree {degree}) in "
        f"{step_s['cycles']:.3f} s: {cyc}, equal to the edge list's counts")

    want_recs = edge_list_recommend(svc.graph, u, ana.top_k)
    if [(r.vertex, r.score) for r in recs] != want_recs or \
            any(r.dist != 2 for r in recs) or not recs:
        raise AssertionError(f"recommend({u}): {recs} != edge list "
                             f"{want_recs}")
    log(f"analytics: recommend({u}) in {step_s['recommend']:.3f} s: "
        f"{len(recs)} candidates, equal to the edge list's common-friend "
        f"counts: {[(r.vertex, r.score) for r in recs]}")

    pna_cpu = PNA(cfg, device="cpu")
    pna_cpu.load_state_dict({k: x.cpu() for k, x in pna.state_dict().items()})
    _, model_cpu, _ = rerank(view, u, recs, pna_cpu, table)
    rerank_err = check_close("re-rank, card vs CPU", torch.from_numpy(model),
                             torch.from_numpy(model_cpu), 1e-4, 1e-5)
    order = np.argsort(-model, kind="stable")
    log(f"analytics: PNA ({cfg.n_layers} layers, d_hidden {cfg.d_hidden}) "
        f"over the {sub_n}-node ego net + embedding_bag mean pooling in "
        f"{step_s['rerank']:.3f} s; re-rank "
        f"{[(int(cand[i]), round(float(model[i]), 4)) for i in order]}; "
        f"equal to the CPU forward (max |diff| {rerank_err:.3g})")

    laps.lap("A2 analytics")

    # -- 3b. kernels vs plain at the main paths' shapes, and their times -----
    s_dev, t_dev = (torch.from_numpy(x).to(dev) for x in batches[0])
    rows = tuple(r.contiguous() for r in prep_rows(svc.index, s_dev, t_dev))
    plain = spc_query_ref(*rows)
    b, l_cap = rows[0].shape
    hub, dist_m, cnt_m = svc.index.hub, svc.index.dist, svc.index.cnt
    k1_calls = {
        "fused": lambda: K.spc_query_index_cuda(hub, dist_m, cnt_m, s_dev,
                                                t_dev),
        "gathered_route": lambda: gathered_route(svc.index, s_dev, t_dev),
        "warp": lambda: K._warp_cuda(*rows),
        "merge": lambda: merge_rows(*rows)}
    for tag, fn in list(k1_calls.items()) + [
            ("gathered form", lambda: K.spc_query_cuda(*rows))]:
        got = fn()
        torch.cuda.synchronize()
        max_err = max(max_err, check_equal(f"main-path pairs, {tag}", got,
                                           plain))
    k1_reps = {k: [] for k in k1_calls}
    for _ in range(K1_REPS):
        for k, fn in k1_calls.items():
            k1_reps[k].append(cuda_ms(fn, 200 if k != "merge" else 50))
    # what the card spends per call, the whole route for the gathered one:
    # calls replayed back to back from a CUDA graph
    k1_busy = {k: graph_ms(k1_calls[k], K1_GRAPH_CALLS)
               for k in ("fused", "gathered_route", "warp")}
    ms = float(np.median(k1_reps["fused"]))
    # plain_ms: the L x L table the kernel is held against (the
    # correctness reference); the plain merge is the same function in
    # plain torch at the same shape
    plain_ms = cuda_ms(lambda: spc_query_ref(*rows), reps=5, warmup=1)
    merge_ms = float(np.median(k1_reps["merge"]))
    nbytes, ops, common_hubs = spc_query_index_work(svc.index, s_dev, t_dev,
                                                     rows)
    bound, by = bound_ms(nbytes, ops)
    full_bytes = spc_query_work(rows)[0]
    bound_full = bound_ms(full_bytes, ops)[0]
    k1_main = {"B": b, "L": l_cap, "design": K.plan(l_cap),
               "ms_rounds": k1_reps["fused"],
               "gathered_route_ms": k1_reps["gathered_route"],
               "warp_ms": k1_reps["warp"], "merge_ms": k1_reps["merge"],
               "device_ms_per_call": k1_busy, "bytes": nbytes,
               "bytes_full_rows": full_bytes, "bound_full_rows_ms":
               bound_full, "common_hubs": common_hubs}
    log(f"spc_query at (B={b}, L={l_cap}): fused {ms:.5f} ms (rounds "
        f"{json.dumps(k1_reps['fused'])}), the gathered route (gather, re-pad, "
        f"warp kernel) {json.dumps(k1_reps['gathered_route'])}, the warp "
        f"kernel alone {json.dumps(k1_reps['warp'])}, plain merge "
        f"{json.dumps(k1_reps['merge'])} ms; the card's ms per call (CUDA "
        f"graph) {json.dumps(k1_busy)}; plain table {plain_ms:.4f} ms; "
        f"bound {bound:.5f} ms ({nbytes} "
        f"B read by id, {ops} ops, {common_hubs} common hubs; both hub rows "
        f"in full: {full_bytes} B, {bound_full:.5f} ms) on {card}")

    bags = torch.from_numpy(common_friend_bags(view, u, cand)).to(dev)
    tz = torch.cat([table, torch.zeros_like(table[:1])]).to(dev)
    got = EB.embedding_bag_cuda(bags, tz)
    old = EB._warp_cuda(bags, tz)
    torch.cuda.synchronize()
    bag_err = max(bag_err, check_close("embedding_bag main-path bags", got,
                                       embedding_bag_ref(bags, tz),
                                       1e-6, 1e-6))
    if not torch.equal(got, old):
        raise AssertionError("embedding_bag at the re-rank's bags: the two "
                             "designs differ")
    rerank_calls = {"packed": lambda: EB.embedding_bag_cuda(bags, tz),
                    "warp": lambda: EB._warp_cuda(bags, tz),
                    "library": lambda: F.embedding_bag(bags, tz, mode="sum")}
    rerank_reps = {k: [] for k in rerank_calls}
    for _ in range(K3_REPS):
        for k, fn in rerank_calls.items():
            rerank_reps[k].append(cuda_ms(fn, 200))
    rerank_device = {k: graph_ms(rerank_calls[k]) for k in ("packed",
                                                             "warp")}
    bag_ms = float(np.median(rerank_reps["packed"]))
    bag_plain_ms = cuda_ms(lambda: embedding_bag_ref(bags, tz), 200)
    bag_lib_ms = float(np.median(rerank_reps["library"]))
    bag_bytes, bag_ops, _ = embedding_bag_work(bags, tz)
    bag_bound, bag_by = bound_ms(bag_bytes, bag_ops)
    log(f"embedding_bag at the re-rank's bags {tuple(bags.shape)}, table "
        f"{tuple(tz.shape)}: packed {json.dumps(rerank_reps['packed'])}, warp "
        f"{json.dumps(rerank_reps['warp'])}, F.embedding_bag "
        f"{json.dumps(rerank_reps['library'])} ms in {K3_REPS} rounds, the "
        f"card's ms per call (CUDA graph) {json.dumps(rerank_device)}; "
        f"median {bag_ms:.5f} ms, plain {bag_plain_ms:.5f} ms, bound "
        f"{bag_bound:.7f} ms ({bag_bytes} B) on {card}")

    laps.lap("3b main-shape kernels")

    # -- B2 (dspc). one insert and one delete through the dspc cells ---------
    dspc_events = launch_dspc_events(svc.graph, svc.index, engine, counts,
                                     edges, args.seed, build_s)
    log(f"B2 dspc: {json.dumps(dspc_events)} (phase 4's build "
        f"{build_s:.3f} s) on {card}")
    laps.lap("B2 dspc events")

    # -- S1-S4. the service stack over phase 5's DynamicSPC ------------------
    del (store, ana, maint, pinned, view, frozen, served, outs, rows,
         hub, dist_m, cnt_m, plain, k1_calls, s_dev, t_dev)
    gc.collect()
    service_numbers = service_phases(svc, counts, args.seed, card)
    del svc
    gc.collect()
    torch.cuda.empty_cache()

    laps.lap("S1-S4 service")

    # -- D. distributed: a graph of its own over a device mesh ---------------
    dist_halvings = max(args.halvings, DIST_HALVINGS)
    dist_n, dist_m = CONFIG.n >> dist_halvings, CONFIG.m >> dist_halvings
    dist_reduced = [f"n {CONFIG.n}->{dist_n}", f"m {CONFIG.m}->{dist_m}"]
    log(f"D reduced: {json.dumps(dist_reduced)} (a graph of its own, "
        f"built on one device to hold the sharded build against)")
    dist_numbers = distributed_phase(
        power_law_edges(dist_n, dist_m, args.seed + 31), dist_n, build_kw,
        counts, args.seed, card)
    gc.collect()
    torch.cuda.empty_cache()
    dist_numbers.update(phase_s=laps.lap("D distributed"),
                        reduced=dist_reduced)
    log(f"distributed: {json.dumps(dist_numbers)} on {card}")

    # -- L. the LM serving path (examples/serve_lm.py at qwen2-1.5b) --------
    # one card, no mesh (lm_config)
    lm_cfg = lm_config()
    decode_32k = LM_SHAPES["decode_32k"].dims
    lm_reduced = [f"global_batch {decode_32k['global_batch']}->{LM_BATCH}",
                  f"n_layers {QWEN_CONFIG.n_layers}->{lm_cfg.n_layers}"]
    log(f"lm reduced: {json.dumps(lm_reduced)} (context "
        f"{decode_32k['seq_len']} kept)")
    t0 = time.monotonic()
    params = tf.init_params(
        lm_cfg, generator=torch.Generator("cuda").manual_seed(args.seed),
        device=dev)
    torch.cuda.synchronize()
    log(f"L1: {lm_cfg.name} at tp 1: {lm_cfg.n_layers} layers, d_model "
        f"{lm_cfg.d_model}, {lm_cfg.padded_heads} query / "
        f"{lm_cfg.n_kv_heads} KV heads of {lm_cfg.d_head}, d_ff "
        f"{lm_cfg.d_ff}, vocab {lm_cfg.padded_vocab}; "
        f"{tf.param_bytes(params)} parameter bytes in {lm_cfg.param_dtype} "
        f"({time.monotonic() - t0:.2f} s on {card})")
    s_max = LM_PROMPT + LM_STEPS
    prompts = lm_prompts(lm_cfg, args.seed, dev)
    lm_numbers, fed, last, cache = serve_lm(params, lm_cfg, prompts,
                                            LM_STEPS, LM_GROUP, counts, "lm")
    trace = trace_decode(params, lm_cfg, cache, fed, lm_numbers)
    lm_numbers.update(param_bytes=tf.param_bytes(params), reduced=lm_reduced)
    want_launches = lm_cfg.n_layers * LM_STEPS
    if counts.by_path["lm"]["flash_decode"] != want_launches:
        raise AssertionError(f"flash_decode launched "
                             f"{counts.by_path['lm']['flash_decode']} times "
                             f"on the lm path, want {want_launches}")
    log(f"L2: prefill {LM_BATCH} x {LM_PROMPT} tokens in groups of "
        f"{LM_GROUP}: {lm_numbers['prefill_s']:.3f} s, peak "
        f"{lm_numbers['prefill_peak_bytes']} B on {card}")
    log(f"L3: {LM_STEPS} decode steps x {LM_BATCH} requests: "
        f"{lm_numbers['decode_s']:.3f} s, step p50 "
        f"{lm_numbers['decode_step_ms_p50']:.3f} ms p90 "
        f"{lm_numbers['decode_step_ms_p90']:.3f} ms, "
        f"{lm_numbers['decode_tokens_per_s']:.1f} tokens/s, peak "
        f"{lm_numbers['decode_peak_bytes']} B; flash_decode launched "
        f"{want_launches} times on {card}")
    log(f"L3 trace: {trace} on {card}")

    t0 = time.monotonic()
    check_cache = {"k": cache["k"][:, :LM_CHECK].clone(),
                   "v": cache["v"][:, :LM_CHECK].clone(),
                   "lengths": cache["lengths"][:LM_CHECK].clone()}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    fault_span = lm_fault_span(lm_cfg, sms)
    l4 = lm_consistency(params, lm_cfg, prompts[:LM_CHECK], fed[:LM_CHECK],
                        last[:LM_CHECK], check_cache, s_max, fault_span)
    del check_cache
    lm_numbers.update(consistency=l4)
    log(f"L4: prefill of {LM_CHECK} x {LM_PROMPT + LM_STEPS} tokens vs the "
        f"last decode step: relative L2 {l4['decode']:.4g} (limit "
        f"{LM_REL_TOL}), argmax agrees on {l4['argmax']}/{LM_CHECK}; the "
        f"fed tokens again from the prompts' cache: {l4['replay']:.4g} on "
        f"the port's route, planted faults {l4['bf16_scores']:.4g} (scores "
        f"and probabilities in bf16) and {l4['drop_span']:.4g} (first "
        f"{fault_span} positions, one span of the kernel at the main "
        f"path's shape, left out) ({time.monotonic() - t0:.3f} "
        f"s on {card})")
    check_l4(l4)
    del params, prompts
    gc.collect()
    torch.cuda.empty_cache()

    laps.lap("L lm path")

    # -- flash_decode at the main path's shape, and its times -----------------
    k0, v0, lens = cache["k"][0], cache["v"][0], cache["lengths"].clone()
    qm = torch.randn((LM_BATCH, lm_cfg.padded_heads, lm_cfg.d_head),
                     generator=torch.Generator("cuda").manual_seed(args.seed),
                     device=dev).to(torch.bfloat16)
    fd_route = FD.plan(LM_BATCH, lm_cfg.n_kv_heads, lm_cfg.padded_heads,
                       int(k0.shape[1]), lm_cfg.d_head, torch.bfloat16,
                       sms).route
    # the planned route held and timed, the CUDA-core route, the planned
    # route with its LSE output and SDPA timed beside it
    fd_row, want = flash_decode_row(
        qm, k0, v0, lens, f"({fd_route}) at the main path's shape", fd_route,
        100, 5, extra={"simt": lambda: FD._simt_cuda(qm, k0, v0, lens),
                       "lse": lambda: FD.flash_decode_cuda(
                           qm, k0, v0, lens, return_lse=True)})
    old = FD._simt_cuda(qm, k0, v0, lens)
    simt_err = check_close("flash_decode (simt) at the main path's shape "
                           "(bf16)", old, want, MAIN_RTOL, MAIN_ATOL)
    simt_rel = rel_l2(old, want)
    del old
    q32, k32, v32 = qm.float(), k0.float(), v0.float()
    got32 = FD.flash_decode_cuda(q32, k32, v32, lens)
    torch.cuda.synchronize()
    main_err32 = check_close("flash_decode at the main path's shape (f32)",
                             got32, want, 2e-5, 2e-5)
    # the bf16 check must fail a kernel that left out its last span
    lost = decode_attention_ref(q32, k32, v32, lens - fault_span).to(
        torch.bfloat16).double()
    lost_err = float((lost - want.double()).abs().max())
    if torch.allclose(lost, want.double(), rtol=MAIN_RTOL, atol=MAIN_ATOL):
        raise AssertionError(f"the main-shape check passes a kernel that "
                             f"leaves out a span (max |diff| {lost_err})")
    del q32, k32, v32, got32, lost
    log(f"flash_decode at the main path's shape == plain: bf16 on the "
        f"{fd_route} route max |diff| {fd_row['max_abs_err']:.3g} (rtol "
        f"{MAIN_RTOL}, atol {MAIN_ATOL}), relative L2 "
        f"{fd_row['rel_l2']:.3g}, bitwise equal across two launches; on "
        f"the simt route {simt_err:.3g}, relative L2 {simt_rel:.3g}; output "
        f"RMS {float(want.norm()) / want.numel() ** 0.5:.3g}; "
        f"f32 max |diff| {main_err32:.3g} (2e-5); one span of "
        f"{fault_span} left out differs by {lost_err:.3g} and fails on "
        f"{card}")
    del want
    # flash_decode's kernels in the decode step's trace (a call a layer):
    # what the card runs in one call, each kernel's device ms per call
    fd_trace = {k: v / lm_cfg.n_layers
                for k, v in lm_numbers["decode_step_ms_by_kernel"].items()
                if k.startswith("flash_decode")}
    fd_ms = fd_row["ms"]
    log(f"flash_decode at {json.dumps(fd_row['shape'])}: {fd_route} "
        f"{json.dumps(fd_row['ms_rounds'])} ms, simt "
        f"{json.dumps(fd_row['simt_ms'])} ms, with the LSE output "
        f"{json.dumps(fd_row['lse_ms'])} ms, SDPA "
        f"{json.dumps(fd_row['library_ms_rounds'])} ms in {FD_REPS} rounds; "
        f"median {fd_ms:.5f} ms ({fd_row['bytes'] / fd_ms / 1e6:.1f} GB/s), "
        f"plain {fd_row['plain_ms']:.4f} ms, SDPA "
        f"{fd_row['library_ms']:.5f} ms, bound {fd_row['bound_ms']:.5f} ms "
        f"({fd_row['bytes']} B, {fd_row['bound_by']}); {lm_cfg.n_layers} "
        f"launches take {lm_cfg.n_layers * fd_ms:.3f} ms of a "
        f"{lm_numbers['decode_step_ms_p50']:.3f} ms step on {card}")
    log(f"flash_decode in the L3 trace, device ms per call by kernel: "
        f"{json.dumps(fd_trace)} on {card}")
    log(f"lm: {json.dumps(lm_numbers)} on {card}")
    del cache, k0, v0
    gc.collect()
    torch.cuda.empty_cache()

    laps.lap("L flash_decode at the main shape")

    # -- M, M-check, M2, M3. the rest of the LM family -----------------------
    family = deepseek_phases(counts, card, args.seed)
    family.update(dense_family_phase(counts, card, args.seed, sms))
    log(f"lm family: {json.dumps(family)} on {card}")
    laps.lap("M-M3 lm family")

    # -- G. the equivariant GNN family ---------------------------------------
    gnn = gnn_phase(counts, card, args.seed)
    log(f"G: {json.dumps(gnn)} on {card}")
    laps.lap("G gnn")

    # -- R. DIEN serving ------------------------------------------------------
    recsys = recsys_phase(counts, card, args.seed)
    log(f"R: {json.dumps(recsys)} on {card}")
    laps.lap("R recsys")

    # -- T. one-card training -------------------------------------------------
    train = train_phase(counts, card, args.seed)
    log(f"T: {json.dumps(train)} on {card}")
    laps.lap("T train")

    # -- X. the mesh models ----------------------------------------------------
    mesh = mesh_phase(counts, card, args.seed)
    mesh["fsdp"] = fsdp_phase(counts, card, args.seed)
    log(f"X: {json.dumps(mesh)} on {card}")
    laps.lap("X mesh")

    # -- B. the launch layer: every cell abstract, one cell a family run ------
    cells = cells_phase()
    ring_bytes = ring_layout_bytes()
    log(f"B1 equiformer-v2/ogb_products@ring, bytes a device by (data, "
        f"model) grid (meta, nothing allocated): {json.dumps(ring_bytes)}")
    laps.lap("B1 cells")
    launch = {"decode": launch_decode(counts, card, args.seed)}
    log(f"B2 decode: {json.dumps(launch['decode'])} on {card}")
    launch["train"] = launch_train_cells(counts, card, args.seed)
    log(f"B2 train: {json.dumps(launch['train'])} on {card}")
    launch.update(dspc=dspc_events, cells=len(cells), ring_bytes=ring_bytes)
    laps.lap("B2 cells on the card")

    # -- B4. the dry run on meta, its counts against the card's -------------
    launch["dry_runs"] = dry_runs()
    launch["roofline"] = roofline_phase(launch, train, card)
    log(f"B4: {json.dumps({k: launch[k] for k in ('dry_runs', 'roofline')})}")
    laps.lap("B4 dry run and roofline")

    # -- B3 and E. the train CLI's processes beside the eight examples -------
    # (B3 and fleet_spc are mostly processes starting: they overlap)
    train_cli = in_background(train_cli_phase)
    examples = examples_phase(counts)
    log(f"E: {json.dumps(examples)} on {card}")
    launch["train_cli"] = train_cli()
    log(f"B3 train CLI: {json.dumps(launch['train_cli'])} on {card}")
    laps.lap("B3 train CLI and E examples")
    log(f"phases (s): {json.dumps(laps.seconds)}")
    fd_family = {name: numbers["flash_decode"]
                 for name, numbers in family.items()
                 if "flash_decode" in numbers}
    fd_lse = mesh["decode"]["qwen2-7b"]["flash_decode_lse"]
    log(f"launches on the main paths: {json.dumps(counts.by_path)}")
    counts.check()

    def paths_of(kernel):
        return [p for p, names in PATH_KERNELS.items() if kernel in names]

    def usage_of(kernel):
        return {f["function"]: [f["registers"], f["smem"], f["spill_stores"],
                                f["spill_loads"]]
                for f in usage.get(kernel, [])}

    kernels = [{
        "name": "spc_query", "route": "cuda",
        "path": paths_of("spc_query"), "ptxas": usage_of("spc_query"),
        "source": KERNEL_SOURCES["spc_query"][0],
        "replaces": KERNEL_SOURCES["spc_query"][1],
        "launches": counts.of("spc_query")[0],
        "launches_by_path": counts.of("spc_query")[1], "max_abs_err": max_err,
        "ms": ms, "device_ms": k1_busy["fused"], "plain_ms": plain_ms,
        "plain_merge_ms": merge_ms,
        "bound_ms": bound, "bound_by": by, "library_ms": None,
        "design": k1_main["design"], "main": k1_main, "serve": serve,
        "query_batch": big, "microbench": q_row, "service": service_numbers,
    }, {
        "name": "segment_matmul", "route": "cuda",
        "path": paths_of("segment_matmul"),
        "ptxas": usage_of("segment_matmul"),
        "design": seg_shapes[1]["design"],
        "microbench_design": seg_shapes[0]["design"],
        "source": KERNEL_SOURCES["segment_matmul"][0],
        "replaces": KERNEL_SOURCES["segment_matmul"][1],
        "launches": counts.of("segment_matmul")[0],
        "launches_by_path": counts.of("segment_matmul")[1],
        "max_abs_err": seg_err, "bf16_max_abs_err": seg_err16,
        "graph_max_abs_err_vs_float64": g_err, "deterministic": True,
        "chunk": SM.CHUNK, **{k: seg_shapes[1][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "shape": seg_shapes[1]["shape"], "shapes": seg_shapes,
    }, {
        "name": "embedding_bag", "route": "cuda",
        "path": paths_of("embedding_bag"),
        "ptxas": usage_of("embedding_bag"),
        "source": KERNEL_SOURCES["embedding_bag"][0],
        "replaces": KERNEL_SOURCES["embedding_bag"][1],
        "launches": counts.of("embedding_bag")[0],
        "launches_by_path": counts.of("embedding_bag")[1],
        "max_abs_err": bag_err,
        "ms": bag_ms, "plain_ms": bag_plain_ms, "bound_ms": bag_bound,
        "bound_by": bag_by, "library_ms": bag_lib_ms,
        "design": EB.plan(tz.shape[1], tz.dtype, tz.data_ptr())._asdict(),
        "ms_rounds": rerank_reps["packed"], "warp_ms": rerank_reps["warp"],
        "device_ms": rerank_device,
        "library_ms_rounds": rerank_reps["library"],
        "l2_bytes_per_s": l2, "l2_probes": l2_probes,
        "shape": list(bags.shape), "shapes": bag_shapes,
    }, {
        "name": "flash_decode", "route": "cuda",
        "path": paths_of("flash_decode"), "ptxas": usage_of("flash_decode"),
        "design": fd_route, "ms_rounds": fd_row["ms_rounds"],
        "trace_ms_per_call": fd_trace, "simt_ms": fd_row["simt_ms"],
        "lse_ms": fd_row["lse_ms"],
        "library_ms_rounds": fd_row["library_ms_rounds"],
        "main_simt_max_abs_err": simt_err, "main_simt_rel_l2": simt_rel,
        "fault_span": fault_span,
        "source": KERNEL_SOURCES["flash_decode"][0],
        "replaces": KERNEL_SOURCES["flash_decode"][1],
        "launches": counts.of("flash_decode")[0],
        "launches_by_path": counts.of("flash_decode")[1],
        "max_abs_err": max(dec_err, dec_err16, fd_row["max_abs_err"],
                           main_err32,
                           *(r["max_abs_err"] for r in fd_family.values()),
                           *(r["served_max_abs_err"]
                             for r in fd_family.values()),
                           fd_family["phi3-medium-14b"]["group5_max_abs_err"],
                           *(fd_lse[r]["max_abs_err"]
                             for r in ("planned", "simt"))),
        "f32_max_abs_err": dec_err,
        "main_max_abs_err": fd_row["max_abs_err"],
        "main_rel_l2": fd_row["rel_l2"],
        "main_f32_max_abs_err": main_err32, "main_tol": [MAIN_RTOL, MAIN_ATOL],
        "main_lost_span_max_abs_err": lost_err,
        **{key: fd_row[key] for key in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "bytes", "library_ms",
                                        "shape")},
        "lm_family": fd_family, "mesh_lse": fd_lse,
        "mesh_launches": mesh["decode"]["qwen2-7b"]["flash_decode_launches"],
    }]
    log(f"chip_smoke: {time.monotonic() - start:.1f} s in all")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
