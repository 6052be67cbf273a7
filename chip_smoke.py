"""Drive the PyTorch/CUDA port's serving and router-training paths on one
NVIDIA GPU and check them.

    python3 chip_smoke.py
    python3 chip_smoke.py predictor lm_train shard_engine lm_mesh  # alone
    python3 chip_smoke.py lm_recurrent_train lm_encdec flash decode_attn
    python3 chip_smoke.py tooling

With phase names (``predictor``, ``lm_train``, ``lm_recurrent_train``,
``shard_engine``, ``lm_mesh``, ``lm_encdec``, ``flash``, ``decode_attn``,
``tooling``)
it runs those
phases alone, checks no kernel, prints no
kernels line, and its last line is ``{"ok": null, "partial": [...]}``:
only a run with no argument ends with ``{"ok": true, ...}``.

Phases, each printing JSON lines; any failure raises and exits non-zero:

  1. env      — the card (name and power limit, from nvidia-smi), the torch,
                CUDA and nvcc versions, the time to build the kernels from
                ``src/repro_torch/csrc`` (one nvcc each, in parallel) and
                ptxas's registers, spills and static shared memory per
                kernel function (``nvcc --resource-usage``, alongside).
  2. kernel   — the lockstep-advance kernel (B1) against its plain PyTorch
                version: 16 envs x 1,024 experts (16,384 rows, R=W=5), then
                4 envs x 6 experts (the N=6 serving rows), over 100
                consecutive advances per admission order, every fourth one
                held against the plain loop (at 16,384 rows those of the
                first 16, and advance 50, where B1 is timed; at 24 rows
                those of the first 40), with arrivals
                pushed between advances, ragged caps, about 1/8 of experts
                down, admission floors on some rows and a t_next per env.
                Queues, clocks and wait-valid bits must be bit-exact,
                done/viol exact, the other accumulators within rtol 1e-6.
                Times both (the kernel with its launches queued ahead).
  3. serve    — the routing path, ``launch/route.py``'s policies through
                ``engine_backend="cuda"``: N=6 with 4 envs (padded obs) and
                N=1,024 with 16 envs (segments obs, ragged caps); RR, SQF, BR,
                QLL and a seeded SAC router, greedy; each run with every
                step after the first replayed from a CUDA graph, and again
                eagerly from the same seeds (``graphs=False``): metrics and
                final state must be equal bit for bit, and requests routed
                per second are printed for both.  Each run must launch
                B1 once per env step; a shorter QLL run on the plain engine
                (20 steps at N=6, 12 at N=1,024) must end in the same state
                as on the kernel.
  4. profile  — for QLL and SAC in each setting: the graphed step's wall
                time, each layer's device time (observation, policy, env
                step, each captured alone and replayed in turn), and the
                device's busy share under torch.profiler, whose trace must
                hold one B1 launch per step; the same for eager steps.
  5. flash    — the flash-attention kernel (B2) against its plain version:
                each expert's full-width heads at S=16 and 128, danube's
                heads at S=1,024 under a binding window of 256, starcoder2's
                at S=4,096 causal, and whisper-medium's unmasked (4 x 16/16
                x 64: Sq = Skv = 1,500, and Sq = 448 over Skv = 1,500);
                bf16 within 2e-2 and float32 within 2e-5
                (max abs), and against the kernel's tile algorithm in plain
                PyTorch (``attention_tiled_ref``: bf16 within one rounding
                step of the output, float32 2e-5).  Times the kernel, the
                plain version and PyTorch's scaled_dot_product_attention,
                beside the bound: their time on the card with the launches
                queued ahead, and the call's time (host launch time
                included); the kernel's TFLOP/s and share of the peak
                (bf16 989, float32 67).
  6. decode_attn — the decode-attention kernel (B3) against its plain
                version of each mask: under ``lengths``, the full-attention
                experts' heads (qwen, starcoder2, dbrx), 4 sequences of
                ragged lengths over the serving cache (S=192, read in its
                (B, S, KV, dh) layout), starcoder2's over S=4,096 and
                whisper-medium's (16/16 x 64) over S=1,500; under
                ``kv_pos``, danube's heads on its serving ring (S=192) and
                recurrentgemma's (10/1 x 256) on its window of 2,048, rings
                that have wrapped; bf16 2e-2, float32 2e-5, and against the
                kernel's algorithm in plain PyTorch
                (``decode_attention_split_ref``: bf16 within one rounding
                step of the output, float32 2e-5).  Times as in 5, with
                scaled_dot_product_attention under the same mask as the
                library call.
  7. moe_gemm — the grouped SwiGLU (B4b) and grouped GEMM (B4a) kernels
                against their plain versions at dbrx's expert shapes (16 x
                6144 x 10752) for capacities 4 (a decode), 5, 10, 20 and 40
                (prefill buckets 16 to 128); each element within atol + rtol * |ref|,
                both 2e-2 in bf16 and 2e-5 in float32; B4a's two calls
                bit-equal.  Times against the weight-stream bound and
                torch.bmm (B4a, beside its previous kernel; for B4b two bmm
                and silu*mul, not one call).  Then B4a at ragged shapes in
                bf16 against its plain version and its split algorithm in
                plain PyTorch, deterministic over two calls.
  8. lm_serve — the LM path, ``launch/serve.py`` at the published widths in
                bf16 (``build_cluster(reduce=False)``): per expert, a prefill
                and a decode step through the kernels against the same
                through their plain versions on the same weights, and the
                same two steps captured as a CUDA graph against them run
                eagerly (bit-equal logits); a reduced cluster on the card
                against the same on the CPU, token for token; then, counted,
                the calibration (k1, k2) and two request streams (SQF, RR;
                30 requests at 20/s, L = 30 ms), once through the servers as
                they serve by default (each step a CUDA graph) and once
                through eager twins on the same weights (``graphs=False``):
                requests that reach the same expert in both runs must get
                the same tokens, and so must a fixed request set stepped to
                the end.  B2 must launch n_layers times per prefill, B3
                n_layers times per decode, counted per replay.  Then a
                profiled window per expert, graphed and eager, whose trace
                must hold each LM kernel's expected launches.
  9. lm_moe   — the same for a mixed cluster with one MoE expert:
                qwen1.5-0.5b, h2o-danube-3-4b and dbrx-132b at its published
                widths cut to 4 of its 40 layers (``reduced``), after the
                dense cluster is freed.  B4b and B4a must launch once per MoE
                layer per prefill and per decode, B3 as in 8, graphed and
                eager as in 8; the plain
                run of the kernels-vs-plain check replays the kernel run's
                expert routing (the free-running difference is reported).
                Then a profiled window of the dbrx expert.
 10. rwkv6_scan — the chunked WKV scan (B5) against the token recurrence
                (y and the final state) at rwkv6-7b's heads (H=64, K=V=64,
                chunk 32): (B, T) = (4, 128), (4, 100) (a tail chunk) and
                (1, 4,096), bf16 and float32; each element within atol +
                rtol * |ref| (2e-2 bf16, 2e-4 float32; the state 2e-4),
                finite.  Both sides of the wrapper's switch, each checked
                and timed: its plan (one walk up to 256 tokens, else three
                passes in groups of 256) and the other side (the wrapper's
                ``GROUP`` set to 32 tokens for three passes, or to T for
                one walk).  Each side's kernels traced by name (sums,
                carry, walk: each one's device time per call beside the
                whole call's); the trace must hold calls times the kernels
                per call the wrapper reports, in one of three profiler
                sessions.  The plain chunk algorithm's time, and
                the bound: the bytes any implementation moves (the chunk
                algorithm's exponentials and operations kept beside it).
 11. rglru_scan — the RG-LRU scan (B6) against its plain version at
                recurrentgemma-2b's width (W=2,560), (B, T) = (4, 128) and
                (1, 4,096), float32 and bf16, a non-zero h0 and some log_a
                > 0 (clamped); 1e-5 float32, 2e-2 bf16.  Both sides of the
                wrapper's switch as in 10 (the single walk up to 128 steps,
                else two passes in chunks of T/16 within 64..256; the other
                side, its ``plan`` set to chunks of 32 for two passes, or
                of T for one walk), each pass's traced time beside the
                call's (held as in 10), the bound in bytes.
 12. lm_recurrent — the recurrent families through the model API
                (``launch/steps.py``): the reduced configs on the card
                against the same weights on the CPU; then rwkv6-7b and
                recurrentgemma-2b at their published widths in bf16 (seeds
                0, 1), after the earlier clusters are freed.  Per model a
                prefill of 4 x 128 tokens through the kernels against the
                same through their plain versions (logits within 2^-4 of
                the largest, greedy tokens, recurrent states), then the
                prefill replayed from its CUDA graph against its eager first
                call (bit-equal logits and cache), a prompt of half the
                length through the same step (its first call, eager and a
                capture into the shared pool, timed beside its replay and
                the eager prefill; both shapes' replays bit-equal), one
                decode step from its cache the same way, 32 greedy decodes
                replayed from a CUDA graph and the same 32 run eagerly from
                a copy of the cache (bit-equal logits; each step timed:
                min/median/max), prefills timed graphed and eager, a
                profiled window (one capture for every prompt; the trace
                must hold B3's expected launches and B5's and B6's kernels:
                calls times the kernels per call their wrappers report) and
                a prefill of 1 x 4,096 (past recurrentgemma's 2,048 window),
                graphed against eager, timed both ways, and one replay of it
                traced (B5's three kernels per layer and their time per
                prefill, B6's two; the trace must hold every one of them in
                one of three replays).  B5 must be called n_layers times per
                rwkv6 prefill, B6 once per recurrent layer per
                recurrentgemma prefill, neither at decode; B3 once per
                attention layer per recurrentgemma decode.
 13. train    — router training (``core/training.py``) in the paper's
                setting at full width: ``EnvConfig()`` (N=6), ``SACConfig()``
                (HAN 2 x 4 heads x 64, MLP 64), ``TrainConfig()`` (16 envs,
                8 collect steps and 8 updates of 256 per iteration, buffer
                100,000, warmup 2,000, 400 iterations, padded obs).  (a) 24
                iterations with every collect step and update replayed from
                CUDA graphs against the same 24 run eagerly from the same
                seeds (15 collect only, then 9 updating), and the first
                run eagerly on B1's plain version (96 rows) against the
                graphed state then: parameters, AdamW moments and step, replay buffer, env
                state and observation bit-equal; each iteration's time,
                graphed and eager.  (c) Where a
                graphed iteration's time goes: a collect step's and an
                update's device time (replays queued ahead), the update in
                parts (sample + losses, + backward, + AdamW and polyak: each
                captured alone), kernels per step and a profiled iteration
                (its trace must hold one B1 launch per collect step; idle
                share against the unprofiled wall time).  (b) Seeds 0, 1, 2
                of the full 400 iterations (``make_iteration``), graphed:
                every iteration's losses and reward finite, the buffer's ``size``/``ptr`` and the AdamW
                step exact, each router evaluated greedily as the serve
                phase evaluates (N=6 x 4 envs x 750 steps, seed 1234)
                beside QLL and the untrained router of its seed; the seeds'
                mean and standard deviation of ``mean_reward``.  Seed 0's
                router is saved in the reference's tree layout and served
                back through ``launch/route.py --ckpt``: the same greedy
                metrics.  B1 once per collect and evaluation step.
 14. train_scale — the reference's fleet-scale training shapes
                (``benchmarks/bench_scaling.py train_sweep``): N=64 padded
                and segments, N=256 segments; 2 envs, 2 x 2 collect, 2
                updates of 16, buffer 1,024; 11 iterations graphed, eager
                and eager on B1's plain version (128 and 512 rows), all
                bit-equal; iterations/s and peak memory, graphed and eager.
 15. scenario — routing under ``stress`` and under ``rolling_outage`` with
                failover (retry budget 2, shed watermark 0.9) at 8
                arrivals/s, N=6 x 4 envs x 750 steps: QLL, SQF and the
                trained router, graphed and eager (bit-equal metrics and
                final state, retry buffer included), the trained router's
                first 250 steps also eagerly on B1's plain version
                (bit-equal, past 20 s of simulated time); the failover run
                must drain and shed.  B1 once per step, under live ``up``,
                ``k_scale`` and ``admit_min`` channels.
 16. train_cli — ``launch/train.py --router --iters 20 --scenario
                rolling_outage --failover --shed-watermark 0.9
                --straggler-z 4.0``: finite rewards, ``straggler_flags`` in
                the history, B1 once per collect step; then the CLI's
                configs' 20 iterations graphed (the CLI's router bit for
                bit, past the first outage), their first 3 against 3
                run eagerly on B1's plain version (96 rows), bit-equal.
 17. sharded  — sharded router training and the sharded engine advance in
                a world of one NCCL rank (one card; ``launch/mesh.py
                init_world``), every collective launched and captured in
                the CUDA graphs: (a) 24 graphed iterations of seed 0 in the
                paper's setting on ``make_train_mesh()`` (capacity-sharded
                replay) and on ``make_train_mesh(data=1)`` (the envs'
                gather path too), every tensor bit-equal to phase 13's
                unsharded graphed run of the same 24; iterations/s beside
                the unsharded run's.  (b) QLL through
                ``engine_backend="shard"`` (each rank's env state holds its
                block of experts; B1 advances it and one all-gather brings
                the accumulators), and a seeded SAC router likewise (its
                observation gathers the channels it reads), graphed: N=6 x
                4 envs x 750 steps and N=1,024 x 16 x 200 (segments, ragged
                caps), final state and metrics bit-equal to
                ``engine_backend="cuda"`` and to the whole-state design
                (``whole_state``, its B1 launches not counted; QLL's avg
                QoS at N=6 still 0.7336170673370361), QLL's state after 5
                steps bit-equal to the plain loop as each rank's body
                (``shard_body="torch"``, eager); requests/s of the three;
                the bytes each reader's collectives bring a rank in one
                step of both designs (``bytes_per_step``), the advance's
                the six accumulators alone.  (c) ``launch/train.py --router --router-mesh
                --iters 20`` in a process of its own: its saved router bit
                for bit that of ``--router --iters 20``.  B1 once per
                collect step and per routing step on every path.
 18. predictor — the request predictor (``core/predictors.py``): its first
                20 steps graphed against eager (parameters, moments, losses
                bit-equal), then the reference's run through ``train``
                (1,500 steps of 256, graphed; the reference's accuracy
                floors); ``bench_predictors.py``'s rows; Table II: the
                parameter counts and one greedy SAC decision on one N=6
                observation, graphed and eager.
 19. lm_train — LM training: qwen1.5-0.5b at published width in bf16
                through ``launch/train.py`` (20 steps; 10, a restart from the
                checkpoint under ``build/``, 10 more, bit-equal to the 20; 3
                graphed against 3 eager; forward, backward and AdamW each
                captured alone; tokens/s, peak memory, save and restore
                seconds; every step recomputes each layer under
                ``cfg.remat``, qwen's default); the recompute checked: one
                8 x 128 batch's loss and every gradient bit-equal with and
                without it, and with and without it the eager forward and
                backward's ms and peak memory, 3 graphed steps' ms and
                peak memory, and the forward and backward captured alone;
                dbrx-132b at published widths cut to 1 of 40
                layers, Adafactor, 4 microbatches: the peak reckoned first,
                2 eager steps against the first 2 of 5 graphed (every
                parameter and state tensor bit-equal).
 19t. tooling — qwen1.5-0.5b at published width in bf16, lm_train's 8 x
                128 tokens, AdamW: one eager training step on the card
                under ``launch.cost_analysis.CostCounter`` (after an eager
                warm-up step), whose totals (every FLOP, byte, collective
                and op without a formula) must equal the same step's on
                the meta device (the dry run's arithmetic,
                ``launch/dryrun.py``); the step's peak
                (``core.introspect.peak_bytes``) within 15% of the meta
                run's argument and temp bytes plus what the card held
                before the step beyond the arguments (the cuBLAS workspace,
                the allocator's rounding, the warm-up's metrics: named
                and added, not tolerated); the counter's FLOPs and bytes
                over the H100's peak rates (``launch.mesh``) against 5
                graphed steps' median time, as fractions; then
                ``examples/serve_cluster_torch.py`` on the card with its
                reduced experts and 12 requests, each stream done, QoS
                printed for ``rr`` and ``sqf``.
 19b. lm_recurrent_train — the recurrent families' training at
                published widths in bf16 with AdamW (``REC_TRAIN``):
                rwkv6-7b cut to 8 of 32 layers on 2 x 512 tokens, and
                recurrentgemma-2b at its 26 layers on 1 x 2,560 (past its
                window of 2,048), random weights from a seed.  Each: the
                training forward's logits (the plain scans) against the
                serving forward's (B5 or B6) on 2 x 512 tokens within
                2^-4 of the largest logit, the training forward launching
                neither kernel; the loss and every gradient bit-equal with
                and without ``cfg.remat`` (their eager ms and peak memory);
                2 eager AdamW steps against the first 2 of 5 graphed
                (every parameter, moment and the step equal by exact int64
                sums of their bit patterns, ``bit_prints``; the losses
                equal), the loss falling over the 5 steps on the one
                batch, a replayed step traced with no B5 or B6 record and
                its graph holding no launch of either; ms a step, tokens/s
                and peak memory; the step's forward and backward captured
                alone with remat on and off (2 x 512, 3 replays each), and
                AdamW once, with the peak memory of each set.
 20. lm_mesh  — the LM model mesh in a world of one NCCL rank on
                ``make_host_mesh(1, 1)``: (a) qwen1.5-0.5b at published
                width in bf16, AdamW, 8 x 128 tokens, 6 steps through
                ``Trainer(mesh=...)`` (the step under its ``MeshPolicy``,
                the parameters a ``ShardedLM``, every collective in the
                graph) against the meshless ``Trainer`` from seed 0:
                parameters, moments and every step's metrics bit-equal; ms
                a step, tokens/s, peak memory and the collectives' bytes
                of both; the same with ``cfg.seq_parallel`` set (on a
                ``model`` axis of 1 nothing splits), and a 4 x 128 prefill
                with the flag under the policy bit-equal to the meshless
                one.  (b) dbrx-132b at published widths cut to 4 of 40
                layers (as in 9): ``_moe_sharded`` called with model = 1
                on the first MoE layer's 512 tokens of a 4 x 128 prefill
                against ``_moe_local`` (within 2^-6 of the largest
                output; ``aux`` equal), its B4b and B4a calls against their
                plain versions; the prefill (eager, then a replay) and 8
                decode steps under a 1 x 1 policy over a ``ShardedLM`` of
                serving blocks, graphed, bit-equal to the same steps
                without a policy, B2 n_layers per prefill, B3 n_layers per
                decode, B4b and B4a once per MoE layer of each (counted
                for the kernels line), and again with ``cfg.seq_parallel``
                set (not counted); (c) one prefill and decode under
                the policy through the kernels against their plain
                versions (the plain run replays the kernel run's expert
                routing), as in 8.  (d) whisper-medium at published
                widths cut to 4 + 4 layers: prefill (2 x 1,500 frames)
                and 4 greedy decodes under a 1 x 1 policy, graphed,
                bit-equal to no policy (B2 4 per prefill, B3 8 per
                decode, counted for the kernels line), and 2 training
                steps on a ``ShardedLM`` under the policy bit-equal to
                the meshless steps.  (e) the Megatron split at published
                widths in bf16: one layer each of qwen1.5-0.5b,
                starcoder2-15b and dbrx-132b, every ``model`` rank's body
                for m = 2 and 4 run one after another in this process
                (attention of a 2 x 256 prefill through B2, the MLP's ff
                columns or the rank's experts through B4b and B4a, one
                decode through B3 on the rank's part of the cache), the
                partials summed by hand within 2^-6 of the whole layer's
                largest output; each rank's B2, B3 and B4 calls against
                their plain versions at its shapes, and their times
                (checks only: not counted).  (f) rwkv6-7b and
                recurrentgemma-2b at published widths and depth in bf16:
                a 4 x 128 prefill (eager, then a replay) and 8 greedy
                decodes through ``launch/steps.py`` under a 1 x 1 policy
                over a ``ShardedLM`` of serving blocks, graphed, bit-equal
                to no policy (logits and caches; B5 32 and B6 18 per
                prefill, B3 8 per recurrentgemma decode, counted for the
                kernels line).  (g) the recurrent families and the
                sequence split at published widths in bf16, every
                ``model`` rank's body for m = 2 and 4 in this process:
                one rwkv6-7b layer (time mix on H/m heads through B5,
                channel mix reduce-scattered and gated by hand) and one
                recurrentgemma-2b superblock (rec1, rec2 on rnn/m
                channels through B6 with the conv output gathered by
                hand; the attention on its heads), a 2 x 256 prefill and
                one decode, summed within 2^-6 of the whole layer's
                largest output; recurrentgemma's decode over a wrapped
                ring of 2,048 and one granite-34b layer's decode over a
                cache of 2 x 4,096, each split by sequence: each rank's
                B3 (o, lse) over its slots merged by hand against B3 over
                the whole cache and the whole layer; every B3 (with lse),
                B5 and B6 call against its plain version at the rank's
                shapes, timed beside the whole width's; the bytes per
                reader of one decode step at m = 2 and 4 by the specs
                (checks only: not counted).  (h) rwkv6-7b cut to 1 of
                32 layers and recurrentgemma-2b to 5 of 26 (a superblock
                and the tail) at published widths in bf16, AdamW with
                remat, 2 x 512 tokens, 3 steps through ``Trainer(mesh=)``
                on the 1 x 1 mesh (the blocks by ``block_spec``) against
                the meshless ``Trainer`` from one seed, each a replay
                after the first: state (``bit_prints``) and every step's
                metrics bit-equal; a traced replay of the mesh step with
                no B5 or B6 record and its graph launching neither;
                rwkv6's mesh checkpoint restored by a meshless
                ``Trainer`` bit-equal (save and restore s).  (i) every
                ``model`` rank's training bodies for m = 2 and 4 in this
                process (``tests/torch_rank_grads.py``): one rwkv6-7b
                layer and one recurrentgemma-2b superblock at published
                widths in bf16 over 2 x 256 tokens, their gradients
                merged over the ranks (split weights concatenated, whole
                ones and the input's summed) within 2^-5 of each one's
                largest magnitude of the whole layer's (checks only).
 21. lm_encdec — whisper-medium at its published widths and depth in bf16
                (24 + 24 layers, 814,190,592 parameters, random weights from
                seed 0), through ``launch/steps.py``: 4 streams of 1,500
                random frame embeddings (the conv stem is a stub, as in the
                reference) prefilled into caches of max_len 1,500 (1.18
                GB), the step's eager first call against its replay
                (bit-equal caches); 32 greedy decodes from
                <|startoftranscript|> replayed from a CUDA graph against
                the same run eagerly on a copy (bit-equal logits and
                caches; each step timed); the teacher-forced ``forward`` on
                the decoded tokens within 2^-4 of its largest logit of the
                decode's (``LOGIT_REL_TOL``).  Counted from 0: B2 24 per
                prefill and 72 per forward (the encoder's 24 unmasked, the
                decoder's 24 causal and 24 cross), B3 48 per decode step
                (self and cross, both under ``lengths``).  Then the
                prefill's cross cache, one decode step from it and the
                teacher-forced forward through the kernels against the
                same calls through their plain versions, each within 2^-4
                of the plain result's largest value, the greedy token the
                same wherever the plain top-2 margin exceeds twice the
                difference (this covers the forward's B2 shapes, 32 x
                1,500 unmasked and 32 x 32 causal).  Then prefills
                graphed and eager and the forward timed, and profiled
                windows of a prefill and of 8 decode steps (the traces
                must hold B2's and B3's launches).  Training:
                ``make_train_step`` with AdamW (``cfg.remat``: each layer
                recomputed in the backward) on 4 x 1,500 frames and 4 x
                128 tokens, 3 steps graphed against 3 eager from the same
                weights (every parameter, moment and loss bit-equal); ms a
                step, peak memory, and the forward, backward and AdamW
                each captured alone.
 22. kernels  — the kernel table line; each kernel's launches are those of
                the counted main paths (3 and 13-17 for B1, 8, 9, 12, 20
                and 21 for the others), calls of its wrapper; B5's and B6's
                entries name the kernels a call launches (``functions``)
                and count them (``kernels_launched``: calls times kernels
                per call).

The phases run in the order 1, 10 and 11's per-pass traces (one profiler
session), 2-9, 12, 21's serving, 10, 11, 13-19, 19t, 19b, 20, 21's training: every
profiled LM window comes before the first backward pass (whisper's
prefill window, taken after the training phases, lost one B2 record in
each of three takes; taken before them it held every record).  Every kernel library is built and loaded
before the first profiler session: on this card a library loaded after
the tracer first started makes later sessions miss kernel records.  A ``seconds`` line gives each phase's time
and the total.  The last line
is ``{"ok": true, "device": {...}}``.  Exits non-zero without
a result when CUDA is unavailable or the package is missing.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
FP32_OPS_PER_S = 67e12           # H100 SXM float32 outside the tensor cores


T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line carries ``t``, the seconds since the
    script started, so that a run's log shows where its time went."""
    if "phase" in obj:
        obj = {**obj, "t": time.perf_counter() - T0}
    print(json.dumps(obj), flush=True)


def ptxas_report(build, name: str) -> dict:
    """ptxas's registers, spills (bytes) and static shared memory per kernel
    function of ``csrc/<name>.cu``, from ``nvcc --resource-usage`` with the
    kernel's own flags (a cubin beside the built libraries)."""
    cubin = build.BUILD_DIR / f"{name}.resources.cubin"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    flags = [f for f in build.flags(name)
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    text = subprocess.run(
        [build.nvcc(), *flags, "--resource-usage", "-cubin", "-o", str(cubin),
         str(build.CSRC / f"{name}.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, check=True, timeout=600).stdout
    out, func = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            func = out.setdefault(m.group(1), {})
        elif func is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m:
                func["spill_stores"], func["spill_loads"] = map(int, m.groups())
            m = re.search(r"Used (\d+) registers", line)
            if m:
                func["registers"] = int(m.group(1))
                m = re.search(r"(\d+) bytes smem", line)
                func["smem"] = int(m.group(1)) if m else 0
    return out


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def lockstep_ops(rows, r, w, turns, done) -> int:
    """Scalar operations the lockstep-advance kernel does on these inputs,
    counted from its body (``csrc/lockstep_advance.cu``): per row, the wait
    side's keys and masks (~6 per wait slot) and the first work test (~1 per
    run slot); per row turn, the run-slot scan (~3 per slot), the waiter
    pick (~2 per slot), the memory check and the choice (~10), the decode's
    slot updates (~3 per slot) or the admit's clock (2), and the closing
    work test (~1 per slot, +2); per finished request, its latency, QoS test
    and six accumulator adds (~10).  ``turns`` and ``done`` are this input's
    own (``engine.advance_shard(counts=...)`` and the ``done`` sums)."""
    per_turn = 3 * r + 2 * w + 10 + 3 * r + r + 2
    return rows * (6 * w + r) + turns * per_turn + 10 * done


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def device_ms(fn, reps: int) -> float:
    """Milliseconds per call of ``fn`` on the card with its launches queued
    ahead: a spin kernel holds the card while the host queues ``reps``
    calls between two events, so the host's time between launches, which
    sets a short call's time in ``cuda_ms``, drops out.  Fails if the host
    could not queue them before the spin ended."""
    fn()
    torch.cuda.synchronize()
    for spin_cycles in (10**8, 10**9):          # ~0.05 s, ~0.5 s
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin_cycles)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        ahead = not a.query()                   # the card still spinning
        b.synchronize()
        if ahead:
            return a.elapsed_time(b) / reps
    raise RuntimeError("the host could not queue the calls ahead of the card")


# ---------------------------------------------------------------------------
# Phase 2: the lockstep-advance kernel against its plain version
# ---------------------------------------------------------------------------


def bulk_arrivals(layout, q, rng, t, wait_caps, p_arrive, dev):
    """Push one request into each (env, expert) picked with probability
    ``p_arrive``, in its first free in-cap wait slot (full queues drop)."""
    b, n, w, _ = q["wait_i"].shape
    pick = torch.as_tensor(rng.uniform(size=(b, n)) < p_arrive, device=dev)
    free = (q["wait_i"][..., 0] == 0) & layout.slot_valid(wait_caps, w)
    slot = torch.argmax(free.to(torch.uint8), dim=-1)
    do = pick & free.any(-1)
    shape = (b, n)
    new_i = torch.stack([
        torch.ones(shape, dtype=torch.int32, device=dev),
        torch.as_tensor(rng.integers(16, 512, shape), dtype=torch.int32,
                        device=dev),
        torch.as_tensor(rng.integers(8, 300, shape), dtype=torch.int32,
                        device=dev),
        torch.zeros(shape, dtype=torch.int32, device=dev)], -1)
    new_f = torch.stack([
        torch.as_tensor(rng.uniform(0.2, 0.95, shape), dtype=torch.float32,
                        device=dev),
        torch.as_tensor(rng.uniform(0.2, 0.95, shape), dtype=torch.float32,
                        device=dev),
        torch.as_tensor(rng.uniform(8, 300, shape), dtype=torch.float32,
                        device=dev),
        t[:, None].expand(shape)], -1)
    onehot = do[..., None] & (torch.arange(w, device=dev) == slot[..., None])
    q = dict(q)
    q["wait_i"] = torch.where(onehot[..., None], new_i[:, :, None, :],
                              q["wait_i"])
    q["wait_f"] = torch.where(onehot[..., None], new_f[:, :, None, :],
                              q["wait_f"])
    return q


# advances per admission order at 16,384 rows held against the plain
# loop, whose 0.3-0.6 s a call sets this phase's time; the kernel still
# runs all 100, and B1 is timed at advance 50 (the 24-row run holds all)
KERNEL_CHECKED = 16


def kernel_phase(dev, n_envs=16, n=1024, steps=100, checked=None,
                 p_arrive=0.16):
    """B1 against its plain version on ``n_envs`` x ``n`` rows (module
    docstring, phase 2) over the first ``checked`` of ``steps`` advances
    (all by default) and at advance ``steps // 2``, then timed on that
    mid-run advance."""
    checked = steps if checked is None else checked
    from repro_torch.env import engine, engine_layout as layout, profiles
    from repro_torch.kernels.lockstep_advance import ops

    r, w, lat_l = 5, 5, 0.030
    pool = profiles.make_pool(n, device=dev)
    run_caps, wait_caps = profiles.memory_caps(pool, r, w)
    wait_caps_t = torch.as_tensor(wait_caps, device=dev)
    rng = np.random.default_rng(0)
    up = torch.as_tensor(rng.uniform(size=(n_envs, n)) >= 0.125, device=dev)
    floor = rng.uniform(0.3, 0.8, (n_envs, n)).astype(np.float32)
    floor[rng.uniform(size=(n_envs, n)) >= 0.1] = -1e30
    admit_min = torch.as_tensor(floor, device=dev)
    par = engine.pool_params(pool, run_caps, wait_caps, up, None,
                             admit_min).reshape(-1, layout.PAR_CH)
    rows = n_envs * n
    max_err, final, timing = 0.0, {}, None
    compared = 0
    for order in engine.ADMIT_ORDERS:
        rng = np.random.default_rng(1)
        q = layout.empty_queues(n, r, w, batch=n_envs, device=dev)
        clocks = torch.zeros((n_envs, n), device=dev)
        t = torch.zeros(n_envs, device=dev)
        for k in range(steps):
            # at 0.16: ~0.8 arrivals/s per expert (the paper's λ=5 over 6
            # experts)
            q = bulk_arrivals(layout, q, rng, t, wait_caps_t, p_arrive, dev)
            t = t + torch.as_tensor(rng.exponential(0.2, n_envs),
                                    dtype=torch.float32, device=dev)
            args = (q["run_i"].reshape(rows, r, 5), q["run_f"].reshape(rows, r, 5),
                    q["wait_i"].reshape(rows, w, 4), q["wait_f"].reshape(rows, w, 4),
                    par, clocks.reshape(rows),
                    t[:, None].expand(n_envs, n).reshape(rows).contiguous())
            args = tuple(a.contiguous() for a in args)
            got = ops.lockstep_advance(*args, latency_L=lat_l,
                                       admit_order=order)
            # every fourth advance against the plain loop, whose 0.3-0.5 s
            # per call sets this phase's time; the kernel runs every advance
            if (k < checked and k % 4 == 0) or k == steps // 2:
                compared += 1
                counts = {}
                ref = engine.advance_shard(*args, latency_L=lat_l,
                                           admit_order=order, counts=counts)
                torch.cuda.synchronize()
                for name, a, b in zip(("run_i", "run_f", "wait_valid",
                                       "clocks"), got[:4], ref[:4]):
                    if not torch.equal(a, b):
                        bad = int((a != b).sum())
                        raise AssertionError(f"{order} step {k}: {name} "
                                             f"differs from the plain version "
                                             f"in {bad} elements")
                for i, key in enumerate(engine.ACC_KEYS):
                    a, b = got[4][:, i], ref[4][:, i]
                    if key in ("done", "viol"):
                        assert torch.equal(a, b), (order, k, key)
                    else:
                        torch.testing.assert_close(a, b, rtol=1e-6, atol=0)
                    max_err = max(max_err, float((a - b).abs().max()))
            if k == steps // 2 and order == "fifo":
                done = int(ref[4][:, engine.ACC_KEYS.index("done")].sum())
                timing = (args, counts["turns"], done)
            run_i, run_f, wvalid, clocks, _ = got
            wait_i = q["wait_i"].clone()
            wait_i[..., 0] = wvalid.reshape(n_envs, n, w)
            q = {"run_i": run_i.reshape(n_envs, n, r, 5),
                 "run_f": run_f.reshape(n_envs, n, r, 5),
                 "wait_i": wait_i, "wait_f": q["wait_f"]}
            clocks = clocks.reshape(n_envs, n)
        final[order] = {"min_clock": float(clocks.min()),
                        "running": int(q["run_i"][..., 0].sum()),
                        "waiting": int(q["wait_i"][..., 0].sum())}
        assert final[order]["running"] > 0, order

    args, turns, done = timing
    kernel = lambda: ops.lockstep_advance(*args, latency_L=lat_l,
                                          admit_order="fifo")
    ms = device_ms(kernel, 200)
    call_ms = cuda_ms(kernel, 50)
    plain_ms = cuda_ms(lambda: engine.advance_shard(
        *args, latency_L=lat_l, admit_order="fifo"), 5)
    out_bytes = sum(x.numel() * x.element_size() for x in args)
    out_bytes += rows * (r * 5 * 4 * 2 + w * 4 + 4 + 6 * 4)
    bytes_ms = out_bytes / HBM_BYTES_PER_S * 1e3
    n_ops = lockstep_ops(rows, r, w, turns, done)
    ops_ms = n_ops / FP32_OPS_PER_S * 1e3
    row = {"phase": "kernel", "name": "lockstep_advance", "rows": rows,
           "R": r, "W": w, "advances_per_order": steps,
           "advances_checked": checked,
           "orders": list(engine.ADMIT_ORDERS), "bit_exact": True,
           "launches_compared": compared, "max_abs_err": max_err,
           "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
           "bytes": out_bytes, "turns": turns, "finished": done,
           "ops": n_ops, "bytes_ms": bytes_ms,
           "ops_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "final_state": final}
    emit(row)
    return row


# ---------------------------------------------------------------------------
# Phase 3: serve requests through the main path
# ---------------------------------------------------------------------------


def same_state(a, b) -> bool:
    """Two env states equal bit for bit (every tensor but the generator)."""
    for k, x in a.items():
        if k == "gen" or x is None or not isinstance(x, (dict, torch.Tensor)):
            continue
        if isinstance(x, dict):
            if not same_state(x, b[k]):
                return False
        elif not torch.equal(x, b[k]):
            return False
    return True


QLL_N6_AVG_QOS = 0.7336170673370361
METRIC_KEYS = ("avg_qos", "avg_latency_per_token", "violation_rate",
               "completed", "dropped", "mean_reward")


def serve_phase(dev, n_experts, n_envs, n_steps, n_check, obs_fmt, ragged,
                seed):
    from repro_torch.core import sac
    from repro_torch.kernels.lockstep_advance import ops
    from repro_torch.launch import route

    env_cfg, pool = route.make_env(n_experts, ragged_caps=ragged,
                                   backend="cuda", device=dev)
    model = sac.init_params(route.sac_config(env_cfg), seed=seed, device=dev)
    rows, launches = [], 0
    for pol in route.make_policies(env_cfg, model, obs_fmt=obs_fmt):
        runs = {}
        for mode in ("graphed", "eager"):
            ops.LAUNCHES = 0
            m, state = route.serve(env_cfg, pool, pol, n_steps=n_steps,
                                   n_envs=n_envs, graphs=mode == "graphed")
            got = ops.LAUNCHES
            assert m["mode"] == mode and got == n_steps, (pol.name, mode, got)
            launches += got
            runs[mode] = (m, state)
        (m, state), (m_eager, s_eager) = runs["graphed"], runs["eager"]
        same = (all(m[k] == m_eager[k] for k in METRIC_KEYS)
                and same_state(state, s_eager))
        assert same, (pol.name, {k: (m[k], m_eager[k]) for k in METRIC_KEYS})
        for k in ("avg_qos", "avg_latency_per_token", "violation_rate",
                  "mean_reward"):
            assert np.isfinite(m[k]), (pol.name, k, m[k])
        assert 0.0 <= m["avg_qos"] <= 1.0, m
        # a SAC router with random weights may drop everything
        assert m["completed"] > 0 or pol.name == "SAC", m
        if (n_experts, n_envs, n_steps, pol.name) == (6, 4, 750, "QLL"):
            # the value every earlier run on this card gave: the
            # heuristics' metrics are a fingerprint of the engine's
            # semantics
            assert m["avg_qos"] == QLL_N6_AVG_QOS, m["avg_qos"]
        assert tuple(state["expert_clock"].shape) == (n_envs, n_experts)
        assert bool((state["expert_clock"] >= state["clock"][:, None]).all())
        row = {"phase": "serve", "n_experts": n_experts, "n_envs": n_envs,
               "obs_fmt": obs_fmt, "ragged_caps": ragged, "backend": "cuda",
               "launches": n_steps,
               **{k: m[k] for k in ("policy", "requests", "avg_qos",
                                    "avg_latency_per_token",
                                    "violation_rate", "completed",
                                    "dropped")},
               "graphed_equals_eager": same,
               "requests_per_s": {"graphed": m["requests_per_s"],
                                  "eager": m_eager["requests_per_s"]},
               "speedup": m["requests_per_s"] / m_eager["requests_per_s"],
               "first_step_s": {"graphed": m["first_step_s"],
                                "eager": m_eager["first_step_s"]},
               "seconds": {"graphed": m["seconds"],
                           "eager": m_eager["seconds"]}}
        emit(row)
        rows.append(row)

    # the same heuristic on the plain engine must end in the same state
    qll = lambda cfg: next(p for p in route.make_policies(cfg)
                           if p.name == "QLL")
    plain_cfg = dataclasses.replace(env_cfg, engine_backend="torch")
    m_cuda, s_cuda = route.serve(env_cfg, pool, qll(env_cfg), n_steps=n_check,
                                 n_envs=n_envs)
    ops.LAUNCHES = 0
    # the plain engine syncs with the host every turn: it runs eagerly
    m, state = route.serve(plain_cfg, pool, qll(plain_cfg), n_steps=n_check,
                           n_envs=n_envs, graphs=False)
    assert ops.LAUNCHES == 0
    assert m["completed"] == m_cuda["completed"], (m, m_cuda)
    assert m["dropped"] == m_cuda["dropped"], (m, m_cuda)
    assert torch.equal(state["expert_clock"], s_cuda["expert_clock"])
    for k in state["queues"]:
        assert torch.equal(state["queues"][k], s_cuda["queues"][k]), k
    emit({"phase": "serve", "n_experts": n_experts, "n_envs": n_envs,
          "obs_fmt": obs_fmt, "ragged_caps": ragged, "policy": "QLL",
          "requests": m["requests"], "same_final_state": True,
          "requests_per_s": {"cuda_graphed": m_cuda["requests_per_s"],
                             "torch_eager": m["requests_per_s"]}})

    for pol in route.make_policies(env_cfg, model, obs_fmt=obs_fmt):
        if pol.name not in ("QLL", "SAC"):
            continue
        emit({"phase": "profile", "n_experts": n_experts, "n_envs": n_envs,
              "obs_fmt": obs_fmt, "policy": pol.name,
              **profile_window(env_cfg, pool, pol, n_envs)})
    return launches, rows


def trace_events(prof, device: str) -> list:
    """The ``device`` ("CPU" or "CUDA") records of a finished torch.profiler
    session, each with the ``name`` and ``time_range`` (us from the trace's
    start) that ``prof.events()`` gives it, read from the raw Kineto events:
    ``prof.events()`` also builds every CPU op's record and links it to its
    kernels, which takes some 26 s for an eager LM window of 330,000
    events."""
    from types import SimpleNamespace

    from torch.autograd.profiler_util import Interval

    result = prof.profiler.kineto_results
    t0 = result.trace_start_ns()
    return [SimpleNamespace(name=e.name(), time_range=Interval(
                (e.start_ns() - t0) / 1e3, (e.end_ns() - t0) / 1e3))
            for e in result.events()
            if str(e.device_type()).endswith(device)]


def profiled(run, expected, label):
    """``run()`` under torch.profiler (CPU and CUDA, synchronised at its
    end): its result, the window's kernel records and the takes it needed.
    The profiler on the card now and then loses some of a window's kernel
    records (whole graph replays, or a few eager launches) though the
    kernels ran, so a window in which a tag of ``expected`` ({tag of
    ``TRACE_KERNELS``: launches}) has fewer records than launches is taken
    again, up to ``TRACE_TAKES`` times.  More records than launches, or
    too few in every take, fails the run."""
    from torch.profiler import ProfilerActivity, profile

    for take in range(1, TRACE_TAKES + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            result = run()
            torch.cuda.synchronize()
        kernels = trace_events(prof, "CUDA")
        got = {tag: sum(any(n in e.name for n in TRACE_KERNELS[tag])
                        for e in kernels) for tag in expected}
        assert all(got[t] <= expected[t] for t in expected), (
            label, got, expected)
        if got == expected:
            return result, kernels, take
    raise AssertionError(f"{label}: kernel records short in all "
                         f"{TRACE_TAKES} takes: {got} against {expected}")


def device_window(run, steps, wall_ms_per_step, b1, label):
    """One call of ``run`` (``steps`` routing steps) under torch.profiler,
    whose trace must hold ``b1`` B1 launches (``profiled``): the device's
    busy time, kernel launches and B1's launches and time per step.
    ``device_idle_share`` sets that busy time against the unprofiled wall
    time per step (as the LM windows do: tracing some 200 kernels a step
    stretches the profiled window's own wall time); it mixes two runs, and
    is negative where the traced busy time exceeds the unprofiled wall
    time.  ``device_idle_share_profiled`` takes both from the profiled
    window."""
    def timed_run():
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    wall_s, kernels, takes = profiled(timed_run, {"b1": b1}, label)
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    lock = [e.time_range.elapsed_us() for e in kernels
            if any(n in e.name for n in TRACE_KERNELS["b1"])]
    busy_ms = busy_us / steps / 1e3
    return {"ms_per_step": wall_ms_per_step,
            "ms_per_step_profiled": wall_s / steps * 1e3,
            "device_busy_ms_per_step": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms_per_step,
            "device_idle_share_profiled": 1.0 - busy_us / 1e6 / wall_s,
            "kernels_per_step": len(kernels) / steps,
            "lockstep_launches": len(lock),
            "lockstep_ms_per_step": sum(lock) / steps / 1e3,
            "trace_takes": takes}


def profile_window(env_cfg, pool, policy, n_envs, steps=30):
    """Where a routing step's time goes, graphed and eager.  Graphed (a
    ``RoutingLoop`` replaying its step): the wall time per step of a run
    synchronised at its end; each layer's device time per step
    (observation, policy, env step, each captured alone over the same
    static state and replayed in turn with the launches queued ahead of the
    card); and one window under torch.profiler, whose trace must hold one
    B1 launch per step.  Eager: host wall time per layer (each
    synchronised), the wall time per step of a run, and a profiled
    window."""
    from repro_torch.core import features, training
    from repro_torch.device import generator
    from repro_torch.env import env as env_lib
    from repro_torch.graphs import StepGraph

    out = {"steps": steps}
    loop = training.RoutingLoop(env_cfg, pool, policy, n_envs, seed=7)
    loop.run(4)                                     # the first step, capture
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loop.run(steps)
    torch.cuda.synchronize()
    graphed = device_window(lambda: loop.run(steps), steps,
                            (time.perf_counter() - t0) / steps * 1e3, steps,
                            f"{policy.name} graphed")
    out["graphed"] = graphed

    # each layer captured alone (a heuristic builds no observation); in
    # turn they make one step
    obs = None if policy.obs_fmt is None else StepGraph(loop.observe)
    layers = [obs, StepGraph(lambda: loop.act(None if obs is None
                                              else obs.out),
                             generators=(loop.act_gen,))]
    layers.append(StepGraph(lambda: loop.apply(layers[1].out),
                            generators=(loop.env_gen,)))
    ev = [[torch.cuda.Event(enable_timing=True) for _ in range(4)]
          for _ in range(steps + 1)]
    torch.cuda.synchronize()
    torch.cuda._sleep(10**8)                        # queue ahead of the card
    for e in ev:
        e[0].record()
        for i, g in enumerate(layers):
            if g is not None:
                g.replay()
            e[i + 1].record()
    torch.cuda.synchronize()
    out["graphed_layer_device_ms_per_step"] = {
        k: float(np.mean([e[i].elapsed_time(e[i + 1]) for e in ev[1:]]))
        for i, k in enumerate(("obs", "policy", "env_step"))}
    # a third reading, from unprofiled runs alone: the layers' device time
    # (busy, and the gaps inside their graphs) against the wall time
    out["graphed"]["device_idle_share_events"] = 1.0 - sum(
        out["graphed_layer_device_ms_per_step"].values()) / graphed[
            "ms_per_step"]

    # eager, as PRs 11-16 measured it
    dev = pool.k1.device
    state = env_lib.reset(env_cfg, pool, generator(dev, 7), n_envs)
    pstate = policy.init_state(n_envs, dev)
    act_gen = generator(dev, 8)

    def one_step(state, pstate, layer_s=None):
        marks = [time.perf_counter()]
        obs = (None if policy.obs_fmt is None else features.build_obs(
            env_cfg, pool, state, fmt=policy.obs_fmt))
        if layer_s is not None:
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
        a, pstate = policy.act(pstate, state, obs, act_gen)
        if layer_s is not None:
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
        state, _, _ = env_lib.step(env_cfg, pool, state, a)
        if layer_s is not None:
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            for i, k in enumerate(("obs", "policy", "env_step")):
                layer_s[k] += marks[i + 1] - marks[i]
        return state, pstate

    for _ in range(3):                                   # warm up
        state, pstate = one_step(state, pstate)
    layer_s = {"obs": 0.0, "policy": 0.0, "env_step": 0.0}
    for _ in range(steps):
        state, pstate = one_step(state, pstate, layer_s)
    out["eager_ms_per_step_synced"] = {k: v / steps * 1e3
                                       for k, v in layer_s.items()}
    carry = [state, pstate]

    def eager_run():
        for _ in range(steps):
            carry[:] = one_step(*carry)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eager_run()
    torch.cuda.synchronize()
    out["eager"] = device_window(eager_run, steps,
                                 (time.perf_counter() - t0) / steps * 1e3,
                                 steps, f"{policy.name} eager")
    return out


# ---------------------------------------------------------------------------
# Phases 13-16: router training, its fleet-scale shapes, scenarios, the CLI
# ---------------------------------------------------------------------------

TRAIN_SEEDS = (0, 1, 2)
TRAIN_CHECK_ITERS = 24       # graphed against eager: 15 collect, then 9 updating
# iterations held against B1's plain version, which waits for the card once
# per turn (~3 s an iteration): B1 runs only in the collect steps, so a
# prefix of collect-only iterations holds all of it
TRAIN_PLAIN_ITERS = 1
# steps of the scenario runs held against B1's plain version, which waits
# for the card once per turn (~0.09 s a step): into the first outage (20-50
# s) of ``rolling_outage``
SCENARIO_PLAIN_STEPS = 250
EVAL = dict(n_steps=750, n_envs=4)     # the serve phase's protocol, seed 1234
EVAL_KEYS = ("mean_reward", "avg_qos", "completed", "dropped",
             "violation_rate")
# the failover scenario run's arrival rate: 1.6x the paper's 5/s, so that
# overload shedding and drains both happen in 750 steps x 4 envs
SCENARIO_RATE = 8.0
SCALE_ITERS = 10
# the CLI's iterations held against B1's plain version (~2.7 s an iteration)
CLI_PLAIN_ITERS = 3


def differing(a: dict, b: dict) -> list:
    """The names of the tensors in which two ``TrainState.tensors()``
    differ (empty: bit-equal): parameters, moments and AdamW step, replay
    buffer, env state and the current observation."""
    return [k for k, x in a.items() if not torch.equal(x, b[k])]


def plain_loop(env_cfg):
    """``env_cfg`` with the env's advance on B1's plain version (the
    PyTorch loop of ``env/engine.py``) instead of the kernel."""
    return dataclasses.replace(env_cfg, engine_backend="torch")


def train_rates(tc, per_iter_s) -> dict:
    """bench_scaling.py's training rates for one iteration's seconds."""
    return {"iterations_per_s": 1.0 / per_iter_s,
            "updates_per_s": tc.updates_per_iter / per_iter_s,
            "transitions_per_s": tc.n_envs * tc.collect_steps / per_iter_s}


def timed_iterations(it_fn, first, n):
    """Seconds of each of iterations ``first .. first+n-1``, each
    synchronised."""
    out = []
    for it in range(first, first + n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        it_fn(it)
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t)
    return out


def update_split(it_fn, reps=50) -> dict:
    """The update's device time in parts: the sample and the losses (actor
    and critic forward), then with the gradients (backward), against the
    whole update (AdamW and polyak the rest).  Each part captured alone
    over the same static state and replayed ``reps`` times with the
    launches queued ahead."""
    from repro_torch.core import replay, sac as sac_lib
    from repro_torch.graphs import capture

    st, tc = it_fn.st, it_fn.tc

    def forward():
        batch = replay.sample(st.buf, st.sample_gen, tc.batch_size)
        with torch.enable_grad():
            return sac_lib.losses(st.sac, batch)[0]

    def backward():
        with torch.enable_grad():
            return sac_lib.grads(forward(), it_fn.params)

    out = {}
    for name, fn in (("forward", forward), ("forward_backward", backward)):
        g, _ = capture(fn, (st.sample_gen,))
        out[name] = device_ms(g.replay, reps)
    out["update"] = device_ms(it_fn.update_graph.replay, reps)
    return {"forward_ms": out["forward"],
            "backward_ms": out["forward_backward"] - out["forward"],
            "adamw_polyak_ms": out["update"] - out["forward_backward"],
            "update_ms": out["update"]}


def train_profile(it_fn, rates) -> dict:
    """Where a graphed iteration's time goes: each step's device time
    (replays queued ahead), the update's split, and torch.profiler windows
    of collect replays, update replays and one whole iteration (its trace
    must hold one B1 launch per collect step).  Idle shares are taken
    against the unprofiled wall times of ``rates`` (traced busy time
    against unprofiled wall time)."""
    tc = it_fn.tc
    s, u = tc.collect_steps, tc.updates_per_iter
    collect_ms = device_ms(it_fn.collect_graph.replay, 50)
    update = update_split(it_fn)
    wall_collect = rates["collect_iteration_ms"] / s
    wall_update = (rates["iteration_ms"] - rates["collect_iteration_ms"]) / u
    replays = lambda g, n: (lambda: [g.replay() for _ in range(n)])
    coll = device_window(replays(it_fn.collect_graph, s), s, wall_collect,
                         s, "train collect")
    upd = device_window(replays(it_fn.update_graph, u), u, wall_update, 0,
                        "train update")
    it_no = it_fn.calls
    whole = device_window(lambda: it_fn(it_no), 1, rates["iteration_ms"], s,
                          "train iteration")
    return {"collect_device_ms": collect_ms, "update": update,
            "collect_window": coll, "update_window": upd,
            "iteration": whole}


def train_phase(dev):
    """The paper's training setting at full width (module docstring): (a)
    graphed against eager and against eager on B1's plain version, (b)
    three seeds of 400 iterations evaluated
    greedily, (c) a profiled iteration, and a saved router served through
    ``launch/route.py --ckpt``.  Returns (B1 launches, a trained router,
    the graphed 24-iteration run: its tensors and rates, which the sharded
    phase holds its runs to)."""
    from repro_torch.core import io, routers, sac as sac_lib, training
    from repro_torch.kernels.lockstep_advance import ops
    from repro_torch.launch import route

    env_cfg, pool = route.make_env(6, device=dev)
    sac_cfg = sac_lib.SACConfig()
    tc = training.TrainConfig()
    s, u = tc.collect_steps, tc.updates_per_iter
    first_update = -(-tc.warmup_transitions // (tc.n_envs * s)) - 1
    launches = 0

    # (a) graphed and eager from the same seeds; eager on B1's plain
    # version (slow: it waits for the card once per turn) for
    # TRAIN_PLAIN_ITERS iterations, held against the graphed state then (the
    # plain run launches no B1 and is not counted)
    n_plain = TRAIN_PLAIN_ITERS
    states, fns, secs = {}, {}, {}
    for mode in ("graphed", "eager", "plain"):
        cfg = plain_loop(env_cfg) if mode == "plain" else env_cfg
        st = training.init_train_state(cfg, sac_cfg, tc, pool)
        fns[mode] = training.make_iteration(cfg, tc, pool, st,
                                            graphs=mode == "graphed")
        n = n_plain if mode == "plain" else TRAIN_CHECK_ITERS
        ops.LAUNCHES = 0
        secs[mode] = timed_iterations(fns[mode], 0, n_plain)
        if mode == "graphed":
            snap = {k: x.clone() for k, x in st.tensors().items()}
        secs[mode] += timed_iterations(fns[mode], n_plain, n - n_plain)
        want = 0 if mode == "plain" else n * s
        assert ops.LAUNCHES == want, (mode, ops.LAUNCHES)
        launches += ops.LAUNCHES
        states[mode] = st
    diff = differing(states["graphed"].tensors(), states["eager"].tensors())
    assert not diff, diff[:10]
    diff = differing(snap, states["plain"].tensors())
    assert not diff, ("plain", diff[:10])
    del snap
    assert int(states["graphed"].opt.step) == (TRAIN_CHECK_ITERS - 1) * u
    rates = {}
    for mode in ("graphed", "eager"):
        t = secs[mode]
        collect_it = float(np.median(t[1:first_update]))
        full_it = float(np.median(t[first_update + 1:]))
        rates[mode] = {"collect_iteration_ms": collect_it * 1e3,
                       "iteration_ms": full_it * 1e3,
                       "first_iteration_s": t[0],
                       "first_update_iteration_s": t[first_update],
                       **train_rates(tc, full_it)}
    unsharded = {"tensors": {k: x.clone() for k, x in
                             states["graphed"].tensors().items()},
                 "rates": rates["graphed"]}
    emit({"phase": "train", "check": "graphed_equals_eager",
          "iterations": TRAIN_CHECK_ITERS, "updating_from": first_update,
          "bit_equal": True, "launches_per_run": TRAIN_CHECK_ITERS * s,
          "b1_rows": tc.n_envs * env_cfg.n_experts,
          "plain_loop_iterations": n_plain, "plain_loop_equal": True,
          "plain_loop_s": sum(secs["plain"]),
          "rates": rates})

    # (c) where a graphed iteration's time goes
    prof = train_profile(fns["graphed"], rates["graphed"])
    emit({"phase": "train_profile", **prof})
    del states, fns

    # (b) three seeds of the full run, evaluated greedily
    qll = next(p for p in route.make_policies(env_cfg) if p.name == "QLL")
    ops.LAUNCHES = 0
    m_qll = training.evaluate(env_cfg, pool, qll, **EVAL)
    assert ops.LAUNCHES == EVAL["n_steps"]
    launches += ops.LAUNCHES
    runs, trained = [], None
    for seed in TRAIN_SEEDS:
        tcs = dataclasses.replace(tc, seed=seed)
        st = training.init_train_state(env_cfg, sac_cfg, tcs, pool)
        it_fn = training.make_iteration(env_cfg, tcs, pool, st)
        untrained = sac_lib.init_params(sac_cfg, seed=seed, device=dev)
        ops.LAUNCHES = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        auxs = [it_fn(it) for it in range(tcs.iterations)]
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        model = st.sac
        assert ops.LAUNCHES == tcs.iterations * s, ops.LAUNCHES
        launches += ops.LAUNCHES
        n_tr = tcs.iterations * tcs.n_envs * s
        size = min(n_tr, tcs.buffer_capacity)
        assert int(st.buf["size"]) == size, int(st.buf["size"])
        assert int(st.buf["ptr"]) == n_tr % tcs.buffer_capacity
        assert int(st.opt.step) == (tcs.iterations - 1) * u
        for k in auxs[0]:
            per_it = torch.stack([a[k] for a in auxs])
            assert bool(torch.isfinite(per_it).all()), (seed, k)
        final = {k: float(v) for k, v in auxs[-1].items()}
        assert bool(torch.isfinite(st.buf["reward"][:size]).all())
        for k, p in model.state_dict().items():
            assert bool(torch.isfinite(p).all()), (seed, k)
        evals = {}
        for name, m in (("SAC", model), ("SAC_untrained", untrained)):
            ops.LAUNCHES = 0
            ev = training.evaluate(env_cfg, pool, routers.sac_policy(name, m),
                                   **EVAL)
            assert ops.LAUNCHES == EVAL["n_steps"]
            launches += ops.LAUNCHES
            evals[name] = {k: ev[k] for k in EVAL_KEYS}
        evals["QLL"] = {k: m_qll[k] for k in EVAL_KEYS}
        row = {"phase": "train", "seed": seed, "iterations": tcs.iterations,
               "seconds": run_s, **train_rates(tcs, run_s / tcs.iterations),
               "size": size, "ptr": int(st.buf["ptr"]),
               "final_collect_reward": final["collect_reward"],
               "final_losses": {k: final[k] for k in
                                ("critic_loss", "actor_loss", "alpha",
                                 "entropy", "q_mean")},
               "eval": evals}
        emit(row)
        runs.append(row)
        if trained is None:
            trained = model
        del st, it_fn, auxs
    rew = [r["eval"]["SAC"]["mean_reward"] for r in runs]
    emit({"phase": "train", "summary": True, "seeds": list(TRAIN_SEEDS),
          "mean_reward_mean": float(np.mean(rew)),
          "mean_reward_std": float(np.std(rew, ddof=1)),
          "qll_mean_reward": m_qll["mean_reward"]})

    # a trained router saved in the reference's layout, served back
    path = os.path.join(ROOT, "build", "router_seed0.npz")
    io.save_pytree(path, io.sac_params_to_numpy(trained))
    ops.LAUNCHES = 0
    rows = route.main(["--ckpt", path, "--steps", str(EVAL["n_steps"]),
                       "--n-envs", str(EVAL["n_envs"])])
    assert ops.LAUNCHES == len(rows) * EVAL["n_steps"]
    launches += ops.LAUNCHES
    got = next(r for r in rows if r["policy"] == "SAC")
    want = runs[0]["eval"]["SAC"]
    assert all(got[k] == want[k] for k in EVAL_KEYS), (got, want)
    emit({"phase": "train", "check": "route_ckpt", "path": "build/"
          "router_seed0.npz", "same_greedy_metrics": True})
    return launches, trained, unsharded


def train_scale_phase(dev):
    """The reference's fleet-scale training shapes
    (``benchmarks/bench_scaling.py train_sweep``): N = 64 padded and
    segments, N = 256 segments; 2 envs, 2 x 2 collect, 2 updates of 16,
    buffer 1,024.  Graphed against eager and against eager on B1's plain
    version (bit-equal), iterations/s of the first two, peak memory."""
    from repro_torch.core import features, sac as sac_lib, training
    from repro_torch.kernels.lockstep_advance import ops
    from repro_torch.launch import route

    launches = 0
    for n, fmt in ((64, "padded"), (64, "segments"), (256, "segments")):
        env_cfg, pool = route.make_env(n, device=dev)
        sac_cfg = sac_lib.SACConfig(
            n_actions=n + 1, flat_dim=n * 3,
            n_run_edges=(features.seg_run_rows(env_cfg)
                         if fmt == "segments" else None))
        tc = training.TrainConfig(
            n_envs=2, collect_steps=2, updates_per_iter=2, batch_size=16,
            buffer_capacity=1024, warmup_transitions=1,
            iterations=SCALE_ITERS + 1, obs_fmt=fmt)
        row, states = {"phase": "train_scale", "n_experts": n,
                       "obs_fmt": fmt}, {}
        for mode in ("graphed", "eager", "plain"):
            cfg = plain_loop(env_cfg) if mode == "plain" else env_cfg
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            st = training.init_train_state(cfg, sac_cfg, tc, pool)
            it_fn = training.make_iteration(cfg, tc, pool, st,
                                            graphs=mode == "graphed")
            ops.LAUNCHES = 0
            first = timed_iterations(it_fn, 0, 1)[0]
            t = timed_iterations(it_fn, 1, SCALE_ITERS)
            states[mode] = st
            if mode == "plain":
                assert ops.LAUNCHES == 0, ops.LAUNCHES
                row["plain_loop_s"] = first + sum(t)
                continue
            assert ops.LAUNCHES == (SCALE_ITERS + 1) * tc.collect_steps
            launches += ops.LAUNCHES
            per_iter = float(np.median(t))
            row[mode] = {"first_iteration_s": first,
                         "iteration_ms": per_iter * 1e3,
                         **train_rates(tc, per_iter),
                         "peak_memory_bytes":
                             torch.cuda.max_memory_allocated()}
        for mode in ("eager", "plain"):
            diff = differing(states["graphed"].tensors(),
                             states[mode].tensors())
            assert not diff, (n, fmt, mode, diff[:10])
        row.update(graphed_equals_eager=True, plain_loop_equal=True,
                   b1_rows=tc.n_envs * n)
        emit(row)
        del states
    return launches


def scenario_phase(dev, trained):
    """Routing under the registry's scenarios at N = 6 x 4 envs: ``stress``,
    and ``rolling_outage`` with failover and overload shedding at
    ``SCENARIO_RATE`` arrivals/s; QLL, SQF and the trained router, graphed
    and eager (bit-equal metrics and final state, retry buffer included);
    the trained router also eager on B1's plain version, bit-equal.  The
    failover run must drain and shed."""
    from repro_torch.core import routers
    from repro_torch.env.failover import FailoverConfig
    from repro_torch.env.workload import WorkloadConfig
    from repro_torch.kernels.lockstep_advance import ops
    from repro_torch.launch import route

    launches = 0
    keys = METRIC_KEYS + ("evicted",)
    for name, fo, rate in (
            ("stress", None, 5.0),
            ("rolling_outage", FailoverConfig(retry_budget=2,
                                              shed_watermark=0.9),
             SCENARIO_RATE)):
        env_cfg, pool = route.make_env(6, device=dev, scenario=name,
                                       failover=fo)
        env_cfg = dataclasses.replace(env_cfg,
                                      workload=WorkloadConfig(rate=rate))
        pols = [p for p in route.make_policies(env_cfg)
                if p.name in ("QLL", "SQF")]
        pols.append(routers.sac_policy("SAC", trained))
        run_keys = keys + (("shed", "retried", "redispatched") if fo
                           else ())
        for pol in pols:
            runs = {}
            for mode in ("graphed", "eager"):
                ops.LAUNCHES = 0
                m, state = route.serve(env_cfg, pool, pol,
                                       n_steps=EVAL["n_steps"],
                                       n_envs=EVAL["n_envs"],
                                       graphs=mode == "graphed")
                assert ops.LAUNCHES == EVAL["n_steps"], (name, pol.name)
                launches += ops.LAUNCHES
                runs[mode] = (m, state)
            (m, state), (m_e, s_e) = runs["graphed"], runs["eager"]
            assert all(m[k] == m_e[k] for k in run_keys), (name, pol.name)
            assert same_state(state, s_e), (name, pol.name)
            plain = {}
            if pol.name == "SAC":
                # the trained router's first SCENARIO_PLAIN_STEPS graphed
                # against eager on B1's plain version (comparison launches,
                # not counted)
                short = dict(n_steps=SCENARIO_PLAIN_STEPS,
                             n_envs=EVAL["n_envs"])
                m_g, s_g = route.serve(env_cfg, pool, pol, **short)
                ops.LAUNCHES = 0
                t = time.perf_counter()
                m_p, s_p = route.serve(plain_loop(env_cfg), pool, pol,
                                       graphs=False, **short)
                assert ops.LAUNCHES == 0, (name, ops.LAUNCHES)
                assert all(m_g[k] == m_p[k] for k in run_keys), name
                assert same_state(s_g, s_p), name
                assert float(s_g["clock"].min()) > 20.0, name
                plain = {"plain_loop_steps": SCENARIO_PLAIN_STEPS,
                         "plain_loop_equal": True,
                         "plain_loop_s": time.perf_counter() - t}
            assert m["completed"] > 0, (name, pol.name, m)
            if fo is not None:
                assert m["retried"] > 0 and m["shed"] > 0, (pol.name, m)
            emit({"phase": "scenario", "scenario": name,
                  "failover": None if fo is None else dataclasses.asdict(fo),
                  "arrival_rate": rate, "policy": pol.name,
                  "graphed_equals_eager": True, "launches": EVAL["n_steps"],
                  **plain,
                  **{k: m[k] for k in run_keys},
                  "requests_per_s": {"graphed": m["requests_per_s"],
                                     "eager": m_e["requests_per_s"]}})
    return launches


def train_cli_phase(dev):
    """``launch/train.py --router`` as the reference's docstring runs it,
    at 20 iterations; then its configs' iterations graphed (the CLI's
    router again, bit for bit, past the first outage), the first
    ``CLI_PLAIN_ITERS`` against eager on B1's plain version, bit-equal."""
    from repro_torch.core import training
    from repro_torch.kernels.lockstep_advance import ops
    from repro_torch.launch import train

    argv = ["--router", "--iters", "20", "--scenario", "rolling_outage",
            "--failover", "--shed-watermark", "0.9", "--straggler-z", "4.0"]
    ops.LAUNCHES = 0
    t0 = time.perf_counter()
    model, hist = train.main(argv)
    secs = time.perf_counter() - t0
    launches = ops.LAUNCHES
    assert launches == 20 * 8, launches
    for h in hist:
        assert np.isfinite(h["collect_reward"]), h
        assert "straggler_flags" in h, h

    env_cfg, pool, sac_cfg, tc = train.router_configs(
        train.parser().parse_args(argv), dev)
    states = {}
    for mode in ("graphed", "plain"):
        cfg = plain_loop(env_cfg) if mode == "plain" else env_cfg
        st = training.init_train_state(cfg, sac_cfg, tc, pool)
        it_fn = training.make_iteration(cfg, tc, pool, st,
                                        graphs=mode == "graphed")
        for it in range(CLI_PLAIN_ITERS):
            it_fn(it)
        if mode == "graphed":
            snap = {k: x.clone() for k, x in st.tensors().items()}
            for it in range(CLI_PLAIN_ITERS, tc.iterations):
                it_fn(it)
        states[mode] = st
    got = states["graphed"].sac.state_dict()
    for k, x in model.state_dict().items():
        assert torch.equal(x, got[k]), k
    diff = differing(snap, states["plain"].tensors())
    assert not diff, diff[:10]
    first_down = 20.0                     # rolling_outage: expert 0 at 20 s
    assert float(states["graphed"].env["clock"].min()) > first_down
    emit({"phase": "train_cli", "argv": argv, "seconds": secs,
          "b1_rows": tc.n_envs * env_cfg.n_experts, "plain_loop_equal": True,
          "plain_loop_iterations": CLI_PLAIN_ITERS,
          "history": hist})
    return launches


# ---------------------------------------------------------------------------
# Phase 17: sharded router training and the sharded engine advance
# ---------------------------------------------------------------------------

# the plain loop waits for the card once per turn: the "shard" engine is
# held against it over its first steps only
SHARD_PLAIN_STEPS = 5
SHARD_ENGINE_CASES = ((6, 4, 750, "padded", False),
                      (1024, 16, 200, "segments", True))


def clone_tree(tree):
    """A copy of every tensor of a state tree (the generator kept)."""
    return {k: (clone_tree(x) if isinstance(x, dict) else
                x.clone() if isinstance(x, torch.Tensor) else x)
            for k, x in tree.items()}


def routed(env_cfg, pool, n_envs, steps, graphs, check_at=None,
           policy=None):
    """``policy`` (QLL by default) over ``RoutingLoop`` for ``steps`` steps
    from the serve phase's seed: (the loop, synchronised seconds after the
    first step, a copy of the env state after ``check_at`` steps)."""
    from repro_torch.core import training
    from repro_torch.launch import route

    if policy is None:
        policy = next(p for p in route.make_policies(env_cfg)
                      if p.name == "QLL")
    loop = training.RoutingLoop(env_cfg, pool, policy, n_envs)
    loop.run(1, graphs)
    snap = None
    t0 = time.perf_counter()
    for n in ((check_at - 1, steps - check_at) if check_at
              else (steps - 1,)):
        loop.run(n, graphs)
        if snap is None and check_at:
            snap = clone_tree(loop.state)
    torch.cuda.synchronize()
    return loop, time.perf_counter() - t0, snap


def sharded_phase(dev, unsharded):
    """Sharded router training and the ``"shard"`` engine in a world of one
    NCCL rank, every collective launched and captured in the CUDA graphs
    (module docstring).  Returns B1 launches."""
    import torch.distributed as dist

    from repro_torch.core import sac as sac_lib, training
    from repro_torch.env import env as env_lib
    from repro_torch.kernels.lockstep_advance import ops
    from repro_torch.launch import mesh as mesh_lib, route, train

    dev = mesh_lib.init_world(dev)
    assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
    launches = 0
    try:
        # (a) 24 graphed iterations of seed 0 on both meshes against the
        # train phase's unsharded graphed run
        env_cfg, pool = route.make_env(6, device=dev)
        sac_cfg, tc = sac_lib.SACConfig(), training.TrainConfig()
        s = tc.collect_steps
        first_update = -(-tc.warmup_transitions // (tc.n_envs * s)) - 1
        for name, data in (("expert", None), ("data1_expert", 1)):
            mesh = mesh_lib.make_train_mesh(data=data)
            st = training.init_train_state(env_cfg, sac_cfg, tc, pool,
                                           mesh=mesh)
            it_fn = training.make_iteration(env_cfg, tc, pool, st, mesh=mesh)
            ops.LAUNCHES = 0
            t = timed_iterations(it_fn, 0, TRAIN_CHECK_ITERS)
            assert ops.LAUNCHES == TRAIN_CHECK_ITERS * s, ops.LAUNCHES
            launches += ops.LAUNCHES
            assert it_fn.collect_graph is not None
            assert it_fn.update_graph is not None
            diff = differing(unsharded["tensors"], st.tensors())
            assert not diff, (name, diff[:10])
            full_it = float(np.median(t[first_update + 1:]))
            emit({"phase": "sharded", "check": "iterations", "mesh": name,
                  "mesh_shape": list(mesh.mesh.shape),
                  "iterations": TRAIN_CHECK_ITERS, "bit_equal": True,
                  "launches": TRAIN_CHECK_ITERS * s,
                  "rates": {"collect_iteration_ms": float(np.median(
                                t[1:first_update])) * 1e3,
                            "iteration_ms": full_it * 1e3,
                            "first_iteration_s": t[0],
                            "first_update_iteration_s": t[first_update],
                            **train_rates(tc, full_it)},
                  "unsharded_rates": unsharded["rates"]})
            del st, it_fn

        launches += shard_engine_runs(dev)

        # (c) the CLI sharded, in a process of its own, against unsharded
        paths = {k: os.path.join(ROOT, "build", f"router_cli_{k}.npz")
                 for k in ("mesh", "plain")}
        argv = ["--router", "--iters", "20", "--out"]
        ops.LAUNCHES = 0
        t = time.perf_counter()
        train.main(argv + [paths["plain"]])
        plain_s = time.perf_counter() - t
        assert ops.LAUNCHES == 20 * s, ops.LAUNCHES
        launches += ops.LAUNCHES
        code = ("import json, sys\n"
                "from repro_torch.kernels.lockstep_advance import ops\n"
                "from repro_torch.launch import train\n"
                "train.main(sys.argv[1:])\n"
                "print(json.dumps({'b1_launches': ops.LAUNCHES}))")
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", code, "--router-mesh"] + argv
            + [paths["mesh"]], capture_output=True, text=True, timeout=600,
            env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
        mesh_s = time.perf_counter() - t
        assert proc.returncode == 0, proc.stderr[-3000:]
        sub = json.loads(proc.stdout.strip().splitlines()[-1])
        assert sub["b1_launches"] == 20 * s, sub
        launches += sub["b1_launches"]
        got, want = np.load(paths["mesh"]), np.load(paths["plain"])
        assert sorted(got.files) == sorted(want.files) and want.files
        for k in want.files:
            assert np.array_equal(got[k], want[k]), k
        emit({"phase": "sharded", "check": "cli",
              "argv": ["--router-mesh"] + argv, "router_bit_equal": True,
              "launches": 2 * 20 * s, "seconds": {"router_mesh": mesh_s,
                                                  "unsharded": plain_s},
              "stdout_tail": proc.stdout.strip().splitlines()[-6:-1]})
    finally:
        mesh_lib.close_world()
    return launches


def shard_engine_runs(dev) -> int:
    """Phase 17 (b): QLL and a seeded SAC router through the ``"shard"``
    engine (this rank's state kept, accumulators gathered), and through the
    whole-state design, against ``"cuda"``, graphed, and QLL's first steps
    against the plain loop as each rank's body; bytes gathered per step by
    reader.  Returns B1 launches of the ``"cuda"`` and ``"shard"`` runs
    (the whole-state design's are checked, not counted)."""
    from repro_torch.core import sac
    from repro_torch.kernels.lockstep_advance import ops
    from repro_torch.launch import route

    launches = 0
    for n, n_envs, steps, fmt, ragged in SHARD_ENGINE_CASES:
        env_cfg, pool = route.make_env(n, ragged_caps=ragged,
                                       backend="cuda", device=dev)
        shard_cfg = dataclasses.replace(env_cfg, engine_backend="shard")
        plain_cfg = dataclasses.replace(shard_cfg, shard_body="torch")
        model = sac.init_params(route.sac_config(env_cfg), seed=0,
                                device=dev)
        policies = {p.name: p for p in route.make_policies(
            env_cfg, model, obs_fmt=fmt) if p.name in ("QLL", "SAC")}
        for pname, policy in policies.items():
            runs = {}
            # "before": the whole-state design, every rank's state whole
            # and the advance gathering every queue row and clock back (the
            # env's state is whole when it has no shard view)
            for name, cfg in (("cuda", env_cfg), ("shard", shard_cfg),
                              ("before", shard_cfg)):
                ops.LAUNCHES = 0
                with whole_state(name == "before"):
                    runs[name] = routed(cfg, pool, n_envs, steps, True,
                                        check_at=SHARD_PLAIN_STEPS,
                                        policy=policy)
                assert ops.LAUNCHES == steps, (name, ops.LAUNCHES)
                if name != "before":
                    launches += ops.LAUNCHES
            (cuda, cuda_s, cuda_snap), (shard, shard_s, shard_snap) = (
                runs["cuda"], runs["shard"])
            before, before_s, _ = runs["before"]
            assert same_state(cuda.state, shard.state), (n, pname)
            assert same_state(cuda.state, before.state), (n, pname)
            assert "shard" in shard.state and "shard" not in before.state
            assert same_state(cuda_snap, shard_snap), (n, pname)
            row = {"phase": "sharded", "check": "engine", "policy": pname,
                   "n_experts": n, "n_envs": n_envs, "steps": steps,
                   "obs_fmt": fmt, "ragged_caps": ragged,
                   "equals_cuda_backend": True, "launches": steps}
            if pname == "QLL":
                ops.LAUNCHES = 0
                t = time.perf_counter()
                plain, _, _ = routed(plain_cfg, pool, n_envs,
                                     SHARD_PLAIN_STEPS, False)
                row["plain_body_s"] = time.perf_counter() - t
                assert ops.LAUNCHES == 0, ops.LAUNCHES
                assert same_state(shard_snap, plain.state), n
                row.update(plain_body_steps=SHARD_PLAIN_STEPS,
                           plain_body_equal=True)
            gathered = {}
            for name in ("shard", "before"):
                with whole_state(name == "before"):
                    gathered[name] = bytes_per_step(shard_cfg, pool, n_envs,
                                                    policy)
            assert sum(gathered["before"].values()) == gathered_bytes(
                env_cfg, n_envs), gathered["before"]
            acc_bytes = 4 * 6 * n * n_envs
            assert gathered["shard"]["accumulators"] == acc_bytes
            assert "caller" not in gathered["shard"], gathered
            if pname == "SAC":
                q = cuda.state["queues"]
                r, w = q["run_i"].shape[2], q["wait_i"].shape[2]
                want = 4 * n_envs * n * (6 * r + 5 * w)
                assert gathered["shard"]["observation"] == want, gathered
            m, m_cuda = shard.metrics(), cuda.metrics()
            assert m == m_cuda, (m, m_cuda)
            if (n, pname) == (6, "QLL"):
                assert m["avg_qos"] == QLL_N6_AVG_QOS, m["avg_qos"]
            if pname == "QLL":
                assert m["completed"] > 0, m
            per_s = lambda secs: (steps - 1) * n_envs / secs
            emit({**row, "avg_qos": m["avg_qos"],
                  "completed": m["completed"],
                  "requests_per_s": {"shard": per_s(shard_s),
                                     "shard_before": per_s(before_s),
                                     "cuda": per_s(cuda_s)},
                  "gathered_bytes_per_step": {
                      "shard": gathered["shard"],
                      "shard_total": sum(gathered["shard"].values()),
                      "shard_before": gathered["before"],
                      "advance": {"shard": acc_bytes,
                                  "shard_before": gathered_bytes(
                                      env_cfg, n_envs)}}})
    return launches


@contextlib.contextmanager
def whole_state(on: bool):
    """With ``on``, envs under the ``"shard"`` backend keep every expert's
    state on every rank and the advance gathers it all back (the design
    before each rank kept its block): the env gets no ``ShardView``."""
    from repro_torch.env import env as env_lib

    view = env_lib.shard_view
    if on:
        env_lib.shard_view = lambda cfg, device: None
    try:
        yield
    finally:
        env_lib.shard_view = view


def bytes_per_step(env_cfg, pool, n_envs, policy) -> dict:
    """The bytes each reader's collectives bring this rank in one eager
    step of ``policy`` (``collectives.BYTES``), after two steps to fill the
    queues."""
    from repro_torch.distributed import collectives

    loop, _, _ = routed(env_cfg, pool, n_envs, 2, False, policy=policy)
    collectives.BYTES.clear()
    loop.run(1, graphs=False)
    torch.cuda.synchronize()
    return dict(collectives.BYTES)


def gathered_bytes(env_cfg, n_envs) -> int:
    """Bytes the whole-state ``"shard"`` engine's all-gather brings each
    rank per step: every expert row's run slots (two tensors of 5 channels), wait
    valid bits, clock and six accumulators, in 4-byte words."""
    words = 2 * env_cfg.run_cap * 5 + env_cfg.wait_cap + 1 + 6
    return 4 * words * env_cfg.n_experts * n_envs


# ---------------------------------------------------------------------------
# Phase 18: the request predictor and Table II
# ---------------------------------------------------------------------------

PRED_STEPS, PRED_BATCH, PRED_LR = 1500, 256, 1e-3   # the reference's train
PRED_PREFIX = 20              # graphed against eager over these steps
PRED_THRESHOLDS = {"score_top1": 0.25, "score_top3": 0.6, "len_top1": 0.2}
ACT_REPS = 200


def synced() -> float:
    torch.cuda.synchronize()
    return time.perf_counter()


def predictor_phase(dev):
    """The request predictor (module docstring): the reference's training
    run, graphed; graphed against eager on a prefix; Table II."""
    from repro_torch.core import features, predictors, sac as sac_lib
    from repro_torch.device import generator
    from repro_torch.env import env as env_lib
    from repro_torch.graphs import StepGraph

    env_cfg = env_lib.EnvConfig()
    pool = env_lib.make_env_pool(env_cfg, device=dev)
    cfg = predictors.PredictorConfig()
    table = predictors.make_type_token_table(cfg, pool.n_types, 0, device=dev)
    # the first PRED_PREFIX steps graphed and eager from the same seeds
    prefix = {}
    for name, graphs in (("graphed", True), ("eager", False)):
        params = predictors.init_params(cfg, pool.n_experts, 0, device=dev)
        opt = predictors.make_optimizer(params, PRED_STEPS, PRED_LR)
        step = predictors.Step(cfg, pool, table, params, opt,
                               generator(dev, 0), PRED_BATCH, graphs)
        times, losses = [], []
        for _ in range(PRED_PREFIX):
            t = synced()
            losses.append(step.run())
            times.append(synced() - t)
        prefix[name] = (params, opt, times, torch.stack(losses))
    (gp, gopt, gt, gl), (ep, eopt, et, el) = prefix["graphed"], prefix["eager"]
    assert torch.equal(gl, el)
    for (k, a), b in zip(gp.state_dict().items(), ep.state_dict().values()):
        assert torch.equal(a, b), k
    for side in ("m", "v"):
        for k, x in getattr(gopt, side).items():
            assert torch.equal(x, getattr(eopt, side)[k]), (side, k)
    del prefix, gp, ep, gopt, eopt
    # the reference's training run through ``train``, graphed
    t = synced()
    params, m = predictors.train(cfg, pool, steps=PRED_STEPS,
                                 batch=PRED_BATCH, lr=PRED_LR, log_fn=None)
    train_s = synced() - t
    for k, floor in PRED_THRESHOLDS.items():
        assert m[k] > floor, (k, m)
    step_us = lambda ts: float(np.median(ts[1:])) * 1e6
    rows = [{"row": "predictors/score", "us_per_step": train_s / PRED_STEPS
             * 1e6, "top1": m["score_top1"], "top3": m["score_top3"]},
            {"row": "predictors/length", "us_per_step": train_s / PRED_STEPS
             * 1e6, "top1": m["len_top1"], "top3": m["len_top3"]},
            {"row": "predictors/params", "value": m["n_params"]}]

    # Table II: parameter counts and one greedy routing decision
    sac = sac_lib.SAC(sac_lib.SACConfig(), torch.Generator().manual_seed(0)
                      ).to(dev)
    count = lambda mod: sum(p.numel() for p in mod.parameters())
    state = env_lib.reset(env_cfg, pool, generator(dev, 0), 1)
    obs = features.build_obs(env_cfg, pool, state)
    act = lambda: sac_lib.act(sac, obs, greedy=True)
    want = act()
    graph = StepGraph(act)
    assert torch.equal(graph.replay(), want)
    latency = {}
    for name, fn in (("graphed", graph.replay), ("eager", act)):
        t = synced()
        for _ in range(ACT_REPS):
            fn()
        queued = (synced() - t) / ACT_REPS
        one = []
        for _ in range(ACT_REPS):
            t = synced()
            fn()
            one.append(synced() - t)
        latency[name] = {"queued_ms": queued * 1e3,
                         "synchronised_ms": float(np.median(one)) * 1e3}
    emit({"phase": "predictor", "steps": PRED_STEPS, "batch": PRED_BATCH,
          "train_s": train_s, "steps_per_s": PRED_STEPS / train_s,
          "eager_steps_per_s": 1e6 / step_us(et),
          "prefix_graphed_us_per_step": step_us(gt),
          "prefix_eager_us_per_step": step_us(et),
          "graphed_equals_eager_steps": PRED_PREFIX,
          "accuracy": {k: m[k] for k in ("score_top1", "score_top3",
                                         "len_top1", "len_top3")},
          "thresholds": PRED_THRESHOLDS, "bench_predictors": rows,
          "table2": {"score_predictor_params": m["n_params"],
                     "length_predictor_params": m["n_params"],
                     "han_params": count(sac.han),
                     "actor_critic_params": sum(count(getattr(sac, k)) for k
                                                in ("actor", "q1", "q2")),
                     "routing_latency": latency, "reps": ACT_REPS}})


# ---------------------------------------------------------------------------
# Phase 19: LM training
# ---------------------------------------------------------------------------

LM_TRAIN = ["--arch", "qwen1.5-0.5b", "--global-batch", "8", "--seq-len",
            "128"]
QWEN_PARAMS = 465_691_648
DBRX_LAYERS, DBRX_GRAPHED, DBRX_EAGER = 1, 5, 2


def train_leaves(state) -> dict:
    """A train state's tensors by checkpoint path (stacks as lists)."""
    from repro_torch.train import checkpoint, trainer as trainer_lib

    return checkpoint._flatten(trainer_lib.tree(state))


def same_train_state(a, b) -> bool:
    x, y = train_leaves(a), train_leaves(b)
    assert set(x) == set(y)
    members = lambda v: v if isinstance(v, list) else [v]
    return all(torch.equal(p, q) for k in x
               for p, q in zip(members(x[k]), members(y[k])))


def free_cuda() -> None:
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def step_rates(step_s, tokens, n_params) -> dict:
    """ms a step (median after the first), tokens/s and 6 N tokens over
    the step time against the bf16 dense peak."""
    s = float(np.median(step_s[1:]))
    return {"ms_per_step": s * 1e3, "first_step_s": step_s[0],
            "tokens_per_s": tokens / s,
            "model_flops_share": 6 * n_params * tokens / s / BF16_OPS_PER_S}


C4_STEPS = 3       # graphed qwen steps each way (the first captures)


def graphed_steps(state, cfg, batch, n) -> dict:
    """``n`` training steps of ``state`` on one ``batch`` under ``cfg``
    through ``make_train_step`` (the first the eager warm-up and the
    capture, the rest replays): each step's loss, the replays' median ms,
    and the first call's peak memory (every tensor of the step: the
    state, the warm-up's activations, then the graph's pool)."""
    from repro_torch.launch import steps

    step = steps.make_train_step(cfg)
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for i in range(n):
        t = synced()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        times.append(synced() - t)
        if i == 0:
            peak = torch.cuda.max_memory_allocated()
    del step
    free_cuda()
    return {"graphed_losses": losses, "graphed_first_step_s": times[0],
            "graphed_ms_per_step": float(np.median(times[1:])) * 1e3,
            "graphed_max_memory_allocated": peak}


def train_step_layers(state, cfg, dev, batch=None, reps=10,
                      optimizer=True) -> dict:
    """A training step's parts, each captured alone and replayed (device
    ms by CUDA events, median of ``reps``): the forward and loss; forward,
    loss and backward; with ``optimizer`` the optimizer's update on those
    gradients (it moves the state: call last).  ``batch`` defaults to 8 x
    128 ``SyntheticLM`` tokens."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.graphs import capture
    from repro_torch.models import model as model_lib

    params, opt = state["params"], state["opt"]
    if batch is None:
        batch = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=128,
                                       global_batch=8), device=dev).batch(0)

    def forward():
        with torch.no_grad():
            return model_lib.lm_loss(params, cfg, batch)[0]

    def backward():
        with torch.enable_grad():
            loss = model_lib.lm_loss(params, cfg, batch)[0]
            return torch.autograd.grad(loss, opt.tensors())

    out = {}
    for name, fn in (("forward", forward), ("forward_backward", backward)):
        graph, grads = capture(fn)
        out[name] = cuda_ms(graph.replay, reps)
        del graph
    out["backward"] = out["forward_backward"] - out["forward"]
    if optimizer:
        graph, _ = capture(lambda: opt.update(list(grads)))
        out["optimizer"] = cuda_ms(graph.replay, reps)
    return out


def remat_pair(model, cfg, batch) -> dict:
    """The loss and every gradient of ``batch`` on ``model``'s weights
    with ``cfg.remat`` off, then on (each layer recomputed in the
    backward): bit-equal (asserted).  For each, eagerly after one warm-up
    call: its synchronised ms and its peak memory above what was
    allocated before it (the weights and the other run's gradients)."""
    from repro_torch.models import model as model_lib

    wrt = [p.requires_grad_(True) for p in model.parameters()]

    def run(c):
        total, _ = model_lib.lm_loss(model, c, batch)
        return total.detach(), torch.autograd.grad(total, wrt)

    runs = {}
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        run(c)                                   # the warm-up
        free_cuda()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t = synced()
        loss, grads = run(c)
        runs[remat] = {"ms": (synced() - t) * 1e3, "loss": loss,
                       "grads": grads,
                       "peak_above_start":
                           torch.cuda.max_memory_allocated() - base}
    off, on = runs[False], runs[True]
    same = torch.equal(off["loss"], on["loss"]) and all(
        torch.equal(a, b) for a, b in zip(off["grads"], on["grads"]))
    assert same, "remat changed the loss or a gradient"
    out = {"loss_and_grads_bit_equal": True, "loss": float(on["loss"]),
           **{f"remat_{str(k).lower()}": {"fwd_bwd_ms_eager": r["ms"],
                                          "peak_above_start": r[
                                              "peak_above_start"]}
              for k, r in runs.items()}}
    del runs, off, on
    free_cuda()
    return out


def lm_train_phase(dev):
    """LM training (module docstring): qwen1.5-0.5b through ``launch/
    train.py``'s LM path, with its recompute (``cfg.remat``) checked and
    timed both ways, dbrx-132b cut to one layer through its step."""
    import shutil

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch import steps, train
    from repro_torch.models import model as model_lib
    from repro_torch.models.transformer import Transformer
    from repro_torch.train import optimizer as opt_lib

    ckpt = os.path.join(ROOT, "build", "lm_train_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    tokens = 8 * 128
    quiet = lambda *a, **k: None
    runs = {}
    torch.cuda.reset_peak_memory_stats()
    runs["straight"] = train.main(LM_TRAIN + ["--steps", "20"])
    peak = torch.cuda.max_memory_allocated()
    runs["first"] = train.main(LM_TRAIN + ["--steps", "10", "--ckpt-dir",
                                           ckpt])
    runs["restarted"] = train.main(LM_TRAIN + ["--steps", "20", "--ckpt-dir",
                                               ckpt])
    assert same_train_state(runs["straight"][0], runs["restarted"][0])
    assert int(runs["restarted"][0]["step"]) == 20
    save_s = runs["first"][1].save_s + runs["restarted"][1].save_s
    restore_s = runs["restarted"][1].restore_s
    assert restore_s is not None and len(save_s) == 2
    straight = runs["straight"][1].step_s
    del runs
    free_cuda()
    graphed, g_tr = train.main(LM_TRAIN + ["--steps", "3"])
    eager, e_tr = train.main(LM_TRAIN + ["--steps", "3", "--eager"])
    assert same_train_state(graphed, eager)
    qwen = get_config("qwen1.5-0.5b")
    assert qwen.remat
    layers_ms = train_step_layers(graphed, qwen, dev)
    layers_off = train_step_layers(
        graphed, dataclasses.replace(qwen, remat=False), dev,
        optimizer=False)
    emit({"phase": "lm_train", "model": "qwen1.5-0.5b", "dtype": "bfloat16",
          "optimizer": "adamw", "global_batch": 8, "seq_len": 128,
          "argv": LM_TRAIN, "restart_bit_equal": {"steps": [10, 10],
                                                  "straight": 20},
          "graphed_equals_eager_steps": 3,
          "remat": True,
          "graphed": step_rates(straight, tokens, QWEN_PARAMS),
          "eager": step_rates(e_tr.step_s, tokens, QWEN_PARAMS),
          "layers_ms": layers_ms, "layers_ms_remat_false": layers_off,
          "max_memory_allocated": peak, "save_s": save_s,
          "restore_s": restore_s, "checkpoint_bytes": sum(
              os.path.getsize(os.path.join(d, f))
              for d, _, fs in os.walk(ckpt) for f in fs)})
    del eager, g_tr, e_tr
    shutil.rmtree(ckpt, ignore_errors=True)
    free_cuda()

    # C4: the step recomputes each layer under cfg.remat: one step's loss
    # and gradients bit-equal both ways; graphed steps timed both ways
    batch = SyntheticLM(DataConfig(vocab=qwen.vocab, seq_len=128,
                                   global_batch=8), device=dev).batch(0)
    c4 = remat_pair(graphed["params"], qwen, batch)
    for remat in (True, False):
        c4[f"remat_{str(remat).lower()}"].update(graphed_steps(
            graphed, dataclasses.replace(qwen, remat=remat), batch,
            C4_STEPS))
    emit({"phase": "lm_train", "check": "remat", "model": qwen.name,
          "dtype": "bfloat16", "global_batch": 8, "seq_len": 128, **c4})
    del graphed
    free_cuda()

    # dbrx-132b at its published widths, one of 40 layers: Adafactor and 4
    # microbatches, 2 eager steps against the first 2 of 5 graphed
    cfg = dataclasses.replace(get_config("dbrx-132b"), n_layers=DBRX_LAYERS)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=128,
                                  global_batch=8,
                                  microbatches=cfg.microbatches), device=dev)
    shapes = Transformer(cfg, torch.device("meta")).parameters()
    n = sum(p.numel() for p in shapes)
    largest = cfg.n_experts * cfg.d_model * cfg.d_ff
    reckoned = {"params_bf16": 2 * n, "grads_bf16": 2 * n,
                "accumulator_f32": 4 * n, "clipped_f32": 4 * n,
                "largest_leaf_update_f32": 4 * 4 * largest}
    emit({"phase": "lm_train", "model": "dbrx-132b", "layers": DBRX_LAYERS,
          "params": n, "reckoned_peak_bytes": sum(reckoned.values()),
          "reckoning": reckoned})
    opt = opt_lib.make_optimizer(cfg.optimizer, peak_lr=3e-4,
                                 warmup_steps=20, total_steps=DBRX_GRAPHED)
    twins = {}
    for name, graphs, n_steps in (("eager", False, DBRX_EAGER),
                                  ("graphed", True, DBRX_GRAPHED)):
        torch.cuda.reset_peak_memory_stats()
        params = model_lib.init_params(cfg, seed=0, device=dev)
        assert sum(p.numel() for p in params.parameters()) == n
        st = steps.train_state(cfg, params, opt)
        step = steps.make_train_step(cfg, graphs=graphs)
        times, losses = [], []
        for i in range(n_steps):
            t = synced()
            st, m = step(st, data.batch(i))
            losses.append(float(m["loss"]))
            times.append(synced() - t)
            emit({"phase": "lm_train", "model": "dbrx-132b", "twin": name,
                  "step": i, "s": times[-1], "loss": losses[-1],
                  "memory_allocated": torch.cuda.memory_allocated(),
                  "max_memory_allocated": torch.cuda.max_memory_allocated(),
                  "memory_reserved": torch.cuda.memory_reserved()})
            if i == DBRX_EAGER - 1:
                leaves = train_leaves(st)
                if name == "eager":
                    host = {k: [x.cpu() for x in (v if isinstance(v, list)
                                                  else [v])]
                            for k, v in leaves.items()}
                else:
                    for k, v in leaves.items():
                        for x, y in zip(v if isinstance(v, list) else [v],
                                        host[k]):
                            assert torch.equal(x.cpu(), y), k
        twins[name] = {"step_s": times, "losses": losses,
                       "max_memory_allocated":
                           torch.cuda.max_memory_allocated()}
        del params, st, step, leaves
        free_cuda()
    assert twins["graphed"]["losses"][:DBRX_EAGER] == twins["eager"]["losses"]
    assert all(np.isfinite(twins["graphed"]["losses"]))
    emit({"phase": "lm_train", "model": "dbrx-132b", "layers": DBRX_LAYERS,
          "optimizer": cfg.optimizer, "microbatches": cfg.microbatches,
          "global_batch": 8, "seq_len": 128,
          "graphed_equals_eager_steps": DBRX_EAGER,
          "graphed": {**step_rates(twins["graphed"]["step_s"], tokens, n),
                      "losses": twins["graphed"]["losses"],
                      "max_memory_allocated":
                          twins["graphed"]["max_memory_allocated"]},
          "eager": {"step_s": twins["eager"]["step_s"],
                    "max_memory_allocated":
                        twins["eager"]["max_memory_allocated"]}})


# ---------------------------------------------------------------------------
# Phase 19b: the recurrent families' training on one card
# ---------------------------------------------------------------------------

# (arch, depth (None: the published one), the fixed batch (B, T), seed):
# rwkv6-7b cut to 8 of 32 layers (weights, gradients and AdamW's moments
# 12 bytes a parameter: 27.4 GB of 2.29 B parameters, where all 32 layers'
# 7.54 B would take 90 GB); recurrentgemma-2b whole (3.55 B, 42.6 GB), its
# batch one sequence of 2,560 tokens, past its window of 2,048
REC_TRAIN = (("rwkv6-7b", 8, (2, 512), 20),
             ("recurrentgemma-2b", None, (1, 2560), 21))
REC_TRAIN_SMALL = (2, 512)   # the remat comparisons, the split, the logits
REC_TRAIN_STEPS, REC_TRAIN_EAGER = 5, 2
REC_SPLIT_REPS = 3           # replays of each captured part of a step
# AdamW at the trainer's peak rate, with no warmup (a first step at rate 0
# would leave the weights as they were)
REC_TRAIN_OPT = dict(peak_lr=3e-4, warmup_steps=0, total_steps=5)
# the training forward's logits (plain scans: rwkv6's D rounded to bf16 as
# the reference rounds it, the RG-LRU's log-depth scan) against the serving
# forward's (B5, which keeps D in float32; B6's serial walk), both bf16:
# within 2^-4 of the largest logit, as the kernels' other full-width logit
# checks (LOGIT_REL_TOL)
TRAIN_SERVE_REL_TOL = 2.0 ** -4


def bit_prints(state) -> dict:
    """Each tensor of a train state (parameters, moments, step) by its
    checkpoint path as two exact int64 sums of its bit patterns: the words
    plain, and each weighted by its position mod 65,521 plus one.  Equal
    states give equal prints; a changed bit changes the first sum."""
    prints = {}
    for k, v in train_leaves(state).items():
        for i, x in enumerate(v if isinstance(v, list) else [v]):
            w = x.detach().reshape(-1)
            if w.is_floating_point():
                w = w.view({2: torch.int16, 4: torch.int32}[w.element_size()])
            acc = torch.zeros(2, dtype=torch.int64, device=w.device)
            for lo in range(0, w.numel(), 1 << 26):
                part = w[lo:lo + (1 << 26)].to(torch.int64)
                pos = torch.arange(lo, lo + part.numel(),
                                   device=w.device) % 65521 + 1
                acc += torch.stack([part.sum(), (part * pos).sum()])
            prints[f"{k}/{i}"] = acc
    keys = sorted(prints)
    return dict(zip(keys, torch.stack([prints[k] for k in keys]).tolist()))


def recurrent_training(dev, arch, depth, shape, seed) -> None:
    """One family's training at published widths in bf16 (module
    docstring, 19b)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.models import model as model_lib
    from repro_torch.train import optimizer as opt_lib

    cfg = get_config(arch)
    if depth is not None:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    assert cfg.remat and cfg.optimizer == "adamw"
    rng = np.random.default_rng(seed)
    draw = lambda b, t: {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab, (b, t)), dtype=torch.int32, device=dev)}
    batch, small = draw(*shape), draw(*REC_TRAIN_SMALL)
    model = model_lib.init_params(cfg, seed=seed, device=dev)
    n = sum(p.numel() for p in model.parameters())
    line = {"phase": "lm_recurrent_train", "model": arch,
            "layers": cfg.n_layers, "published_layers":
                get_config(arch).n_layers, "params": n, "dtype": "bfloat16",
            "optimizer": "adamw", "batch": list(shape),
            "small_batch": list(REC_TRAIN_SMALL)}

    # the training forward's plain scans against the serving forward's
    # kernels, on the small batch
    before = counters()
    with torch.no_grad():
        trained, _ = model_lib.forward(model, cfg, small["tokens"],
                                       train=True)
        mid = counters()
        served, _ = model_lib.forward(model, cfg, small["tokens"])
    after = counters()
    scans = ("rwkv6_scan", "rglru_scan")
    assert all(mid[k] == before[k] for k in scans), (before, mid)
    assert any(after[k] > mid[k] for k in scans), (mid, after)
    a, b = (x[..., :cfg.vocab].float() for x in (trained, served))
    err, scale = float((a - b).abs().max()), float(b.abs().max())
    line["train_vs_serve_logits"] = {
        "max_abs_diff": err, "max_abs_logit": scale,
        "tol": TRAIN_SERVE_REL_TOL * scale,
        "greedy_agree_share": float((a.argmax(-1) == b.argmax(-1))
                                    .float().mean())}
    assert err <= TRAIN_SERVE_REL_TOL * scale, line["train_vs_serve_logits"]
    del trained, served, a, b
    free_cuda()

    # remat: the loss and every gradient bit-equal both ways
    line["remat_check"] = remat_pair(model, cfg, small)

    # two eager steps on the batch, then the graphed twin from the same
    # weights: five steps (the first the warm-up and capture), its state
    # after two bit-equal to the eager one's, the loss falling, a replay
    # traced with no B5 or B6 record
    opt = opt_lib.make_optimizer("adamw", **REC_TRAIN_OPT)
    st = steps.train_state(cfg, model, opt)
    eager = steps.make_train_step(cfg, graphs=False)
    e_losses = []
    for _ in range(REC_TRAIN_EAGER):
        st, m = eager(st, batch)
        e_losses.append(float(m["loss"]))
    prints = bit_prints(st)
    del st, model, eager
    free_cuda()
    model = model_lib.init_params(cfg, seed=seed, device=dev)
    st = steps.train_state(cfg, model, opt)
    step = steps.make_train_step(cfg)
    torch.cuda.reset_peak_memory_stats()
    losses, times, launched = [], [], counters()
    for i in range(REC_TRAIN_STEPS):
        t = synced()
        if i == REC_TRAIN_EAGER:
            (st, m), kernels, takes = profiled(
                lambda: step(st, batch), {"b5": 0, "b6": 0},
                f"{arch} training step")
            line["traced_step"] = {"kernels": len(kernels),
                                   "b5_records": 0, "b6_records": 0,
                                   "trace_takes": takes}
        else:
            st, m = step(st, batch)
        losses.append(float(m["loss"]))
        times.append(synced() - t)
        if i == 0:
            line["graphed_max_memory_allocated"] = (
                torch.cuda.max_memory_allocated())
        if i + 1 == REC_TRAIN_EAGER:
            assert bit_prints(st) == prints, "graphed step differs"
            assert losses == e_losses, (losses, e_losses)
    assert all(counters()[k] == launched[k] for k in scans)
    (graph,) = [g for _, _, g in step.graphs.values()]
    assert all(graph.launches[COUNTER_NAMES.index(k)] == 0 for k in scans)
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    line.update(graphed_equals_eager_steps=REC_TRAIN_EAGER,
                losses=losses, graphed_first_step_s=times[0],
                graphed_ms_per_step=float(np.median(times[1:])) * 1e3,
                tokens_per_s=shape[0] * shape[1] / np.median(times[1:]))
    del step, graph
    free_cuda()

    # the step's parts with remat on and off, each captured alone, and
    # the peak memory of each set of captures (AdamW's update, which remat
    # does not touch, once)
    for remat in (True, False):
        torch.cuda.reset_peak_memory_stats()
        parts = train_step_layers(st, dataclasses.replace(cfg, remat=remat),
                                  dev, small, reps=REC_SPLIT_REPS,
                                  optimizer=remat)
        parts["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        line[f"layers_ms_remat_{str(remat).lower()}"] = parts
        free_cuda()
    emit(line)
    del st, model
    free_cuda()


def lm_recurrent_train_phase(dev) -> None:
    """The recurrent families' training on one card (module docstring)."""
    for arch, depth, shape, seed in REC_TRAIN:
        recurrent_training(dev, arch, depth, shape, seed)


# ---------------------------------------------------------------------------
# Phase 20: the LM model mesh in a world of one NCCL rank
# ---------------------------------------------------------------------------

MESH_TRAIN_STEPS = 6     # qwen trainer steps a run (the first captures)
MESH_DECODES = 8         # decode steps under the policy and without
# _moe_sharded against _moe_local on one layer's tokens: the same expert
# buffers through B4b and B4a, combined in float32 and rounded once against
# four bf16 adds; held to 2^-6 of the largest output
MOE_SHARDED_REL_TOL = 2.0 ** -6
# B4a on activations: float32 order across 10,752 products, as a share of
# the largest output (mesh_moe)
B4A_SCALE_TOL = 2.0 ** -10


@contextlib.contextmanager
def expert_calls():
    """Record every B4b and B4a call of the MoE layer (inputs and output),
    in call order."""
    from repro_torch.models import moe

    real = (moe.expert_swiglu, moe.expert_gemm)
    calls = []

    def swiglu(x, wg, wu):
        out = real[0](x, wg, wu)
        calls.append(("grouped_swiglu", (x, wg, wu), out))
        return out

    def gemm(h, wd):
        out = real[1](h, wd)
        calls.append(("grouped_gemm", (h, wd), out))
        return out

    moe.expert_swiglu, moe.expert_gemm = swiglu, gemm
    try:
        yield calls
    finally:
        moe.expert_swiglu, moe.expert_gemm = real


def mesh_training(dev, mesh) -> None:
    """(a) qwen1.5-0.5b at published width in bf16, AdamW, 8 x 128 tokens:
    ``Trainer(mesh=)`` against the meshless ``Trainer`` from seed 0, each
    step a CUDA graph replay after the first; state and every step's
    metrics bit-equal; the same with ``cfg.seq_parallel`` set (on 1 x 1
    nothing splits), and a 4 x 128 prefill under the policy with the flag
    bit-equal to the meshless one."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.distributed import collectives
    from repro_torch.train import trainer as trainer_lib

    from repro_torch.distributed import sharding
    from repro_torch.distributed.api import MeshPolicy
    from repro_torch.launch import steps

    cfg = get_config("qwen1.5-0.5b")
    seq_cfg = dataclasses.replace(cfg, seq_parallel=True)
    runs = {}
    for name, m, c in (("meshless", None, cfg), ("mesh", mesh, cfg),
                       ("mesh_seq_parallel", mesh, seq_cfg)):
        free_cuda()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()     # the other run's state
        collectives.BYTES.clear()
        tc = trainer_lib.TrainerConfig(total_steps=MESH_TRAIN_STEPS,
                                       log_every=10 ** 9)
        tr = trainer_lib.Trainer(c, tc, mesh=m, device=dev,
                                 log_fn=lambda *a, **k: None)
        data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=128,
                                      global_batch=8), mesh=m, device=dev)
        metrics, step = [], tr._step_fn

        def recorded(st, batch):
            st, out = step(st, batch)
            metrics.append({k: float(v) for k, v in out.items()})
            return st, out
        tr._step_fn = recorded
        state = tr.run(tr.init_state(seed=0), data)
        runs[name] = {"state": state, "metrics": metrics,
                      "rates": step_rates(tr.step_s, 8 * 128, QWEN_PARAMS),
                      "peak_memory_above_start":
                          torch.cuda.max_memory_allocated() - base,
                      "max_memory_allocated":
                          torch.cuda.max_memory_allocated(),
                      "bytes": dict(collectives.BYTES),
                      "graphs": len(step.graphs)}
        assert runs[name]["graphs"] == 1, runs[name]["graphs"]
    for name in ("mesh", "mesh_seq_parallel"):
        same = same_train_state(runs["meshless"]["state"],
                                runs[name]["state"])
        assert same and runs[name]["metrics"] == runs["meshless"]["metrics"]
    assert all(np.isfinite(m["loss"]) for m in runs["mesh"]["metrics"])
    toks = torch.as_tensor(np.random.default_rng(8).integers(
        2, cfg.vocab, (4, 128)), dtype=torch.int32, device=dev)
    policy = MeshPolicy(mesh, sharding.activation_rules(mesh, train=False))
    with torch.no_grad():
        plain = steps.make_prefill_step(cfg, 136)(
            runs["meshless"]["state"]["params"], toks)
        seq = steps.make_prefill_step(seq_cfg, 136, policy)(
            runs["mesh_seq_parallel"]["state"]["params"].model, toks)
    assert torch.equal(plain[0], seq[0]) and all(
        torch.equal(plain[1][k], seq[1][k]) for k in plain[1])
    emit({"phase": "lm_mesh", "check": "training", "model": cfg.name,
          "mesh": str(mesh), "dtype": "bfloat16", "optimizer": "adamw",
          "global_batch": 8, "seq_len": 128, "steps": MESH_TRAIN_STEPS,
          "bit_equal": True, "seq_parallel_bit_equal": True,
          "seq_parallel_prefill_bit_equal": [4, 128],
          "losses": [m["loss"] for m in runs["mesh"]["metrics"]],
          **{name: {k: r[k] for k in ("rates", "peak_memory_above_start",
                                      "max_memory_allocated", "bytes")}
             for name, r in runs.items()}})
    del runs
    free_cuda()


def mesh_moe(dev, mesh, model, cfg) -> None:
    """(b) ``_moe_sharded`` at model = 1 on the first MoE layer's tokens of
    a 4 x 128 prefill against ``_moe_local`` on them (and
    ``_moe_data_parallel`` at data = 1 likewise), and its B4b and B4a
    calls against their plain versions (B4a also against its split
    algorithm, ``grouped_gemm_split_ref``)."""
    from repro_torch.models import moe, transformer

    rng = np.random.default_rng(8)
    toks = torch.as_tensor(rng.integers(2, cfg.vocab, (4, 128)),
                           dtype=torch.int32, device=dev)
    xs, real = [], moe.moe_block

    def first_input(p, x, c, train=False):
        xs.append(x.clone())
        return real(p, x, c, train)
    moe.moe_block = first_input
    try:
        with torch.no_grad():
            transformer.prefill(model, cfg, toks, 128)
    finally:
        moe.moe_block = real
    x, p = xs[0], model.layers[cfg.n_dense_layers].moe
    with torch.no_grad(), expert_calls() as calls:
        y, aux = moe._moe_sharded(p, x, cfg, mesh)
    y_loc, aux_loc = moe._moe_local(p, x, cfg)
    with torch.no_grad():
        y_dp, aux_dp = moe._moe_data_parallel(p, x, cfg, mesh)
    assert [c[0] for c in calls] == ["grouped_swiglu", "grouped_gemm"]
    assert calls[0][1][0].shape[:2] == (cfg.n_experts,
                                        moe._capacity(x.shape[0], cfg))
    err = float((y.float() - y_loc.float()).abs().max())
    scale = float(y_loc.float().abs().max())
    rows = check_expert_calls(calls)
    row = {"phase": "lm_mesh", "check": "moe_sharded_vs_local",
           "model": cfg.name, "tokens": x.shape[0],
           "e_local": cfg.n_experts,
           "cap_local": moe._capacity(x.shape[0], cfg),
           "max_abs_diff": err, "max_abs_out": scale,
           "tol": MOE_SHARDED_REL_TOL * scale,
           "aux_equal": bool(torch.equal(aux, aux_loc)),
           "finite": bool(torch.isfinite(y).all()), "kernels": rows,
           # the data-parallel MoE at data = 1: the local path's buffers,
           # its aux from the probabilities' sum over T against their mean
           "data_parallel_max_abs_diff":
               float((y_dp.float() - y_loc.float()).abs().max()),
           "data_parallel_aux_rel_diff":
               float((aux_dp - aux_loc).abs() / aux_loc.abs())}
    emit(row)
    assert row["finite"] and row["aux_equal"], row
    assert err <= MOE_SHARDED_REL_TOL * scale, row
    assert row["data_parallel_max_abs_diff"] <= MOE_SHARDED_REL_TOL * scale
    assert row["data_parallel_aux_rel_diff"] <= 1e-5, row


def mesh_steps(dev, mesh, model, cfg) -> dict:
    """(b) the prefill and decode steps under a 1 x 1 policy (over a
    ``ShardedLM`` of serving blocks) against the same steps without one,
    graphed: logits and cache bit-equal.  (c) the same steps run eagerly
    under the policy through the kernels against their plain versions
    (the plain run replays the kernel run's expert routing).  Returns the
    graphed policy steps' launches."""
    from repro_torch.distributed import sharding
    from repro_torch.distributed.api import MeshPolicy, use_mesh_policy
    from repro_torch.launch import steps
    from repro_torch.models import io as model_io, transformer

    policy = MeshPolicy(mesh, sharding.activation_rules(mesh, train=False))
    own = list(model.parameters())
    sp = model_io.ShardedLM(model, cfg, mesh, train=False)
    # every leaf its own block: the model's tensors, none gathered
    assert not sp.gathers and all(
        a is b for a, b in zip(own, sp.model.parameters()))
    rng = np.random.default_rng(9)
    max_len = 128 + MESH_DECODES
    toks = torch.as_tensor(rng.integers(2, cfg.vocab, (4, 128)),
                           dtype=torch.int32, device=dev)
    nxt = torch.as_tensor(rng.integers(2, cfg.vocab, (MESH_DECODES, 4)),
                          dtype=torch.int32, device=dev)

    def run(params, pol, c=cfg):
        prefill = steps.make_prefill_step(c, max_len, pol)
        decode = steps.make_decode_step(c, pol)
        first, _ = prefill(params, toks)            # eager, then captured
        logits, cache = prefill(params, toks)       # a replay
        out = {"prefill_first": first, "prefill": logits,
               "cache": {k: v.clone() for k, v in cache.items()}}
        for i in range(MESH_DECODES):
            logits, cache = decode(params, cache, nxt[i])
            out[f"decode{i}"] = logits
        return out

    plain = run(model, None)
    before = counters()
    got = run(sp, policy)
    launches = {k: counters()[k] - before[k] for k in before}
    # cfg.seq_parallel under the 1 x 1 policy: nothing splits (not counted)
    seq = run(sp, policy, dataclasses.replace(cfg, seq_parallel=True))
    assert all((all(torch.equal(plain[k][c], seq[k][c]) for c in plain[k])
                if isinstance(plain[k], dict)
                else torch.equal(plain[k], seq[k])) for k in plain)
    del seq
    n_moe = cfg.n_layers - cfg.n_dense_layers
    want = dict.fromkeys(launches, 0)
    want.update(flash_attn=2 * cfg.n_layers,
                decode_attn=MESH_DECODES * cfg.n_layers,
                grouped_swiglu=(2 + MESH_DECODES) * n_moe,
                grouped_gemm=(2 + MESH_DECODES) * n_moe)
    assert launches == want, (launches, want)
    differs = [k for k in plain if not (
        all(torch.equal(plain[k][c], got[k][c]) for c in plain[k])
        if isinstance(plain[k], dict) else torch.equal(plain[k], got[k]))]
    assert not differs, differs

    # the kernels under the policy against their plain versions
    def eager():
        with use_mesh_policy(policy), torch.no_grad():
            pre, cache = transformer.prefill(sp.model, cfg, toks[:1], max_len)
            dec, _ = transformer.decode_step(sp.model, cfg, cache, nxt[0, :1])
        return pre, dec

    with moe_routing() as ids:
        kern = eager()
    with plain_kernels(), moe_routing(replay=ids):
        ref = eager()
    checks = []
    for name, a, b in zip(("prefill", "decode"), kern, ref):
        a, b = (t.float()[0, :cfg.vocab] for t in (a, b))
        err, scale = float((a - b).abs().max()), float(b.abs().max())
        checks.append({"step": name, "max_abs_logit_diff": err,
                       "max_abs_logit": scale, "tol": LOGIT_REL_TOL * scale,
                       "greedy": [int(a.argmax()), int(b.argmax())]})
        assert err <= LOGIT_REL_TOL * scale, checks[-1]
        assert checks[-1]["greedy"][0] == checks[-1]["greedy"][1], checks[-1]
    emit({"phase": "lm_mesh", "check": "steps_under_policy",
          "model": cfg.name, "layers": cfg.n_layers, "prompts": [4, 128],
          "decodes": MESH_DECODES, "bit_equal_to_no_policy": True,
          "seq_parallel_bit_equal_to_no_policy": True,
          "launches": launches, "kernels_vs_plain": checks})
    return launches


WHISPER_MESH_LAYERS = 4       # encoder and decoder layers of the 1 x 1 run
WHISPER_MESH_FRAMES = 1500
WHISPER_MESH_DECODES = 4
WHISPER_MESH_TRAIN_STEPS = 2


def mesh_whisper(dev, mesh) -> dict:
    """(d) whisper-medium at published widths in bf16, cut to 4 + 4
    layers: the prefill (eager, then a replay) of 2 x 1,500 frames and 4
    greedy decode steps under a 1 x 1 policy over a ``ShardedLM`` of
    serving blocks, graphed, bit-equal to the same steps without one; then
    2 training steps (``make_train_step``, AdamW, 2 x 1,500 frames and 2 x
    128 tokens) on a ``ShardedLM`` of training blocks under the policy,
    bit-equal to the meshless steps (state and losses).  Returns the
    serving steps' launches."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding
    from repro_torch.distributed.api import MeshPolicy
    from repro_torch.launch import steps
    from repro_torch.models import io as model_io, model as model_lib
    from repro_torch.train import optimizer as opt_lib

    cfg = dataclasses.replace(get_config("whisper-medium"),
                              n_layers=WHISPER_MESH_LAYERS,
                              n_enc_layers=WHISPER_MESH_LAYERS)
    gen = torch.Generator(device=dev).manual_seed(21)
    frames = torch.randn((2, WHISPER_MESH_FRAMES, cfg.d_model),
                         generator=gen, device=dev).to(torch.bfloat16)
    sot = torch.full((2,), WHISPER_SOT, dtype=torch.int32, device=dev)
    serve = MeshPolicy(mesh, sharding.activation_rules(mesh, train=False))
    model = model_lib.init_params(cfg, seed=4, device=dev)

    def run(params, pol):
        prefill = steps.make_prefill_step(cfg, WHISPER_MESH_FRAMES, pol)
        decode = steps.make_decode_step(cfg, pol)
        prefill(params, {"frames": frames})         # eager, then captured
        cache = prefill(params, {"frames": frames})  # a replay
        out = {f"cache {k}": v.clone() for k, v in cache.items()}
        tok = sot
        for i in range(WHISPER_MESH_DECODES):
            logits, cache = decode(params, cache, tok)
            out[f"decode{i}"] = logits
            tok = logits[:, :cfg.vocab].argmax(-1).to(torch.int32)
        return out

    plain = run(model, None)
    before = counters()
    got = run(model_io.ShardedLM(model, cfg, mesh, train=False), serve)
    launches = {k: counters()[k] - before[k] for k in before}
    want = dict.fromkeys(launches, 0)
    want.update(flash_attn=2 * cfg.n_enc_layers,
                decode_attn=WHISPER_MESH_DECODES * 2 * cfg.n_layers)
    assert launches == want, (launches, want)
    differs = [k for k in plain if not torch.equal(plain[k], got[k])]
    assert not differs, differs
    del model, plain, got
    free_cuda()

    batch = {"frames": frames,
             "tokens": torch.randint(0, cfg.vocab, (2, ENCDEC_TRAIN_TOKENS),
                                     generator=gen, device=dev,
                                     dtype=torch.int32)}
    twins, train = {}, MeshPolicy(mesh, sharding.activation_rules(
        mesh, train=True))
    for name in ("meshless", "mesh"):
        free_cuda()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()     # the other run's state
        params = model_lib.init_params(cfg, seed=5, device=dev)
        if name == "mesh":
            params = model_io.ShardedLM(params, cfg, mesh, train=True)
        opt = opt_lib.make_optimizer("adamw", peak_lr=3e-4, warmup_steps=0,
                                     total_steps=WHISPER_MESH_TRAIN_STEPS)
        st = steps.train_state(cfg, params, opt)
        step = steps.make_train_step(cfg, train if name == "mesh" else None)
        losses = [float(step(st, batch)[1]["loss"])
                  for _ in range(WHISPER_MESH_TRAIN_STEPS)]
        twins[name] = (st, losses, torch.cuda.max_memory_allocated() - base)
    assert twins["mesh"][1] == twins["meshless"][1]
    assert all(np.isfinite(twins["mesh"][1]))
    assert same_train_state(twins["mesh"][0], twins["meshless"][0])
    emit({"phase": "lm_mesh", "check": "whisper_under_policy",
          "model": cfg.name, "layers": [cfg.n_enc_layers, cfg.n_layers],
          "frames": [2, WHISPER_MESH_FRAMES],
          "decodes": WHISPER_MESH_DECODES, "bit_equal_to_no_policy": True,
          "launches": launches, "train_steps": WHISPER_MESH_TRAIN_STEPS,
          "train_bit_equal": True, "losses": twins["mesh"][1],
          "peak_memory_above_start": {k: v[2] for k, v in twins.items()}})
    del twins
    free_cuda()
    return launches


MESH_RANK_ARCHS = ("qwen1.5-0.5b", "starcoder2-15b", "dbrx-132b")
MESH_RANK_MS = (2, 4)
MESH_RANK_PROMPT = (2, 256)   # rows and tokens through the layer
MESH_RANK_CACHE = 272         # the decode's cache slots
# every model rank's partial output in bf16 (one product over its heads
# or ff columns, rounded once), summed in float32 by hand, against the
# whole layer's product rounded once: m roundings of partials of the
# output's size, held to 2^-6 of the largest output
MESH_RANK_REL_TOL = 2.0 ** -6
ATTN_NAMES = ("wq", "wk", "wv", "wo", "bq", "bk", "bv")


@contextlib.contextmanager
def attention_calls():
    """Record every B2 and B3 call of the transformer's layers (inputs,
    keywords, output), in call order."""
    from repro_torch.models import transformer

    real = (transformer.flash_attn, transformer.decode_attn)
    calls = []

    def flash(q, k, v, **kw):
        out = real[0](q, k, v, **kw)
        calls.append(("flash_attn", (q, k, v), kw, out))
        return out

    def decode(q, k, v, lengths=None, **kw):
        out = real[1](q, k, v, lengths, **kw)
        calls.append(("decode_attn", (q, k, v), dict(lengths=lengths, **kw),
                      out))
        return out

    transformer.flash_attn, transformer.decode_attn = flash, decode
    try:
        yield calls
    finally:
        transformer.flash_attn, transformer.decode_attn = real


def check_attention_calls(calls, label) -> list:
    """Each recorded B2 or B3 call against its plain version on the same
    inputs (``FLASH_TOL``), a row per shape with its time on the card."""
    from repro_torch.kernels.decode_attn import ops as da_ops
    from repro_torch.kernels.decode_attn.ref import decode_attn_plain
    from repro_torch.kernels.flash_attn import ops as fa_ops
    from repro_torch.kernels.flash_attn.ref import attention_ref

    kernels = {"flash_attn": (fa_ops.flash_attn, attention_ref),
               "decode_attn": (da_ops.decode_attn, decode_attn_plain)}
    rows = {}
    for name, args, kw, out in calls:
        kernel, plain = kernels[name]
        want = plain(*args, **kw)
        lse_err = None
        if isinstance(out, tuple):                # B3 with its lse
            (out, lse), (want, lse_want) = out, want
            lse_err = lse_over(lse, lse_want, f"{name} {label}")
        err = float((out.float() - want.float()).abs().max())
        tol = FLASH_TOL[out.dtype]
        if not err <= tol:
            raise AssertionError(f"{name} {label} q {tuple(args[0].shape)} "
                                 f"k {tuple(args[1].shape)}: max abs error "
                                 f"{err} above {tol}")
        key = (name, tuple(args[0].shape), tuple(args[1].shape),
               lse_err is not None)
        if key not in rows:
            rows[key] = {"kernel": name, "q": list(args[0].shape),
                         "k": list(args[1].shape), "calls": 0,
                         "max_abs_err": 0.0, "tol": tol,
                         "ms": device_ms(lambda: kernel(*args, **kw), 20)}
            if lse_err is not None:
                rows[key].update(lse=True, lse_over_tol=0.0,
                                 lse_tol=LSE_REL_TOL)
        rows[key]["calls"] += 1
        rows[key]["max_abs_err"] = max(rows[key]["max_abs_err"], err)
        if lse_err is not None:
            rows[key]["lse_over_tol"] = max(rows[key]["lse_over_tol"],
                                            lse_err)
    return list(rows.values())


# B3's log-sum-exp against its plain version's: float32 sums of the same
# scores in another order and exp2 approximations, within 1e-4 of
# max(1, |lse|); -inf exactly where a row has no valid key
LSE_REL_TOL = 1e-4


def lse_over(got, want, label) -> float:
    """The largest error of a log-sum-exp over ``LSE_REL_TOL`` of
    ``max(1, |want|)``; fails if it is above 1 or the -inf rows differ."""
    empty = want == float("-inf")
    if not torch.equal(got == float("-inf"), empty):
        raise AssertionError(f"{label}: lse -inf rows differ")
    if bool(empty.all()):
        return 0.0
    g, w = got[~empty], want[~empty]
    over = float(((g - w).abs() / (LSE_REL_TOL * w.abs().clamp(min=1.0)))
                 .max())
    if not over <= 1.0:
        raise AssertionError(f"{label}: lse {over} times its tolerance")
    return over


def check_expert_calls(calls) -> list:
    """Each recorded B4b and B4a call against its plain version (B4a also
    against its split algorithm), as phase 7 holds them."""
    from repro_torch.kernels.moe_gemm import ops
    from repro_torch.kernels.moe_gemm.ref import (grouped_gemm_ref,
                                                  grouped_gemm_split_ref,
                                                  grouped_swiglu_ref)

    rows = []
    for name, args, out in calls:
        out = out.float()
        if name == "grouped_swiglu":
            # each element within atol + rtol * |ref|, as phase 7 holds it
            ref = grouped_swiglu_ref(*args).float()
            over = float(((out - ref).abs() / (FLASH_TOL[torch.bfloat16]
                                               * (1 + ref.abs()))).max())
        else:
            # outputs reach ~4e4 as sums of 10,752 products, and float32
            # sums in another order move an element by ~1e-5 of that
            # scale, which near a cancelled element is many of its bf16
            # steps: each element within one bf16 rounding step of itself
            # plus 2^-10 of the largest output, against the plain version
            # and against the card's split algorithm in plain PyTorch
            ref = grouped_gemm_ref(*args).float()
            split = grouped_gemm_split_ref(*args,
                                           ops.sm_count(out.device)).float()
            over = max(float(((out - r).abs() / (
                TILED_REL_TOL * r.abs() + B4A_SCALE_TOL * r.abs().max()))
                .max()) for r in (ref, split))
        rows.append({"kernel": name, "shape": list(args[0].shape),
                     "max_abs_err": float((out - ref).abs().max()),
                     "max_abs_ref": float(ref.abs().max()),
                     "over_tol": over})
        assert over <= 1.0, rows[-1]
    return rows


def rank_sum_check(whole, parts, what) -> dict:
    """Every rank's partial output summed in float32 against the whole
    layer's (``MESH_RANK_REL_TOL``)."""
    total = sum(p.float() for p in parts)
    err = float((total - whole.float()).abs().max())
    scale = float(whole.float().abs().max())
    row = {"part": what, "max_abs_diff": err, "max_abs_whole": scale,
           "tol": MESH_RANK_REL_TOL * scale,
           "finite": bool(torch.isfinite(total).all())}
    if not (row["finite"] and err <= row["tol"]):
        raise AssertionError(f"rank sums vs whole layer: {row}")
    return row


def mesh_rank_layer(dev, arch) -> None:
    """(e) One layer of ``arch`` at published widths in bf16: every
    ``model`` rank's body for m = 2 and m = 4, run one after another in
    this process on its blocks (``sharding.rank_blocks``), the partial
    outputs summed by hand against the whole layer: the attention of a
    2 x 256 prefill through B2, its FFN (the MLP's ff columns, or the
    rank's experts through B4b and B4a at the whole batch's capacity),
    and one decode step through B3 on each rank's part of the cache.
    Each rank's B2, B3 and B4 calls are held against their plain
    versions at its shapes and timed."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding
    from repro_torch.models import layers, model as model_lib, moe
    from repro_torch.models import transformer

    cfg = dataclasses.replace(get_config(arch), n_layers=1)
    model = model_lib.init_params(cfg, seed=6, device=dev)
    blk = model.layers[0]
    b, s = MESH_RANK_PROMPT
    gen = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn((b, s, cfg.d_model), generator=gen,
                    device=dev).to(torch.bfloat16)
    pos = transformer._positions(b, s, dev)
    hn = layers.rms_norm(x, blk.attn_norm, cfg.norm_eps)
    blocks = lambda m, r: sharding.rank_blocks(blk.attn, "layers/attn",
                                               ATTN_NAMES, m, r)
    with torch.no_grad():
        whole, k, v = transformer.attention_body(blocks(1, 0), cfg, hn, pos)
        y = layers.rms_norm(x + whole, blk.mlp_norm, cfg.norm_eps)
        if blk.use_moe:
            ffn_names, path = ("w_gate", "w_up", "w_down"), "moe_layers/moe"
            tokens = y.reshape(b * s, -1)
            gates, ids, _ = moe.route_topk(tokens.float() @ blk.moe.router,
                                           cfg.top_k)
            cap = moe._capacity(b * s, cfg)

            def ffn(m, r):
                w = sharding.rank_blocks(blk.moe, path, ffn_names, m, r)
                e = cfg.n_experts // m
                return moe.moe_shard_body(w, tokens, gates, ids, cfg, r, e,
                                          cap)
        else:
            ffn_names, path = ("w_gate", "w_up", "w_down"), "layers/mlp"

            def ffn(m, r):
                return transformer.mlp_body(sharding.rank_blocks(
                    blk.mlp, path, ffn_names, m, r), y)
        ffn_whole = ffn(1, 0)
        # the decode: a cache of the prefill's keys and values, one token
        sc = MESH_RANK_CACHE
        kc = torch.zeros((b, sc) + tuple(k.shape[2:]), dtype=k.dtype,
                         device=dev)
        vc = torch.zeros_like(kc)
        kc[:, :s], vc[:, :s] = k, v
        xd = layers.rms_norm(torch.randn((b, 1, cfg.d_model), generator=gen,
                                         device=dev).to(torch.bfloat16),
                             blk.attn_norm, cfg.norm_eps)
        dpos = torch.full((b,), s, dtype=torch.int32, device=dev)
        kv_pos = torch.where(torch.arange(sc, device=dev)[None] <= s,
                             torch.arange(sc, device=dev)[None],
                             -1).to(torch.int32).expand(b, sc).contiguous()
        lengths = (dpos + 1).to(torch.int32)
        dec_whole = transformer.attention_decode_body(
            blocks(1, 0), cfg, xd, dpos, dpos.long(), kc.clone(), vc.clone(),
            kv_pos, lengths)
    rows = []
    for m in MESH_RANK_MS:
        kv = cfg.n_kv_heads // m if cfg.n_kv_heads % m == 0 else \
            cfg.n_kv_heads
        with torch.no_grad(), attention_calls() as acalls, \
                expert_calls() as ecalls:
            att = [transformer.attention_body(blocks(m, r), cfg, hn, pos, r)[0]
                   for r in range(m)]
            ffns = [ffn(m, r) for r in range(m)]
            decs = []
            for r in range(m):
                lo = r * kv if kv < cfg.n_kv_heads else 0
                decs.append(transformer.attention_decode_body(
                    blocks(m, r), cfg, xd, dpos, dpos.long(),
                    kc[:, :, lo:lo + kv].clone(), vc[:, :, lo:lo + kv].clone(),
                    kv_pos, lengths, r))
        row = {"phase": "lm_mesh", "check": "rank_bodies", "model": arch,
               "dtype": "bfloat16", "m": m, "prompt": [b, s],
               "cache_slots": MESH_RANK_CACHE,
               "heads_per_rank": cfg.n_heads // m, "kv_heads_per_rank": kv,
               "sums": [rank_sum_check(whole, att, "attention"),
                        rank_sum_check(ffn_whole, ffns,
                                       "moe" if blk.use_moe else "mlp"),
                        rank_sum_check(dec_whole, decs, "decode")],
               "attention_kernels": check_attention_calls(
                   acalls, f"{arch} m={m}"),
               "expert_kernels": check_expert_calls(ecalls)}
        assert len(acalls) == 2 * m, len(acalls)
        assert len(ecalls) == (2 * m if blk.use_moe else 0), len(ecalls)
        emit(row)
        rows.append(row)
        del acalls, ecalls, att, ffns, decs
    del model, blk, whole, k, v, kc, vc
    free_cuda()


MESH_RECURRENT = (("rwkv6-7b", 10), ("recurrentgemma-2b", 11))
MESH_RANK_RING = 2048         # recurrentgemma's window: the ring's slots
MESH_RANK_LONG = 4096         # granite's decode cache: slots a row


def mesh_recurrent(dev, mesh, arch, seed) -> dict:
    """(f) ``arch`` at published widths and depth in bf16: a 4 x 128
    prefill (eager, then a replay) and 8 greedy decodes through the steps
    under a 1 x 1 policy over a ``ShardedLM`` of serving blocks, graphed,
    against the same steps without one: logits and caches bit-equal.
    Returns the policy run's launches."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding
    from repro_torch.distributed.api import MeshPolicy
    from repro_torch.launch import steps
    from repro_torch.models import io as model_io, model as model_lib

    cfg = get_config(arch)
    model = model_lib.init_params(cfg, seed=seed, device=dev)
    policy = MeshPolicy(mesh, sharding.activation_rules(mesh, train=False))
    own = list(model.parameters())
    sp = model_io.ShardedLM(model, cfg, mesh, train=False)
    assert not sp.gathers and all(
        a is b for a, b in zip(own, sp.model.parameters()))
    rng = np.random.default_rng(seed)
    b, n = REC_BATCH, REC_PROMPT
    toks = torch.as_tensor(rng.integers(2, cfg.vocab, (b, n)),
                           dtype=torch.int32, device=dev)

    def run(params, pol):
        prefill = steps.make_prefill_step(cfg, n + MESH_DECODES, pol)
        decode = steps.make_decode_step(cfg, pol)
        first, _ = prefill(params, toks)            # eager, then captured
        logits, cache = prefill(params, toks)       # a replay
        out = {"prefill_first": first, "prefill": logits}
        out.update({f"cache{i}": x.clone()
                    for i, x in enumerate(cache_leaves(cache))})
        tok = logits[:, :cfg.vocab].argmax(-1).to(torch.int32)
        for i in range(MESH_DECODES):
            logits, cache = decode(params, cache, tok)
            out[f"decode{i}"] = logits
            tok = logits[:, :cfg.vocab].argmax(-1).to(torch.int32)
        out.update({f"final cache{i}": x.clone()
                    for i, x in enumerate(cache_leaves(cache))})
        return out

    plain = run(model, None)
    before = counters()
    got = run(sp, policy)
    launches = {k: counters()[k] - before[k] for k in before}
    want = dict.fromkeys(launches, 0)
    for k, v in scan_launches_per_pass(cfg).items():
        want[k] += 2 * v
    want["decode_attn"] += MESH_DECODES * b3_launches_per_decode(cfg)
    assert launches == want, (launches, want)
    differs = [k for k in plain if not torch.equal(plain[k], got[k])]
    assert not differs, differs
    assert all(bool(torch.isfinite(got[f"decode{i}"].float()).all())
               for i in range(MESH_DECODES))
    emit({"phase": "lm_mesh", "check": "recurrent_under_policy",
          "model": arch, "layers": cfg.n_layers, "prompts": [b, n],
          "decodes": MESH_DECODES, "bit_equal_to_no_policy": True,
          "launches": launches})
    del model, sp, plain, got
    free_cuda()
    return launches


@contextlib.contextmanager
def scan_calls():
    """Record every B5 and B6 call of the recurrent layers (inputs,
    keywords, output), in call order."""
    from repro_torch.models import rglru, rwkv6

    real = (rwkv6.wkv, rglru.lru)
    calls = []

    def wkv(*args, **kw):
        out = real[0](*args, **kw)
        calls.append(("rwkv6_scan", args, kw, out))
        return out

    def lru(*args):
        out = real[1](*args)
        calls.append(("rglru_scan", args, {}, out))
        return out

    rwkv6.wkv, rglru.lru = wkv, lru
    try:
        yield calls
    finally:
        rwkv6.wkv, rglru.lru = real


def check_scan_calls(calls, label) -> list:
    """Each recorded B5 call against the token recurrence
    (``rwkv6_scan_ref``: y within ``WKV_TOL`` of its dtype, the state
    within float32's) and each B6 call against its plain version
    (``LRU_TOL``), as phases 10 and 11 hold them; a row per shape with
    its time on the card."""
    from repro_torch.kernels.rglru_scan import ops as lru_ops
    from repro_torch.kernels.rwkv6_scan import ops as wkv_ops
    from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref

    rows = {}
    for name, args, kw, out in calls:
        if name == "rwkv6_scan":
            (y, state), (y_ref, s_ref) = out, rwkv6_scan_ref(*args[:5])
            over = max(over_limit(y, y_ref, WKV_TOL[y.dtype]),
                       over_limit(state, s_ref, WKV_TOL[torch.float32]))
            err = float((y.float() - y_ref.float()).abs().max())
            fn = lambda: wkv_ops.wkv(*args, **kw)
            shape = list(args[0].shape)             # (B, H, T, K)
        else:
            ref = plain_lru(*args)
            over = over_limit(out, ref, LRU_TOL[out.dtype])
            err = float((out.float() - ref.float()).abs().max())
            fn = lambda: lru_ops.lru(*args)
            shape = list(args[0].shape)             # (B, T, channels)
        if not over <= 1.0:
            raise AssertionError(f"{name} {label} {shape}: error {err}, "
                                 f"{over} times its tolerance")
        key = (name, tuple(shape))
        if key not in rows:
            rows[key] = {"kernel": name, "shape": shape, "calls": 0,
                         "max_abs_err": 0.0, "over_tol": 0.0,
                         "ms": device_ms(fn, 20)}
        row = rows[key]
        row["calls"] += 1
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["over_tol"] = max(row["over_tol"], over)
    return list(rows.values())


def state_check(whole, parts, dim, what) -> dict:
    """Every rank's state side by side along ``dim`` against the whole
    layer's (``MESH_RANK_REL_TOL`` of its largest value)."""
    got = torch.cat([p.float() for p in parts], dim)
    err = float((got - whole.float()).abs().max())
    scale = float(whole.float().abs().max())
    row = {"part": what, "max_abs_diff": err, "max_abs_whole": scale,
           "tol": MESH_RANK_REL_TOL * scale}
    if not err <= row["tol"]:
        raise AssertionError(f"rank states vs whole layer: {row}")
    return row


def rank_inputs(cfg, dev, seed, t):
    """A normalised bf16 input (B, t, d) of the rank bodies."""
    from repro_torch.models import layers

    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((MESH_RANK_PROMPT[0], t, cfg.d_model), generator=gen,
                    device=dev)
    return layers.rms_norm(x, torch.zeros(cfg.d_model, device=dev),
                           cfg.norm_eps).to(torch.bfloat16)


def mesh_rank_rwkv6(dev) -> list:
    """(g) One rwkv6-7b layer at published widths in bf16: every ``model``
    rank's ``time_mix_body`` (its H/m heads through B5) and
    ``channel_mix_body`` for m = 2 and 4, over a 2 x 256 prefill from the
    zero state and one decode from the prefill's state, summed (the
    channel mix's partial outputs summed, then each rank's gate on its
    channels) against the whole layer; the states side by side."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding
    from repro_torch.models import rwkv6

    cfg = dataclasses.replace(get_config("rwkv6-7b"), n_layers=1)
    layer = rwkv6.init_params(cfg, seed=12, device=dev).layers[0]
    b, s = MESH_RANK_PROMPT
    h, dh, d = cfg.n_heads, cfg.head_size, cfg.d_model
    x, xd = rank_inputs(cfg, dev, 13, s), rank_inputs(cfg, dev, 14, 1)
    tm_prev, cm_prev = x[:, 0] * 0.5, x[:, 1] * 0.5
    zero = torch.zeros((b, h, dh, dh), dtype=torch.float32, device=dev)
    tm = lambda m, r: sharding.rank_blocks(layer, "layers", rwkv6.TIME_MIX,
                                           m, r)
    cm = lambda m, r: sharding.rank_blocks(layer, "layers",
                                           rwkv6.CHANNEL_MIX, m, r)

    def channel(m, xx):
        parts = [rwkv6.channel_mix_body(cm(m, r), cfg, xx, cm_prev)
                 for r in range(m)]
        total = sum(p[0].float() for p in parts)
        dl = d // m
        return torch.cat([p[1].float() * total[..., r * dl:(r + 1) * dl]
                          for r, p in enumerate(parts)], -1)

    rows = []
    with torch.no_grad(), scan_calls() as calls:
        whole, _, s_whole = rwkv6.time_mix_body(tm(1, 0), cfg, x, tm_prev,
                                                zero.clone(), single=False)
        dec_whole, _, sd_whole = rwkv6.time_mix_body(
            tm(1, 0), cfg, xd, tm_prev, s_whole.clone(), single=True)
        cm_whole, cmd_whole = channel(1, x), channel(1, xd)
        whole_calls = list(calls)
        for m in MESH_RANK_MS:
            hl = h // m
            del calls[:]
            outs, states, decs, dstates = [], [], [], []
            for r in range(m):
                o, _, st = rwkv6.time_mix_body(
                    tm(m, r), cfg, x, tm_prev, zero[:, r * hl:(r + 1) * hl]
                    .clone(), r, single=False)
                od, _, sd = rwkv6.time_mix_body(
                    tm(m, r), cfg, xd, tm_prev,
                    s_whole[:, r * hl:(r + 1) * hl].clone(), r, single=True)
                outs.append(o)
                states.append(st)
                decs.append(od)
                dstates.append(sd)
            row = {"phase": "lm_mesh", "check": "rank_bodies",
                   "model": "rwkv6-7b", "dtype": "bfloat16", "m": m,
                   "prompt": [b, s], "heads_per_rank": hl,
                   "sums": [rank_sum_check(whole, outs, "time_mix"),
                            state_check(s_whole, states, 1, "S"),
                            rank_sum_check(dec_whole, decs,
                                           "time_mix decode"),
                            state_check(sd_whole, dstates, 1, "S decode"),
                            rank_sum_check(cm_whole, [channel(m, x)],
                                           "channel_mix"),
                            rank_sum_check(cmd_whole, [channel(m, xd)],
                                           "channel_mix decode")],
                   "scan_kernels": check_scan_calls(calls, f"rwkv6 m={m}"),
                   "whole_width_kernels": check_scan_calls(
                       whole_calls, "rwkv6 whole")}
            assert len(calls) == m, len(calls)
            emit(row)
            rows.append(row)
    del layer, calls, whole_calls
    free_cuda()
    return rows


def merge_check(parts, whole, what) -> dict:
    """Every rank's B3 (output, lse) over its slots merged by hand
    (``merge_partials``) against B3 over the whole cache
    (``MESH_RANK_REL_TOL`` of the largest output), no NaN."""
    from repro_torch.kernels.decode_attn.ref import merge_partials

    merged = merge_partials([p[0] for p in parts], [p[1] for p in parts])
    row = rank_sum_check(whole, [merged], what)
    row["ranks_without_a_valid_slot"] = [
        int((p[1] == float("-inf")).all(-1).sum()) for p in parts]
    return row, merged


def mesh_rank_rglru(dev) -> list:
    """(g) One recurrentgemma-2b superblock at published widths in bf16:
    every ``model`` rank's body for m = 2 and 4 over a 2 x 256 prefill
    (rec1 and rec2: ``rec_in_body``, the conv outputs side by side,
    ``rec_out_body`` through B6 on its rnn/m channels, the GeGLU MLP; the
    attention on its query heads: 5 over 2 ranks, all 10 over 4) and one
    decode (the recurrent step from the prefill's states; the attention
    over a wrapped ring of 2,048 split by sequence: each rank's query
    heads gathered by hand, the token written on the owning rank, B3
    with its lse on its slots, the partial softmaxes merged by hand),
    summed or, where the heads are whole, alike, against the whole."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding
    from repro_torch.kernels.decode_attn.ref import merge_partials
    from repro_torch.models import rglru, transformer

    cfg = dataclasses.replace(get_config("recurrentgemma-2b"), n_layers=3)
    model = rglru.init_params(cfg, seed=15, device=dev)
    b, s = MESH_RANK_PROMPT
    x, xd = rank_inputs(cfg, dev, 16, s), rank_inputs(cfg, dev, 17, 1)
    rw, cw, w_all = cfg.rnn_width, cfg.conv_width, MESH_RANK_RING
    positions = torch.arange(s, dtype=torch.int32,
                             device=dev)[None].expand(b, s)
    gen = torch.Generator(device=dev).manual_seed(18)
    ring = torch.randn((2, b, w_all, 1, cfg.d_head), generator=gen,
                       device=dev).to(torch.bfloat16)
    kv_pos = (w_all + torch.arange(w_all, dtype=torch.int32, device=dev)
              )[None].expand(b, w_all).contiguous()     # a wrapped ring
    pos = torch.tensor(2 * w_all, dtype=torch.int32, device=dev)
    slot = int(pos) % w_all
    rec = lambda i, m, r: sharding.rank_blocks(
        model.layers[i], f"super/rec{i + 1}", rglru.REC, m, r)
    mlp = lambda i, m, r: sharding.rank_blocks(
        model.layers[i].mlp, "super/rec1/mlp", rglru.MLP_NAMES, m, r)
    attn = lambda m, r: sharding.rank_blocks(model.layers[2], "super/attn",
                                             rglru.ATTN, m, r)

    def recurrent(i, m, xx, conv, h0, single):
        n = rw // m
        ins = [rglru.rec_in_body(rec(i, m, r), cfg, xx,
                                 conv[..., r * n:(r + 1) * n])
               for r in range(m)]
        bx_all = torch.cat([t[0] for t in ins], -1)
        # a rank's state is its own tensor (the cache's ``h``): contiguous
        outs = [rglru.rec_out_body(rec(i, m, r), cfg, bx_all, ins[r][1],
                                   h0[:, r * n:(r + 1) * n].contiguous(), r,
                                   single=single) for r in range(m)]
        return ([o[0] for o in outs], torch.cat([o[1] for o in outs], -1),
                torch.cat([t[2] for t in ins], -1))

    def decode_attention(m):
        """Every rank's decode over its slots of the ring, merged."""
        hq = cfg.n_heads // m if cfg.n_heads % m == 0 else cfg.n_heads
        qs = [rglru.decode_query(attn(m, r), cfg, xd, pos) for r in range(m)]
        q_all = (torch.cat([t[0] for t in qs], 1) if hq < cfg.n_heads
                 else qs[0][0])
        n = w_all // m
        parts = []
        for r in range(m):
            st = {"k": ring[0][:, r * n:(r + 1) * n].clone(),
                  "v": ring[1][:, r * n:(r + 1) * n].clone(),
                  "kv_pos": kv_after}
            transformer.write_owned(st["k"], st["v"], qs[r][1], qs[r][2],
                                    pos % w_all, r * n)
            parts.append(rglru.ring_attend(q_all, st, pos, r * n))
        merged = merge_partials([p[0] for p in parts],
                                [p[1] for p in parts])
        outs = [rglru.attention_out(attn(m, r), transformer.own_heads(
            merged, hq, r)) for r in range(m)]
        return q_all, parts, outs

    rows = []
    zero_h = torch.zeros((b, rw), dtype=torch.float32, device=dev)
    zero_c = torch.zeros((b, cw - 1, rw), dtype=torch.bfloat16, device=dev)
    with torch.no_grad(), scan_calls() as scans, \
            attention_calls() as acalls:
        whole = {}
        for i in (0, 1):
            outs, h, c = recurrent(i, 1, x, zero_c, zero_h, False)
            whole[f"rec{i + 1}"], whole[f"h{i}"], whole[f"c{i}"] = \
                outs[0], h, c
            outs, h, c = recurrent(i, 1, xd, whole[f"c{i}"], whole[f"h{i}"],
                                   True)
            whole[f"rec{i + 1} decode"], whole[f"hd{i}"] = outs[0], h
            whole[f"mlp{i}"] = rglru.mlp_body(mlp(i, 1, 0), x)
        whole["attn"], k, v = rglru.attention_full_body(attn(1, 0), cfg, x,
                                                        positions)
        q, kn, vn = rglru.decode_query(attn(1, 0), cfg, xd, pos)
        kv_after = kv_pos.clone()
        kv_after[:, slot] = pos
        ring_after = ring.clone()
        ring_after[0][:, slot], ring_after[1][:, slot] = kn, vn
        whole_b3 = lambda qq: transformer.decode_attn(
            qq, ring_after[0].transpose(1, 2), ring_after[1].transpose(1, 2),
            kv_pos=kv_after, pos=pos, return_lse=True)[0]
        whole["attn decode"] = rglru.attention_out(attn(1, 0), whole_b3(q))
        whole_scans, whole_calls = list(scans), list(acalls)
        for m in MESH_RANK_MS:
            del scans[:], acalls[:]
            sums = []
            for i in (0, 1):
                outs, h, c = recurrent(i, m, x, zero_c, zero_h, False)
                sums += [rank_sum_check(whole[f"rec{i + 1}"], outs,
                                        f"rec{i + 1}"),
                         state_check(whole[f"h{i}"], [h], -1, f"h{i}")]
                assert torch.equal(c, whole[f"c{i}"])
                outs, h, _ = recurrent(i, m, xd, whole[f"c{i}"],
                                       whole[f"h{i}"], True)
                sums += [rank_sum_check(whole[f"rec{i + 1} decode"], outs,
                                        f"rec{i + 1} decode"),
                         state_check(whole[f"hd{i}"], [h], -1,
                                     f"h{i} decode"),
                         rank_sum_check(whole[f"mlp{i}"], [
                             rglru.mlp_body(mlp(i, m, r), x)
                             for r in range(m)], f"mlp{i}")]
            split = cfg.n_heads % m == 0
            outs = [rglru.attention_full_body(attn(m, r), cfg, x,
                                              positions)[0]
                    for r in range(m)]
            if not split:                  # every head on every rank
                assert all(torch.equal(o, outs[0]) for o in outs), m
                outs = outs[:1]
            sums.append(rank_sum_check(whole["attn"], outs, "attention"))
            q_all, parts, outs = decode_attention(m)
            # B3 over the whole ring for the same (gathered) query heads
            merge_row, _ = merge_check(parts, whole_b3(q_all), "ring merge")
            if not split:
                assert all(torch.equal(o, outs[0]) for o in outs), m
                outs = outs[:1]
            sums += [merge_row, rank_sum_check(whole["attn decode"], outs,
                                               "attention decode")]
            row = {"phase": "lm_mesh", "check": "rank_bodies",
                   "model": "recurrentgemma-2b", "dtype": "bfloat16",
                   "m": m, "prompt": [b, s], "ring": w_all,
                   "channels_per_rank": rw // m,
                   "heads_per_rank": cfg.n_heads // m if split
                   else cfg.n_heads, "sums": sums,
                   "scan_kernels": check_scan_calls(scans, f"rglru m={m}"),
                   "attention_kernels": check_attention_calls(
                       acalls, f"rglru m={m}"),
                   "whole_width_kernels": check_scan_calls(
                       whole_scans, "rglru whole") + check_attention_calls(
                       whole_calls, "rglru whole")}
            assert len(scans) == 2 * m and len(acalls) == m + 1, (
                len(scans), len(acalls))
            emit(row)
            rows.append(row)
    del model, ring, ring_after, scans, acalls, whole_scans, whole_calls
    free_cuda()
    return rows


def mesh_rank_granite(dev) -> list:
    """(g) One granite-34b layer's decode at published widths in bf16 over
    a cache of 2 x 4,096 slots (its one KV head: the cache split by
    sequence), lengths 4,096 and 2,500: every ``model`` rank's query
    heads (24 or 12) gathered by hand, the token written on the rank that
    owns each row's slot, B3 with its lse over the rank's slots (its
    valid ones ``clamp(lengths - lo, 0, S/m)``), the partial softmaxes
    merged by hand against B3 over the whole cache, each rank's heads
    through its ``wo`` rows, summed against the whole layer's
    ``attention_decode_body``."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding
    from repro_torch.models import transformer

    cfg = dataclasses.replace(get_config("granite-34b"), n_layers=1)
    attn = transformer.init_params(cfg, seed=19, device=dev).layers[0].attn
    b, sc = MESH_RANK_PROMPT[0], MESH_RANK_LONG
    xd = rank_inputs(cfg, dev, 20, 1)
    gen = torch.Generator(device=dev).manual_seed(21)
    cache = torch.randn((2, b, sc, cfg.n_kv_heads, cfg.d_head),
                        generator=gen, device=dev).to(torch.bfloat16)
    lengths = torch.tensor([sc, 2500], dtype=torch.int32, device=dev)
    pos = lengths - 1
    slot = pos.long()
    kv_pos = torch.where(torch.arange(sc, device=dev)[None] <= pos[:, None],
                         torch.arange(sc, device=dev)[None],
                         -1).to(torch.int32)
    blocks = lambda m, r: sharding.rank_blocks(attn, "layers/attn",
                                               ATTN_NAMES, m, r)
    rows = []
    with torch.no_grad(), attention_calls() as acalls:
        kw, vw = cache[0].clone(), cache[1].clone()
        whole = transformer.attention_decode_body(
            blocks(1, 0), cfg, xd, pos, slot, kw, vw, kv_pos, lengths)
        whole_calls = list(acalls)
        for m in MESH_RANK_MS:
            del acalls[:]
            n = sc // m
            qs = [transformer.decode_query(blocks(m, r), cfg, xd, pos)
                  for r in range(m)]
            q_all = torch.cat([t[0] for t in qs], 1)
            parts = []
            for r in range(m):
                rk = cache[0][:, r * n:(r + 1) * n].clone()
                rv = cache[1][:, r * n:(r + 1) * n].clone()
                transformer.write_owned(rk, rv, qs[r][1], qs[r][2], slot,
                                        r * n)
                assert torch.equal(rk, kw[:, r * n:(r + 1) * n])
                parts.append(transformer.seq_attend(q_all, rk, rv, r * n,
                                                    lengths=lengths))
            # B3 over the whole cache for the same (gathered) query heads
            o_whole, _ = transformer.decode_attn(
                q_all, kw.transpose(1, 2), vw.transpose(1, 2), lengths,
                return_lse=True)
            merge_row, merged = merge_check(parts, o_whole, "cache merge")
            hq = cfg.n_heads // m
            outs = [torch.einsum("bhe,hed->bd", transformer.own_heads(
                merged, hq, r), blocks(m, r).wo) for r in range(m)]
            row = {"phase": "lm_mesh", "check": "rank_bodies",
                   "model": "granite-34b", "dtype": "bfloat16", "m": m,
                   "cache_slots": [b, sc], "lengths": lengths.tolist(),
                   "slots_per_rank": n, "heads_per_rank": hq,
                   "sums": [merge_row,
                            rank_sum_check(whole, outs, "decode")],
                   "attention_kernels": check_attention_calls(
                       acalls, f"granite m={m}"),
                   "whole_width_kernels": check_attention_calls(
                       whole_calls, "granite whole")}
            assert len(acalls) == m + 1, len(acalls)
            emit(row)
            rows.append(row)
    del attn, cache, kw, vw, acalls, whole_calls
    free_cuda()
    return rows


def decode_bytes() -> None:
    """The bytes per reader of one decode step of 2 rows a rank receives
    at m = 2 and 4 (``sharding.serve_step_bytes``, from the specs):
    rwkv6-7b, recurrentgemma-2b over its ring of 2,048, granite-34b over
    a cache of 4,096."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding

    for arch, cache_len in (("rwkv6-7b", 0),
                            ("recurrentgemma-2b", MESH_RANK_RING),
                            ("granite-34b", MESH_RANK_LONG)):
        cfg = get_config(arch)
        emit({"phase": "lm_mesh", "check": "decode_bytes", "model": arch,
              "rows": MESH_RANK_PROMPT[0], "cache_slots": cache_len,
              "dtype": cfg.compute_dtype,
              **{f"m{m}": sharding.serve_step_bytes(
                  cfg, m, MESH_RANK_PROMPT[0], 1, cache_len, True)
                 for m in MESH_RANK_MS}})


# (h) the recurrent families trained on the 1 x 1 mesh against no mesh:
# (arch, layers, seed); 2 x 512 tokens, 3 AdamW steps (warmup 1: the
# second and third move every weight), the first eager and captured.
# rwkv6 at one layer: its checkpoint's save and restore (~7.5 GB of state,
# three quarters of it the embedding and head) take most of the check
MESH_REC_TRAIN = (("rwkv6-7b", 1, 22), ("recurrentgemma-2b", 5, 23))
MESH_REC_BATCH = (2, 512)
MESH_REC_STEPS = 3
# (i) every model rank's training bodies in bf16, their gradients merged
# (split weights concatenated, whole ones and the input's summed) against
# the whole layer's, each within this share of its largest magnitude: the
# row-parallel partial outputs are rounded to bf16 before their sum, where
# the whole layer rounds one product
MESH_GRAD_REL_TOL = 2.0 ** -5


def mesh_recurrent_training(dev, mesh, arch, depth, seed, save) -> None:
    """(h) ``arch`` at published widths cut to ``depth`` layers in bf16,
    AdamW, ``MESH_REC_BATCH`` tokens: ``Trainer(mesh=)`` on the 1 x 1 mesh
    against the meshless ``Trainer`` from one seed, each step a replay
    after the first; the state (``bit_prints``) and every step's metrics
    bit-equal; a traced replay of the mesh step with no B5 or B6 record,
    its graph launching neither; with ``save`` the mesh run's checkpoint
    restored by a meshless ``Trainer`` bit-equal."""
    import shutil
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.distributed import collectives
    from repro_torch.train import trainer as trainer_lib

    cfg = dataclasses.replace(get_config(arch), n_layers=depth)
    b, n = MESH_REC_BATCH
    ckpt = tempfile.mkdtemp(prefix="mesh_rec_ckpt") if save else ""
    line = {"phase": "lm_mesh", "check": "recurrent_training", "model": arch,
            "layers": depth, "published_layers": get_config(arch).n_layers,
            "dtype": "bfloat16", "optimizer": cfg.optimizer,
            "remat": cfg.remat, "batch": [b, n], "steps": MESH_REC_STEPS}
    runs = {}
    try:
        for name, m in (("meshless", None), ("mesh", mesh)):
            free_cuda()
            torch.cuda.reset_peak_memory_stats()
            collectives.BYTES.clear()
            tc = trainer_lib.TrainerConfig(
                total_steps=MESH_REC_STEPS, warmup_steps=1,
                log_every=10 ** 9, ckpt_every=10 ** 9,
                ckpt_dir=ckpt if m is not None else "")
            tr = trainer_lib.Trainer(cfg, tc, mesh=m, device=dev,
                                     log_fn=lambda *a, **k: None)
            data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=n,
                                          global_batch=b), mesh=m, device=dev)
            metrics, step = [], tr._step_fn

            def recorded(st, batch):
                st, out = step(st, batch)
                metrics.append({k: float(v) for k, v in out.items()})
                return st, out
            tr._step_fn = recorded
            t = synced()
            state = tr.run(tr.init_state(seed=seed), data)
            run = {"prints": bit_prints(state), "metrics": metrics,
                   "run_s": synced() - t, "step_s": tr.step_s,
                   "max_memory_allocated": torch.cuda.max_memory_allocated(),
                   "bytes": dict(collectives.BYTES), "save_s": tr.save_s}
            assert len(step.graphs) == 1, len(step.graphs)
            if m is not None:
                launched = counters()
                _, kernels, takes = profiled(
                    lambda: step(state, data.batch(MESH_REC_STEPS)),
                    {"b5": 0, "b6": 0}, f"{arch} mesh training step")
                (graph,) = [g for _, _, g in step.graphs.values()]
                assert all(graph.launches[COUNTER_NAMES.index(k)] == 0
                           for k in ("rwkv6_scan", "rglru_scan"))
                assert counters() == launched
                run["traced_step"] = {"kernels": len(kernels),
                                      "b5_records": 0, "b6_records": 0,
                                      "trace_takes": takes}
            runs[name] = run
            del state, tr, step
        a, m_run = runs["meshless"], runs["mesh"]
        assert a["prints"] == m_run["prints"], "mesh state differs"
        assert a["metrics"] == m_run["metrics"], (a["metrics"],
                                                   m_run["metrics"])
        assert all(np.isfinite(x["loss"]) for x in a["metrics"])
        line.update(bit_equal=True, losses=[x["loss"] for x in a["metrics"]],
                    traced_step=m_run["traced_step"],
                    **{name: {k: r[k] for k in ("run_s", "step_s",
                                                "max_memory_allocated",
                                                "bytes")}
                       for name, r in runs.items()})
        if save:
            free_cuda()
            tc = trainer_lib.TrainerConfig(total_steps=MESH_REC_STEPS,
                                           ckpt_dir=ckpt)
            tr = trainer_lib.Trainer(cfg, tc, device=dev,
                                     log_fn=lambda *a, **k: None)
            state = tr.init_or_restore(seed=seed + 1)
            assert bit_prints(state) == m_run["prints"], "restore differs"
            line["mesh_checkpoint_restored_without_mesh"] = {
                "bit_equal": True, "save_s": m_run["save_s"],
                "restore_s": tr.restore_s}
            del state, tr
    finally:
        if ckpt:
            shutil.rmtree(ckpt, ignore_errors=True)
    emit(line)
    free_cuda()


def mesh_rank_grads(dev) -> None:
    """(i) The training bodies' backward on every ``model`` rank for m =
    2 and 4, composed in this process (``tests/torch_rank_grads.py``):
    one rwkv6-7b layer (time mix through ``wkv_chunked`` on H/m heads,
    channel mix) and one recurrentgemma-2b superblock (rec1, rec2 through
    ``rg_lru_scan_train`` on rnn/m channels, the attention on 5 heads of 2
    ranks or all 10 on each of 4, the GeGLU MLPs) at published widths in
    bf16 over ``MESH_RANK_PROMPT`` tokens; the input's gradient and every
    weight's, merged over the ranks, against the whole layer's within
    ``MESH_GRAD_REL_TOL`` of each one's largest magnitude."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_rank_grads as trg

    from repro_torch.configs import get_config
    from repro_torch.models import rglru, rwkv6

    gen = torch.Generator(device=dev).manual_seed(24)
    for arch in ("rwkv6-7b", "recurrentgemma-2b"):
        cfg = dataclasses.replace(get_config(arch), n_layers=(
            1 if arch == "rwkv6-7b" else len(rglru.PATTERN)))
        x = rank_inputs(cfg, dev, 25, MESH_RANK_PROMPT[1])
        shape = x.shape if arch != "rwkv6-7b" else (2,) + tuple(x.shape)
        c = torch.randn(shape, generator=gen, device=dev)
        if arch == "rwkv6-7b":
            layer = rwkv6.init_params(cfg, seed=26, device=dev).layers[0]
            run = lambda m: trg.rwkv6_layer(layer, cfg, x, m, c)
        else:
            model = rglru.init_params(cfg, seed=27, device=dev)
            run = lambda m: trg.rglru_superblock(model, cfg, x, m, c)
        t = synced()
        gx_want, want = run(1)
        whole_s = synced() - t
        for m in MESH_RANK_MS:
            t = synced()
            gx, got = run(m)
            ranks_s = synced() - t
            x_err = float((gx.float() - gx_want.float()).abs().max()
                          / gx_want.float().abs().max())
            w_err = trg.worst(got, want)
            row = {"phase": "lm_mesh", "check": "rank_grads", "model": arch,
                   "dtype": "bfloat16", "m": m,
                   "prompt": list(MESH_RANK_PROMPT), "weights": len(want),
                   "input_grad_rel_err": x_err,
                   "worst_weight_grad_rel_err": w_err,
                   "tol": MESH_GRAD_REL_TOL, "whole_s": whole_s,
                   "ranks_s": ranks_s}
            if not (x_err <= MESH_GRAD_REL_TOL and w_err <= MESH_GRAD_REL_TOL
                    and min(float(g.abs().max()) for g in want.values())
                    > 0):
                raise AssertionError(f"rank gradients vs whole layer: {row}")
            emit(row)
            del gx, got
        del want, gx_want, run
        free_cuda()


def lm_mesh_phase(dev) -> dict:
    """The LM model mesh in a world of one NCCL rank on
    ``make_host_mesh(1, 1)`` (module docstring).  Returns the kernel
    launches of its main path, the graphed steps under the policy."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import model as model_lib

    dev = mesh_lib.init_world(dev)
    assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
    try:
        mesh = mesh_lib.make_host_mesh(1, 1)
        mesh_training(dev, mesh)
        for i, (arch, depth, seed) in enumerate(MESH_REC_TRAIN):
            mesh_recurrent_training(dev, mesh, arch, depth, seed,
                                    save=i == 0)
        cfg = dataclasses.replace(get_config("dbrx-132b"), n_layers=MOE_DEPTH)
        model = model_lib.init_params(cfg, seed=2, device=dev)
        mesh_moe(dev, mesh, model, cfg)
        launches = mesh_steps(dev, mesh, model, cfg)
        del model
        free_cuda()
        more = mesh_whisper(dev, mesh)
        launches = {k: launches[k] + more[k] for k in launches}
        for arch, seed in MESH_RECURRENT:
            more = mesh_recurrent(dev, mesh, arch, seed)
            launches = {k: launches[k] + more[k] for k in launches}
        # the rank bodies: checks, outside the counted runs
        for arch in MESH_RANK_ARCHS:
            mesh_rank_layer(dev, arch)
        mesh_rank_rwkv6(dev)
        mesh_rank_rglru(dev)
        mesh_rank_granite(dev)
        mesh_rank_grads(dev)
        decode_bytes()
        return launches
    finally:
        mesh_lib.close_world()


# ---------------------------------------------------------------------------
# Phase 5: the flash-attention kernel against its plain version
# ---------------------------------------------------------------------------

BF16_OPS_PER_S = 989e12          # H100 SXM bf16 tensor cores, dense
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# against ``attention_tiled_ref``, the bf16 kernel's own tile algorithm in
# plain PyTorch (P rounded to bf16 as the kernel rounds it): the two differ
# by float32 summation order and ex2.approx, which can move the output by
# one bf16 rounding step, 2^-7 of its magnitude at most (outputs under 1
# are held to 2^-7 absolute); float32 as against ``attention_ref``
TILED_REL_TOL = 2.0 ** -7
# (label, H, KV, dh, S, window): full-width heads of each expert
FLASH_CASES = [
    ("qwen1.5-0.5b", 16, 16, 64, 16, 0), ("qwen1.5-0.5b", 16, 16, 64, 128, 0),
    ("h2o-danube-3-4b", 32, 8, 120, 16, 4096),
    ("h2o-danube-3-4b", 32, 8, 120, 128, 4096),
    ("starcoder2-15b", 48, 4, 128, 16, 0), ("starcoder2-15b", 48, 4, 128, 128, 0),
    ("h2o-danube-3-4b", 32, 8, 120, 1024, 256),
    ("starcoder2-15b", 48, 4, 128, 4096, 0)]
# (label, B, H, KV, dh, Sq, Skv): whisper-medium's unmasked calls, G = 1:
# the encoder's self-attention over 1,500 frames, and cross-attention from
# the 448 tokens of its text context over them
WHISPER_FLASH_CASES = [("whisper-medium", 4, 16, 16, 64, 1500, 1500),
                       ("whisper-medium", 4, 16, 16, 64, 448, 1500)]
LINE_CASE = ("starcoder2-15b", 128, "bfloat16")   # the kernels line's row


def visible_pairs(s: int, window: int) -> int:
    """Query-key pairs a causal (and windowed) attention over S positions
    computes: sum over queries of the keys it sees."""
    seen = np.arange(1, s + 1)
    if window > 0:
        seen = np.minimum(seen, window)
    return int(seen.sum())


def sdpa(q, k, v, window, causal=True):
    """PyTorch's fused attention on the same inputs: the yardstick, never
    called by the port."""
    import torch.nn.functional as F
    if window <= 0:
        return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                              enable_gqa=True)
    s = q.shape[2]
    i = torch.arange(s, device=q.device)
    mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                          enable_gqa=True)


def over_tiled(got, tiled, dtype) -> float:
    """The largest error against the tile algorithm as a share of its
    tolerance (above 1 fails)."""
    diff = (got.float() - tiled.float()).abs()
    if dtype == torch.float32:
        return float(diff.max()) / FLASH_TOL[dtype]
    scale = tiled.float().abs().clamp(min=1.0)
    return float((diff / (TILED_REL_TOL * scale)).max())


def flash_phase(dev):
    from repro_torch.kernels.flash_attn import ops
    from repro_torch.kernels.flash_attn.ref import (attention_ref,
                                                    attention_tiled_ref)

    rows = []
    # (label, B, H, KV, dh, Sq, Skv, window, causal)
    cases = ([(label, 1, h, kv, dh, s, s, window, True)
              for label, h, kv, dh, s, window in FLASH_CASES]
             + [(label, b, h, kv, dh, sq, skv, 0, False)
                for label, b, h, kv, dh, sq, skv in WHISPER_FLASH_CASES])
    for label, b, h, kv, dh, s, skv, window, causal in cases:
        gen = torch.Generator(device=dev).manual_seed(s * h + dh + skv - s)
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (torch.randn((b, n, m, dh), generator=gen,
                                   device=dev).to(dtype)
                       for n, m in ((h, s), (kv, skv), (kv, skv)))
            kw = dict(causal=causal, window=window)
            got = ops.flash_attn(q, k, v, **kw)
            ref = attention_ref(q, k, v, **kw)
            tiled = attention_tiled_ref(q, k, v, **kw)
            torch.cuda.synchronize()
            err = float((got.float() - ref.float()).abs().max())
            tiled_err = float((got.float() - tiled.float()).abs().max())
            tiled_share = over_tiled(got, tiled, dtype)
            case = f"{label} Sq={s} Skv={skv} window={window} causal={causal}"
            if not err <= FLASH_TOL[dtype]:
                raise AssertionError(f"flash_attn {case} {dtype}: max abs "
                                     f"error {err}")
            if not tiled_share <= 1.0:
                raise AssertionError(f"flash_attn {case} {dtype}: "
                                     f"{tiled_share} of the tolerance "
                                     f"against the tile algorithm")
            lib = sdpa(q, k, v, window, causal)
            lib_err = float((lib.float() - ref.float()).abs().max())
            reps = 5 if max(s, skv) >= 1024 else 20
            nbytes = 2 * (q.numel() + k.numel()) * q.element_size()
            pairs = visible_pairs(s, window) if causal else s * skv
            flops = 4 * b * h * dh * pairs
            rate = BF16_OPS_PER_S if dtype == torch.bfloat16 else FP32_OPS_PER_S
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = flops / rate * 1e3
            fns = {"": lambda: ops.flash_attn(q, k, v, **kw),
                   "plain_": lambda: attention_ref(q, k, v, **kw),
                   "library_": lambda: sdpa(q, k, v, window, causal)}
            row = {"phase": "flash", "expert_heads": label, "B": b, "H": h,
                   "KV": kv, "dh": dh, "S": s, "Skv": skv, "causal": causal,
                   "window": window,
                   "dtype": str(dtype).split(".")[-1], "max_abs_err": err,
                   "tol": FLASH_TOL[dtype], "tiled_max_abs_err": tiled_err,
                   "tiled_share_of_tol": tiled_share,
                   "library_max_abs_err": lib_err}
            for key, fn in fns.items():     # time on the card; call time
                row[f"{key}ms"] = device_ms(fn, reps)
                row[f"{key}call_ms"] = cuda_ms(fn, reps)
            row.update({"bytes": nbytes, "flops": flops, "bytes_ms": bytes_ms,
                        "ops_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
                        "bound_by": ("bytes" if bytes_ms >= ops_ms
                                     else "operations"),
                        "tflops": flops / row["ms"] / 1e9,
                        "share_of_peak": flops / row["ms"] * 1e3 / rate})
            emit(row)
            rows.append(row)
            del q, k, v, got, ref, tiled, lib
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# Phase 6: the decode-attention kernel against its plain version
# ---------------------------------------------------------------------------

# (label, H, KV, dh, S, mask): the full-attention experts' heads at the
# serving cache (4 slots x 192 positions), starcoder2's over a long cache,
# danube's on its serving ring, recurrentgemma's on its window, and
# whisper-medium's (G = 1) over its cache of 1,500 slots
DECODE_CASES = [("qwen1.5-0.5b", 16, 16, 64, 192, "lengths"),
                ("starcoder2-15b", 48, 4, 128, 192, "lengths"),
                ("dbrx-132b", 48, 8, 128, 192, "lengths"),
                ("h2o-danube-3-4b", 32, 8, 120, 192, "kv_pos"),
                ("recurrentgemma-2b", 10, 1, 256, 2048, "kv_pos"),
                ("starcoder2-15b", 48, 4, 128, 4096, "lengths"),
                ("whisper-medium", 16, 16, 64, 1500, "lengths")]
DECODE_LINE_CASE = ("dbrx-132b", 192, "bfloat16")   # the kernels line's row


def decode_mask(b, s, h, mask, dev):
    """The mask's arguments: ragged lengths (one full), or rings that have
    wrapped (slot j holds the latest position p <= pos with p = j mod S),
    as ``decode_attn`` takes them, and the (B, S) boolean of the slots that
    count."""
    rng = np.random.default_rng(s + h)
    if mask == "lengths":
        lengths = torch.as_tensor(rng.integers(1, s + 1, b), dtype=torch.int32)
        lengths[-1] = s
        lengths = lengths.to(dev)
        valid = torch.arange(s, device=dev)[None, :] < lengths[:, None]
        return {"lengths": lengths}, valid
    pos = rng.integers(s, 3 * s, b)
    kv_pos = pos[:, None] - (pos[:, None] - np.arange(s)[None, :]) % s
    kw = {"kv_pos": torch.as_tensor(kv_pos, dtype=torch.int32, device=dev),
          "pos": torch.as_tensor(pos, dtype=torch.int32, device=dev)}
    valid = (kw["kv_pos"] >= 0) & (kw["kv_pos"] <= kw["pos"][:, None])
    return kw, valid


def sdpa_decode(q, k, v, valid):
    """PyTorch's fused attention with a boolean mask of the slots that
    count, on the same inputs: the yardstick, never called by the port."""
    import torch.nn.functional as F
    return F.scaled_dot_product_attention(q[:, :, None], k, v,
                                          attn_mask=valid[:, None, None, :],
                                          enable_gqa=True)[:, :, 0]


def decode_attn_phase(dev):
    from repro_torch.kernels.decode_attn import ops
    from repro_torch.kernels.decode_attn.ref import (decode_attention_split_ref,
                                                     decode_attn_plain,
                                                     split_plan)

    rows = []
    b = 4
    for label, h, kv, dh, s, mask in DECODE_CASES:
        gen = torch.Generator(device=dev).manual_seed(s * h + dh)
        kw, valid = decode_mask(b, s, h, mask, dev)
        for dtype in (torch.bfloat16, torch.float32):
            q = torch.randn((b, h, dh), generator=gen, device=dev).to(dtype)
            # the serving cache's layout (B, S, KV, dh), read as (B, KV, S, dh)
            cache = torch.randn((2, b, s, kv, dh), generator=gen,
                                device=dev).to(dtype)
            k, v = cache[0].transpose(1, 2), cache[1].transpose(1, 2)
            got = ops.decode_attn(q, k, v, **kw)
            ref = decode_attn_plain(q, k, v, **kw)
            n_sm = ops.sm_count(dev.index or 0)
            split = decode_attention_split_ref(q, k, v, n_sm=n_sm, **kw)
            torch.cuda.synchronize()
            err = float((got.float() - ref.float()).abs().max())
            split_share = over_tiled(got, split, dtype)
            if not err <= FLASH_TOL[dtype]:
                raise AssertionError(f"decode_attn {label} S={s} {dtype}: max "
                                     f"abs error {err}")
            if not split_share <= 1.0:
                raise AssertionError(f"decode_attn {label} S={s} {dtype}: "
                                     f"{split_share} of the tolerance against "
                                     f"the kernel's algorithm")
            lib_err = float((sdpa_decode(q, k, v, valid).float()
                             - ref.float()).abs().max())
            seen = int(valid.sum())
            size = q.element_size()
            # K and V read once: the valid prefix under lengths (the rest is
            # never read), every slot of a ring, whose kv_pos is read too
            read = seen if mask == "lengths" else b * s
            nbytes = ((2 * read * kv * dh + 2 * b * h * dh) * size
                      + (4 * b if mask == "lengths" else 4 * b * s + 4 * b))
            flops = 4 * h * dh * seen
            rate = BF16_OPS_PER_S if dtype == torch.bfloat16 else FP32_OPS_PER_S
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = flops / rate * 1e3
            fns = {"": lambda: ops.decode_attn(q, k, v, **kw),
                   "plain_": lambda: decode_attn_plain(q, k, v, **kw),
                   "library_": lambda: sdpa_decode(q, k, v, valid)}
            row = {"phase": "decode_attn", "expert_heads": label, "B": b,
                   "H": h, "KV": kv, "dh": dh, "S": s, "mask": mask,
                   "splits": split_plan(s, b * kv * -(-(h // kv) // 16),
                                        n_sm)[0],
                   "valid_keys": seen, "dtype": str(dtype).split(".")[-1],
                   "max_abs_err": err, "tol": FLASH_TOL[dtype],
                   "split_max_abs_err": float((got.float()
                                               - split.float()).abs().max()),
                   "split_share_of_tol": split_share,
                   "library_max_abs_err": lib_err}
            for key, fn in fns.items():
                row[f"{key}ms"] = device_ms(fn, 50)
                row[f"{key}call_ms"] = cuda_ms(fn, 20)
            row.update({"bytes": nbytes, "flops": flops, "bytes_ms": bytes_ms,
                        "ops_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
                        "bound_by": ("bytes" if bytes_ms >= ops_ms
                                     else "operations")})
            emit(row)
            rows.append(row)
            del q, cache, k, v, got, ref, split
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# Phase 7: the grouped expert GEMM kernels against their plain versions
# ---------------------------------------------------------------------------

# dbrx's expert FFN: E=16, d=6144, f=10752; C=4 is a decode of 4 slots, 5,
# 10, 20 and 40 the prefill buckets 16 to 128 (``moe._capacity``).  With weights
# at 1/sqrt(fan-in) the outputs reach ~20 (products of two unit normals),
# where one bf16 rounding step is 2^-3, so each element is held to atol +
# rtol * |ref| (both 2e-2 in bf16, 2e-5 in f32)
MOE_E, MOE_D, MOE_F = 16, 6144, 10752
MOE_CAPACITIES = (4, 5, 10, 20, 40)
MOE_LINE_CASE = (4, "bfloat16")                      # the kernels line's rows
# (E, C, D, F) of B4a beside dbrx's: ragged C, D and F that its split path
# takes (C past one row tile), and F not a multiple of 8, which it does not
MOE_RAGGED = [(5, 7, 1000, 136), (3, 70, 200, 1000), (2, 9, 64, 130)]


def previous_gemm(x, w):
    """B4a as PRs 13-16 ran it (a block per output tile, ``moe_gemm_mma``),
    which the library keeps for the shapes the split path does not take:
    timed beside the new kernel on the same inputs."""
    from repro_torch.kernels.moe_gemm import ops
    e, c, d = x.shape
    out = torch.empty((e, c, w.shape[2]), dtype=x.dtype, device=x.device)
    rc = ops._library().moe_gemm_launch(
        x.data_ptr(), w.data_ptr(), None, out.data_ptr(), e, c, d, w.shape[2],
        0, int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream().cuda_stream)
    assert rc == 0, rc
    return out


def moe_gemm_phase(dev):
    from repro_torch.kernels.moe_gemm import ops
    from repro_torch.kernels.moe_gemm.ref import (gemm_plan, gemm_tiled,
                                                  grouped_gemm_ref,
                                                  grouped_gemm_split_ref,
                                                  grouped_swiglu_ref)

    rows = []
    e, d, f = MOE_E, MOE_D, MOE_F
    for dtype in (torch.bfloat16, torch.float32):
        gen = torch.Generator(device=dev).manual_seed(11)
        # the scale of a trained layer's weights: outputs of order 1
        wg, wu = ((torch.randn((e, d, f), generator=gen, device=dev)
                   / d ** 0.5).to(dtype) for _ in range(2))
        wd = (torch.randn((e, f, d), generator=gen, device=dev)
              / f ** 0.5).to(dtype)
        size = wg.element_size()
        rate = BF16_OPS_PER_S if dtype == torch.bfloat16 else FP32_OPS_PER_S
        for c in MOE_CAPACITIES:
            x = torch.randn((e, c, d), generator=gen, device=dev).to(dtype)
            h = ops.expert_swiglu(x, wg, wu)
            y = ops.expert_gemm(h, wd)
            # the split and its merge order are fixed: two calls, same bits
            assert torch.equal(y, ops.expert_gemm(h, wd)), (c, dtype)
            h_ref = grouped_swiglu_ref(x, wg, wu)
            y_ref = grouped_gemm_ref(h, wd)
            torch.cuda.synchronize()
            cases = {
                "grouped_swiglu": (h, h_ref, 2 * e * d * f + e * c * (d + f),
                                   4 * e * c * d * f,
                                   {"": lambda: ops.expert_swiglu(x, wg, wu),
                                    "plain_": lambda: grouped_swiglu_ref(x, wg, wu),
                                    "library_composite_": lambda: torch.nn.functional.silu(
                                        torch.bmm(x, wg)) * torch.bmm(x, wu)}),
                "grouped_gemm": (y, y_ref, e * f * d + e * c * (f + d),
                                 2 * e * c * f * d,
                                 {"": lambda: ops.expert_gemm(h, wd),
                                  "plain_": lambda: grouped_gemm_ref(h, wd),
                                  "library_": lambda: torch.bmm(h, wd),
                                  "previous_": lambda: previous_gemm(h, wd)})}
            for name, (got, ref, n_el, flops, fns) in cases.items():
                tol = FLASH_TOL[dtype]
                diff = (got.float() - ref.float()).abs()
                err = float(diff.max())
                top = float(ref.float().abs().max())
                over = float((diff / (tol + tol * ref.float().abs())).max())
                if not over <= 1.0:
                    raise AssertionError(f"{name} C={c} {dtype}: error {over}x "
                                         f"its limit {tol} + {tol} |ref|")
                nbytes = n_el * size
                bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
                ops_ms = flops / rate * 1e3
                row = {"phase": "moe_gemm", "name": name, "E": e, "C": c,
                       "D": d, "F": f, "dtype": str(dtype).split(".")[-1],
                       "max_abs_err": err, "atol": tol, "rtol": tol,
                       "err_over_limit": over, "max_abs_out": top}
                for key, fn in fns.items():
                    row[f"{key}ms"] = device_ms(fn, 10)
                if "library_ms" not in row:
                    row["library_ms"] = None
                    row["library_composite"] = ("two torch.bmm and silu*mul: "
                                                "not one call")
                row.update({"bytes": nbytes, "flops": flops,
                            "bytes_ms": bytes_ms, "ops_ms": ops_ms,
                            "bound_ms": max(bytes_ms, ops_ms),
                            "bound_by": ("bytes" if bytes_ms >= ops_ms
                                         else "operations"),
                            "share_of_bound": max(bytes_ms, ops_ms) / row["ms"]})
                if name == "grouped_gemm":
                    row["deterministic"] = True
                    if gemm_tiled(dtype, f, d):
                        plan = gemm_plan(e, c, f, d, ops.sm_count(dev))
                        row["split"] = {"ctas": plan.ctas, "units": plan.units,
                                        "cut_tiles": len(plan.merges())}
                emit(row)
                rows.append(row)
            del x, h, y, h_ref, y_ref, cases
        del wg, wu, wd
        torch.cuda.empty_cache()

    # B4a at ragged shapes, bf16: the plain version, its split algorithm in
    # plain PyTorch and two calls
    tol = FLASH_TOL[torch.bfloat16]
    for e, c, d, f in MOE_RAGGED:
        gen = torch.Generator(device=dev).manual_seed(e + c + d + f)
        x = torch.randn((e, c, d), generator=gen, device=dev).bfloat16()
        w = (torch.randn((e, d, f), generator=gen, device=dev)
             / d ** 0.5).bfloat16()
        y = ops.expert_gemm(x, w)
        same = torch.equal(y, ops.expert_gemm(x, w))
        over = {}
        for key, ref in (("plain", grouped_gemm_ref(x, w)),
                         ("split", grouped_gemm_split_ref(x, w,
                                                          ops.sm_count(dev)))):
            diff = (y.float() - ref.float()).abs()
            over[key] = float((diff / (tol + tol * ref.float().abs())).max())
        row = {"phase": "moe_gemm", "name": "grouped_gemm_ragged", "E": e,
               "C": c, "D": d, "F": f, "dtype": "bfloat16",
               "split_path": gemm_tiled(torch.bfloat16, d, f),
               "deterministic": same, "err_over_limit": over}
        emit(row)
        assert same and max(over.values()) <= 1.0, row
    return rows


# ---------------------------------------------------------------------------
# Phases 8 and 9: the LM experts at full width
# ---------------------------------------------------------------------------

STREAM = dict(n_requests=30, rate=20.0, latency_L=0.030)
# a kernel and its plain version differ only in float32 summation order,
# which flips a few bf16 roundings of its output per layer; the logits
# (bf16) of the two paths must stay within 2^-4 of the largest logit (8-16
# bf16 ulps of it), and give the same greedy token
LOGIT_REL_TOL = 2.0 ** -4


# the kernels line's names of ``repro_torch.graphs.COUNTERS``, in order
COUNTER_NAMES = ("lockstep_advance", "flash_attn", "decode_attn",
                 "grouped_swiglu", "grouped_gemm", "rwkv6_scan", "rglru_scan")


def counters() -> dict:
    """Each kernel's launch count so far (a graph replay counts the
    launches its capture recorded)."""
    from repro_torch import graphs
    return dict(zip(COUNTER_NAMES, graphs.launch_counts()))


def reset_counters() -> None:
    from repro_torch import graphs
    graphs.add_launch_counts(tuple(-n for n in graphs.launch_counts()))


def plain_lru(log_a, b, h0):
    """B6's plain version behind the wrapper's clamp, as ``ops.lru`` runs
    it on the CPU."""
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
    return rglru_scan_ref(log_a.clamp(max=0.0), b, h0)


@contextlib.contextmanager
def plain_kernels():
    """Every kernel of the LM path swapped for its plain version, through
    the names the model modules call them by (B5's is the chunk algorithm
    with the model's rounding of D, as on the CPU)."""
    from repro_torch.kernels.decode_attn.ref import decode_attn_plain
    from repro_torch.kernels.flash_attn.ref import attention_ref
    from repro_torch.kernels.moe_gemm.ref import grouped_gemm_ref, grouped_swiglu_ref
    from repro_torch.kernels.rwkv6_scan.ref import wkv_chunked_ref
    from repro_torch.models import encdec, moe, rglru, rwkv6, transformer

    swaps = [(transformer, "flash_attn", attention_ref),
             (transformer, "decode_attn", decode_attn_plain),
             (encdec, "flash_attn", attention_ref),
             (encdec, "decode_attn", decode_attn_plain),
             (rglru, "decode_attn", decode_attn_plain),
             (moe, "expert_swiglu", grouped_swiglu_ref),
             (moe, "expert_gemm", grouped_gemm_ref),
             (rwkv6, "wkv", wkv_chunked_ref),
             (rglru, "lru", plain_lru)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    before = counters()
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    assert counters() == before, (counters(), before)


@contextlib.contextmanager
def moe_routing(replay=None):
    """Record the expert ids of every MoE routing call of a run (a list,
    one (T, k) tensor per call, in call order), or replay recorded ones:
    ids from the record, gates this run's own router probabilities at
    those ids, normalised as ``route_topk`` does."""
    from repro_torch.models import moe

    real = moe.route_topk
    calls = []

    def route(logits, top_k):
        gates, ids, probs = real(logits, top_k)
        if replay is not None:
            ids = replay[len(calls)]
            g = torch.gather(probs, 1, ids.long())
            gates = g / g.sum(dim=-1, keepdim=True).clamp(min=1e-9)
        calls.append(ids)
        return gates, ids, probs

    moe.route_topk = route
    try:
        yield calls
    finally:
        moe.route_topk = real


def expected_launches(servers) -> dict:
    """What the main path must have launched, from the servers' iteration
    counts: B2 n_layers per prefill; B3 n_layers per decode (both masks);
    B4a and B4b once per MoE layer per prefill and per decode; B1, B5 and
    B6 none."""
    out = dict.fromkeys(counters(), 0)
    for s in servers:
        cfg, it = s.cfg, s.iterations
        out["flash_attn"] += it["prefill"] * cfg.n_layers
        out["decode_attn"] += it["decode"] * cfg.n_layers
        if cfg.family == "moe":
            n_moe = cfg.n_layers - cfg.n_dense_layers
            out["grouped_swiglu"] += (it["prefill"] + it["decode"]) * n_moe
            out["grouped_gemm"] += (it["prefill"] + it["decode"]) * n_moe
    return out


def plain_vs_kernel(srv, rng, phase):
    """One full-width prefill (prompt 100, bucket 128) and one decode step
    from its cache through the kernels, and the same through their plain
    versions, same weights, same tokens.

    An MoE layer's routing is discrete: where a token's top-k or an
    expert's capacity is near a tie, one bf16 rounding of difference
    between a kernel and its plain version sends the token elsewhere, and
    the logits then differ by a whole expert's contribution.  So the plain
    run replays the kernel run's expert ids (its gates are its own router
    probabilities at those ids), and the logits are held to the tolerance
    under the same routing; the free-running plain run is reported beside
    it, with the number of (layer, token) routings that differ.  Without
    an MoE layer the two plain runs are the same."""
    from repro_torch.models import transformer

    p = 100
    toks = torch.zeros((1, 128), dtype=torch.int32, device=srv.device)
    toks[0, :p] = torch.as_tensor(rng.integers(2, srv.cfg.vocab, p))
    nxt = torch.as_tensor(rng.integers(2, srv.cfg.vocab, 1), dtype=torch.int32,
                          device=srv.device)
    lengths = torch.tensor([p], dtype=torch.int32, device=srv.device)

    def run():
        pre, cache = transformer.prefill(srv.params, srv.cfg, toks,
                                         srv.max_len, lengths=lengths)
        dec, _ = transformer.decode_step(srv.params, srv.cfg, cache, nxt)
        return pre, dec

    with moe_routing() as ids:
        got = run()
    with plain_kernels(), moe_routing() as free_ids:
        free = run()
    with plain_kernels(), moe_routing(replay=ids):
        ref = run()
    n_calls = len(ids) // 2                         # prefill's, then decode's
    for i, (step, a, b, c) in enumerate(zip(("prefill", "decode"), got, ref,
                                            free)):
        a, b, c = (t.float()[0, :srv.cfg.vocab] for t in (a, b, c))
        err = float((a - b).abs().max())
        scale = float(b.abs().max())
        top2 = torch.topk(b, 2).values
        calls = range(i * n_calls, (i + 1) * n_calls)
        row = {"phase": phase, "check": f"{step}_kernels_vs_plain",
               "expert": srv.name, "prompt": p, "bucket": 128,
               "max_abs_logit_diff": err, "max_abs_logit": scale,
               "tol": LOGIT_REL_TOL * scale,
               "greedy": [int(a.argmax()), int(b.argmax())],
               "plain_top2_margin": float(top2[0] - top2[1]),
               "finite": bool(torch.isfinite(a).all()),
               "moe_routing_calls": n_calls,
               "free_routing_differs": sum(
                   int((ids[j] != free_ids[j]).any(dim=-1).sum())
                   for j in calls),
               "free_max_abs_logit_diff": float((a - c).abs().max()),
               "free_greedy": int(c.argmax())}
        emit(row)
        assert row["finite"], row
        assert err <= LOGIT_REL_TOL * scale, row
        assert row["greedy"][0] == row["greedy"][1], row


def small_cluster_matches_cpu(dev, experts, phase):
    """A reduced cluster on the card (kernels, float32) against the same
    weights on the CPU (plain versions): the same requests give the same
    iterations and tokens."""
    from repro_torch.env.serve_engine import ExpertServer, Request
    from repro_torch.launch import serve
    from repro_torch.models.transformer import Transformer

    rng = np.random.default_rng(3)
    prompts = [(rng.integers(2, 250, p), n)
               for p, n in ((12, 5), (30, 7), (100, 9), (9, 3), (61, 6))]
    for srv in serve.build_cluster(experts, slots=2, device=dev):
        cpu_params = Transformer(srv.cfg, torch.device("cpu"))
        cpu_params.load_state_dict(srv.params.state_dict())
        cpu = ExpertServer(srv.name, srv.cfg, cpu_params, slots=2,
                           max_len=srv.max_len)
        runs = []
        for server in (srv, cpu):
            for rid, (toks, n) in enumerate(prompts):
                server.submit(Request(rid=rid, tokens=toks, max_new=n))
            done = []
            while server.has_work():
                done.extend(server.step())
            runs.append(([(e["kind"], e["x"]) for e in server.iteration_log],
                         [(r.rid, r.generated) for r in done]))
        assert runs[0] == runs[1], (srv.name, runs)
        emit({"phase": phase, "check": "reduced_card_vs_cpu",
              "expert": srv.name, "iterations": len(runs[0][0]),
              "tokens": sum(len(g) for _, g in runs[0][1]), "same": True})


def lm_window(srv, phase, n_prefill=3, n_decode=12):
    """Where an iteration's time goes, per expert: synchronised wall time of
    prefills (bucket 128) and full decodes, then one window of the same
    under torch.profiler for the device's busy time and each LM kernel's
    launches and time (the idle share sets that busy time against the
    unprofiled wall time).  Through the server's own steps: graph replays
    unless it is an eager twin."""
    rng = np.random.default_rng(5)
    toks = rng.integers(2, 250, 128).astype(np.int32)
    dec = rng.integers(2, 250, srv.slots).astype(np.int32)

    def run():
        t0 = time.perf_counter()
        for j in range(n_prefill):
            int(srv._prefill_one(toks, 120, j % srv.slots).cpu())
        t1 = time.perf_counter()
        for _ in range(n_decode):
            srv._decode_all(dec).cpu()
        return t1 - t0, time.perf_counter() - t1

    run()                                                   # warm up
    pre_s, dec_s = run()
    cfg = srv.cfg
    n_moe = (cfg.n_layers - cfg.n_dense_layers if cfg.family == "moe" else 0)
    expected = {"b2": n_prefill * cfg.n_layers, "b3": n_decode * cfg.n_layers,
                "b4": 2 * n_moe * (n_prefill + n_decode)}
    _, kernels, takes = profiled(run, expected, srv.name)
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    row = {"phase": phase, "expert": srv.name,
           "mode": "graphed" if srv.graphed else "eager",
           "prefill_ms": pre_s / n_prefill * 1e3,
           "decode_ms": dec_s / n_decode * 1e3,
           "iterations_profiled": n_prefill + n_decode,
           "device_busy_ms": busy_ms,
           "wall_ms": (pre_s + dec_s) * 1e3,
           "device_idle_share": 1.0 - busy_ms / ((pre_s + dec_s) * 1e3),
           "kernels": len(kernels),
           "kernels_per_iteration": len(kernels) / (n_prefill + n_decode),
           "trace_takes": takes}
    traced(row, kernels, expected)
    return row


# takes of a profiled window whose trace lacks some kernel records
TRACE_TAKES = 3
# each kernel's main kernels by name in a trace; the merges apart
TRACE_KERNELS = {"b1": ("lockstep_advance",),
                 "b2": ("flash_attn_bf16_kernel", "flash_attn_f32_kernel"),
                 "b3": ("decode_attn_mma", "decode_attn_simt"),
                 "b3_merge": ("decode_attn_merge",),
                 "b4": ("moe_gemm_mma", "moe_gemm_simt", "moe_gemm_tma"),
                 "b4_merge": ("moe_gemm_merge",),
                 "b5": ("rwkv6_wkv_sums", "rwkv6_wkv_carry", "rwkv6_wkv_out"),
                 "b6": ("rglru_chunk_sums", "rglru_chunk_walk")}


def traced(row, kernels, expected):
    """Each LM kernel's launches and time in a profiled window, into
    ``row``, with B3's and B4a's merge launches; the launches of each tag
    of ``expected`` must equal its count there: what the counters credit a
    graph replay with, read from the trace (a window from ``profiled``)."""
    for tag in (*expected, "b3_merge", "b4_merge"):
        us = [e.time_range.elapsed_us() for e in kernels
              if any(n in e.name for n in TRACE_KERNELS[tag])]
        row[f"{tag}_launches"] = len(us)
        row[f"{tag}_ms_per_launch"] = float(np.mean(us)) / 1e3 if us else None
        row[f"{tag}_ms"] = sum(us) / 1e3
    row["traced_launches_expected"] = expected
    got = {tag: row[f"{tag}_launches"] for tag in expected}
    assert got == expected, (row.get("expert", row.get("arch")), got,
                             expected)


def serve_counted(servers, phase, n_warm=8):
    """The main path, counted: every kernel count set to 0, calibration,
    then two streams, then the counts read and held against the servers'
    iterations.  Returns the counts and each stream's finished requests."""
    from repro_torch.launch import serve

    mode = "graphed" if servers[0].graphed else "eager"
    reset_counters()
    fits = serve.profile_cluster(servers, n_warm=n_warm)
    streams, finished = {}, {}
    for router in ("sqf", "rr"):
        finished[router] = []
        streams[router] = serve.run_stream(servers, router=router,
                                           finished=finished[router], **STREAM)
    got = counters()
    expected = expected_launches(servers)
    assert got == expected, (mode, got, expected)
    for srv, fit in zip(servers, fits):
        assert all(np.isfinite(v) for v in fit.values()), fit
        emit({"phase": phase, "check": "calibrate", "mode": mode,
              "expert": srv.name, "n_layers": srv.cfg.n_layers, **fit})
    for router, m in streams.items():
        assert m["completed"] == STREAM["n_requests"], m
        assert all(np.isfinite(v) for v in m.values()), m
        emit({"phase": phase, "check": "stream", "mode": mode,
              "router": router, **STREAM, **m})
    emit({"phase": phase, "check": "launches", "mode": mode, "launches": got,
          "expected": expected,
          "iterations": {s.name: dict(s.iterations) for s in servers},
          "max_memory_allocated": torch.cuda.max_memory_allocated()})
    return got, finished


def eager_twins(servers):
    """A server per expert on the same weights that runs its steps eagerly
    (``graphs=False``), with a cache of its own."""
    from repro_torch.env.serve_engine import ExpertServer
    return [ExpertServer(s.name, s.cfg, s.params, slots=s.slots,
                         max_len=s.max_len, graphs=False) for s in servers]


def graphed_logits_equal(srv, rng, phase):
    """A prefill (prompt 100, bucket 128) and a decode step from its cache,
    captured as one CUDA graph as the server captures its steps, give
    bit-equal logits to the same two steps run eagerly."""
    from repro_torch.graphs import StepGraph
    from repro_torch.models import transformer

    p = 100
    toks = torch.zeros((1, 128), dtype=torch.int32, device=srv.device)
    toks[0, :p] = torch.as_tensor(rng.integers(2, srv.cfg.vocab, p))
    nxt = torch.as_tensor(rng.integers(2, srv.cfg.vocab, 1), dtype=torch.int32,
                          device=srv.device)
    lengths = torch.tensor([p], dtype=torch.int32, device=srv.device)

    def run():
        pre, cache = transformer.prefill(srv.params, srv.cfg, toks,
                                         srv.max_len, lengths=lengths)
        dec, _ = transformer.decode_step(srv.params, srv.cfg, cache, nxt)
        return pre, dec

    eager = run()
    graph = StepGraph(run)
    got = graph.replay()
    same = [bool(torch.equal(a, b)) for a, b in zip(got, eager)]
    emit({"phase": phase, "check": "graphed_vs_eager_logits",
          "expert": srv.name, "prompt": p, "bucket": 128,
          "prefill_equal": same[0], "decode_equal": same[1],
          "max_abs_logit_diff": max(float((a.float() - b.float()).abs().max())
                                    for a, b in zip(got, eager))})
    assert all(same), (srv.name, same)
    del graph, got, eager
    torch.cuda.empty_cache()


def same_stream_tokens(finished, phase):
    """The graphed and eager runs of each stream: every request that
    reached the same expert in both gets the same tokens (round robin sends
    every one to the same expert)."""
    for router in finished["graphed"]:
        graphed = {r.rid: r for r in finished["graphed"][router]}
        eager = {r.rid: r for r in finished["eager"][router]}
        pairs = [(graphed[i], eager[i]) for i in graphed
                 if graphed[i].expert == eager[i].expert]
        differ = [a.rid for a, b in pairs if a.generated != b.generated]
        emit({"phase": phase, "check": "stream_tokens_graphed_vs_eager",
              "router": router, "compared": len(pairs),
              "requests": len(graphed), "differ": differ})
        assert not differ, (router, differ)
        assert router != "rr" or len(pairs) == len(graphed), router


def same_tokens_to_the_end(servers, twins, phase):
    """A fixed request set (the stream's prompt and output lengths)
    submitted at once and stepped to the end gives the same iterations and
    tokens through each server and its eager twin."""
    from repro_torch.env.serve_engine import Request

    rng = np.random.default_rng(8)
    reqs = [(rng.integers(2, 250, int(rng.integers(8, 120))),
             int(rng.integers(4, 24))) for _ in range(10)]
    for srv, twin in zip(servers, twins):
        runs = []
        for server in (srv, twin):
            server.iteration_log.clear()
            for rid, (toks, n) in enumerate(reqs):
                server.submit(Request(rid=rid, tokens=toks, max_new=n))
            done = []
            while server.has_work():
                done.extend(server.step())
            runs.append(([(e["kind"], e["x"]) for e in server.iteration_log],
                         sorted((r.rid, r.generated) for r in done)))
        assert runs[0] == runs[1], (srv.name, runs)
        emit({"phase": phase, "check": "graphed_vs_eager_to_the_end",
              "expert": srv.name, "iterations": len(runs[0][0]),
              "tokens": sum(len(g) for _, g in runs[0][1]), "same": True})


def serve_graphed_and_eager(servers, phase, rng, profiled=None):
    """The counted main path through the servers (CUDA graphs) and through
    their eager twins, the graphs checked against eager steps, then a
    profiled window of each server named in ``profiled`` (all by default)
    and of its twin.  Returns the launches of both runs."""
    for srv in servers:
        graphed_logits_equal(srv, rng, phase)
    twins = eager_twins(servers)
    got, finished = serve_counted(servers, phase)
    eager_got, finished_eager = serve_counted(twins, phase)
    same_stream_tokens({"graphed": finished, "eager": finished_eager}, phase)
    same_tokens_to_the_end(servers, twins, phase)
    for srv, twin in zip(servers, twins):
        if profiled is None or srv.name in profiled:
            for server in (srv, twin):
                emit(lm_window(server, "lm_profile"))
    return {k: got[k] + eager_got[k] for k in got}


def build_line(servers, phase, t0, reduced):
    emit({"phase": phase, "check": "build", "experts": [
              {"name": s.name, "family": s.cfg.family,
               "n_layers": s.cfg.n_layers,
               "params": sum(p.numel() for p in s.params.parameters()),
               "bytes": sum(p.numel() * p.element_size()
                            for p in s.params.parameters()),
               "dtype": s.cfg.param_dtype} for s in servers],
          "reduced": reduced, "init_s": time.perf_counter() - t0,
          "max_memory_allocated": torch.cuda.max_memory_allocated()})


def lm_serve_phase(dev):
    """The dense trio (``serve.DEFAULT_EXPERTS``) at full width."""
    from repro_torch.launch import serve

    small_cluster_matches_cpu(dev, serve.DEFAULT_EXPERTS, "lm_serve")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    servers = serve.build_cluster(serve.DEFAULT_EXPERTS, reduce=False,
                                  device=dev)
    torch.cuda.synchronize()
    build_line(servers, "lm_serve", t0, {})
    rng = np.random.default_rng(4)
    for srv in servers:
        plain_vs_kernel(srv, rng, "lm_serve")
    launches = serve_graphed_and_eager(servers, "lm_serve", rng)
    del servers
    torch.cuda.empty_cache()
    return launches


# the heterogeneous cluster with one MoE expert: dbrx at its published
# widths, cut to 4 of its 40 layers (28.5 GB of bf16 weights), beside two
# dense experts; ~37.4 GB in all
MOE_EXPERTS = ["qwen1.5-0.5b", "h2o-danube-3-4b", "dbrx-132b"]
MOE_DEPTH = 4


def lm_moe_phase(dev):
    from repro_torch.configs import get_config
    from repro_torch.env.serve_engine import ExpertServer
    from repro_torch.launch import serve
    from repro_torch.models import model as model_lib

    small_cluster_matches_cpu(dev, ["dbrx-132b"], "lm_moe")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    servers = serve.build_cluster(MOE_EXPERTS[:2], reduce=False, device=dev)
    full = get_config("dbrx-132b")
    cfg = dataclasses.replace(full, n_layers=MOE_DEPTH)
    servers.append(ExpertServer(
        f"expert2:{cfg.name}", cfg,
        model_lib.init_params(cfg, seed=2, device=dev), slots=4, max_len=192))
    torch.cuda.synchronize()
    build_line(servers, "lm_moe", t0,
               {"n_layers": f"{full.n_layers} -> {cfg.n_layers}"})
    rng = np.random.default_rng(6)
    plain_vs_kernel(servers[-1], rng, "lm_moe")
    launches = serve_graphed_and_eager(servers, "lm_moe", rng,
                                       profiled=[servers[-1].name])
    del servers
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# Phases 10 and 11: the recurrent scans against their plain versions
# ---------------------------------------------------------------------------

# The special function units evaluate 16 ex2 per clock on each SM (NVIDIA's
# table of arithmetic instruction throughput, compute capability 9.0), at
# the 1.98 GHz that FP32_OPS_PER_S implies (132 SMs x 128 lanes x 2
# flops); an expf is one ex2 beside FMAs
SFU_OPS_PER_S = 132 * 16 * 1.98e9
# rwkv6-7b's heads: H=64, K=V=64, chunk 32; (B, T)
WKV_H, WKV_K, WKV_CHUNK = 64, 64, 32
WKV_CASES = [(4, 128), (4, 100), (1, 4096)]
# float32: the chunk algorithm against the token recurrence differs by
# float32 rounding of cumulative decays of up to ~240 (a few 1e-6 of
# outputs of up to ~100); bf16: one rounding of y; the state is float32
WKV_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
WKV_LINE_CASE = (4, 128, "bfloat16")       # the kernels line's row
WKV_OTHER_GROUP = 32      # tokens per group on the far side of B5's switch
# recurrentgemma-2b's width; (B, T)
LRU_W = 2560
LRU_CASES = [(4, 128), (1, 4096)]
LRU_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
LRU_LINE_CASE = (4, 128, "float32")        # the model's gates are float32
LRU_OTHER_CHUNK = 32      # steps per chunk on the far side of B6's switch


@contextlib.contextmanager
def switched(module, name, value):
    """``module.name`` set to ``value`` inside the block: a wrapper's
    constant moved so that a call reaches the far side of its shape switch
    at the same shape."""
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def wkv_sides(n):
    """B5's two sides at T = ``n``: (side, the patch of its wrapper's
    ``GROUP``, group) for the plan and the other side (three passes in
    groups of 32 tokens where the plan walks once, one walk where it takes
    three passes)."""
    from repro_torch.kernels.rwkv6_scan import ops
    other = WKV_OTHER_GROUP if n <= ops.GROUP else n
    return [(side, ("GROUP", group), group)
            for side, group in (("plan", ops.GROUP), ("other", other))]


def lru_sides(n):
    """B6's two sides at T = ``n``: (side, the patch of its wrapper's
    ``plan``, chunk) for the plan and the other side (two passes in chunks
    of 32 where the plan walks once, one walk where it takes two)."""
    from repro_torch.kernels.rglru_scan import ops
    other = LRU_OTHER_CHUNK if n <= ops.SINGLE_T else n
    return [(side, ("plan", lambda n_t, c=chunk: c), chunk)
            for side, chunk in (("plan", ops.plan(n)), ("other", other))]


def chunk_algorithm_work(b, h, n, kd, vd, chunk):
    """Exponentials and float32 operations of the reference's chunk
    algorithm on these shapes (each chunk counted at its own rows, so a
    tail chunk counts less): the decay matrix (one exponential and three
    operations per (i, s<i, k)), r e^p and k e^(p_end - q), e^p_end, the
    products with S and within the chunk, the bonus and the state update.
    Kept beside B5's rows as what that algorithm does; the kernel factors
    the decay and does less, so its bound is the bytes alone."""
    exps = flops = 0
    for t0 in range(0, n, chunk):
        rows = min(chunk, n - t0)
        pairs = rows * (rows - 1) // 2
        exps += pairs * kd + 2 * rows * kd + kd
        flops += (3 * pairs * kd + 2 * rows * kd + 2 * rows * kd * vd
                  + 2 * pairs * vd + 3 * rows * kd + 4 * rows * vd
                  + kd * vd * (2 * rows + 2))
    return b * h * exps, b * h * flops


def bound_row(nbytes, flops, exps):
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = max(flops / FP32_OPS_PER_S, exps / SFU_OPS_PER_S) * 1e3
    return {"bytes": nbytes, "flops": flops, "exps": exps,
            "bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def wkv_inputs(b, n, dtype, dev, seed):
    """rwkv6-7b's heads at (b, n): r, k, v, dlog, u from ``seed``.  The
    decays are the model's, -exp(clip(w0 + lora, -8, 2)), w0 ~ 0.3 N - 0.6,
    widened to reach both ends of the clip."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    h, kd = WKV_H, WKV_K
    r, k, v = (torch.randn((b, h, n, kd), generator=gen, device=dev).to(dtype)
               for _ in range(3))
    expo = torch.randn((b, h, n, kd), generator=gen, device=dev) - 0.6
    dlog = -torch.exp(expo.clamp(-8.0, 2.0))
    u = (torch.randn((h, kd), generator=gen, device=dev) * 0.3).to(dtype)
    return r, k, v, dlog, u


def lru_inputs(b, n, dtype, dev, seed):
    """recurrentgemma-2b's width at (b, n): log_a, x, h0 from ``seed``;
    decays as the model's (-8 softplus(lam) r, lam in [0.4, 0.9)) plus a
    few above 0, which the wrapper clamps."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    log_a = (-8 * torch.rand((b, n, LRU_W), generator=gen, device=dev)
             + 0.05).to(dtype)
    x = torch.randn((b, n, LRU_W), generator=gen, device=dev).to(dtype)
    h0 = torch.randn((b, LRU_W), generator=gen, device=dev)
    return log_a, x, h0


def scan_sides():
    """Phases 10 and 11's calls: (key, tag, kernels per call, make), with
    ``make(dev)`` returning the call.  Each case and dtype on both sides of
    its wrapper's switch (``wkv_sides``, ``lru_sides``)."""
    from repro_torch.kernels.rglru_scan import ops as lru_ops
    from repro_torch.kernels.rwkv6_scan import ops as wkv_ops

    def side_call(ops, patch, fn):
        def call():
            with switched(ops, *patch):
                return fn()
        return call

    out = []
    for b, n in WKV_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            for side, patch, _ in wkv_sides(n):
                def make(dev, b=b, n=n, dtype=dtype, patch=patch):
                    x = wkv_inputs(b, n, dtype, dev, b * n)
                    return side_call(wkv_ops, patch,
                                     lambda: wkv_ops.wkv(*x, chunk=WKV_CHUNK))
                with switched(wkv_ops, *patch):
                    per_call = wkv_ops.kernels_per_call(n)
                out.append((("b5", b, n, str(dtype), side), "b5", per_call,
                            make))
    for b, n in LRU_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            for side, patch, _ in lru_sides(n):
                def make(dev, b=b, n=n, dtype=dtype, patch=patch):
                    x = lru_inputs(b, n, dtype, dev, b * n + 1)
                    return side_call(lru_ops, patch, lambda: lru_ops.lru(*x))
                with switched(lru_ops, *patch):
                    per_call = lru_ops.kernels_per_call(n)
                out.append((("b6", b, n, str(dtype), side), "b6", per_call,
                            make))
    return out


def scan_pass_times(dev, calls=5, sessions=3):
    """B5's and B6's device time per call of each of their kernels, on
    every side of ``scan_sides``, from a torch.profiler session (CPU and
    CUDA) at the start of the run.  Each case's
    calls run inside a ``record_function`` range and end synchronised, so
    a kernel record belongs to the case whose range holds its start; each
    kernel's time is the mean of its records (each kernel runs once a
    call).  A case's records must be its calls times the kernels per call
    that the wrapper reports; a case whose session lacks some is traced
    again in the next, and one still short after ``sessions`` fails the
    run, so no time is a sum of part of a call.  Returns {key: row}."""
    from torch.profiler import ProfilerActivity, profile, record_function

    sides = [(key, tag, per_call, make(dev))
             for key, tag, per_call, make in scan_sides()]
    for *_, fn in sides:                       # build, warm, workspaces
        fn()
    torch.cuda.synchronize()
    out, short = {}, {}
    for session in range(sessions):
        labels = {f"scan_pass_times/{i}": i for i, side in enumerate(sides)
                  if side[0] not in out}
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for label, i in labels.items():
                with record_function(label):
                    for _ in range(calls):
                        sides[i][3]()
                    torch.cuda.synchronize()
        spans = {labels[e.name]: (e.time_range.start, e.time_range.end)
                 for e in trace_events(prof, "CPU") if e.name in labels}
        kernels = trace_events(prof, "CUDA")
        for i in labels.values():
            key, tag, per_call, _ = sides[i]
            t0, t1 = spans[i]
            us = {n: [] for n in TRACE_KERNELS[tag]}
            for e in kernels:
                name = next((n for n in TRACE_KERNELS[tag] if n in e.name),
                            None)
                if name is not None and t0 <= e.time_range.start <= t1:
                    us[name].append(e.time_range.elapsed_us())
            held = sum(map(len, us.values()))
            if held != per_call * calls:
                short[key] = (held, per_call * calls)
                continue
            row = {f"{n}_ms": float(np.mean(t)) / 1e3 if t else None
                   for n, t in us.items()}
            row["traced_ms"] = sum(t for t in row.values() if t is not None)
            row["kernels_per_call"] = per_call
            row["trace_session"] = session
            out[key] = row
        if len(out) == len(sides):
            break
    missing = {key: short[key] for key, *_ in sides if key not in out}
    assert not missing, ("scan_pass_times: kernel records (held, expected) "
                         f"short in every session: {missing}")
    del sides
    torch.cuda.empty_cache()
    return out


def over_limit(got, ref, tol):
    """The largest error as a share of atol + rtol * |ref| (atol = rtol)."""
    got, ref = got.float(), ref.float()
    return float(((got - ref).abs() / (tol + tol * ref.abs())).max())


def rwkv6_scan_phase(dev, passes):
    """Phase 10; ``passes`` is ``scan_pass_times``'s result."""
    from repro_torch.kernels.rwkv6_scan import ops
    from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref, wkv_chunked_ref

    rows = []
    h, kd = WKV_H, WKV_K
    for b, n in WKV_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            r, k, v, dlog, u = wkv_inputs(b, n, dtype, dev, b * n)
            y_ref, s_ref = rwkv6_scan_ref(r, k, v, dlog, u)
            sides = {}
            for side, patch, group in wkv_sides(n):
                with switched(ops, *patch):
                    y, state = ops.wkv(r, k, v, dlog, u, chunk=WKV_CHUNK)
                torch.cuda.synchronize()
                sides[side] = {
                    "group": group,
                    "max_abs_err": float((y.float() - y_ref.float()).abs().max()),
                    "state_max_abs_err": float((state - s_ref).abs().max()),
                    "err_over_limit": over_limit(y, y_ref, WKV_TOL[dtype]),
                    "state_err_over_limit": over_limit(
                        state, s_ref, WKV_TOL[torch.float32]),
                    "finite": bool(torch.isfinite(y.float()).all()
                                   and torch.isfinite(state).all())}
                fn = lambda: ops.wkv(r, k, v, dlog, u, chunk=WKV_CHUNK)
                with switched(ops, *patch):
                    sides[side]["ms"] = device_ms(fn, 5 if n > 1024 else 20)
                sides[side].update(passes[("b5", b, n, str(dtype), side)])
                del y, state
            plan = sides["plan"]
            row = {"phase": "rwkv6_scan", "B": b, "H": h, "T": n, "K": kd,
                   "V": kd, "chunk": WKV_CHUNK,
                   "dtype": str(dtype).split(".")[-1],
                   **{key: plan[key] for key in plan},
                   "max_abs_out": float(y_ref.float().abs().max()),
                   "atol": WKV_TOL[dtype], "rtol": WKV_TOL[dtype],
                   "other_side": sides["other"]}
            for side in sides.values():
                if not (side["err_over_limit"] <= 1.0
                        and side["state_err_over_limit"] <= 1.0 and side["finite"]):
                    raise AssertionError(f"rwkv6_scan disagrees with the token "
                                         f"recurrence: {row}")
            fn = lambda: ops.wkv(r, k, v, dlog, u, chunk=WKV_CHUNK)
            plain = lambda: wkv_chunked_ref(r, k, v, dlog, u, WKV_CHUNK)
            if n % WKV_CHUNK:          # the plain chunks need whole ones
                plain = lambda: rwkv6_scan_ref(r, k, v, dlog, u)
            row["call_ms"] = cuda_ms(fn, 5)
            row["plain"] = ("wkv_chunked_ref" if n % WKV_CHUNK == 0
                            else "rwkv6_scan_ref")
            row["plain_ms"] = cuda_ms(plain, 2 if n > 1024 else 5)
            row["library_ms"] = None
            size = r.element_size()
            nbytes = (4 * b * h * n * kd * size + 4 * b * h * n * kd
                      + h * kd * size + 4 * b * h * kd * kd)
            exps, flops = chunk_algorithm_work(b, h, n, kd, kd, WKV_CHUNK)
            row.update(bound_row(nbytes, 0, 0))
            row["chunk_algorithm_exps"] = exps
            row["chunk_algorithm_flops"] = flops
            emit(row)
            rows.append(row)
            del r, k, v, dlog, u, y_ref, s_ref
    torch.cuda.empty_cache()
    return rows


def rglru_scan_phase(dev, passes):
    """Phase 11; ``passes`` is ``scan_pass_times``'s result."""
    from repro_torch.kernels.rglru_scan import ops
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref

    rows = []
    w = LRU_W
    for b, n in LRU_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            log_a, x, h0 = lru_inputs(b, n, dtype, dev, b * n + 1)
            ref = rglru_scan_ref(log_a.clamp(max=0.0), x, h0)
            sides = {}
            for side, patch, chunk in lru_sides(n):
                with switched(ops, *patch):
                    got = ops.lru(log_a, x, h0)
                torch.cuda.synchronize()
                sides[side] = {
                    "chunk": chunk,
                    "max_abs_err": float((got.float() - ref.float()).abs().max()),
                    "err_over_limit": over_limit(got, ref, LRU_TOL[dtype])}
                fn = lambda: ops.lru(log_a, x, h0)
                with switched(ops, *patch):
                    sides[side]["ms"] = device_ms(fn, 20)
                sides[side].update(passes[("b6", b, n, str(dtype), side)])
                del got
            plan = sides["plan"]
            row = {"phase": "rglru_scan", "B": b, "T": n, "W": w,
                   "dtype": str(dtype).split(".")[-1],
                   "clamped": int((log_a > 0).sum()),
                   **{key: plan[key] for key in plan},
                   "atol": LRU_TOL[dtype], "rtol": LRU_TOL[dtype],
                   "other_side": sides["other"]}
            if (not all(sd["err_over_limit"] <= 1.0 for sd in sides.values())
                    or row["clamped"] == 0):
                raise AssertionError(f"rglru_scan disagrees with its plain "
                                     f"version: {row}")
            fn = lambda: ops.lru(log_a, x, h0)
            row["call_ms"] = cuda_ms(fn, 5)
            row["plain_ms"] = cuda_ms(lambda: plain_lru(log_a, x, h0),
                                      2 if n > 1024 else 5)
            row["library_ms"] = None
            size = x.element_size()
            row.update(bound_row(3 * b * n * w * size + 4 * b * w,
                                 2 * b * n * w, b * n * w))
            emit(row)
            rows.append(row)
            del log_a, x, h0, ref
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# Phase 12: the recurrent families at full width, through the model API
# ---------------------------------------------------------------------------

# (arch, seed): both at their published widths, nothing cut
RECURRENT = [("rwkv6-7b", 0), ("recurrentgemma-2b", 1)]
REC_BATCH, REC_PROMPT, REC_DECODE, REC_LONG = 4, 128, 32, 4096


def scan_launches_per_pass(cfg) -> dict:
    """B5 and B6 launches of one prefill or forward: B5 once per rwkv6
    layer, B6 once per recurrent layer of recurrentgemma."""
    from repro_torch.models import rglru
    out = {"rwkv6_scan": 0, "rglru_scan": 0}
    if cfg.family == "ssm":
        out["rwkv6_scan"] = cfg.n_layers
    else:
        out["rglru_scan"] = sum(k == "rec" for k in rglru.layer_kinds(cfg))
    return out


def scan_kernels_per_pass(cfg, n_t) -> dict:
    """B5's and B6's kernels in a trace of one prefill of T = ``n_t``:
    calls times the kernels per call that each wrapper reports."""
    from repro_torch.kernels.rglru_scan import ops as lru_ops
    from repro_torch.kernels.rwkv6_scan import ops as wkv_ops
    calls = scan_launches_per_pass(cfg)
    return {"b5": calls["rwkv6_scan"] * wkv_ops.kernels_per_call(n_t),
            "b6": calls["rglru_scan"] * lru_ops.kernels_per_call(n_t)}


def b3_launches_per_decode(cfg) -> int:
    """B3 launches of one decode step: once per attention layer of
    recurrentgemma, none for rwkv6."""
    from repro_torch.models import rglru
    if cfg.family == "ssm":
        return 0
    return sum(k == "attn" for k in rglru.layer_kinds(cfg))


def state_leaves(cfg, cache) -> dict:
    """The recurrent state of a cache by name, each a tensor."""
    if cfg.family == "ssm":
        return {k: cache[k] for k in ("S", "tm_prev", "cm_prev")}
    out = {}
    for i, st in enumerate(cache["layers"]):
        for k in ("h", "conv", "k", "v"):
            if k in st:
                out[f"layers.{i}.{k}"] = st[k]
    return out


def greedy_check(got, ref, vocab):
    """Per row: the greedy tokens of two logits (B, Vp) and the plain top-2
    margin; rows whose tokens differ must have a margin within the
    tolerance."""
    got, ref = got.float()[:, :vocab], ref.float()[:, :vocab]
    scale = float(ref.abs().max())
    top2 = torch.topk(ref, 2, dim=-1).values
    margin = (top2[:, 0] - top2[:, 1]).tolist()
    a, b = got.argmax(-1).tolist(), ref.argmax(-1).tolist()
    flips = [{"row": i, "margin": margin[i]} for i in range(len(a))
             if a[i] != b[i]]
    ok = all(f["margin"] <= LOGIT_REL_TOL * scale for f in flips)
    return {"max_abs_logit_diff": float((got - ref).abs().max()),
            "max_abs_logit": scale, "tol": LOGIT_REL_TOL * scale,
            "greedy": [a, b], "plain_top2_margin": margin, "flips": flips,
            "finite": bool(torch.isfinite(got).all())}, ok


def recurrent_small_matches_cpu(dev, phase):
    """The reduced configs on the card (kernels, float32) against the same
    weights on the CPU (plain versions): a prefill of 2 x 16 tokens and 6
    greedy decode steps through the step functions give logits within
    1e-4 and the same tokens; the card run launches B5 or B6 once per
    layer of its family per prefill, none at decode."""
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.launch import steps
    from repro_torch.models import model as model_lib

    rng = np.random.default_rng(9)
    for arch, seed in RECURRENT:
        cfg = reduce_config(get_config(arch))
        card = model_lib.init_params(cfg, seed=seed, device=dev)
        cpu = model_lib.init_params(cfg, seed=seed, device="cpu")
        cpu.load_state_dict(card.state_dict())
        toks = torch.as_tensor(rng.integers(2, cfg.vocab, (2, 16)),
                               dtype=torch.int32)
        prefill = steps.make_prefill_step(cfg, 32)
        decode = steps.make_decode_step(cfg)
        runs = []
        for params, d in ((card, dev), (cpu, torch.device("cpu"))):
            before = counters()
            logits, cache = prefill(params, toks.to(d))
            outs, tokens = [logits.cpu()], []
            for i in range(6):
                tok = (runs[0][1][i] if runs else
                       logits.argmax(-1).to(torch.int32).cpu())
                tokens.append(tok)
                logits, cache = decode(params, cache, tok.to(d))
                outs.append(logits.cpu())
            got = {k: counters()[k] - before[k] for k in before}
            runs.append((outs, tokens, got))
        (card_out, card_tok, launched), (cpu_out, _, none) = runs
        want = dict.fromkeys(launched, 0)
        want.update(scan_launches_per_pass(cfg))
        want["decode_attn"] = 6 * b3_launches_per_decode(cfg)
        assert launched == want and not any(none.values()), (launched, none)
        err = max(float((a - b).abs().max()) for a, b in zip(card_out, cpu_out))
        same = all(torch.equal(a.argmax(-1), b.argmax(-1))
                   for a, b in zip(card_out, cpu_out))
        emit({"phase": phase, "check": "reduced_card_vs_cpu", "arch": arch,
              "n_layers": cfg.n_layers, "max_abs_logit_diff": err,
              "tol": 1e-4, "same_tokens": same, "launches": launched})
        assert err <= 1e-4 and same, (arch, err, same)


def recurrent_window(params, cfg, toks, n_decode=8):
    """Where an iteration's time goes: one prefill and ``n_decode`` decodes,
    synchronised for wall time, then the same under torch.profiler for the
    device's busy time, kernels per iteration and B3/B5/B6's launches and
    time.  Each run is a new prompt through the steps a user gets: the
    first run captures both graphs, every later run replays the prefill's
    and its first decode copies the new prefill's cache into the step's own
    (timed with the decodes); the window must hold one capture of each.
    Returns the row and the passes: prefills and decode steps run (the
    window's takes included)."""
    from repro_torch.launch import steps

    prefill = steps.make_prefill_step(cfg, toks.shape[1] + n_decode + 1)
    decode = steps.make_decode_step(cfg)

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(params, toks)
        tok = logits.argmax(-1).to(torch.int32)
        tok.cpu()
        t1 = time.perf_counter()
        for _ in range(n_decode):
            logits, cache = decode(params, cache, tok)
            tok = logits.argmax(-1).to(torch.int32)
        tok.cpu()
        return t1 - t0, time.perf_counter() - t1

    run()                                         # the capture
    pre_s, dec_s = run()
    expected = {"b3": n_decode * b3_launches_per_decode(cfg),
                **scan_kernels_per_pass(cfg, toks.shape[1])}
    _, kernels, takes = profiled(run, expected, cfg.name)
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    wall_ms = (pre_s + dec_s) * 1e3
    row = {"prefill_ms": pre_s * 1e3, "decode_ms": dec_s / n_decode * 1e3,
           "decode": "graphed", "iterations_profiled": 1 + n_decode,
           "device_busy_ms": busy_ms,
           "wall_ms": wall_ms, "device_idle_share": 1.0 - busy_ms / wall_ms,
           "kernels": len(kernels),
           "kernels_per_iteration": len(kernels) / (1 + n_decode),
           "captures": len(decode.graphs),
           "prefill_captures": len(prefill.graphs), "trace_takes": takes}
    traced(row, kernels, expected)
    assert row["captures"] == 1 and row["prefill_captures"] == 1, row
    return row, {"prefill": 2 + takes, "decode": (2 + takes) * n_decode}


def cache_leaves(c):
    """Every tensor of a cache, in order."""
    if isinstance(c, (dict, list)):
        return [y for x in (c.values() if isinstance(c, dict) else c)
                for y in cache_leaves(x)]
    return [c]


def same_prefill(a, b) -> bool:
    """Two (logits, cache) bit for bit."""
    return torch.equal(a[0], b[0]) and all(
        torch.equal(x, y) for x, y in zip(cache_leaves(a[1]),
                                          cache_leaves(b[1])))


def recurrent_serve(params, cfg, name, rng, phase):
    """The model's main path through the step functions: a prefill of 4 x
    128 tokens (the step's first call for the shape: eager, and the graph's
    capture) held against the same through the plain versions, and a
    replay of its graph held bit for bit against it; one decode step from
    its cache through the kernels against the plain versions; 32 greedy
    decodes graphed and 32 eager (no B5/B6 launch), each step timed;
    prefills timed graphed and eager; a profiled window; one long prefill
    (1 x 4,096) replayed against its eager first call, and timed both
    ways.  Returns the prefills and decode steps it ran."""
    from repro_torch.launch import steps
    from repro_torch.models import model as model_lib

    max_len = REC_PROMPT + REC_DECODE
    prefill = steps.make_prefill_step(cfg, max_len)
    toks = torch.as_tensor(rng.integers(2, cfg.vocab, (REC_BATCH, REC_PROMPT)),
                           dtype=torch.int32, device=params.embed.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(params, toks)             # eager, and the capture
    logits.argmax(-1).cpu()
    first_ms = (time.perf_counter() - t0) * 1e3
    with plain_kernels():
        plain_logits, plain_cache = model_lib.prefill(params, cfg, toks,
                                                      max_len)
    row, ok = greedy_check(logits, plain_logits, cfg.vocab)
    ref_states = state_leaves(cfg, plain_cache)
    states = {}
    for key, got in state_leaves(cfg, cache).items():
        ref = ref_states[key].float()
        states[key] = (float((got.float() - ref).abs().max())
                       / max(float(ref.abs().max()), 1e-30))
    worst = max(states, key=states.get)
    row = {"phase": phase, "check": "prefill_kernels_vs_plain", "arch": name,
           "B": REC_BATCH, "T": REC_PROMPT, **row,
           "state_max_rel_diff": states[worst], "state_worst": worst,
           "state_rel_tol": LOGIT_REL_TOL}
    emit(row)
    assert row["finite"] and ok, row
    assert row["max_abs_logit_diff"] <= row["tol"], row
    assert states[worst] <= LOGIT_REL_TOL, row
    del plain_cache, ref_states

    # the graph's replay against the eager first call: bit for bit
    same = same_prefill(prefill(params, toks), (logits, cache))
    emit({"phase": phase, "check": "prefill_graphed_vs_eager", "arch": name,
          "B": REC_BATCH, "T": REC_PROMPT, "bit_equal": same,
          "first_call_ms": first_ms, "captures": len(prefill.graphs)})
    assert same and len(prefill.graphs) == 1, name

    # a prompt of a new length: the step's first call for it (eager, then a
    # capture into the pool the first shape's graph shares), its replay and
    # the eager prefill, timed; both shapes' replays stay bit-equal
    short = toks[:, :REC_PROMPT // 2].contiguous()
    new_ms = {}
    for mode in ("first_call", "replay", "eager"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = (model_lib.prefill(params, cfg, short, max_len)
               if mode == "eager" else prefill(params, short))
        out[0].argmax(-1).cpu()
        new_ms[mode] = (time.perf_counter() - t0) * 1e3
        if mode == "first_call":
            short_out = out
        elif mode == "replay":
            same = same_prefill(out, short_out)
    del out, short_out
    same_again = same_prefill(prefill(params, toks), (logits, cache))
    emit({"phase": phase, "check": "prefill_new_shape", "arch": name,
          "B": REC_BATCH, "T": REC_PROMPT // 2,
          **{f"{k}_ms": v for k, v in new_ms.items()},
          "replay_bit_equal": same, "first_shape_still_equal": same_again,
          "captures": len(prefill.graphs)})
    assert same and same_again and len(prefill.graphs) == 2, name

    # one decode step from that cache, through the kernels and through the
    # plain versions (RecurrentGemma's attention in float32 against B3,
    # which rounds P to bf16 for P V), each on a copy of the cache
    first = logits.argmax(-1).to(torch.int32)
    got, _ = model_lib.decode_step(params, cfg, steps.clone_cache(cache), first)
    with plain_kernels():
        ref, _ = model_lib.decode_step(params, cfg, steps.clone_cache(cache),
                                       first)
    row, ok = greedy_check(got, ref, cfg.vocab)
    row = {"phase": phase, "check": "decode_kernels_vs_plain", "arch": name,
           "B": REC_BATCH, "pos": REC_PROMPT, **row}
    emit(row)
    assert row["finite"] and ok, row
    assert row["max_abs_logit_diff"] <= row["tol"], row

    # REC_DECODE greedy steps replayed from a CUDA graph, and the same run
    # eagerly (the model's step) from a copy of the cache: bit-equal
    # logits; each step synchronised and timed (the graph's first: the copy
    # of the cache into the step's own and the capture)
    before = counters()
    runs = {}
    for mode, c in (("graphed", cache), ("eager", steps.clone_cache(cache))):
        step = (steps.make_decode_step(cfg) if mode == "graphed" else
                lambda p, c, t: model_lib.decode_step(p, cfg, c, t))
        tok, outs, step_ms = first, [], []
        for _ in range(REC_DECODE):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, c = step(params, c, tok)
            tok = out.argmax(-1).to(torch.int32)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            outs.append(out)
        runs[mode] = (outs, step_ms, c)
    graphed, eager = runs["graphed"][0], runs["eager"][0]
    same = all(torch.equal(a, b) for a, b in zip(graphed, eager))
    tokens = torch.stack([o.argmax(-1) for o in graphed], 1).cpu()
    want = dict(before)
    want["decode_attn"] += 2 * REC_DECODE * b3_launches_per_decode(cfg)
    assert counters() == want, (counters(), want)
    logits, cache = graphed[-1], runs["graphed"][2]
    assert same, (name, "graphed and eager decodes differ")
    assert bool(torch.isfinite(logits).all()) and int(cache["pos"]) == max_len
    assert int(runs["eager"][2]["pos"]) == max_len
    dec = {mode: {"first": run[1][0], "mean": float(np.mean(run[1][1:])),
                  "min": float(np.min(run[1][1:])),
                  "median": float(np.median(run[1][1:])),
                  "max": float(np.max(run[1][1:])),
                  "slowest_step": int(np.argmax(run[1][1:])) + 1}
           for mode, run in runs.items()}
    del runs, graphed, eager

    pre_ms = {"graphed": [], "eager": []}
    for mode in ("graphed", "eager", "graphed", "eager"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, _ = (prefill(params, toks) if mode == "graphed" else
                  model_lib.prefill(params, cfg, toks, max_len))
        out.argmax(-1).cpu()
        pre_ms[mode].append((time.perf_counter() - t0) * 1e3)
    emit({"phase": phase, "check": "serve", "arch": name, "B": REC_BATCH,
          "prompt": REC_PROMPT, "decode_steps": REC_DECODE,
          "prefill_ms": pre_ms, "decode_ms_per_step": dec["graphed"]["mean"],
          "eager_decode_ms_per_step": dec["eager"]["mean"],
          "decode_step_ms": dec,
          "graphed_equals_eager_logits": same,
          "tokens_row0": tokens[0].tolist(),
          "max_memory_allocated": torch.cuda.max_memory_allocated()})
    window, passes = recurrent_window(params, cfg, toks)
    emit({"phase": "lm_profile", "arch": name, **window})
    del prefill

    long = torch.as_tensor(rng.integers(2, cfg.vocab, (1, REC_LONG)),
                           dtype=torch.int32, device=toks.device)
    long_step = steps.make_prefill_step(cfg, REC_LONG + REC_DECODE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eager_out = long_step(params, long)               # eager, and the capture
    eager_out[0].argmax(-1).cpu()
    long_ms = {"first_call": (time.perf_counter() - t0) * 1e3}
    for mode in ("graphed", "eager"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = (long_step(params, long) if mode == "graphed" else
               model_lib.prefill(params, cfg, long, REC_LONG + REC_DECODE))
        out[0].argmax(-1).cpu()
        long_ms[mode] = (time.perf_counter() - t0) * 1e3
        if mode == "graphed":
            logits, cache = out
    del out
    want = scan_kernels_per_pass(cfg, REC_LONG)
    _, kernels, takes = profiled(
        lambda: long_step(params, long)[0].argmax(-1).cpu(), want,
        f"{name} 1 x {REC_LONG} prefill")
    traced_long = {}
    traced(traced_long, kernels, want)
    row = {"phase": phase, "check": "long_prefill", "arch": name, "B": 1,
           "T": REC_LONG, "prefill_ms": long_ms["graphed"],
           "eager_prefill_ms": long_ms["eager"],
           "first_call_ms": long_ms["first_call"],
           "graphed_equals_eager": same_prefill((logits, cache), eager_out),
           "traced_replay": {key: traced_long[key] for key in (
               "b5_launches", "b5_ms", "b6_launches", "b6_ms",
               "traced_launches_expected")},
           "traced_replays": takes,
           "finite": bool(torch.isfinite(logits).all()),
           "max_memory_allocated": torch.cuda.max_memory_allocated()}
    if cfg.family == "hybrid":               # the ring holds the last window
        ring = next(st for st in cache["layers"] if "kv_pos" in st)["kv_pos"]
        w = ring.shape[1]
        kept = torch.arange(REC_LONG - w, REC_LONG, device=ring.device)
        assert torch.equal(ring[0].sort().values, kept.to(ring.dtype))
        assert torch.equal(ring[0] % w, torch.arange(w, device=ring.device))
        row["ring"] = {"slots": w, "first": int(kept[0]), "last": REC_LONG - 1}
    emit(row)
    assert row["finite"] and row["graphed_equals_eager"], row
    del long_step, eager_out, logits, cache
    # by T: checked, replayed, the first shape's replay after the new
    # length's, timed (2 graphed, 2 eager), the window's; the new length
    # (first call, replay, eager); long (3 and the traced replays)
    return {"prefill": {REC_PROMPT: 1 + 1 + 1 + 4 + passes["prefill"],
                        REC_PROMPT // 2: 3, REC_LONG: 3 + takes},
            "decode": 1 + 2 * REC_DECODE + passes["decode"]}


def lm_recurrent_phase(dev):
    """rwkv6-7b and recurrentgemma-2b at their published widths in bf16,
    after the earlier clusters are freed; the counted main path is every
    call of ``recurrent_serve``."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as model_lib

    recurrent_small_matches_cpu(dev, "lm_recurrent")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    models = [(name, get_config(name),
               model_lib.init_params(get_config(name), seed=seed, device=dev))
              for name, seed in RECURRENT]
    torch.cuda.synchronize()
    emit({"phase": "lm_recurrent", "check": "build", "models": [
              {"name": name, "family": cfg.family, "n_layers": cfg.n_layers,
               "seed": seed,
               "params": sum(p.numel() for p in params.parameters()),
               "bytes": sum(p.numel() * p.element_size()
                            for p in params.parameters()),
               "dtype": cfg.param_dtype}
              for (name, cfg, params), (_, seed) in zip(models, RECURRENT)],
          "reduced": {}, "init_s": time.perf_counter() - t0,
          "max_memory_allocated": torch.cuda.max_memory_allocated()})
    rng = np.random.default_rng(12)
    reset_counters()
    expected = dict.fromkeys(counters(), 0)
    kernels = {"rwkv6_scan": 0, "rglru_scan": 0}   # calls x kernels per call
    for name, cfg, params in models:
        passes = recurrent_serve(params, cfg, name, rng, "lm_recurrent")
        for n_t, n_pass in passes["prefill"].items():
            for k, v in scan_launches_per_pass(cfg).items():
                expected[k] += n_pass * v
            per_pass = scan_kernels_per_pass(cfg, n_t)
            kernels["rwkv6_scan"] += n_pass * per_pass["b5"]
            kernels["rglru_scan"] += n_pass * per_pass["b6"]
        expected["decode_attn"] += passes["decode"] * b3_launches_per_decode(cfg)
    got = counters()
    emit({"phase": "lm_recurrent", "check": "launches", "launches": got,
          "expected": expected, "scan_kernels_launched": kernels,
          "max_memory_allocated": torch.cuda.max_memory_allocated()})
    assert got == expected, (got, expected)
    del models
    torch.cuda.empty_cache()
    return got, kernels


# ---------------------------------------------------------------------------
# Phase 21: the enc-dec family (whisper-medium) at full width
# ---------------------------------------------------------------------------

ENCDEC_STREAMS = 4
ENCDEC_FRAMES = 1500        # Whisper's 30 s window after the conv stem
ENCDEC_DECODES = 32
ENCDEC_TRAIN_TOKENS = 128
ENCDEC_TRAIN_STEPS = 3
WHISPER_PARAMS = 814_190_592
WHISPER_SOT = 50258         # <|startoftranscript|>, the decoder's first token


def spread_ms(times) -> dict:
    ms = np.asarray(times) * 1e3
    return {"min_ms": float(ms.min()), "median_ms": float(np.median(ms)),
            "max_ms": float(ms.max())}


def encdec_window(label, run, n, expected) -> None:
    """``run()`` (``n`` replayed prefills or decode steps) timed, then
    under torch.profiler (``profiled``): per call the wall ms, the
    device's busy ms, its idle share against the unprofiled wall time, the
    kernels, and B2's and B3's launches and ms (``traced``)."""
    t = synced()
    run()
    wall_ms = (synced() - t) * 1e3 / n
    _, kernels, takes = profiled(run, expected, label)
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / n
    row = {"phase": "lm_encdec", "check": "window", "window": label,
           "calls": n, "wall_ms_per_call": wall_ms,
           "device_busy_ms_per_call": busy_ms,
           "device_idle_share": 1.0 - busy_ms / wall_ms,
           "kernels_per_call": len(kernels) / n, "trace_takes": takes}
    traced(row, kernels, expected)
    emit(row)


def encdec_plain_vs_kernel(params, cfg, frames, fed, sot) -> None:
    """The prefill's cross cache, one decode step from it and the
    teacher-forced forward on ``fed``, through the kernels and through
    their plain versions, same weights and inputs (module docstring)."""
    from repro_torch.models import model as model_lib

    def run():
        with torch.no_grad():
            cache = model_lib.prefill(params, cfg, {"frames": frames},
                                      ENCDEC_FRAMES)
            cross = {k: cache[k].clone() for k in ("cross_k", "cross_v")}
            dec, _ = model_lib.decode_step(params, cfg, cache, sot)
            del cache
            tf, _ = model_lib.forward(params, cfg, {"frames": frames,
                                                    "tokens": fed})
        return {**cross, "decode": dec[:, :cfg.vocab],
                "forward": tf[..., :cfg.vocab]}

    got = run()
    with plain_kernels():
        ref = run()
    for k, plain in ref.items():
        a, b = got[k].float(), plain.float()
        err = float((a - b).abs().max())
        scale = float(b.abs().max())
        row = {"phase": "lm_encdec", "check": f"{k}_kernels_vs_plain",
               "shape": list(b.shape), "max_abs_diff": err,
               "max_abs_plain": scale, "tol": LOGIT_REL_TOL * scale,
               "finite": bool(torch.isfinite(a).all())}
        if k in ("decode", "forward"):
            top2 = torch.topk(b, 2, dim=-1).values
            sure = (top2[..., 0] - top2[..., 1]) > 2 * err
            same = a.argmax(-1) == b.argmax(-1)
            row.update(greedy_agreement=float(same.float().mean()),
                       greedy_checked=int(sure.sum()),
                       greedy_differs_where_sure=int((sure & ~same).sum()))
        emit(row)
        assert row["finite"], row
        assert err <= LOGIT_REL_TOL * scale, row
        assert row.get("greedy_differs_where_sure", 0) == 0, row
    del got, ref
    free_cuda()


def encdec_serve(params, cfg, dev) -> dict:
    """Prefill (eager first call and its graph's replay, bit-equal), 32
    greedy decodes graphed and eager (bit-equal logits and caches), and
    the teacher-forced forward on the decoded tokens against the decode's
    logits; returns the launch counts of that run (module docstring).
    Then ``encdec_plain_vs_kernel``, the prefill's, the eager prefill's
    and the forward's times, and a
    profiled window of a prefill and of 8 decode steps, graphed."""
    from repro_torch.launch import steps
    from repro_torch.models import model as model_lib

    b, s = ENCDEC_STREAMS, ENCDEC_FRAMES
    gen = torch.Generator(device=dev).manual_seed(1)
    frames = torch.randn((b, s, cfg.d_model), generator=gen,
                         device=dev).to(torch.bfloat16)
    prefill = steps.make_prefill_step(cfg, s)
    reset_counters()
    t = synced()
    eager_cache = prefill(params, {"frames": frames})   # eager, the capture
    first_s = synced() - t
    per_prefill = counters()["flash_attn"]
    cache = prefill(params, {"frames": frames})          # a replay
    assert counters()["flash_attn"] == 2 * per_prefill == 2 * cfg.n_enc_layers
    for k in cache:
        assert torch.equal(cache[k], eager_cache[k]), k
    cache_bytes = sum(x.numel() * x.element_size() for x in cache.values())
    del eager_cache

    sot = torch.full((b,), WHISPER_SOT, dtype=torch.int32, device=dev)
    decode = steps.make_decode_step(cfg)
    eager = lambda p, c, tok: model_lib.decode_step(p, cfg, c, tok)
    runs = {}
    for name, fn, c in (("eager", eager, steps.clone_cache(cache)),
                        ("graphed", decode, cache)):
        seen, carry = [], {"cache": c, "tok": sot}

        def one(_, fn=fn, seen=seen, carry=carry):
            logits, carry["cache"] = fn(params, carry["cache"], carry["tok"])
            seen.append(logits)
            carry["tok"] = logits[:, :cfg.vocab].argmax(-1).to(torch.int32)

        before = counters()["decode_attn"]
        times = timed_iterations(one, 0, ENCDEC_DECODES)
        assert (counters()["decode_attn"] - before
                == ENCDEC_DECODES * 2 * cfg.n_layers), name
        runs[name] = (torch.stack(seen, 1), carry["cache"], times)
    (ge, gc, g_times), (ee, ec, e_times) = runs["graphed"], runs["eager"]
    assert torch.equal(ge, ee)
    for k in gc:
        assert torch.equal(gc[k], ec[k]), k
    assert int(gc["pos"]) == ENCDEC_DECODES
    fed = torch.cat([sot[:, None], ge[:, :-1, :cfg.vocab].argmax(-1).to(
        torch.int32)], 1)
    before = counters()["flash_attn"]
    with torch.no_grad():
        tf, _ = model_lib.forward(params, cfg, {"frames": frames,
                                                "tokens": fed})
    per_forward = counters()["flash_attn"] - before
    assert per_forward == cfg.n_enc_layers + 2 * cfg.n_layers
    got = counters()
    real = slice(0, cfg.vocab)
    err = float((ge[..., real].float() - tf[..., real].float()).abs().max())
    scale = float(tf[..., real].float().abs().max())
    agree = float((ge[..., real].argmax(-1) == tf[..., real].argmax(-1))
                  .float().mean())
    emit({"phase": "lm_encdec", "check": "serve", "streams": b, "frames": s,
          "max_len": s, "cache_bytes": cache_bytes,
          "prefill_first_call_s": first_s,
          "flash_per_prefill": per_prefill, "flash_per_forward": per_forward,
          "decode_attn_per_decode": 2 * cfg.n_layers,
          "decodes": ENCDEC_DECODES, "graphed_equals_eager": True,
          "decode_graphed": spread_ms(g_times),
          "decode_eager": spread_ms(e_times),
          "teacher_forced_max_abs_err": err, "largest_logit": scale,
          "tol": LOGIT_REL_TOL * scale, "greedy_agreement": agree})
    if not err <= LOGIT_REL_TOL * scale:
        raise AssertionError(f"whisper decode vs teacher-forced forward: "
                             f"{err} above {LOGIT_REL_TOL} x {scale}")
    del runs, ge, ee, ec, tf, cache
    # outside the counted run: the kernels against their plain versions,
    # times, and where they go
    encdec_plain_vs_kernel(params, cfg, frames, fed, sot)
    timing = {"prefill_graphed_ms": cuda_ms(
        lambda: prefill(params, {"frames": frames}), 5),
        "prefill_eager_ms": cuda_ms(lambda: model_lib.prefill(
            params, cfg, {"frames": frames}, s), 5),
        "forward_ms": cuda_ms(lambda: model_lib.forward(
            params, cfg, {"frames": frames, "tokens": fed}), 5)}
    emit({"phase": "lm_encdec", "check": "serve_times", **timing})
    encdec_window("prefill", lambda: prefill(params, {"frames": frames}), 1,
                  {"b2": cfg.n_enc_layers, "b3": 0})
    n_dec = 8

    def decodes():
        for _ in range(n_dec):                   # the step's own cache
            decode(params, gc, sot)

    encdec_window("decode", decodes, n_dec,
                  {"b2": 0, "b3": n_dec * 2 * cfg.n_layers})
    del prefill, decode, gc
    free_cuda()
    return got


def encdec_train(cfg, dev) -> dict:
    """``make_train_step`` with AdamW on 4 x 1,500 frames and 4 x 128
    tokens: 3 steps graphed against 3 eager from the same weights, every
    parameter and state tensor bit-equal; ms a step and peak memory; the
    step's parts each captured alone (``train_step_layers``)."""
    from repro_torch.launch import steps
    from repro_torch.models import model as model_lib
    from repro_torch.train import optimizer as opt_lib

    gen = torch.Generator(device=dev).manual_seed(2)
    b = ENCDEC_STREAMS
    batch = {"frames": torch.randn((b, ENCDEC_FRAMES, cfg.d_model),
                                   generator=gen, device=dev).to(
                                       torch.bfloat16),
             "tokens": torch.randint(0, cfg.vocab, (b, ENCDEC_TRAIN_TOKENS),
                                     generator=gen, device=dev,
                                     dtype=torch.int32)}
    twins = {}
    for name, graphs in (("eager", False), ("graphed", True)):
        torch.cuda.reset_peak_memory_stats()
        params = model_lib.init_params(cfg, seed=0, device=dev)
        opt = opt_lib.make_optimizer("adamw", peak_lr=3e-4, warmup_steps=0,
                                     total_steps=ENCDEC_TRAIN_STEPS)
        st = steps.train_state(cfg, params, opt)
        step = steps.make_train_step(cfg, graphs=graphs)
        losses = []

        def one(_, st=st, step=step, losses=losses):
            _, m = step(st, batch)                  # updates st in place
            losses.append(float(m["loss"]))

        times = timed_iterations(one, 0, ENCDEC_TRAIN_STEPS)
        twins[name] = {"state": st, "step_s": times, "losses": losses,
                       "max_memory_allocated":
                           torch.cuda.max_memory_allocated()}
    assert twins["graphed"]["losses"] == twins["eager"]["losses"]
    assert all(np.isfinite(twins["graphed"]["losses"]))
    assert same_train_state(twins["graphed"]["state"],
                            twins["eager"]["state"])
    del twins["eager"]["state"]
    free_cuda()
    out = {"phase": "lm_encdec", "check": "train", "optimizer": "adamw",
           "remat": cfg.remat, "batch": b, "frames": ENCDEC_FRAMES,
           "tokens": ENCDEC_TRAIN_TOKENS,
           "graphed_equals_eager_steps": ENCDEC_TRAIN_STEPS,
           "layers_ms": train_step_layers(twins["graphed"]["state"], cfg,
                                          dev, batch)}
    for name, tw in twins.items():
        out[name] = {"step_s": tw["step_s"], "losses": tw["losses"],
                     "ms_per_step": float(np.median(tw["step_s"][1:])) * 1e3,
                     "max_memory_allocated": tw["max_memory_allocated"]}
    emit(out)
    del twins
    free_cuda()
    return out


def encdec_serve_phase(dev) -> dict:
    """whisper-medium's serving half (module docstring); returns its
    counted run's launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as model_lib

    cfg = get_config("whisper-medium")
    params = model_lib.init_params(cfg, seed=0, device=dev)
    assert model_lib.count_params(params) == WHISPER_PARAMS
    got = encdec_serve(params, cfg, dev)
    del params
    free_cuda()
    return got


def encdec_train_phase(dev) -> None:
    from repro_torch.configs import get_config

    encdec_train(get_config("whisper-medium"), dev)


def lm_encdec_phase(dev) -> dict:
    """whisper-medium at its published widths in bf16 (module docstring):
    serving, then training; returns the serving run's launch counts."""
    got = encdec_serve_phase(dev)
    encdec_train_phase(dev)
    return got


TOOLING_EXAMPLE_REQUESTS = 12
TOOLING_PEAK_TOL = 0.15
TOOLING_GRAPHED_STEPS = 6


def tooling_phase(dev) -> dict:
    """The tooling (module docstring): the cost counter on the card against
    the meta run, the peak against the dry run's prediction, the step's
    counts against the card's peak rates, the serving example."""
    import importlib.util

    from repro_torch.configs import get_config
    from repro_torch.core import introspect
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch import cost_analysis, mesh as mesh_lib, steps
    from repro_torch.models import io, model as model_lib
    from repro_torch.train import optimizer as opt_lib

    cfg = get_config("qwen1.5-0.5b")
    opt = opt_lib.make_optimizer(cfg.optimizer)
    batch = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=128,
                                   global_batch=8), device=dev).batch(0)
    meta_state = steps.train_state(cfg, io.empty_model(cfg, "meta"), opt)
    meta_batch = {k: torch.empty_like(x, device="meta")
                  for k, x in batch.items()}
    meta = cost_analysis.CostCounter(
        steps.arg_tensors((meta_state, meta_batch)))
    with meta:
        steps.make_train_step(cfg)(meta_state, meta_batch)
    del meta_state

    free_cuda()
    state = steps.train_state(cfg, model_lib.init_params(cfg, seed=0,
                                                         device=dev), opt)
    eager = steps.make_train_step(cfg, graphs=False)
    eager(state, batch)                              # the warm-up step
    torch.cuda.synchronize()
    args = steps.arg_tensors((state, batch))
    before = torch.cuda.memory_allocated()
    card = cost_analysis.CostCounter(args)
    with card:
        peak = introspect.peak_bytes(eager, state, batch)
    got, want = card.totals.as_dict(), meta.totals.as_dict()
    if got != want:
        raise AssertionError(f"the counter on the card {got} differs from "
                             f"the meta run's {want}")
    assert card.argument_bytes == meta.argument_bytes
    other = before - meta.argument_bytes
    predicted = meta.argument_bytes + meta.peak_bytes + other
    share = peak / predicted
    if not abs(share - 1.0) <= TOOLING_PEAK_TOL:
        raise AssertionError(f"peak {peak} is {share} of the predicted "
                             f"{predicted}")
    del eager
    timed_steps = graphed_steps(state, cfg, batch, TOOLING_GRAPHED_STEPS)
    step_s = timed_steps["graphed_ms_per_step"] / 1e3
    tot = meta.totals
    flops_s = tot.flops / mesh_lib.PEAK_FLOPS_BF16
    bytes_s = tot.memory_bytes / mesh_lib.HBM_BW
    out = {"phase": "tooling", "model": cfg.name, "dtype": cfg.param_dtype,
           "global_batch": 8, "seq_len": 128, "optimizer": cfg.optimizer,
           "counter_card_equals_meta": True, "totals": want,
           "argument_bytes": meta.argument_bytes,
           "temp_bytes": meta.peak_bytes,
           "allocated_before_step": before,
           "held_beyond_arguments": other,
           "predicted_peak_bytes": predicted, "peak_bytes": peak,
           "peak_over_predicted": share,
           "graphed_ms_per_step": timed_steps["graphed_ms_per_step"],
           "flops_at_peak_ms": flops_s * 1e3,
           "bytes_at_hbm_rate_ms": bytes_s * 1e3,
           "flops_fraction_of_step": flops_s / step_s,
           "bytes_fraction_of_step": bytes_s / step_s,
           "peak_flops_bf16": mesh_lib.PEAK_FLOPS_BF16,
           "hbm_bytes_per_s": mesh_lib.HBM_BW}
    del state, timed_steps
    free_cuda()

    path = os.path.join(ROOT, "examples", "serve_cluster_torch.py")
    spec = importlib.util.spec_from_file_location("serve_cluster_torch", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    served = example.main(["--requests", str(TOOLING_EXAMPLE_REQUESTS)])
    for router in ("rr", "sqf"):
        m = served[router]
        assert m["completed"] == TOOLING_EXAMPLE_REQUESTS, (router, m)
        out[f"example_{router}"] = {k: m[k] for k in (
            "avg_qos", "avg_latency_per_token_ms",
            "p95_latency_per_token_ms", "completed", "tokens_per_s")}
    out["example_fits"] = served["fits"]
    emit(out)
    free_cuda()
    return out


def kernel_line(name, source, replaces, launches, row, library_ms):
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{source}",
            "replaces": replaces, "launches": launches,
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": library_ms}


def only_phases(names, dev, timed) -> None:
    """Some phases alone (module docstring): no kernel line."""
    from repro_torch.launch import mesh as mesh_lib

    known = {"predictor": predictor_phase, "lm_train": lm_train_phase,
             "lm_recurrent_train": lm_recurrent_train_phase,
             "shard_engine": shard_engine_runs, "lm_mesh": lm_mesh_phase,
             "lm_encdec": lm_encdec_phase, "flash": flash_phase,
             "decode_attn": decode_attn_phase, "tooling": tooling_phase}
    for name in names:
        if name not in known:
            raise SystemExit(f"unknown phase {name!r}; known: {sorted(known)}")
        if name == "shard_engine":
            world = mesh_lib.init_world(dev)
            try:
                timed(name, known[name], world)
            finally:
                mesh_lib.close_world()
        else:
            timed(name, known[name], dev)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check "
              "needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = gpu_line()
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(build.KERNEL_FLAGS)) as pool:
        ptxas = pool.map(lambda name: ptxas_report(build, name),
                         build.KERNEL_FLAGS)
        build.build_all()
        build_s = time.perf_counter() - t0
        ptxas = dict(zip(build.KERNEL_FLAGS, ptxas))
    # every library loaded before the first profiler session: with one
    # loaded after the tracer first started, later sessions miss kernel
    # records
    for name in build.KERNEL_FLAGS:
        build.load(name)
    nvcc = subprocess.run([build.nvcc(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60).stdout
    emit({"phase": "env", "gpu": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "nvcc": nvcc.strip().splitlines()[-1], "build_s": build_s,
          "device_count": torch.cuda.device_count(),
          "ptxas": ptxas})

    seconds = {"build": build_s}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t
        return out

    if len(sys.argv) > 1:
        only_phases(sys.argv[1:], dev, timed)
        emit({"phase": "seconds", **seconds,
              "total": time.perf_counter() - t0})
        print(card, flush=True)
        emit({"ok": None, "partial": sys.argv[1:]})
        return 0

    # phases 10 and 11's per-pass traces, first (see scan_pass_times)
    passes = timed("rwkv6_scan", scan_pass_times, dev)
    kernel = timed("kernel", kernel_phase, dev, 16, 1024, 100, KERNEL_CHECKED)
    timed("kernel", kernel_phase, dev, 4, 6, 100, 40)   # the N=6 x 4 rows
    launches, _ = timed("serve", serve_phase, dev, 6, 4, 750, 20, "padded",
                        False, 0)
    more, _ = timed("serve", serve_phase, dev, 1024, 16, 200, 12,
                    "segments", True, 0)
    launches += more
    flash = timed("flash", flash_phase, dev)
    decode = timed("decode_attn", decode_attn_phase, dev)
    gemm = timed("moe_gemm", moe_gemm_phase, dev)
    dense = timed("lm_serve", lm_serve_phase, dev)
    mixed = timed("lm_moe", lm_moe_phase, dev)
    recurrent, scan_kernels = timed("lm_recurrent", lm_recurrent_phase, dev)
    whisper = timed("lm_encdec", encdec_serve_phase, dev)
    wkv = timed("rwkv6_scan", rwkv6_scan_phase, dev, passes)
    lru = timed("rglru_scan", rglru_scan_phase, dev, passes)
    # the training phases last: their graphs, backward passes and profiled
    # windows come after every LM trace is held
    more, trained, unsharded = timed("train", train_phase, dev)
    launches += more
    launches += timed("train_scale", train_scale_phase, dev)
    launches += timed("scenario", scenario_phase, dev, trained)
    launches += timed("train_cli", train_cli_phase, dev)
    del trained
    launches += timed("sharded", sharded_phase, dev, unsharded)
    del unsharded
    timed("predictor", predictor_phase, dev)
    timed("lm_train", lm_train_phase, dev)
    timed("tooling", tooling_phase, dev)
    timed("lm_recurrent_train", lm_recurrent_train_phase, dev)
    on_mesh = timed("lm_mesh", lm_mesh_phase, dev)
    timed("lm_encdec", encdec_train_phase, dev)
    emit({"phase": "seconds", **seconds,
          "total": time.perf_counter() - t0})
    lm = {k: dense[k] + mixed[k] + recurrent[k] + on_mesh[k] + whisper[k]
          for k in dense}

    flash_row = next(r for r in flash
                     if (r["expert_heads"], r["S"], r["dtype"]) == LINE_CASE)
    decode_row = next(r for r in decode if (r["expert_heads"], r["S"],
                                            r["dtype"]) == DECODE_LINE_CASE)
    gemm_rows = {r["name"]: r for r in gemm
                 if (r["C"], r["dtype"]) == MOE_LINE_CASE}
    wkv_row = next(r for r in wkv if (r["B"], r["T"], r["dtype"]) == WKV_LINE_CASE)
    lru_row = next(r for r in lru if (r["B"], r["T"], r["dtype"]) == LRU_LINE_CASE)
    moe_src = "src/repro/kernels/moe_gemm/kernel.py"
    emit({"kernels": [
        {"name": "lockstep_advance", "route": "cuda",
         "source": "src/repro_torch/csrc/lockstep_advance.cu",
         "replaces": "src/repro/kernels/lockstep_advance/kernel.py:223",
         "launches": launches, "max_abs_err": kernel["max_abs_err"],
         "ms": kernel["ms"], "plain_ms": kernel["plain_ms"],
         "bound_ms": kernel["bound_ms"], "bound_by": kernel["bound_by"],
         "library_ms": None},
        kernel_line("flash_attn", "flash_attn.cu",
                    "src/repro/kernels/flash_attn/kernel.py:78",
                    lm["flash_attn"], flash_row, flash_row["library_ms"]),
        kernel_line("decode_attn", "decode_attn.cu",
                    "src/repro/kernels/decode_attn/kernel.py:73",
                    lm["decode_attn"], decode_row, decode_row["library_ms"]),
        kernel_line("grouped_gemm", "moe_gemm.cu", f"{moe_src}:65",
                    lm["grouped_gemm"], gemm_rows["grouped_gemm"],
                    gemm_rows["grouped_gemm"]["library_ms"]),
        kernel_line("grouped_swiglu", "moe_gemm.cu", f"{moe_src}:88",
                    lm["grouped_swiglu"], gemm_rows["grouped_swiglu"], None),
        {**kernel_line("rwkv6_scan", "rwkv6_scan.cu",
                       "src/repro/kernels/rwkv6_scan/kernel.py:66",
                       lm["rwkv6_scan"], wkv_row, None),
         "functions": list(TRACE_KERNELS["b5"]),
         "kernels_launched": scan_kernels["rwkv6_scan"]},
        {**kernel_line("rglru_scan", "rglru_scan.cu",
                       "src/repro/kernels/rglru_scan/kernel.py:45",
                       lm["rglru_scan"], lru_row, None),
         "functions": list(TRACE_KERNELS["b6"]),
         "kernels_launched": scan_kernels["rglru_scan"]}]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
