#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` and
runs these phases; any failure exits non-zero:

1. environment: the card, its power limit, torch and CUDA versions, the
   kernel build (seconds and each kernel's registers and spills);
2. every kernel against its plain PyTorch version on the card, at the main
   paths' shapes and at edge shapes, with the tolerance stated per case
   (``tte_sample`` also on ties across the blocks of a row's cluster, a
   +inf row, row-strided views and logits aligned otherwise than the
   uniforms, each in one launch; ``flash_attention`` also with position
   masks in fp32 and bf16 against ``suffix_prefill_attention_ref`` at
   ``tests/test_kernels.py``'s suffix cases and Delphi-2M's chunk, the
   padded rows exact zeros, and its index route bit-equal to the position
   route at a head chunk; flash and paged also at the dense LMs' shapes:
   GQA 32/4 hd 64, 32/8 hd 80 with a window of 4,096 past it, G 8 hd 64
   and G 4 hd 80 in a 5,120-token ring with the window; and at Zamba2's:
   ``ssd_intra`` at 8 chunks x 64 heads with N 64, flash as MHA 32/32 at hd
   64 and S 1,024, paged on a ring of B 8, Hkv 32, G 1, hd 64, W 4,096; and
   at the MoE LMs': flash as MHA 16/16 at hd 128, B 8, S 1,024, paged on a
   partly filled ring of B 8, Hkv 16, G 1, hd 128, W 1,024; and at the
   zoo's, each in bf16 and fp32: flash as GQA 48/8 at hd 128, B 8, S 1,024
   (InternVL2), bidirectional MHA 16/16 at hd 64, B 8, S = T = 4,096
   (SeamlessM4T's encoder), non-causal with 64 queries over 4,096 keys
   (its cross-attention prefill; ``FLASH_CROSS_CASES``), paged on a ring of
   B 8, Hkv 8, G 6, hd 128, W 1,280 and on a full cross ring of B 8, Hkv
   16, G 1, hd 64, W 4,096 at step W - 1; and at Qwen2.5-32B's and
   DeepSeek-7B's, each in bf16 and fp32: flash as GQA 40/8 at hd 128, B 8,
   S 1,024 and B 1, S 4,096 (causal), as MHA 32/32 at hd 128, B 8, S
   1,024, paged on partly filled rings of B 8, Hkv 8, G 5 (one query head
   a block) and of B 8, Hkv 32, G 1, hd 128, W 1,024, and on a full ring
   of B 1, Hkv 8, G 5, W 16,384; where 4,096 keys or more are visible (no
   window), also that the tolerance fails a kernel that dropped the last
   128 keys (causal: masked for every query), ``flash_drop_check`` and
   ``paged_drop_check``); then
   ``models/moe.py::apply_moe`` at Qwen2-MoE's widths, one layer, at T 8
   and T 2,048: the bf16 route against the same weights in fp32 (TF32
   off), within ``MOE_BF16_REL`` of the output's scale on the tokens whose
   routing cannot flip (the near-ties counted and left out); and its
   dispatches on the same layer at both T: ``ragged`` and
   ``dense_einsum`` against ``dense_scan`` in fp32 (TF32 off) within the
   CPU test's 1e-5, and in bf16 against the fp32 ``dense_scan`` within
   ``MOE_BF16_REL`` (near-ties left out), with the grouped product
   ``ragged`` ran (``torch._grouped_mm`` or the plain loop), each route's
   ms a layer, and whether ``ragged``'s rows keep their bits across T;
3. the Delphi path at full width: Delphi-2M (12 layers, d_model 120) from
   ``init_params(seed)`` in bf16, served by the ring-cache ``BatchedEngine``
   through ``repro_torch.launch.serve`` (32 synthetic patient prompts, 16
   slots, ``max_new`` 48).  Every request must finish, the engine must make
   exactly one device->host copy per tick and per admission batch, and each
   of the path's three kernels must have launched on it (launch counts are
   zeroed just before it and read just after it);
3b. the Mamba2 path at full width: Mamba2-780M (48 layers, d_model 1536,
   V 50280) from ``init_params(seed)`` in bf16 on ``BatchedEngine(slots=8)``
   with generator uniforms, 16 requests of seeded random token ids (prompts
   of 96-1024 tokens), ``max_new`` 32.  Every request must get its 32
   tokens, one host copy per tick and per admission, every prefill shape
   ``(1, S)``, and ``ssd_intra`` must launch once per layer per admission
   (counts zeroed just before, read just after);
3c. the paged Delphi path at full width: the same model, prompts and seed
   served through ``repro_torch.launch.serve --cache paged`` (16 slots,
   ``max_context`` 256, 16-token blocks, the dense-equivalent pool of 257
   blocks).  Every request must finish, one host copy per tick and per
   admission batch, ``paged_decode_attention`` 12 launches a tick, flash
   and ``tte_sample`` launched, the pool drained to no used block; the
   trajectories must equal phase 3's bit for bit (the same generator
   draws through the same arithmetic);
3d. futures at full width: a prefix-cached paged engine (16 slots)
   ``sample_futures`` 16 futures of each of 4 synthetic patients
   (``max_new`` 48, generator uniforms), each patient twice; the second
   time the parent admits by reference with no prefill.  Forks, copies on
   write, shared blocks and prefix hits are printed; no block or refcount
   may be left after ``drop_prefix_cache()``;
3e. mixed long/short traffic at full width (``benchmarks/run.py``'s
   ``bench_chunked_prefill``): Delphi-2M bf16 on a paged engine (12 slots,
   ``max_context`` 256, 192 blocks), 6 short requests (6-event prompts, 48
   new events) and 6 long ones (200-event prompts, 4 new), one long every 8
   steps from step 3; monolithic and chunked prefill (64 tokens a step) in
   turns, twice each.  Events/s and the short requests' p50/p95 per-event
   latency per run; every request finishes, the pool drains, host copies =
   ticks + admission batches; the chunked run launches the position-masked
   flash 12 times a chunk;
3f. partial-hit suffix prefill: a prefix-cached chunked engine serves a
   200-event prompt, then a 240-event prompt extending it, which must
   prefill only its suffix (``suffix_tokens_saved`` = the 192 matched
   tokens);
3g. HTTP serving at full width: Delphi-2M bf16 on ``EngineBackend`` (phase
   3d's knobs: 16 slots, ``max_context`` 256, paged, prefix cache) behind
   ``InferenceServer``, the engine on its background loop.  Phase 3's 32
   prompts over ``/v1/generate`` from 8 concurrent ``RemoteBackend``
   clients with generator uniforms (48 new events), 8 ``/v1/stream``
   calls, phase 3d's 4 patients x 16 futures over ``/v1/futures`` and 4
   ``/v1/risk`` calls.  Every request answered with no error, host copies
   = ticks + admission batches, the three Delphi kernels launched on the
   HTTP run; events/s in turns (HTTP, in-process background twice, HTTP),
   the SSE time to first event (p50, p95) and the device idle share of one
   HTTP run; the streams' time to first event also against a server with
   the stdlib's listen backlog of 5 (the JAX package's), in turns.  On a
   fresh server and a fresh twin engine, one request at a
   time under injected uniforms: ``/v1/generate`` == the twin's generate
   bit for bit, ``/v1/stream`` == it, ``/v1/futures`` ==
   ``ring_reference_futures``; ``/v1/risk`` == ``core/risk.py`` on the
   card's logits.  The server's CLI boots as a subprocess (fp32 on the
   card) beside the futures, risk and exactness checks (after every
   timed run), then answers ``/v1/healthz`` and a generate, and exits 0
   on SIGINT;
3h. the router on one card: ``RouterServer`` over 2 in-process paged
   replicas; each of phase 3d's patients asked for futures twice, the
   second visit routed by affinity to the replica holding its prefix
   (whose prefix hits rise); one replica drained under 16 concurrent
   requests, every one answered; on a fresh router and a fresh direct
   server, router ``/v1/generate`` == the direct server's bit for bit;
3i. a cohort sweep at full width: ``ScenarioEngine`` over ``EngineBackend``
   (phase 3d's knobs, its background loop) samples 8 futures x 32 events
   for each of 32 patients (the first halves of ``patient(i,
   SimulatorConfig(seed=7))``), 4 in flight, in bf16; ``assert_sweep_parity``
   holds bit for bit on the first 4 patients in bf16 and in fp32; a paired
   counterfactual (two edits of a 40-event history) on a fresh engine hits
   the prefix cache once per arm; patients/s, events/s, the prefix hit rate,
   the three kernels' launches on the sweep, and the idle share of its first
   16 patients under the profiler;
3u. the reference engine: the seed host-loop ``ReferenceEngine``
   (full-width Delphi-2M, bf16, 8 slots, ``max_context`` 128, as
   ``benchmarks/run.py``'s ``bench_serving_engine``) on 16 synthetic
   prompts cut to 64 events, 24 new events each, after a warm drive:
   every request done, flash 12 launches an admission, paged 12 a decode
   call, ``tte_sample`` one an emitted event (counts zeroed just before
   and read just after); its events/s beside the ring ``BatchedEngine``'s
   on the same prompts, in turns, and each engine's idle share of a drive;
3j. the SDK artifact at full width: Delphi-2M exported by
   ``repro_torch.sdk.export_model`` (``torch.export`` traced on the CPU,
   in phase 1 while ``nvcc`` builds the kernels), spec v2 in bf16 (its
   depth cut to ``ARTIFACT_BF16_LAYERS`` layers), spec v2 and v1 in fp32
   (cut to ``ARTIFACT_FP32_LAYERS`` layers), checked with ``verify_checksums``
   (strict) and loaded with ``ArtifactBackend(device="cuda")``.  On 4
   patients: the full graph's logits == eager ``forward(mode="train")``
   bit for bit (and in fp32 v1's == v2's), prefill and 8 decode steps ==
   the same functions run eagerly bit for bit (logits and cache), with
   flash launched once a layer a full or prefill call and the paged
   kernel once a layer a decode step through the ``repro_torch::``
   operators; then ``ArtifactBackend`` == ``LocalBackend.stream`` token
   for token and age for age under injected uniforms, one request at a
   time.  Export seconds, artifact bytes and load seconds; in bf16: ms per
   event of a request through v2 decode and ``LocalBackend.stream``, ms
   per call of a v2 decode step and an eager decode step, and of the
   decode graph's ``forward`` against the eager function on the card's
   inputs, each in turns; the kernels' launches on a drive of the bf16 v2
   artifact, one request's idle share, and the host cost a call of each
   attention kernel through its wrapper and through its operator; the
   server CLI on ``--artifact`` (the fp32 v2 artifact) as a subprocess,
   booted while the fp32 artifact is gated, answers ``/v1/manifest``
   (with the artifact's manifest) and a generate, and exits 0 on SIGINT;
3k. TinyLlama-1.1B at full width (22 layers, d_model 2048, 32 query / 4
   key-value heads of 64, d_ff 5632, V 32000; RoPE, RMSNorm, SwiGLU, untied
   head) from ``init_params_on_device(seed)`` in bf16 on
   ``BatchedEngine(slots=8, max_context=1024)``, ring then paged (16-token blocks, prefix cache):
   8 requests of seeded random ids (64-768 tokens; the count cut from 16
   to keep the call in its time), 32 new tokens each.
   Every request gets its 32 tokens, one host copy a tick and an admission
   batch, flash 22 launches an admission batch, paged 22 a tick,
   ``tte_sample`` none, the pool drained; ring == paged == chunked (64
   tokens a step) bit for bit under injected uniforms (ring == paged over
   the 8 requests served together, chunked == unchunked on the shortest,
   the shortest ragged (164 tokens: chunks of 64, 64 and 36) and the
   longest, each served alone); tokens/s and the idle share of one
   profiled ring run;
3l. H2O-Danube-1.8B at full width (its depth cut from 24 to
   ``DANUBE_LAYERS`` layers; d_model 2560, 32/8 heads of 80, window 4,096)
   in bf16: one 4,600-token prompt with ``max_context``
   5,120.  The last prefill position's logits through the kernels (bf16)
   are as close to the fp32 model's (plain route, TF32 off) as the plain
   route's in bf16 are, within ``DENSE_LOGITS_VS_PLAIN`` times, and differ
   from a run with no window (the window bites); the prompt and 32 new
   tokens on the ring (the window's 4,096 wide) and on the paged cache
   (5,120-token tables) under injected uniforms, each run held step by
   step against the model's full forward (near-ties within twice the
   kernels' bf16 logits error), the tokens equal before the two runs part
   counted (the two decode walks order the window's positions differently);
3m. Delphi-100M served at full width (16 layers, d_model 768, hd 64)
   through ``repro_torch.launch.serve`` with phase 3's knobs (32 prompts,
   16 slots, 48 new events, ring): one host copy a tick and an admission
   batch, all three Delphi kernels launched, ages monotone;
3n. the generic-LM artifact: TinyLlama at full width with its depth cut to
   2 layers, exported (spec v2, bf16, ``seq_len`` 256; traced in phase 1,
   in 3t's export process beside ``nvcc``) and loaded on the card; on two prompts the full, prefill and 8 decode-step graphs ==
   the eager functions bit for bit, flash 2 launches a full or prefill
   call and paged 2 a decode step through the ``repro_torch::``
   operators, the decode graph's inputs ``(cache, token, step)``;
   ``ArtifactBackend`` == ``LocalBackend.stream`` and held margin-aware
   against the eager model's scores (``LM_MARGIN``);
3o. Zamba2-1.2B at full width (38 Mamba2 layers, d_model 2048, N 64, 64
   SSD heads; one weight-shared attention block, 32/32 heads of 64, window
   4,096, d_ff 8,192, applied before every 6th layer: 7 applications; V
   32000) from ``init_params_on_device(seed)`` in bf16 on
   ``BatchedEngine(slots=8, max_context=4096)``, its rings the window's 4,096 wide: 16 requests of
   seeded random ids (96-1024 tokens), 32 new tokens each.  Every request
   gets its 32 tokens, one host copy a tick and an admission, every
   prefill ``(1, S)``, ``ssd_intra`` 38 launches an admission, flash 7 an
   admission, paged 7 a tick, ``tte_sample`` none (counts zeroed just
   before, read just after); a held parent (parked 6 ticks beside other
   traffic) forked into 4 children == 4 immediate forks bit for bit under
   injected uniforms; the 1024-token prompt's last logits through the
   kernels against the fp32 model (plain route, TF32 off), within
   ``DENSE_LOGITS_VS_PLAIN`` times the plain route's bf16 error (the fp32
   model made from the same draws); tokens/s, the idle share of a
   profiled window (the first ``PROFILE_REQUESTS``
   prompts, ``PROFILE_MAX_NEW`` tokens each), the weights' making time;
3t. the recurrent artifact: Mamba2-780M and Zamba2-1.2B at full width,
   their depths cut to ``SSM_ARTIFACT_LAYERS`` (4 of 48, 7 of 38 Mamba2
   layers: 2 applications of the shared block), fp32 weights made on the
   card, exported (spec v2, bf16, ``seq_len`` 1,024, ``verify_checksums``
   strict; in phase 1, by a process of their own beside ``nvcc``) and
   loaded with ``ArtifactBackend``.  On seeded prompts of 96,
   500 and 1,024 tokens: the full and prefill graphs == the eager
   functions bit for bit (logits and every cache leaf), 8 decode steps
   too on the prompts shorter than the axis; ``ssd_intra`` launched once
   a Mamba layer a full or prefill call through ``repro_torch::ssd_intra``
   and never in a decode step, Zamba2's flash once an application a full
   or prefill call and paged once an application a decode step,
   ``tte_sample`` never.  The padded prompt's masked prefill (its last
   logits, and one decode step after it) against the fp32 model's
   exact-length prefill and step (plain route, TF32 off) within
   ``DENSE_LOGITS_VS_PLAIN`` times the eager kernel route's own bf16
   error at the exact length (3l's rule); the control, the padded prompt
   prefilled with no ``last_index`` (the state after the padding, as the
   reference's artifact decodes), farther off than that at the decode step
   on the 96- and 500-token prompts.  ``ArtifactBackend`` ==
   ``LocalBackend.stream`` token for token under injected uniforms (16
   tokens on the two shorter prompts), held margin-aware against the
   eager model's scores (``LM_MARGIN``); export and load seconds, bytes,
   ms a token of the drive and of a v2 decode step against an eager one in
   turns, the drive's launches and idle share under the profiler; host
   microseconds a call of ``ssd_intra`` through its wrapper and through
   the operator at 3b's prefill shape;
3p. OLMoE-1B-7B at full width (16 layers, d_model 2048, 16/16 heads of
   128, 64 experts of 1,024, top-8, V 50,304) in bf16, its weights made on
   the card (``init_params_on_device``), with 3k's knobs: the ring, then the
   prefix-cached paged cache; under injected uniforms ring == paged bit for
   bit on all 8 requests, chunked (64 tokens a step) == unchunked bit for
   bit on the shortest, the shortest ragged and the longest served alone;
   one host copy a tick and an admission batch, the pool drained, flash
   16 launches an
   admission batch (a chunk when chunked), paged 16 a tick, ``tte_sample``
   none; tokens/s, peak memory and a profiled ring window (3o's: the first
   ``PROFILE_REQUESTS`` prompts, ``PROFILE_MAX_NEW`` tokens each); the longest
   prompt's last logits against the fp32 model made from the same draws
   (3l's rule, ``DENSE_LOGITS_VS_PLAIN``), with the router choices the
   bf16 model flips, layer by layer;
3q. Qwen2-MoE-A2.7B at full width (24 layers, 16/16 heads of 128, QKV
   biases, 60 experts of 1,408, top-4, 4 shared experts, V 151,936): 3p's
   runs and gates, its peak memory asserted under the card's; the fp32
   comparison on a model cut to ``MOE_FP32_LAYERS`` layers at full width
   (57 GB of fp32 weights do not fit beside the bf16 model).  3p and 3q
   run last, after phase 5's other rows and profiles (their ring runs'
   large traces ahead of those rows cost the rows their device times);
3r. InternVL2-26B at full width and depth (48 layers, d_model 6,144, 48/8
   heads of 128, SwiGLU d_ff 16,384, V 92,553; 39.7 GB in bf16, its
   weights made on the card) through the model-level path of
   ``tests/test_models_smoke.py``: ``forward(mode="prefill",
   last_index=...)`` over 8 rows of 256 seeded N(0, 1) patch embeddings
   before 64-768 seeded text ids right-padded to 768 (S' 1,024, rings
   1,280 wide), ``mask_padded_positions``, then a greedy ``decode_step``
   loop at per-row steps (``text_offset`` + the text position) to 32 new
   tokens a row (``zoo_generate``), a warm drive and a timed one.  Every
   row gets its 32 tokens; flash 48 launches in the prefill, paged 48 a
   decode step, ``tte_sample`` and ``ssd_intra`` none (counts zeroed just
   before each); the patches move the longest row's last logits; on the
   model cut to ``MOE_FP32_LAYERS`` layers at full width, the longest
   row's last prefill logits and one ``decode_step`` after a prefill of
   all its tokens but the last, through the kernels in bf16, against the
   fp32 model (plain route, TF32 off) within ``DENSE_LOGITS_VS_PLAIN``
   times the plain route's own bf16 error; tokens/s, peak memory (under
   the card's), the weights' making time, a profiled window (the first
   ``PROFILE_REQUESTS`` rows, ``PROFILE_MAX_NEW`` tokens);
3s. SeamlessM4T-large-v2 at full width and depth (24 encoder + 24 decoder
   layers, d_model 1,024, 16/16 heads of 64, GELU d_ff 8,192, LayerNorm,
   V 256,206): 3r's path over 8 rows of 4,096 seeded N(0, 1) frame
   embeddings (``dec_enc_len``) and decoder prompts of 16-64 ids
   right-padded to 64 (self rings 128 wide).  Flash 72 launches in the
   prefill (24 encoder, 24 decoder self, 24 cross), paged 48 a decode
   step (24 self, 24 cross), the cross rings bit for bit unchanged by the
   decode loop; 3r's logits gates with the fp32 model at full depth
   (6.5 GB); 3r's numbers.  3r and 3s run after 3p and 3q;
4. end-to-end parity in fp32: the same weights and injected uniforms through
   the engine on the card (kernels) and on the CPU (plain versions), for
   Delphi-2M and for Mamba2-780M at full width cut to 4 layers; the card's
   trajectories are held step by step against the CPU model
   (``repro_torch.core.parity``).  Then, on the card alone with injected
   uniforms, in fp32 and in bf16: ring == paged bit for bit (tokens and
   fp32 ages, an over-width prompt included), and ``sample_futures`` on
   the ring, the paged and the prefix-cached paged engine == the port's
   ``ring_reference_futures`` bit for bit; the paged engine == the port's
   ``chunked_reference_trajectory`` bit for bit unchunked (an unbounded
   budget), chunked at one block and at 64 tokens, on a partial prefix hit
   (``matched_tokens``), futures forked from a parent prefilled in one
   chunk == the unchunked fork's and from one prefilled in 7 chunks == the
   oracle per future; ``monte_carlo_risk`` over phase 3d's futures equals the
   host aggregation exactly, and analytic risk on the card the CPU's;
6a. gradients on the card: one full-width train step (Delphi-2M, fp32,
   TF32 off, a 32 x 128 ``pack_trajectories`` batch); the loss and every
   gradient against the CPU port's on the same batch, every gradient finite
   and non-zero, no kernel launched (the training route is plain torch);
6b. training at full width: ``python -m repro_torch.launch.train --arch
   delphi-2m`` (its ``main``) for 100 steps of 32 x 128 over 2,048 simulated
   patients, bf16 activations over fp32 masters; the loss of the last 20
   steps below the first 20's; steps/s, target tokens/s, peak memory, the
   idle share of 10 steps under the profiler; the server built from
   ``--ckpt`` on its output answers a generate;
6c. federated fine-tuning: 3 clients (64 patients each), 2 rounds of 2
   local steps at full width, deltas clipped to norm 2; the mean client
   loss falls; seconds a round;
6d. the canary loop over HTTP: 4 member canaries of 8 (3 secret codes)
   planted 8 times into 512 simulated patients, full-width Delphi trained
   on the card, served by ``EngineBackend`` behind ``InferenceServer``,
   audited by ``python -m repro_torch.privacy.audit --url`` as a subprocess
   (exit 0, a valid report); the MI AUC, its CI and the extraction gap are
   printed (measurements, not gates), with the kernels' launches on the
   audit;
6e. Delphi-100M training at S 1,024 (the blocked attention route): one
   fp32 step (TF32 off) of 2 x 1024 at full width cut to 2 layers, its
   loss and every gradient against the CPU port's; then ``python -m
   repro_torch.launch.train --arch delphi-100m --seq-len 1024`` for 20 bf16
   steps of 8 x 1024 at full width: loss finite, steps/s, target tokens/s
   and the training's peak memory;
6f. Mamba2-780M training (the plain SSD route): one fp32 ``lm`` step of 2
   x 256 seeded random ids at full width cut to 2 layers (TF32 off), its
   loss and every gradient against the CPU port's (within
   ``GRAD_CARD_REL`` of each leaf's largest element); the plain SSD route's
   ``y`` and final state against the kernel route's within 1e-4 at full
   width and 1,024 tokens (dt ~ 0.01 as the init's); then ``python -m
   repro_torch.launch.train --arch mamba2-780m`` at full depth for 5 bf16
   steps of 4 x 512: no kernel launched, the loss finite, steps/s, target
   tokens/s, peak memory, and the idle share of one step under the
   profiler;
6g. Zamba2-1.2B training: 6f's checks and CLI for ``--arch zamba2-1.2b``;
6h. MoE training: Qwen2-MoE-A2.7B at full width cut to 2 layers (~1.76 B
   parameters, fp32 masters made on the card), bf16 activations, 2 x 256
   seeded ids: at one layer, both dispatches' bf16 gradients against the
   fp32 ``dense_scan`` ones within ``MOE_GRAD_REL`` of each leaf's largest
   |g| (the tokens whose experts flip in bf16 left out); one model
   gradient each with ``moe_impl="dense_scan"`` and ``"ragged"`` from the
   same weights and batch, the losses within ``MOE_TRAIN_LOSS_REL`` of
   each other, every gradient finite, the largest relative gradient
   difference printed beside the routing flips by layer, and with
   ``ragged`` held to ``dense_scan``'s experts every leaf within
   ``MOE_GRAD_REL``, no kernel launched; one AdamW step
   of each dispatch with ``remat`` off and on: step seconds and peak
   memory;
6i. the launch layer, in a subprocess run beside phase 4's untimed
   checks (its result logged in its own place): a process group of one
   (NCCL, the loopback address), ``ensure_distributed(expect_devices=1)``,
   an all-reduce, the 1 x 1 ``DeviceMesh`` on ``cuda``, full-width
   Delphi-2M's parameters placed by ``param_shardings`` as DTensors (every
   placement ``Replicate``), a forward through their local tensors == the
   plain parameters' logits bit for bit, and the tied head (embedding
   gather, product, bias) on the DTensors themselves == on the plain
   tensors bit for bit; then the sharded step (``sharded_drive``):
   full-width TinyLlama-1.1B in bf16, parameters, batch and ring cache
   placed by ``distribute_tree``, a prefill of 8 x 1,024 and 8 decode
   steps on the DTensors themselves == the plain route bit for bit
   (logits, rings), ``flash_attention`` launched 22 times and
   ``paged_decode_attention`` 22 x 8 on that drive, no collective sent,
   the drive's seconds printed; then the grouped MoE dispatches (the
   same ``sharded_drive``): full-width OLMoE-1B-7B at 2 of 16 layers in
   bf16, the same prefill and decode on DTensors under ``ragged_local``
   and ``ragged`` == the plain ``ragged`` route bit for bit (logits,
   rings), 4 flash and 32 paged launches, no collective; one AdamW step
   (``moe_train_drive``) on DTensors under each against the plain step
   (the loss and aux within ``MOE_SHARD_LOSS_REL``, the moments within
   ``MOE_SHARD_GRAD_REL``);
6j. SeamlessM4T-large-v2 training (after phase 5's rows, as 6k and 3v),
   on the plain route: one fp32 ``lm`` step (TF32 off) at full width cut
   to 2 encoder and 2 decoder layers, 2 x 128 tokens over 16 frames, its
   loss (within 1e-5) and every gradient (within ``GRAD_CARD_REL`` of its
   leaf's largest element) against the CPU port's; then at full depth (24
   + 24), fp32 masters made on the card, bf16 activations,
   ``make_train_step`` with AdamW: a warm step and 10 steps of 4 x 512
   tokens over 64 frames, every loss finite, steps/s, target tokens/s,
   peak memory and the idle share of one step under the profiler; no
   kernel launched by any step (counts zeroed just before, read just
   after); the trained masters saved by ``train.checkpoint.save`` and
   loaded by ``load_checkpoint`` in bf16: every leaf == its master in its
   use dtype bit for bit, the load's device peak within the tree + its
   largest fp32 piece + 1 GiB, and 3s's model-level prefill on the loaded
   tree == on ``cast_params(masters)`` bit for bit;
6k. InternVL2-26B training: 6j's fp32 gate at 1 layer, 1 x (256 patches +
   64 text tokens), and its bf16 steps at 2 layers (1.92 B parameters), 2
   x (256 + 768) tokens (3r's bucket);
3v. a full-width OLMoE-1B-7B checkpoint: its fp32 masters (27.7 GB) made
   on the card and saved by the port's ``save`` (the free disk checked
   first; no kernel launched), then ``python -m repro_torch.launch.serve
   --arch olmoe-1b-7b --ckpt DIR`` with 3p's knobs run through the CLI's
   ``main`` in a subprocess: 3p's gates on the 8 requests (launch counts
   zeroed before ``main``, read after), the engine holding the loaded
   tensors as its working weights, every leaf ==
   ``init_params_on_device`` in bf16 bit for bit, and the load's device
   peak within the bf16 tree + its largest fp32 layer slice + 1 GiB; the
   save's and the load's seconds and rates, the child's ``VmHWM`` (its
   ``VmRSS`` after the load where the kernel lists no ``VmHWM``);
7. the user-facing surface, each script in processes of its own, started
   beside phase 4's untimed checks (with 6i) and waited for after them:
   ``scripts/torch_examples_smoke.py --device cuda`` runs the eight
   ``examples/torch_*.py`` with their fast arguments, ``EXAMPLE_JOBS`` at
   a time (an example fails unless every kernel of its path launched:
   ``tte_sample``, flash and paged for the ones that generate or serve,
   flash and paged for the exported artifact, flash, paged and
   ``ssd_intra`` for the zoo's ten reduced architectures, none for the
   two that only train); beside it, ``scripts/torch_paged_parity.py``
   (paged == ring bit for bit, four storms with zero leaked blocks) and
   ``scripts/torch_router_roundtrip.py`` (router == direct bit for bit,
   the failover storm); each example's seconds and launch counts, each
   round trip's seconds and last line;
3w. Qwen2.5-32B at full width and depth (64 layers, d_model 5,120, 40/8
   heads of 128, QKV biases, SwiGLU d_ff 27,648, V 152,064, RoPE theta
   1e6; 65.53 GB in bf16, its weights made on the card: no fp32 copy of
   the model exists anywhere), right after phase 2 with 3x and their rows
   in a process of their own (``lm_phases``: the long prompt needs ~72
   GiB of a card that holds nothing else, and the windows' profiler
   activities stay out of the later traces): first ``python -m
   repro_torch.launch.serve --arch qwen2.5-32b --max-context 1024 --slots
   8 --requests 8`` through the CLI's ``main`` in this process
   (``lm_cli_drive``: its weights made on the card in their use dtypes by
   ``init_weights``, 3p's launch gates, its device peak within the bf16
   tree + the ring + one fp32 piece + 4 GiB; freed before the phase makes
   its own); then 3p's runs and gates (``lm_path``), the logits of the
   shortest and the longest prompt's last prefill position against the
   fp32 model at full depth (``core.parity.layered_prefill_logits``: one
   layer upcast at a time, plain route, TF32 off) within
   ``DENSE_LOGITS_VS_PLAIN`` times the plain bf16 route's error; last one
   prompt of 16,352 seeded ids with 8 new tokens, 1 slot, ``max_context``
   16,384 (``lm_long_drive``): the ring and the paged pool (1,024 blocks of
   16) bit for bit under injected uniforms, the first 2 tokens held
   teacher-forced against the kernels' prefills of the prompt and of the
   prompt extended by the first token (``core.parity.check_lm_steps``,
   score margin twice the logits error), a decode step's logits against
   the extended prefill's, the peak allocation against the card's;
3x. DeepSeek-7B at full width and depth (30 layers, d_model 4,096, 32/32
   heads of 128, SwiGLU d_ff 11,008, V 102,400; 13.82 GB in bf16): 3w's
   runs, gates and full-depth logits check, without the CLI and the long
   prompt;
5. times at the main paths' shapes: each kernel, its plain version, one
   PyTorch library call where one computes the same function (a yardstick
   the port never calls), and the bound from bytes and operations (for
   ``ssd_intra`` at a 1024- and a 128-token prompt, both terms printed;
   ``flash_attention`` also at B 4, S 256, ``paged_decode_attention``
   also on a full ring and on the paged pool (the ring's tokens in 16-token
   blocks scattered over 257, unused table columns -1), ``tte_sample``
   also at V 256,206 with a cold L2: the kernel's device time alone after
   a 128 MB write and after a 128 MB
   read, warm beside them), beside the launch floor (a one-element
   ``zero_()``, the least a launch costs on the device);
   device time per call from ``torch.profiler`` and per-call time from CUDA
   events (the ``kernels`` line's ``ms`` is the device time); then each path
   once more under the profiler (the Delphi ring path and the Mamba2 path
   over the same window as 3o's; device busy time, idle share, top
   kernels, and the Mamba2 path's ``ssd_intra`` total; the paged, futures
   and mixed drives of 3c-3e are not profiled again); ``flash_attention`` also with position
   masks at phase 3e's chunk (64 queries over 128 + 64 keys), its library
   call SDPA with the boolean mask built from the positions; flash and
   paged at the dense LMs' shapes: phase 3k's largest prefill bucket (GQA
   32/4, hd 64) and ring (G 8), a 4,608-token H2O-Danube prefill (32/8, hd
   80, window 4,096) and phase 3l's ring (G 4, the window), each beside
   its bound and SDPA (GQA by ``enable_gqa``); phase 3o's shapes:
   ``ssd_intra`` at a 1024-token prompt (64 heads, N 64), flash as MHA
   32/32 at hd 64, S 1,024, and paged on 3o's ring after the run (B 8, Hkv
   32, G 1, W 4,096); and the MoE LMs' (3p and 3q share them): flash at B 8,
   MHA 16/16, S 1,024, hd 128, and paged on 3q's ring after the run (B 8,
   Hkv 16, G 1, hd 128, W 1,024); and the zoo's: flash at 3r's prefill (B
   8, GQA 48/8, S 1,024, hd 128, causal), at 3s's encoder (B 8, MHA 16/16,
   S = T = 4,096, hd 64, bidirectional) and
   at its cross-attention prefill (64 queries over 4,096 keys), paged on
   3r's ring after the run (B 8, Hkv 8, G 6, hd 128, W 1,280) and on 3s's
   cross ring (B 8, Hkv 16, G 1, hd 64, W 4,096, step W - 1); and 3w's and
   3x's, timed in their subprocess after those phases: flash at 3w's largest bucket (GQA 40/8, hd 128), at
   B 1, S 4,096 and at the long prompt's S 16,384 (the plain version 1,024
   queries a call, ``flash_ref_blocks``; SDPA on the K/V heads repeated),
   paged on 3w's ring (G 5, W 1,024) and on the long prompt's (W 16,384),
   flash at 3x's largest bucket (MHA 32/32) and paged on its ring (G 1, 32
   kv heads).

Each phase's wall seconds are printed on a line of their own as it ends
(``phase 3j 171.4 s``: the time since the previous phase ended, so they
add up to the run) and kept in the JSON record's ``phase_seconds``.
The ``kernels`` line holds the four kernels and, as a fifth row, the flash
kernel's position-masked route with its launches on the chunked drive of
phase 3e; each Delphi kernel's row also gives its launches on the sweep of
phase 3i, on the audit of phase 6d, on the artifact drive of phase 3j and
on the ring runs of 3k, 3l and 3m, the drive of 3n, the Zamba2 run of 3o,
the drives of 3t (both models' counts summed; ``ssd_intra`` too),
the MoE ring runs of 3p and 3q, the training CLIs of 6f and 6g, the
training steps of 6j and 6k, the CLI's serving in 3v, the ring runs of
3w (its long prompt's as ``3w long``) and 3x and phase 7's examples (their
counts summed) (``launches_by_path``, counts zeroed just before each and
read just after, in each example's own process;
6f, 6g, 6j and 6k read 0; 3r and 3s count the timed drive, prefill and
decode);
twenty-one more rows give flash and paged at the shapes of 3k, 3l, 3o,
3q, 3r, 3w, 3w's long prompt and 3x, flash at 3w's S 4,096, flash at 3s's
encoder and cross prefill (both with 3s's flash
launches, which count the two together with the decoder's self
attention), paged on 3s's cross ring, and ``ssd_intra`` at 3o's, with
their launches there.  The last lines are the ``kernels``
JSON line, the card's name and power limit (``nvidia-smi``), and the result
line ``{"ok": true, "device": ...}``.  A copy of all numbers goes to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM memory rate
PEAK_FLOPS = {"bfloat16": 989e12,  # dense tensor-core rates of the H100 SXM
              "float32": 495e12,   # (TF32 for fp32 inputs)
              # fp32 on the CUDA cores (NVIDIA's data sheet)
              "float32_simt": 67e12,
              # fp32-accurate products on the tensor cores: three TF32
              # passes (hi*hi + hi*lo + lo*hi) per product
              "float32_3xtf32": 495e12 / 3}
SEED = 0
DEVICE = "cuda"

REPLACES = {
    "tte_sample": "src/repro/kernels/tte_sample.py:64",
    "flash_attention": "src/repro/kernels/flash_attention.py:86",
    "paged_decode_attention": "src/repro/kernels/paged_attention.py:82",
    "ssd_intra": "src/repro/kernels/ssd_scan.py:50",
}
SOURCES = {
    "tte_sample": "src/repro_torch/kernels/csrc/tte_sample.cu",
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "paged_decode_attention": "src/repro_torch/kernels/csrc/paged_attention.cu",
    "ssd_intra": "src/repro_torch/kernels/csrc/ssd_intra.cu",
}
DELPHI_KERNELS = ("tte_sample", "flash_attention", "paged_decode_attention")
MAMBA_SLOTS, MAMBA_REQUESTS, MAMBA_MAX_NEW = 8, 16, 32


def log(msg: str = "") -> None:
    print(msg, flush=True)


# wall seconds of each phase, in the order run: each phase's time is the
# time since the previous one ended, so the phases add up to the run
PHASE_S: dict = {}
_PHASE_T = [time.perf_counter()]


def phase_done(name: str) -> None:
    """Log the wall seconds since the previous phase ended (or since the
    script started) on a line of its own: ``phase 3j 171.4 s``."""
    now = time.perf_counter()
    PHASE_S[name] = now - _PHASE_T[0]
    _PHASE_T[0] = now
    log(f"phase {name} {PHASE_S[name]:.1f} s")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def _tol(dtype, want) -> float:
    """fp32 atol 2e-5; bf16 atol 3e-2 of the reference's largest value,
    never above 2e-2.  Over thousands of keys the outputs shrink (a std of
    ~0.026 at 4,096), and a fixed 2e-2 would pass a kernel that skipped a
    whole key tile."""
    import torch
    if dtype == torch.float32:
        return 2e-5
    return min(2e-2, 3e-2 * float(want.abs().max()))


# keys a dropped tile leaves out, and the least key count at which phase 2
# shows that the bf16 tolerance fails such a kernel
DROPPED_TILE = 128
DROP_CHECK_KEYS = 4096


def check_tte(gen) -> float:
    """Events equal except at near-ties (best and second-best t within
    1e-6 relative); t_min within 1e-6 relative.  The ties cases must give
    the lowest index: equal t everywhere, -0 (u = 1) from index 7 on, and
    across the blocks of a row's cluster (V 256,206: -0 from an index j in
    the third of eight ranks, +0 (l = 200) after it; +0 at j against -0
    in the first rank); a +inf row (l = -100) gives event 0, t_min inf.
    Row-strided views and logits aligned otherwise than the uniforms go
    through the same kernel.  Returns the largest relative t_min error at
    the main path's shape."""
    import torch
    from repro_torch.core.sampler import sample_waiting_times
    from repro_torch.kernels import ref
    from repro_torch.kernels import tte_sample as k
    dev = DEVICE
    Vl = 256206
    j = int(Vl * 2.5 / 8)
    main_err = 0.0
    for B, V, kind in [(16, 1289, "main"), (3, Vl, "large V"),
                       (2, 100, "ragged V"), (1, 5, "tiny V"),
                       (4, 1289, "ties"), (5, Vl, "ties across ranks"),
                       (2, 1289, "+inf row"), (6, 1289, "strided rows"),
                       (6, Vl, "strided rows"), (6, 1289, "misaligned u"),
                       (6, Vl, "misaligned u")]:
        logits = torch.randn((B, V + 37), generator=gen, device=dev) * 3 - 4
        u = torch.rand((B, V + 37), generator=gen, device=dev)
        if kind == "strided rows":       # big[:, :V] of (B, V + 37)
            logits, u = logits[:, :V], u[:, :V]
        elif kind == "misaligned u":     # 4-byte words, not 16-byte slots
            logits, u = logits[:, 1:V + 1], u[:, :V]
        else:
            logits = logits[:, :V].contiguous()
            u = u[:, :V].contiguous()
        want = None
        if kind == "ties":      # every t equal: the lowest index must win
            logits = torch.zeros_like(logits)
            u = torch.full_like(u, 0.3)
            u[1, 7:] = 1.0        # t = -0 from index 7 on
            want = [0, 7, 0, 0]
        elif kind == "ties across ranks":
            logits = torch.zeros_like(logits)
            u = torch.full_like(u, 0.3)
            u[1, j:] = 1.0
            u[2, j:j + 5000] = 1.0
            logits[2, j + 5000:] = 200.0
            logits[3] = -100.0
            logits[4, j] = 200.0
            u[4, j + 9] = 1.0
            u[4, j - 70000] = 1.0
            want = [0, j, j, 0, j - 70000]
        elif kind == "+inf row":
            logits = torch.full_like(logits, -100.0)
            u = u.clamp(1e-3, 0.999)
            want = [0, 0]
        n0 = k.launches
        e1, t1 = k.tte_sample_cuda(logits, u)
        e2, t2 = ref.tte_sample_ref(logits, u)
        torch.cuda.synchronize()
        if k.launches != n0 + 1:
            raise AssertionError(f"tte_sample {kind}: {k.launches - n0} "
                                 f"launches for one call")
        t_all = sample_waiting_times(logits, u)
        bad = (e1 != e2).nonzero().flatten().tolist()
        for b in bad:
            g1 = float(t_all[b, e1[b].long()])
            g2 = float(t_all[b, e2[b].long()])
            if abs(g1 - g2) > 1e-6 * abs(g2):
                raise AssertionError(
                    f"tte_sample {kind} row {b}: event {int(e1[b])} vs "
                    f"{int(e2[b])}, t {g1} vs {g2}")
        if want is not None and e1.tolist() != want:
            raise AssertionError(f"tte_sample {kind}: {e1.tolist()}, "
                                 f"want {want}")
        if kind == "+inf row" and not bool(torch.isinf(t1).all()):
            raise AssertionError(f"tte_sample +inf row: t_min {t1.tolist()}")
        fin = torch.isfinite(t2)
        if not bool((torch.isfinite(t1) == fin).all()):
            raise AssertionError(f"tte_sample {kind}: t_min {t1.tolist()} vs"
                                 f" {t2.tolist()}")
        rel = float(((t1 - t2)[fin].abs()
                     / t2[fin].abs().clamp_min(1e-30)).max()) \
            if bool(fin.any()) else 0.0
        if rel > 1e-6:
            raise AssertionError(f"tte_sample {kind}: t_min rel err {rel}")
        if kind == "main":
            main_err = rel
        log(f"  tte_sample B={B} V={V} ({kind}, plan "
            f"{k.plan(B, V)}): events differ at {len(bad)} near-ties, t_min "
            f"rel err {rel:.3g} (tol 1e-6)")
    return main_err


FLASH_CASES = [
    # (B, Hq, Hkv, S, hd, window, causal, dtype name, note)
    (16, 12, 12, 8, 10, None, True, "bfloat16", "main S=8"),
    (16, 12, 12, 16, 10, None, True, "bfloat16", "main S=16"),
    (16, 12, 12, 32, 10, None, True, "bfloat16", "main S=32"),
    (16, 12, 12, 64, 10, None, True, "bfloat16", "main S=64"),
    (4, 12, 12, 256, 10, None, True, "bfloat16", "main S=256"),
    (16, 12, 12, 64, 10, None, True, "float32", "fp32 S=64"),
    (2, 12, 12, 256, 10, 100, True, "float32", "window"),
    (2, 12, 12, 200, 10, None, True, "float32", "ragged S"),
    (2, 4, 2, 256, 64, None, True, "float32", "GQA hd=64"),
    (1, 2, 2, 384, 64, 100, True, "float32", "window hd=64"),
    (2, 8, 2, 77, 64, 16, True, "bfloat16", "ragged window GQA bf16"),
    (1, 2, 2, 130, 128, None, True, "float32", "hd=128 ragged"),
    (1, 2, 2, 128, 64, None, False, "float32", "bidirectional"),
    (2, 12, 12, 256, 10, 100, True, "bfloat16", "window bf16"),
    (2, 12, 12, 40, 10, None, False, "bfloat16", "bidirectional bf16"),
    (2, 4, 4, 96, 32, None, True, "bfloat16", "hd=32 bf16"),
    (2, 4, 2, 70, 40, None, True, "bfloat16", "hd=40 bf16 (padded to 64)"),
    (2, 4, 2, 50, 12, None, True, "bfloat16", "hd=12 bf16 (8-byte staging)"),
    (2, 4, 2, 50, 9, None, True, "bfloat16", "odd hd=9 bf16 (by element)"),
    (2, 4, 2, 256, 64, None, True, "bfloat16", "GQA hd=64 bf16"),
    (1, 2, 2, 384, 64, 100, True, "bfloat16", "window hd=64 bf16"),
    (1, 2, 2, 130, 128, None, True, "bfloat16", "hd=128 ragged bf16"),
    (1, 2, 2, 128, 64, None, False, "bfloat16", "bidirectional hd=64 bf16"),
    (1, 32, 4, 768, 64, None, True, "bfloat16",
     "TinyLlama GQA 32/4 hd=64 bf16"),
    (1, 32, 8, 4608, 80, 4096, True, "bfloat16",
     "H2O-Danube GQA 32/8 hd=80 (padded to 128) window 4096 bf16"),
    (1, 32, 32, 1024, 64, 4096, True, "bfloat16",
     "Zamba2 shared block MHA 32/32 hd=64 S=1024 window 4096 bf16"),
    (8, 16, 16, 1024, 128, None, True, "bfloat16",
     "OLMoE/Qwen2-MoE MHA 16/16 hd=128 S=1024 bf16"),
    (8, 48, 8, 1024, 128, None, True, "bfloat16",
     "InternVL2 GQA 48/8 hd=128 S=1024 bf16"),
    (8, 48, 8, 1024, 128, None, True, "float32",
     "InternVL2 GQA 48/8 hd=128 S=1024 fp32"),
    (8, 16, 16, 4096, 64, None, False, "bfloat16",
     "SeamlessM4T encoder bidirectional MHA 16/16 hd=64 S=T=4096 bf16"),
    (8, 16, 16, 4096, 64, None, False, "float32",
     "SeamlessM4T encoder bidirectional MHA 16/16 hd=64 S=T=4096 fp32"),
    (8, 40, 8, 1024, 128, None, True, "bfloat16",
     "Qwen2.5-32B GQA 40/8 hd=128 S=1024 bf16"),
    (8, 40, 8, 1024, 128, None, True, "float32",
     "Qwen2.5-32B GQA 40/8 hd=128 S=1024 fp32"),
    (1, 40, 8, 4096, 128, None, True, "bfloat16",
     "Qwen2.5-32B GQA 40/8 hd=128 S=4096 bf16"),
    (1, 40, 8, 4096, 128, None, True, "float32",
     "Qwen2.5-32B GQA 40/8 hd=128 S=4096 fp32"),
    (8, 32, 32, 1024, 128, None, True, "bfloat16",
     "DeepSeek-7B MHA 32/32 hd=128 S=1024 bf16"),
    (8, 32, 32, 1024, 128, None, True, "float32",
     "DeepSeek-7B MHA 32/32 hd=128 S=1024 fp32"),
]
# non-causal with T != S: (B, Hq, Hkv, S, T, hd, dtype name, note)
FLASH_CROSS_CASES = [
    (2, 4, 2, 37, 300, 64, "float32", "ragged cross GQA fp32"),
    (2, 4, 2, 37, 300, 64, "bfloat16", "ragged cross GQA bf16"),
    (8, 16, 16, 64, 4096, 64, "bfloat16",
     "SeamlessM4T cross-attention prefill, 64 queries over 4096 keys bf16"),
    (8, 16, 16, 64, 4096, 64, "float32",
     "SeamlessM4T cross-attention prefill, 64 queries over 4096 keys fp32"),
]


def flash_drop_check(note, q, k, v, want, tol, causal=False) -> None:
    """Shows that ``tol`` fails a flash kernel that skipped its last key
    tile: the plain version over every key but the last ``DROPPED_TILE``
    (causal: those keys masked by position for every query, so the last
    queries lose up to ``DROPPED_TILE`` of theirs), rounded to the
    kernel's dtype, must miss ``want`` by more than ``tol``."""
    import torch
    from repro_torch.kernels import ref
    d = -DROPPED_TILE
    if causal:
        B, S = q.shape[0], q.shape[2]
        qp = torch.arange(S, dtype=torch.int32, device=q.device).expand(
            B, S)
        kp = qp.clone()
        kp[:, d:] = -1
        bad = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                      q_pos=qp, k_pos=kp)
    else:
        bad = ref.flash_attention_ref(q.float(), k[:, :, :d].float(),
                                      v[:, :, :d].float(), causal=False)
    drop_err = float((bad.to(q.dtype).float() - want).abs().max())
    if not drop_err > tol:
        raise AssertionError(f"flash_attention {note}: a kernel that drops "
                             f"the last {DROPPED_TILE} keys would err "
                             f"{drop_err}, within the tolerance {tol}")
    log(f"  flash_attention {note}: a kernel that dropped the last "
        f"{DROPPED_TILE} keys would err {drop_err:.3g} (tol {tol:.3g})")


def check_flash(gen) -> float:
    """fp32 atol 2e-5, bf16 atol ``_tol`` against the plain version in fp32
    on the same (rounded) inputs.  q/k/v are transposed views of (B, S, H, hd)
    tensors, as the model passes them; at ``DROP_CHECK_KEYS`` keys or more
    (no window) ``flash_drop_check`` shows the tolerance fails a kernel
    that drops its last key tile.  Returns the largest error over the bf16
    cases at the main path's widths."""
    import torch
    from repro_torch.kernels import flash_attention as k
    from repro_torch.kernels import ref
    main_err = 0.0
    for B, Hq, Hkv, S, hd, window, causal, dt, note in FLASH_CASES:
        dtype = getattr(torch, dt)

        def rnd(h):
            return torch.randn((B, S, h, hd), generator=gen, device=DEVICE
                               ).to(dtype).transpose(1, 2)
        q, kk, v = rnd(Hq), rnd(Hkv), rnd(Hkv)
        out = k.flash_attention_cuda(q, kk, v, causal=causal, window=window)
        r = ref.flash_attention_ref(q.float(), kk.float(), v.float(),
                                    causal=causal, window=window)
        torch.cuda.synchronize()
        err = float((out.float() - r).abs().max())
        tol = _tol(dtype, r)
        if not err <= tol:
            raise AssertionError(f"flash_attention {note}: err {err} > {tol}")
        if S >= DROP_CHECK_KEYS and window is None:
            flash_drop_check(note, q, kk, v, r, tol, causal=causal)
        if note.startswith("main"):
            main_err = max(main_err, err)
        log(f"  flash_attention {note} (B={B} Hq={Hq} Hkv={Hkv} S={S} "
            f"hd={hd} window={window} causal={causal} {dt}): max abs err "
            f"{err:.3g} (tol {tol})")
    for B, Hq, Hkv, S, T, hd, dt, note in FLASH_CROSS_CASES:
        dtype = getattr(torch, dt)

        def rnd(n, h):
            return torch.randn((B, n, h, hd), generator=gen, device=DEVICE
                               ).to(dtype).transpose(1, 2)
        q, kk, v = rnd(S, Hq), rnd(T, Hkv), rnd(T, Hkv)
        out = k.flash_attention_cuda(q, kk, v, causal=False)
        r = ref.flash_attention_ref(q.float(), kk.float(), v.float(),
                                    causal=False)
        torch.cuda.synchronize()
        err = float((out.float() - r).abs().max())
        tol = _tol(dtype, r)
        if not err <= tol:
            raise AssertionError(f"flash_attention {note}: err {err} > {tol}")
        if T >= DROP_CHECK_KEYS:
            flash_drop_check(note, q, kk, v, r, tol)
        log(f"  flash_attention {note} (B={B} Hq={Hq} Hkv={Hkv} S={S} T={T} "
            f"hd={hd} bidirectional {dt}): max abs err {err:.3g} (tol {tol})")
    return main_err


SUFFIX_CASES = [
    # (B, Sc, C, Hkv, G, hd, window, note): tests/test_kernels.py's
    # SUFFIX_CASES, then Delphi-2M's chunk of phase 3e
    (1, 16, 0, 1, 1, 32, None, "chunk at the prompt head"),
    (2, 16, 32, 2, 2, 32, None, "GQA mid-prompt chunk"),
    (1, 8, 24, 1, 4, 64, None, "strong GQA"),
    (2, 16, 16, 2, 1, 16, 12, "sliding window"),
    (1, 16, 32, 2, 2, 32, None, "GQA hd=32"),
    (1, 64, 128, 12, 1, 10, None, "main: Delphi-2M chunk, 64 over 128"),
]


def check_flash_positions(gen) -> float:
    """The position-masked routes (``ops.suffix_prefill_attention``: the
    context and the chunk concatenated, the flash kernel with q_pos/k_pos)
    in fp32 and bf16 against ``suffix_prefill_attention_ref`` in fp32 on
    the same (rounded) inputs, fp32 atol 2e-5, bf16 atol ``_tol``: context
    padded with trash positions (-1) and the chunk's padded tail (-1),
    whose rows must come out as exact zeros.  Then the index route against
    the position route at a head chunk with no context (Delphi's heads, the
    main path's buckets): bit for bit on the valid rows.  Returns the
    largest error at Delphi-2M's chunk in bf16."""
    import torch
    from repro_torch.kernels import ops, ref
    main_err = 0.0
    for B, Sc, C, Hkv, G, hd, window, note in SUFFIX_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            def rnd(*shape):
                return torch.randn(shape, generator=gen, device=DEVICE
                                   ).to(dtype)
            q = rnd(B, Sc, Hkv * G, hd)
            k, v = rnd(B, Sc, Hkv, hd), rnd(B, Sc, Hkv, hd)
            ck, cv = rnd(B, C, Hkv, hd), rnd(B, C, Hkv, hd)
            n_ctx, n_q = max(C - 3, 0), Sc - 2
            cpos = torch.full((B, C), -1, dtype=torch.int32, device=DEVICE)
            cpos[:, :n_ctx] = torch.arange(n_ctx, device=DEVICE)
            qpos = torch.full((B, Sc), -1, dtype=torch.int32, device=DEVICE)
            qpos[:, :n_q] = n_ctx + torch.arange(n_q, device=DEVICE)
            out = ops.suffix_prefill_attention(q, k, v, ck, cv, qpos, cpos,
                                               window=window, q_per_kv=G)
            r = ref.suffix_prefill_attention_ref(
                q.float(), k.float(), v.float(), ck.float(), cv.float(),
                qpos, cpos, window=window)
            torch.cuda.synchronize()
            err = float((out[:, :n_q].float() - r[:, :n_q]).abs().max())
            tol = _tol(dtype, r[:, :n_q])
            if not err <= tol:
                raise AssertionError(f"flash_attention positions {note}: err "
                                     f"{err} > {tol}")
            if bool(out[:, n_q:].any()):
                raise AssertionError(f"flash_attention positions {note}: a "
                                     f"padded row is not zeros")
            if note.startswith("main") and dtype == torch.bfloat16:
                main_err = err
            log(f"  flash_attention positions {note} (B={B} Sc={Sc} C={C} "
                f"Hkv={Hkv} G={G} hd={hd} window={window} "
                f"{str(dtype)[6:]}): max abs err {err:.3g} (tol {tol}); "
                f"{Sc - n_q} padded rows exact zeros")
    for dtype in (torch.float32, torch.bfloat16):
        for S, n in ((8, 5), (16, 16), (32, 21), (64, 64), (256, 200)):
            q, k, v = (torch.randn((1, S, 12, 10), generator=gen,
                                   device=DEVICE).to(dtype) for _ in range(3))
            pos = torch.full((1, S), -1, dtype=torch.int32, device=DEVICE)
            pos[:, :n] = torch.arange(n, device=DEVICE)
            empty = q.new_zeros((1, 0, 12, 10))
            by_pos = ops.suffix_prefill_attention(q, k, v, empty, empty, pos,
                                                  pos[:, :0])
            by_index = ops.flash_attention(
                q.transpose(1, 2), k.transpose(1, 2),
                v.transpose(1, 2)).transpose(1, 2)
            if not torch.equal(by_pos[:, :n], by_index[:, :n]):
                raise AssertionError(f"flash_attention: the position route "
                                     f"differs from the index route at S={S} "
                                     f"{dtype}")
    log("  flash_attention: index route == position route bit for bit at a "
        "head chunk (Hkv 12, hd 10, S 8/16/32/64/256, fp32 and bf16)")
    return main_err


def ring_inputs(gen, B, Hkv, G, hd, W, dtype, steps, padded=True):
    """A ring cache as the engine holds it, viewed as a pool of one block
    per slot: slot b has written positions 0..steps[b] at ring slot p % W;
    with ``padded`` slot 0 also has two prompt positions masked (pos -1, as
    after a right-padded prefill)."""
    import torch
    k = torch.randn((B, Hkv, W, hd), generator=gen, device=DEVICE).to(dtype)
    v = torch.randn((B, Hkv, W, hd), generator=gen, device=DEVICE).to(dtype)
    q = torch.randn((B, Hkv * G, hd), generator=gen, device=DEVICE).to(dtype)
    pos = torch.full((B, W), -1, dtype=torch.int32)
    for b, s in enumerate(steps):
        for p in range(max(0, s - W + 1), s + 1):
            pos[b, p % W] = p
    if padded:
        pos[0, 1:3] = -1
    table = torch.arange(B, dtype=torch.int32)[:, None]
    step = torch.tensor(steps, dtype=torch.int32)
    return q, k, v, table.to(DEVICE), pos.to(DEVICE), step.to(DEVICE)


def paged_inputs(gen, B, Hkv, G, hd, bs, nbs, dtype, *, wrap=False,
                 empty_slot=False):
    """A true paged pool: each slot's blocks are scattered over the pool in
    random order, unallocated table entries are -1, and with ``wrap`` the
    positions have wrapped past the ring width, with every other one left
    stale (evicted: at or below step - W)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(int(torch.randint(0, 2**31 - 1, (1,),
                                                  generator=gen,
                                                  device=DEVICE)))
    W = nbs * bs
    NB = 1 + B * nbs
    perm = rng.permutation(np.arange(1, NB))
    table = np.full((B, nbs), -1, np.int32)
    pos = np.full((NB, bs), -1, np.int32)
    step = np.zeros((B,), np.int32)
    nxt = 0
    for b in range(B):
        if empty_slot and b == B - 1:
            break
        n_tok = int(rng.integers(1, W))
        off = W if wrap else 0
        step[b] = n_tok - 1 + off
        for jb in range(-(-n_tok // bs)):
            blk = int(perm[nxt])
            nxt += 1
            table[b, jb] = blk
            for o in range(bs):
                p = jb * bs + o
                if p < n_tok:
                    pos[blk, o] = p + off
                    if wrap and o % 2 == 0:
                        pos[blk, o] -= W
    q = torch.from_numpy(rng.standard_normal((B, Hkv * G, hd))).to(dtype)
    k = torch.from_numpy(rng.standard_normal((NB, Hkv, bs, hd))).to(dtype)
    v = torch.from_numpy(rng.standard_normal((NB, Hkv, bs, hd))).to(dtype)
    return tuple(t.to(DEVICE) for t in (
        q, k, v, torch.from_numpy(table), torch.from_numpy(pos),
        torch.from_numpy(step)))


def paged_drop_check(note, q, k, v, table, pos, step, window, want,
                     tol) -> None:
    """Shows that ``tol`` fails a paged kernel that skipped the last tile
    of a full ring: the plain version with the ring's last
    ``DROPPED_TILE`` positions masked, rounded to the kernel's dtype, must
    miss ``want`` by more than ``tol``."""
    from repro_torch.kernels import ref
    B, Hq, hd = q.shape
    Hkv = k.shape[1]
    short = pos.clone()
    short[:, -DROPPED_TILE:] = -1
    bad = ref.paged_decode_attention_ref(
        q.float().reshape(B, Hkv, Hq // Hkv, hd), k.float(), v.float(),
        table, short, step, window=window).reshape(B, Hq, hd)
    drop_err = float((bad.to(q.dtype).float() - want).abs().max())
    if not drop_err > tol:
        raise AssertionError(f"paged_decode_attention {note}: a kernel that "
                             f"drops the ring's last {DROPPED_TILE} positions"
                             f" would err {drop_err}, within the tolerance "
                             f"{tol}")
    log(f"  paged_decode_attention {note}: a kernel that dropped the ring's "
        f"last {DROPPED_TILE} positions would err {drop_err:.3g} (tol "
        f"{tol:.3g})")


def check_paged(gen) -> float:
    """fp32 atol 2e-5, bf16 atol ``_tol`` against the plain version in fp32
    on the same (rounded) inputs.  Returns the largest error of the ring-as-
    pool cases at the main path's widths (bf16)."""
    import torch
    from repro_torch.kernels import ops, ref
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        ("main: ring as pool, bs=256", ring_inputs(
            gen, 16, 12, 1, 10, 256, bf16,
            [40, 300, 255, 256, 1000, 3, 0, 511] + [20 + 9 * i for i in range(8)]),
         None),
        ("ring as pool fp32", ring_inputs(
            gen, 16, 12, 1, 10, 256, f32, [17 * i + 5 for i in range(16)]),
         None),
        ("ring, every step below 128", ring_inputs(
            gen, 16, 12, 1, 10, 256, bf16, [8 * i + 3 for i in range(16)]),
         None),
        ("ring full, every step >= 255", ring_inputs(
            gen, 16, 12, 1, 10, 256, bf16, [255 + 37 * i for i in range(16)],
            padded=False), None),
        ("paged bs=4 G=4 hd=64", paged_inputs(gen, 3, 2, 4, 64, 4, 8, f32),
         None),
        ("paged bs=16 wrapped stale G=2 window", paged_inputs(
            gen, 4, 2, 2, 32, 16, 4, f32, wrap=True), 20),
        ("paged bs=16 wrapped bf16 G=4 window", paged_inputs(
            gen, 4, 2, 4, 16, 16, 4, bf16, wrap=True), 20),
        ("paged bs=16 wrapped bf16 G=8 hd=128", paged_inputs(
            gen, 2, 2, 8, 128, 16, 4, bf16, wrap=True), None),
        ("paged bs=16 odd hd=9 bf16", paged_inputs(
            gen, 2, 2, 2, 9, 16, 2, bf16), None),
        ("paged bs=4 empty slot", paged_inputs(
            gen, 3, 2, 2, 16, 4, 4, f32, empty_slot=True), None),
        ("TinyLlama G=8 hd=64 bf16", paged_inputs(
            gen, 8, 4, 8, 64, 16, 64, bf16), None),
        ("H2O-Danube G=4 hd=80 window 4096 in a 5120 ring, wrapped, bf16",
         paged_inputs(gen, 2, 8, 4, 80, 16, 320, bf16, wrap=True), 4096),
        ("Zamba2 ring B=8 Hkv=32 G=1 hd=64 W=4096 window 4096, bf16",
         ring_inputs(gen, 8, 32, 1, 64, 4096, bf16,
                     [100, 1055, 4095, 4096, 5000, 300, 2047, 8191]), 4096),
        ("MoE ring B=8 Hkv=16 G=1 hd=128 W=1024, partly filled, bf16",
         ring_inputs(gen, 8, 16, 1, 128, 1024, bf16,
                     [63, 700, 1023, 1024, 1500, 200, 511, 2047]), None),
    ]
    # InternVL2's ring (G 6 at hd 128, W 1,280, patches and text) and
    # SeamlessM4T's cross ring (every one of 4,096 memory positions valid,
    # step W - 1: what models.attention.cross_decode_attention passes);
    # Qwen2.5-32B's rings (G 5: one query head a block, each K/V row read
    # 5 times; 3w's 8 slots, and the long prompt's full 16,384-token ring)
    # and DeepSeek-7B's (MHA over 32 kv heads)
    for dt in (bf16, f32):
        cases += [
            (f"InternVL2 ring B=8 Hkv=8 G=6 hd=128 W=1280, partly filled, "
             f"{str(dt)[6:]}",
             ring_inputs(gen, 8, 8, 6, 128, 1280, dt,
                         [319, 700, 1023, 1279, 1300, 400, 900, 1055]), None),
            (f"SeamlessM4T cross ring B=8 Hkv=16 G=1 hd=64 W=4096, full, "
             f"step W-1, {str(dt)[6:]}",
             ring_inputs(gen, 8, 16, 1, 64, 4096, dt, [4095] * 8,
                         padded=False), None),
            (f"Qwen2.5-32B ring B=8 Hkv=8 G=5 hd=128 W=1024, partly filled, "
             f"{str(dt)[6:]}",
             ring_inputs(gen, 8, 8, 5, 128, 1024, dt,
                         [63, 700, 1023, 1024, 1500, 200, 511, 2047]), None),
            (f"Qwen2.5-32B long ring B=1 Hkv=8 G=5 hd=128 W=16384, full, "
             f"{str(dt)[6:]}",
             ring_inputs(gen, 1, 8, 5, 128, LM_LONG_CONTEXT, dt,
                         [LM_LONG_CONTEXT - 1], padded=False), None),
            (f"DeepSeek-7B ring B=8 Hkv=32 G=1 hd=128 W=1024, partly "
             f"filled, {str(dt)[6:]}",
             ring_inputs(gen, 8, 32, 1, 128, 1024, dt,
                         [63, 700, 1023, 1024, 1500, 200, 511, 2047]), None)]
    main_err = 0.0
    for note, (q, k, v, table, pos, step), window in cases:
        B, Hq, hd = q.shape
        Hkv = k.shape[1]
        out = ops.paged_decode_attention(q, k, v, table, pos, step,
                                         window=window)
        r = ref.paged_decode_attention_ref(
            q.float().reshape(B, Hkv, Hq // Hkv, hd), k.float(), v.float(),
            table, pos, step, window=window).reshape(B, Hq, hd)
        torch.cuda.synchronize()
        err = float((out.float() - r).abs().max())
        tol = _tol(q.dtype, r)
        if not err <= tol:
            raise AssertionError(f"paged_decode_attention {note}: err {err}"
                                 f" > {tol}")
        if table.shape[1] == 1 and pos.shape[1] >= DROP_CHECK_KEYS and bool(
                ((pos >= 0) & (pos <= step[:, None])).all()):
            paged_drop_check(note, q, k, v, table, pos, step, window, r, tol)
        if "empty" in note and float(out[-1].abs().max()) != 0.0:
            raise AssertionError("paged_decode_attention: an empty slot "
                                 "must give zeros")
        if note.startswith("main"):
            main_err = err
        log(f"  paged_decode_attention {note} (B={B} Hkv={Hkv} "
            f"G={Hq // Hkv} hd={hd} bs={k.shape[2]} nbs={table.shape[1]} "
            f"{str(q.dtype)[6:]}): max abs err {err:.3g} (tol {tol})")
    return main_err


SSD_CASES = [
    # (b, C, Q, H, P, N, xdt dtype, B/C dtype, B/C shared by the heads,
    #  largest decrement of cum per step, note)
    (1, 1, 16, 1, 8, 8, "float32", "float32", False, 0.2, "Q16 P8 N8"),
    (4, 3, 32, 1, 16, 32, "float32", "float32", False, 0.2, "Q32 P16 N32"),
    (2, 2, 128, 1, 64, 128, "float32", "float32", False, 0.2,
     "production tile"),
    (2, 2, 64, 1, 32, 64, "bfloat16", "bfloat16", False, 0.2, "bf16 Q64"),
    (2, 3, 32, 16, 32, 16, "float32", "float32", True, 0.2, "reduced mamba2"),
    (1, 8, 128, 48, 64, 128, "float32", "bfloat16", True, 0.2,
     "main: 1024-token prompt"),
    (1, 1, 128, 48, 64, 128, "float32", "bfloat16", True, 0.2,
     "one-chunk prompt (128 tokens)"),
    (2, 2, 128, 4, 64, 128, "float32", "bfloat16", False, 0.2,
     "bf16 B/C per head"),
    (1, 2, 128, 8, 64, 128, "float32", "bfloat16", True, 2.0,
     "steep decay (L underflows to 0)"),
    (2, 2, 128, 8, 64, 128, "float32", "float32", True, 0.2,
     "fp32 B/C shared by the heads"),
    (1, 8, 128, 64, 64, 64, "float32", "bfloat16", True, 0.2,
     "Zamba2: 1024-token prompt, 64 heads, N 64"),
]


def check_ssd(gen) -> dict:
    """atol 1e-4 (tests/test_kernels.py's SSD tolerance) against the plain
    version in fp32 on the same (rounded) inputs, drawn as test_kernels.py
    draws them (N(0, 1) tiles, cum of U(0, 0.2) decrements; U(0, 2.0) in
    the steep case, where L underflows to 0 and no NaN may appear).
    Returns the errors at the main path's tile (48 heads sharing bf16 B/C
    by a 0 stride, fp32 xdt, as the model passes them) and at Zamba2's
    (``{"main": ..., "zamba2": ...}``)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as k
    out = {}
    for b, C, Q, H, P, N, dx, dbc, shared, step, note in SSD_CASES:
        def rnd(*shape, dt):
            return torch.randn(shape, generator=gen, device=DEVICE
                               ).to(getattr(torch, dt))
        hb = 1 if shared else H
        xdt = rnd(b, C, Q, H, P, dt=dx)
        Bm = rnd(b, C, Q, hb, N, dt=dbc).expand(b, C, Q, H, N)
        Cm = rnd(b, C, Q, hb, N, dt=dbc).expand(b, C, Q, H, N)
        cum = -torch.cumsum(step * torch.rand((b, C, Q, H), generator=gen,
                                              device=DEVICE), dim=2)
        y, st = k.ssd_intra_cuda(xdt, Bm, Cm, cum)
        yr, sr = ref.ssd_intra_ref(xdt.transpose(2, 3), Bm.transpose(2, 3),
                                   Cm.transpose(2, 3), cum.transpose(2, 3))
        torch.cuda.synchronize()
        err = max(float((y - yr.transpose(2, 3)).abs().max()),
                  float((st - sr).abs().max()))
        if not (err <= 1e-4 and bool(y.isfinite().all())
                and bool(st.isfinite().all())):
            raise AssertionError(f"ssd_intra {note}: err {err} > 1e-4")
        if note.startswith("main"):
            out["main"] = err
        if note.startswith("Zamba2"):
            out["zamba2"] = err
        log(f"  ssd_intra {note} (b={b} C={C} Q={Q} H={H} P={P} N={N} xdt "
            f"{dx}, B/C {dbc}{', shared' if shared else ''}, cum steps "
            f"<= {step}): max abs err "
            f"{err:.3g} (tol 1e-4)")
    return out


# ---------------------------------------------------------------------------
# phase 3 / 4: the serving paths
# ---------------------------------------------------------------------------
def serve_args(requests: int, max_new: int, cache: str = "ring"):
    from repro_torch.launch import serve as launch
    return launch.parse_args(["--arch", "delphi-2m", "--requests",
                              str(requests), "--slots", "16", "--max-new",
                              str(max_new), "--seed", str(SEED),
                              "--cache", cache, "--device", DEVICE])


def main_path(cache: str = "ring") -> dict:
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launch
    cfg_v = 1289
    # first use of cuBLAS and the allocator, through the same entry point
    launch.serve(serve_args(4, 4, cache))
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    out = launch.serve(serve_args(32, 48, cache))
    counts = ops.launch_counts()
    eng, done = out["engine"], out["done"]
    if len(done) != 32 or not all(r.done and r.error is None for r in done):
        raise AssertionError(f"{len(done)} of 32 requests completed")
    if eng.host_syncs != eng.ticks + eng.admit_batches:
        raise AssertionError(f"host_syncs {eng.host_syncs} != ticks "
                             f"{eng.ticks} + admit_batches "
                             f"{eng.admit_batches}")
    for name in DELPHI_KERNELS:
        if counts[name] <= 0:
            raise AssertionError(f"{name} never launched on the Delphi path")
    for r in done:
        toks = np.asarray(r.out_tokens)
        ages = np.asarray(r.out_ages, np.float64)
        if len(toks) > 48 or (len(toks) and (toks.min() < 0
                                             or toks.max() >= cfg_v)):
            raise AssertionError(f"bad tokens {toks}")
        if not (np.isfinite(ages).all() and (ages <= 85.0).all()
                and (np.diff(ages) >= 0).all()):
            raise AssertionError(f"bad ages {ages}")
    if cache == "paged":
        if counts["paged_decode_attention"] != 12 * eng.ticks:
            raise AssertionError(
                f"paged_decode_attention launched "
                f"{counts['paged_decode_attention']} times in {eng.ticks} "
                f"ticks (12 a tick)")
        if eng.allocator.used or eng.pool._refs or eng.preemptions:
            raise AssertionError(f"pool not drained: {eng.pool_stats()}")
    return {"engine": eng, "done": done, "seconds": out["seconds"],
            "events": out["events"], "launches": counts}


FUTURES_PATIENTS, FUTURES_N, FUTURES_MAX_NEW = 4, 16, 48


def futures_patients():
    """The first halves of 4 synthetic patient histories (seeded)."""
    from repro_torch.data import SimulatorConfig, generate_dataset
    trajs, _ = generate_dataset(SimulatorConfig(
        n_train=FUTURES_PATIENTS, n_val=1, seed=SEED + 23))
    return [(t[:max(len(t) // 2, 1)], a[:max(len(t) // 2, 1)])
            for t, a in trajs]


def futures_run(params, cfg, patients):
    """16 futures of each patient, each patient twice, on one
    prefix-cached paged engine with generator uniforms; returns (engine,
    children by call, seconds ending in a device synchronise)."""
    import torch
    from repro_torch.serve import BatchedEngine
    eng = BatchedEngine(params, cfg, slots=16, max_context=cfg.max_seq_len,
                        cache="paged", block_size=16, prefix_cache=True,
                        seed=SEED, device=DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    calls = [eng.sample_futures(t, a, n=FUTURES_N, max_new=FUTURES_MAX_NEW)
             for _ in range(2) for t, a in patients]
    torch.cuda.synchronize()
    return eng, calls, time.perf_counter() - t0


def futures_path() -> dict:
    """Phase 3d: futures at full width (counts zeroed just before the run
    and read just after)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import init_params
    cfg = get_config("delphi-2m")
    params = init_params(cfg, seed=SEED, device=DEVICE)
    patients = futures_patients()
    ops.reset_launch_counts()
    eng, calls, sec = futures_run(params, cfg, patients)
    counts = ops.launch_counts()
    kids = [k for c in calls for k in c]
    if len(kids) != 2 * FUTURES_PATIENTS * FUTURES_N or not all(
            k.done and k.error is None for k in kids):
        raise AssertionError("a future did not finish")
    for k in kids:
        ages = np.asarray(k.out_ages, np.float64)
        if not (len(k.out_tokens) <= FUTURES_MAX_NEW
                and np.isfinite(ages).all() and (np.diff(ages) >= 0).all()):
            raise AssertionError(f"bad future {k.out_tokens} {k.out_ages}")
    st = eng.pool_stats()
    pfx = st["prefix_cache"]
    if eng.host_syncs != eng.ticks + eng.admit_batches:
        raise AssertionError(f"host_syncs {eng.host_syncs} != ticks "
                             f"{eng.ticks} + admit_batches "
                             f"{eng.admit_batches}")
    if (st["forks"] != 2 * FUTURES_PATIENTS or pfx["hits"] != FUTURES_PATIENTS
            or len(eng.prefill_shapes) > FUTURES_PATIENTS
            or counts["flash_attention"] != 12 * FUTURES_PATIENTS
            or counts["paged_decode_attention"] != 12 * eng.ticks
            or counts["tte_sample"] == 0):
        raise AssertionError(f"futures path: {st}, launches {counts}, "
                             f"prefill shapes {eng.prefill_shapes}")
    bs = eng.block_size
    unshared = FUTURES_N * sum(-(-len(t) // bs) for t, _ in patients)
    events = sum(len(k.out_tokens) for k in kids)
    freed = eng.drop_prefix_cache()
    if eng.allocator.used or eng.pool._refs or (eng._table != -1).any():
        raise AssertionError(f"leaked blocks after drop_prefix_cache: "
                             f"{eng.allocator.used} used, refs "
                             f"{eng.pool._refs}")
    return {"engine": eng, "seconds": sec, "events": events,
            "launches": counts, "stats": st, "unshared_blocks": unshared,
            "index_blocks_freed": freed, "params": params, "cfg": cfg,
            "patients": patients, "calls": calls,
            "prompt_lengths": [len(t) for t, _ in patients]}


# phase 3e: mixed long/short traffic (benchmarks/run.py's
# bench_chunked_prefill at Delphi-2M's full width and max_seq_len)
MIXED_SLOTS, MIXED_SHORT, MIXED_LONG = 12, 6, 6
MIXED_S_LONG, MIXED_CHUNK, MIXED_BLOCKS = 200, 64, 192


def mixed_requests():
    """6 short requests (6-event prompts, 48 new events), then 6 long ones
    (200-event prompts, 4 new events), generator-sampled."""
    import numpy as np
    from repro_torch.serve import Request
    shorts = [Request(tokens=((np.arange(3, 9) + 7 * i) % 90).astype(np.int32),
                      ages=np.linspace(0.0, 30.0, 6).astype(np.float32),
                      max_new=48) for i in range(MIXED_SHORT)]
    longs = [Request(
        tokens=((np.arange(3, 3 + MIXED_S_LONG) + 11 * i) % 90).astype(
            np.int32),
        ages=np.linspace(0.0, 60.0, MIXED_S_LONG).astype(np.float32),
        max_new=4) for i in range(MIXED_LONG)]
    return shorts, longs


def mixed_engine(params, cfg, chunk):
    from repro_torch.serve import BatchedEngine
    return BatchedEngine(params, cfg, slots=MIXED_SLOTS,
                         max_context=cfg.max_seq_len, cache="paged",
                         block_size=16, blocks=MIXED_BLOCKS,
                         prefill_chunk_tokens=chunk, seed=SEED,
                         device=DEVICE)


def mixed_drive(eng) -> dict:
    """The short requests first; one long request arrives every 8 steps
    from step 3 while they decode.  Each short request's per-event latency
    is the host time between the steps that gave it events, over the events
    given.  Every request must finish, the pool must drain, and the step's
    host copies must be one per tick and per admission batch."""
    import numpy as np
    import torch
    shorts, longs = mixed_requests()
    syncs0, ticks0, adm0 = eng.host_syncs, eng.ticks, eng.admit_batches
    chunks0 = eng.prefill_chunks
    for r in shorts:
        eng.submit(r)
    pending = list(longs)
    lat, seen = [], [0] * len(shorts)
    torch.cuda.synchronize()
    now = time.perf_counter()
    last = [now] * len(shorts)
    step, t0 = 0, now
    while not all(r.done for r in shorts + longs):
        if pending and step % 8 == 3:
            eng.submit(pending.pop(0))
        eng.step()
        step += 1
        now = time.perf_counter()
        for i, r in enumerate(shorts):
            k = len(r.out_tokens)
            if k > seen[i]:
                lat.extend([(now - last[i]) / (k - seen[i])] * (k - seen[i]))
                seen[i], last[i] = k, now
        if step > 5000:
            raise AssertionError("mixed traffic did not finish")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not all(r.error is None for r in shorts + longs):
        raise AssertionError("a mixed-traffic request failed")
    if eng.allocator.used or eng.pool._refs or eng._prefills:
        raise AssertionError(f"mixed traffic: pool not drained "
                             f"{eng.pool_stats()}")
    ticks, adm = eng.ticks - ticks0, eng.admit_batches - adm0
    if eng.host_syncs - syncs0 != ticks + adm:
        raise AssertionError(f"mixed traffic: host_syncs "
                             f"{eng.host_syncs - syncs0} != ticks {ticks} + "
                             f"admission batches {adm}")
    lat = np.asarray(lat)
    events = sum(len(r.out_tokens) for r in shorts + longs)
    return {"wall_s": wall, "events": events, "events_per_s": events / wall,
            "p50_ms": float(np.percentile(lat, 50)) * 1e3,
            "p95_ms": float(np.percentile(lat, 95)) * 1e3,
            "short_events": int(lat.size), "steps": step, "ticks": ticks,
            "admit_batches": adm, "host_syncs": ticks + adm,
            "chunks": eng.prefill_chunks - chunks0}


def mixed_path() -> dict:
    """Phase 3e: monolithic and chunked prefill (64 tokens a step) on one
    model, a warm-up drive each, then timed drives in turns (monolithic,
    chunked, chunked, monolithic).  Launch counts are zeroed just before
    the first timed chunked drive and read just after it."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import ops
    from repro_torch.models import init_params
    cfg = get_config("delphi-2m")
    params = init_params(cfg, seed=SEED, device=DEVICE)
    engs = {"monolithic": mixed_engine(params, cfg, None),
            "chunked": mixed_engine(params, cfg, MIXED_CHUNK)}
    for eng in engs.values():
        mixed_drive(eng)                        # first use of these shapes
    runs, counts = [], None
    for mode in ("monolithic", "chunked", "chunked", "monolithic"):
        torch.cuda.synchronize()
        first_chunked = mode == "chunked" and counts is None
        if first_chunked:
            ops.reset_launch_counts()
        r = mixed_drive(engs[mode])
        if first_chunked:
            counts = dict(ops.launch_counts(),
                          flash_positions=fk.position_launches)
            if (counts["flash_positions"] != 12 * r["chunks"]
                    or counts["flash_attention"] != counts["flash_positions"]
                    or counts["paged_decode_attention"] != 12 * r["ticks"]
                    or counts["tte_sample"] == 0):
                raise AssertionError(f"chunked drive: launches {counts}, "
                                     f"{r['chunks']} chunks, {r['ticks']} "
                                     f"ticks")
        runs.append((mode, r))
    ceng = engs["chunked"]
    st = ceng.pool_stats()
    if st["chunked_prefills"] != 3 * (MIXED_SHORT + MIXED_LONG):
        raise AssertionError(f"chunked prefills {st['chunked_prefills']}")
    return {"runs": runs, "launches": counts, "stats": st,
            "chunk_shapes": sorted(ceng.prefill_shapes),
            "monolithic_shapes": sorted(engs["monolithic"].prefill_shapes)}


def suffix_path(params, cfg) -> dict:
    """Phase 3f: a prefix-cached chunked engine (64 tokens a step) serves a
    200-event prompt, then a 240-event prompt that extends it: the second
    shares the first's 12 full blocks by reference and prefills only its
    48-token suffix, in one chunk."""
    import numpy as np
    from repro_torch.serve import BatchedEngine, Request
    rng = np.random.default_rng(SEED + 31)
    toks = rng.integers(3, cfg.vocab_size, 240).astype(np.int32)
    ages = np.sort(rng.uniform(20, 70, 240)).astype(np.float32)
    eng = BatchedEngine(params, cfg, slots=MIXED_SLOTS,
                        max_context=cfg.max_seq_len, cache="paged",
                        block_size=16, prefix_cache=True,
                        prefill_chunk_tokens=MIXED_CHUNK, seed=SEED,
                        device=DEVICE)
    first = Request(tokens=toks[:200], ages=ages[:200], max_new=8)
    eng.submit(first)
    eng.run()
    chunks0 = eng.prefill_chunks
    second = Request(tokens=toks, ages=ages, max_new=8)
    eng.submit(second)
    eng.run()
    st = eng.pool_stats()
    matched = (200 // 16) * 16
    if not (first.done and second.done and first.error is None
            and second.error is None):
        raise AssertionError("phase 3f: a request failed")
    if (st["suffix_tokens_saved"] != matched
            or st["prefix_cache"]["partial_hits"] != 1
            or eng.prefill_chunks - chunks0 != 1
            or eng.host_syncs != eng.ticks + eng.admit_batches):
        raise AssertionError(f"phase 3f: {st}")
    eng.drop_prefix_cache()
    if eng.allocator.used or eng.pool._refs:
        raise AssertionError("phase 3f: leaked blocks")
    return {"stats": st, "matched": matched,
            "suffix_chunks": eng.prefill_chunks - chunks0,
            "shapes": sorted(eng.prefill_shapes)}


def parity() -> dict:
    """fp32 engine on the card (kernels) and on the CPU (plain versions)
    with the same weights and uniforms."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core import parity as par
    from repro_torch.data import SimulatorConfig, generate_dataset
    from repro_torch.models import init_params
    from repro_torch.serve import BatchedEngine, Request
    cfg = get_config("delphi-2m").replace(dtype="float32")
    n_req, max_new, W = 24, 48, cfg.max_seq_len
    trajs, _ = generate_dataset(SimulatorConfig(n_train=n_req, n_val=1,
                                                seed=SEED + 17))
    rng = np.random.default_rng(SEED + 1)
    prompts = [(t[:max(len(t) // 2, 1)], a[:max(len(t) // 2, 1)])
               for t, a in trajs]
    us = [rng.random((max_new, cfg.vocab_size), dtype=np.float32)
          for _ in prompts]
    runs, params = {}, {}
    for dev in (DEVICE, "cpu"):
        params[dev] = init_params(cfg, seed=SEED + 1, device=dev)
        eng = BatchedEngine(params[dev], cfg, slots=16, max_context=W,
                            device=dev)
        reqs = [Request(tokens=t, ages=a, max_new=max_new, uniforms=u)
                for (t, a), u in zip(prompts, us)]
        for r in reqs:
            eng.submit(r)
        t0 = time.perf_counter()
        eng.run()
        runs[dev] = [(r.out_tokens, r.out_ages) for r in reqs]
        if eng.host_syncs != eng.ticks + eng.admit_batches:
            raise AssertionError(f"{dev}: host_syncs {eng.host_syncs}")
        log(f"  {dev}: {sum(len(t) for t, _ in runs[dev])} events, "
            f"{eng.ticks} ticks in {time.perf_counter() - t0:.2f}s")
    # tolerance: the card and the CPU differ in fp32 summation order and in
    # sin/cos of the ~1e4-1e5 rad age-encoding angles; 1e-3 relative on a
    # waiting time is ~3x the port-vs-JAX disagreement measured on the CPU
    held = par.check_trajectories(
        prompts, runs[DEVICE], us, par.port_logits_fn(params["cpu"], cfg),
        margin_tol=1e-3, age_rtol=1e-3, max_age=cfg.max_age,
        death_token=cfg.death_token, max_context=W)
    free = par.compare_runs(runs["cpu"], runs[DEVICE], age_rtol=0.25)
    log(f"  card trajectories held step by step against the CPU model: "
        f"{held['steps']} steps, {len(held['near_ties'])} near-ties, largest "
        f"age-increment rel err {held['max_age_rel_err']:.3g} (tol 1e-3)")
    log(f"  free-running card vs CPU: {free['compared']} events equal before"
        f" the first divergence; divergences at {free['divergences']}")
    return {"held": held, "free": free}


def paged_parity() -> dict:
    """On the card with injected uniforms, full-width Delphi-2M in fp32 and
    in bf16: the ring and the paged engine (16-token blocks) give the same
    tokens and fp32 ages bit for bit over phase 4's prompts plus one
    over-width prompt (300 events > max_context 256); and sample_futures
    (16 futures, 48 events) on the ring, the paged and the prefix-cached
    paged engine (twice) equals the port's ring_reference_futures bit for
    bit."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.data import SimulatorConfig, generate_dataset
    from repro_torch.models import init_params
    from repro_torch.serve import (BatchedEngine, Request,
                                   ring_reference_futures)
    base = get_config("delphi-2m")
    W, V, max_new = base.max_seq_len, base.vocab_size, 48
    trajs, _ = generate_dataset(SimulatorConfig(n_train=24, n_val=1,
                                                seed=SEED + 17))
    prompts = [(t[:max(len(t) // 2, 1)], a[:max(len(t) // 2, 1)])
               for t, a in trajs]
    rng = np.random.default_rng(SEED + 7)
    prompts.append((rng.integers(3, V, 300).astype(np.int32),
                    np.sort(rng.uniform(20, 70, 300)).astype(np.float32)))
    us = [rng.random((max_new, V), dtype=np.float32) for _ in prompts]
    fut_u = rng.random((FUTURES_N, max_new, V), dtype=np.float32)
    ftoks, fages = prompts[0]
    out = {}
    for dt in ("float32", "bfloat16"):
        cfg = base.replace(dtype=dt)
        params = init_params(cfg, seed=SEED + 1, device=DEVICE)
        runs = {}
        for kind in ("ring", "paged"):
            eng = BatchedEngine(params, cfg, slots=16, max_context=W,
                                cache=kind, device=DEVICE)
            reqs = [Request(tokens=t, ages=a, max_new=max_new, uniforms=u)
                    for (t, a), u in zip(prompts, us)]
            for r in reqs:
                eng.submit(r)
            eng.run()
            if not all(r.done and r.error is None for r in reqs):
                raise AssertionError(f"{dt} {kind}: a request failed")
            runs[kind] = [(r.out_tokens, r.out_ages) for r in reqs]
        if runs["ring"] != runs["paged"]:
            bad = [i for i, (x, y) in enumerate(zip(runs["ring"],
                                                    runs["paged"])) if x != y]
            raise AssertionError(f"{dt}: ring != paged at requests {bad}")
        if eng.allocator.used:
            raise AssertionError(f"{dt}: {eng.allocator.used} blocks leaked")
        ora = ring_reference_futures(params, cfg, ftoks, fages, n=FUTURES_N,
                                     max_new=max_new, uniforms=fut_u,
                                     slots=16, max_context=W, device=DEVICE)
        for kind, kw, rounds in (
                ("ring", {}, 1), ("paged", {"cache": "paged"}, 1),
                ("prefix-cached paged", {"cache": "paged",
                                         "prefix_cache": True}, 2)):
            eng = BatchedEngine(params, cfg, slots=16, max_context=W,
                                device=DEVICE, **kw)
            for rnd in range(rounds):
                kids = eng.sample_futures(ftoks, fages, n=FUTURES_N,
                                          max_new=max_new, uniforms=fut_u)
                got = [(k.out_tokens, k.out_ages) for k in kids]
                if got != ora:
                    raise AssertionError(f"{dt} {kind} round {rnd}: fork "
                                         f"!= ring_reference_futures")
            if eng.paged:
                eng.drop_prefix_cache()
                if eng.allocator.used or eng.pool._refs:
                    raise AssertionError(f"{dt} {kind}: leaked blocks")
        ev = sum(len(t) for t, _ in runs["ring"])
        fev = sum(len(t) for t, _ in ora)
        log(f"  {dt}: ring == paged bit for bit ({len(prompts)} requests, "
            f"{ev} events, one prompt of 300 > {W}); fork == "
            f"ring_reference_futures bit for bit on ring, paged, "
            f"prefix-cached paged x2 ({FUTURES_N} futures, {fev} events)")
        out[dt] = {"requests": len(prompts), "events": ev,
                   "futures_events": fev}
    return out


def chunked_parity() -> dict:
    """On the card with injected uniforms, full-width Delphi-2M in fp32 and
    in bf16, each request alone on a fresh paged engine (16-token blocks,
    max_context 256) and held bit for bit against the port's
    ``chunked_reference_trajectory``: the unchunked engine against the
    oracle at an unbounded budget (the engine == straight-line oracle gate
    of the paged engine), the chunked engine at one block and at 64 tokens
    against the oracle at that budget, a partial prefix hit (a 160-event
    registrant, then its 200-event extension) against the oracle with
    ``matched_tokens``; ``sample_futures`` from a parent prefilled in one
    chunk against the unchunked engine's, and from one prefilled in 7
    chunks against the oracle on each future's uniforms (a multi-chunk
    prefill is not bit-equal to the monolithic one: its softmax runs over
    other key widths)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serve import (BatchedEngine, Request,
                                   chunked_reference_trajectory)
    base = get_config("delphi-2m")
    W, V, max_new = base.max_seq_len, base.vocab_size, 24
    rng = np.random.default_rng(SEED + 29)
    prompts = [(rng.integers(3, V, S).astype(np.int32),
                np.sort(rng.uniform(20, 70, S)).astype(np.float32))
               for S in (5, 21, 100, 200)]
    us = [rng.random((max_new, V), dtype=np.float32) for _ in prompts]
    fut_u = rng.random((4, max_new, V), dtype=np.float32)
    out = {}
    for dt in ("float32", "bfloat16"):
        cfg = base.replace(dtype=dt)
        params = init_params(cfg, seed=SEED + 1, device=DEVICE)

        def engine(**kw):
            return BatchedEngine(params, cfg, slots=4, max_context=W,
                                 cache="paged", block_size=16, device=DEVICE,
                                 **kw)

        def serve(eng, toks, ages, u):
            r = Request(tokens=toks, ages=ages, max_new=max_new, uniforms=u)
            eng.submit(r)
            eng.run()
            leaked = eng.prefix is None and eng.allocator.used
            if r.error is not None or leaked:
                raise AssertionError(f"{dt}: a request failed or leaked")
            return (r.out_tokens, r.out_ages)

        def oracle(toks, ages, u, chunk, matched=0):
            return chunked_reference_trajectory(
                params, cfg, toks, ages, max_new=max_new, uniforms=u,
                chunk_tokens=chunk, matched_tokens=matched, slots=4,
                max_context=W, block_size=16, device=DEVICE)
        checks = 0
        for (toks, ages), u in zip(prompts, us):
            S = len(toks)
            if serve(engine(), toks, ages, u) != oracle(toks, ages, u, W):
                raise AssertionError(f"{dt} S={S}: the paged engine != "
                                     f"chunked_reference_trajectory")
            for budget in (16, 64):
                got = serve(engine(prefill_chunk_tokens=budget), toks, ages,
                            u)
                if got != oracle(toks, ages, u, budget):
                    raise AssertionError(f"{dt} S={S}: the chunked engine "
                                         f"({budget}) != the oracle")
            checks += 3
        toks, ages = prompts[-1]
        eng = engine(prefix_cache=True, prefill_chunk_tokens=64)
        serve(eng, toks[:160], ages[:160], us[0])
        got = serve(eng, toks, ages, us[-1])
        if eng.pool_stats()["suffix_tokens_saved"] != 160 or \
                got != oracle(toks, ages, us[-1], 64, matched=160):
            raise AssertionError(f"{dt}: the partial hit != the oracle with "
                                 f"matched_tokens=160 "
                                 f"({eng.pool_stats()['suffix_tokens_saved']}"
                                 f" tokens saved)")
        def futures(ftoks, fages, **kw):
            feng = engine(**kw)
            kids = feng.sample_futures(ftoks, fages, n=4, max_new=max_new,
                                       uniforms=fut_u)
            if feng.allocator.used or feng.pool_stats()["chunked_prefills"] \
                    != (1 if kw else 0):
                raise AssertionError(f"{dt}: fork: {feng.pool_stats()}")
            return [(k.out_tokens, k.out_ages) for k in kids]
        # a parent prefilled in one chunk (64 >= 21 events): the unchunked
        # fork's bits; one prefilled in 7 chunks (16 a step, 100 events):
        # each future == the oracle on its uniforms
        ftoks, fages = prompts[1]
        if futures(ftoks, fages, prefill_chunk_tokens=64) != \
                futures(ftoks, fages):
            raise AssertionError(f"{dt}: the fork from a one-chunk parent "
                                 f"!= the unchunked fork")
        ftoks, fages = prompts[2]
        want = [oracle(ftoks, fages, fut_u[j], 16) for j in range(4)]
        if futures(ftoks, fages, prefill_chunk_tokens=16) != want:
            raise AssertionError(f"{dt}: the fork from a 7-chunk parent != "
                                 f"the oracle per future")
        log(f"  {dt}: unchunked paged == chunked_reference_trajectory "
            f"(unbounded budget) and chunked (16, 64) == the oracle, bit for "
            f"bit, at prompts of {[len(t) for t, _ in prompts]} events; "
            f"partial hit (160 of 200 matched) == the oracle; 4 futures "
            f"forked from a parent prefilled in one chunk == the unchunked "
            f"fork, and from one prefilled in 7 chunks == the oracle per "
            f"future")
        out[dt] = {"checks": checks + 3, "prompt_lengths":
                   [len(t) for t, _ in prompts]}
    return out


def risk_checks(fut: dict) -> dict:
    """Risk on the card: ``monte_carlo_risk`` over phase 3d's first 16
    futures (patient 0) equals the host-side ``futures_risk_items`` and
    ``futures_chapter_risk`` on the same futures exactly; analytic
    next-event risk from the card's logits on the 4 patients' histories,
    on the card and on the CPU, within 1e-6 (fp32 logsumexp, softmax and
    exp in two libraries; the port-vs-JAX difference on the CPU was below
    2.4e-7)."""
    import numpy as np
    import torch
    from repro_torch.core import risk
    from repro_torch.models import forward
    params, cfg = fut["params"], fut["cfg"]
    V = cfg.vocab_size
    toks, ages = fut["patients"][0]
    kids = fut["calls"][0]
    futs = [(k.out_tokens, k.out_ages) for k in kids]
    packed = risk.pack_futures_trajectories(toks, ages, futs,
                                            max_new=FUTURES_MAX_NEW,
                                            device=DEVICE)
    mc = risk.monte_carlo_risk(
        params, cfg, torch.as_tensor(toks, device=DEVICE),
        torch.as_tensor(np.asarray(ages, np.float32), device=DEVICE),
        horizon=5.0, chapter_of=risk.disease_chapter_map(V, DEVICE),
        trajectories=packed)
    age0 = float(np.float32(ages[-1]))
    items = dict(risk.futures_risk_items(futs, age0, 5.0, V, top=V))
    want = np.asarray([items[i] for i in range(V)], np.float32)
    chap = risk.futures_chapter_risk(futs, age0, 5.0, V).astype(np.float32)
    if not (np.array_equal(mc["code_risk"].cpu().numpy(), want)
            and np.array_equal(mc["chapter_risk"].cpu().numpy(), chap)):
        raise AssertionError("monte_carlo_risk on the card != the host "
                             "aggregation of the same futures")
    lgs = []
    for t, a in fut["patients"]:
        o = forward(params, cfg, {
            "tokens": torch.as_tensor(t[None], device=DEVICE),
            "ages": torch.as_tensor(np.asarray(a, np.float32)[None],
                                    device=DEVICE)}, mode="prefill")
        lgs.append(o["logits"][:, 0].float())
    lg = torch.cat(lgs)
    card = risk.analytic_next_event_risk(lg, 5.0)
    cpu = risk.analytic_next_event_risk(lg.cpu(), 5.0)
    err = float((card.cpu() - cpu).abs().max())
    if not (err <= 1e-6 and bool(torch.isfinite(card).all())):
        raise AssertionError(f"analytic risk card vs CPU: err {err} > 1e-6")
    top = mc["code_risk"].argsort(descending=True)[:3].tolist()
    log(f"  monte_carlo_risk over phase 3d's 16 futures of patient 0 == the "
        f"host aggregation (codes and chapters, exactly); death risk "
        f"{float(mc['death_risk']):.4f}, top codes {top}; analytic risk "
        f"card vs CPU on {lg.shape[0]} patients: max abs err {err:.3g} "
        f"(tol 1e-6)")
    return {"death_risk": float(mc["death_risk"]), "analytic_err": err}


def mamba_config():
    from repro_torch.configs import get_config
    return get_config("mamba2-780m")


def mamba_prompts(vocab: int):
    """16 prompts of seeded random token ids, 96 to 1024 tokens (1024 is a
    multiple of the 128-token chunk; the others are not), in seeded order."""
    import numpy as np
    rng = np.random.default_rng(SEED + 3)
    lens = np.linspace(96, 1024, MAMBA_REQUESTS).astype(int)
    rng.shuffle(lens)
    return [rng.integers(0, vocab, int(S)).astype(np.int32) for S in lens]


def mamba_serve(params, cfg, prompts, max_new: int):
    """Serve ``prompts`` with generator uniforms; returns (engine, requests,
    seconds of ``run()`` ending in a device synchronise)."""
    import torch
    from repro_torch.serve import BatchedEngine, Request
    eng = BatchedEngine(params, cfg, slots=MAMBA_SLOTS,
                        max_context=cfg.max_seq_len, seed=SEED, device=DEVICE)
    reqs = [Request(tokens=t, max_new=max_new) for t in prompts]
    for r in reqs:
        eng.submit(r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    return eng, reqs, time.perf_counter() - t0


def mamba_path() -> dict:
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import init_params
    cfg = mamba_config()
    params = init_params(cfg, seed=SEED, device=DEVICE)
    prompts = mamba_prompts(cfg.vocab_size)
    # first use of cuBLAS and the allocator at these shapes, same entry point
    mamba_serve(params, cfg, prompts[:2], 2)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    eng, reqs, sec = mamba_serve(params, cfg, prompts, MAMBA_MAX_NEW)
    counts = ops.launch_counts()
    if not all(r.done and r.error is None for r in reqs):
        raise AssertionError("a Mamba2 request did not finish")
    for r in reqs:
        toks = r.out_tokens
        if len(toks) != MAMBA_MAX_NEW or r.out_ages or not all(
                0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f"bad Mamba2 output {toks} {r.out_ages}")
    if eng.host_syncs != eng.ticks + eng.admit_batches:
        raise AssertionError(f"host_syncs {eng.host_syncs} != ticks "
                             f"{eng.ticks} + admit_batches "
                             f"{eng.admit_batches}")
    want_shapes = {(1, len(t)) for t in prompts}
    if eng.prefill_shapes != want_shapes:
        raise AssertionError(f"prefill shapes {sorted(eng.prefill_shapes)}")
    if counts["ssd_intra"] != cfg.n_layers * eng.admit_batches \
            or eng.admit_batches != len(prompts):
        raise AssertionError(f"ssd_intra launched {counts['ssd_intra']} "
                             f"times for {eng.admit_batches} admissions")
    return {"engine": eng, "seconds": sec, "tokens": len(reqs) * MAMBA_MAX_NEW,
            "launches": counts, "params": params, "cfg": cfg,
            "prompts": prompts}


def mamba_parity() -> dict:
    """fp32 Mamba2-780M at full width, cut to 4 layers: the engine on the
    card (kernels) and on the CPU (plain versions) with the same weights
    and injected uniforms; the card's tokens held step by step against the
    CPU model's Gumbel scores."""
    import numpy as np
    from repro_torch.core import parity as par
    from repro_torch.models import init_params
    from repro_torch.serve import BatchedEngine, Request
    cfg = mamba_config().replace(n_layers=4, dtype="float32")
    max_new, V = 16, cfg.vocab_size
    rng = np.random.default_rng(SEED + 5)
    prompts = [rng.integers(0, V, S).astype(np.int32)
               for S in (100, 237, 384, 520)]
    us = [rng.random((max_new, V), dtype=np.float32) for _ in prompts]
    runs, params = {}, {}
    for dev in (DEVICE, "cpu"):
        params[dev] = init_params(cfg, seed=SEED + 1, device=dev)
        eng = BatchedEngine(params[dev], cfg, slots=4,
                            max_context=cfg.max_seq_len, device=dev)
        reqs = [Request(tokens=t, max_new=max_new, uniforms=u)
                for t, u in zip(prompts, us)]
        for r in reqs:
            eng.submit(r)
        t0 = time.perf_counter()
        eng.run()
        runs[dev] = [r.out_tokens for r in reqs]
        if eng.host_syncs != eng.ticks + eng.admit_batches or any(
                len(t) != max_new for t in runs[dev]):
            raise AssertionError(f"{dev}: host_syncs {eng.host_syncs}, "
                                 f"lengths {[len(t) for t in runs[dev]]}")
        log(f"  mamba2 {dev}: {sum(len(t) for t in runs[dev])} tokens, "
            f"{eng.ticks} ticks in {time.perf_counter() - t0:.2f}s")
    # tolerance: the card and the CPU sum fp32 products in other orders
    # (cuBLAS, the SSD kernel); logits of this model are O(1), and their
    # card-vs-CPU differences are ~1e-5, so a score gap under 1e-3 is a tie
    held = par.check_lm_trajectories(
        prompts, runs[DEVICE], us, par.port_logits_fn(params["cpu"], cfg),
        margin_tol=1e-3)
    free = par.compare_runs([(t, []) for t in runs["cpu"]],
                            [(t, []) for t in runs[DEVICE]], age_rtol=0.0)
    log(f"  mamba2 card tokens held step by step against the CPU model: "
        f"{held['steps']} steps, {len(held['near_ties'])} near-ties "
        f"(score margin 1e-3)")
    log(f"  mamba2 free-running card vs CPU: {free['compared']} tokens equal"
        f" before the first divergence; divergences at {free['divergences']}")
    return {"held": held, "free": free}


# ---------------------------------------------------------------------------
# phase 3g / 3h: the serving surface on the card (HTTP server, router)
# ---------------------------------------------------------------------------
HTTP_CLIENTS, HTTP_REQUESTS, HTTP_MAX_NEW = 8, 32, 48
HTTP_STREAMS, HTTP_RISKS, HTTP_EXACT = 8, 4, 4
HTTP_KNOBS = dict(slots=16, max_context=256, cache="paged", prefix_cache=True)


def http_prompts():
    """Phase 3's 32 prompts: the first halves of the same synthetic
    patients (``repro_torch.launch.serve``), as JSON-ready lists."""
    from repro_torch.data import SimulatorConfig, generate_dataset
    trajs, _ = generate_dataset(SimulatorConfig(
        n_train=HTTP_REQUESTS, n_val=1, seed=SEED + 17))
    out = []
    for t, a in trajs:
        half = max(len(t) // 2, 1)
        out.append(([int(x) for x in t[:half]],
                    [float(x) for x in a[:half]]))
    return out


def serving_backend(params, cfg):
    """Phase 3d's knobs: a prefix-cached paged engine, 16 slots."""
    from repro_torch.api.client import EngineBackend
    return EngineBackend.create(params, cfg, seed=SEED, device=DEVICE,
                                **HTTP_KNOBS)


def check_result(r, cfg, max_new: int) -> None:
    import numpy as np
    toks = np.asarray(r.tokens)
    ages = np.asarray(r.ages, np.float64)
    if len(toks) > max_new or len(ages) != len(toks) or (
            len(toks) and (toks.min() < 0 or toks.max() >= cfg.vocab_size)):
        raise AssertionError(f"bad result {r.tokens} {r.ages}")
    if not (np.isfinite(ages).all() and (np.diff(ages) >= 0).all()):
        raise AssertionError(f"bad ages {r.ages}")


def concurrent(make_client, jobs, fn, threads: int = HTTP_CLIENTS):
    """``fn(client, job)`` over ``jobs`` from ``threads`` threads, each
    with its own client from ``make_client()``, job i on thread i % threads.
    Returns (results in job order, wall seconds ending in a device
    synchronise); any error is raised."""
    import threading
    import torch
    results = [None] * len(jobs)
    errors = []

    def worker(k):
        try:
            client = make_client()
            for i in range(k, len(jobs), threads):
                results[i] = fn(client, jobs[i])
        except Exception as e:                  # noqa: BLE001
            errors.append(e)
    ts = [threading.Thread(target=worker, args=(k,)) for k in range(threads)]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=600)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    if any(t.is_alive() for t in ts) or any(r is None for r in results):
        raise AssertionError("a request was not answered")
    return results, wall


def generate_traffic(make_client, prompts, cfg) -> dict:
    """Phase 3's 32 prompts with generator uniforms, 48 new events each,
    from 8 concurrent clients."""
    from repro_torch.api import GenerateRequest

    def gen(client, p):
        return client.generate(GenerateRequest(tokens=p[0], ages=p[1],
                                               max_new=HTTP_MAX_NEW))
    results, wall = concurrent(make_client, prompts, gen)
    for r in results:
        check_result(r, cfg, HTTP_MAX_NEW)
    events = sum(len(r.tokens) for r in results)
    return {"wall_s": wall, "events": events, "events_per_s": events / wall}


def stream_traffic(url, prompts, cfg) -> dict:
    """``/v1/stream`` for 8 prompts from 8 concurrent clients: each
    stream's time from its POST to its first event."""
    from repro_torch.api import GenerateRequest, RemoteBackend

    def stream(client, p):
        t0 = time.perf_counter()
        it = client.stream(GenerateRequest(tokens=p[0], ages=p[1],
                                           max_new=HTTP_MAX_NEW))
        first = next(it, None)
        ttfe = time.perf_counter() - t0
        evs = ([first] if first is not None else []) + list(it)
        return ttfe, evs
    out, wall = concurrent(lambda: RemoteBackend(url), prompts, stream)
    for _, evs in out:
        if [e.index for e in evs] != list(range(len(evs))) or any(
                e.age is None or not 0 <= e.token < cfg.vocab_size
                for e in evs):
            raise AssertionError("bad stream")
    return {"ttfe_s": [t for t, _ in out],
            "events": sum(len(e) for _, e in out), "wall_s": wall}


def pct(xs, q: float) -> float:
    import numpy as np
    return float(np.percentile(np.asarray(xs, np.float64), q))


def http_exact(params, cfg, prompts, patients) -> dict:
    """On a fresh server and a fresh twin engine with the same knobs, one
    request at a time under injected uniforms: ``/v1/generate`` == the
    twin's generate bit for bit (tokens and ages), ``/v1/stream`` == that
    generate, and ``/v1/futures`` == ``ring_reference_futures``."""
    import numpy as np
    from repro_torch.api import Client, FuturesRequest
    from repro_torch.serve import ring_reference_futures
    from repro_torch.serve.server import InferenceServer
    V = cfg.vocab_size
    rng = np.random.default_rng(SEED + 41)
    server = InferenceServer(serving_backend(params, cfg), port=0).start()
    try:
        remote = Client.connect(server.address)
        twin = Client.from_engine(serving_backend(params, cfg).engine)
        events = 0
        for t, a in prompts[:HTTP_EXACT]:
            u = rng.random((HTTP_MAX_NEW, V), dtype=np.float32)
            r = remote.generate(tokens=t, ages=a, max_new=HTTP_MAX_NEW,
                                uniforms=u)
            w = twin.generate(tokens=t, ages=a, max_new=HTTP_MAX_NEW,
                              uniforms=u)
            if not r.tokens or (r.tokens, r.ages) != (w.tokens, w.ages):
                raise AssertionError(f"/v1/generate {r.tokens} != the twin "
                                     f"engine's {w.tokens}")
            evs = list(remote.stream(tokens=t, ages=a, max_new=HTTP_MAX_NEW,
                                     uniforms=u))
            if [(e.token, e.age) for e in evs] != list(zip(r.tokens,
                                                           r.ages)):
                raise AssertionError("/v1/stream != /v1/generate")
            events += len(r.tokens)
        t, a = patients[0]
        fu = rng.random((FUTURES_N, 16, V), dtype=np.float32)
        fr = remote.sample_futures(FuturesRequest(
            tokens=[int(x) for x in t], ages=[float(x) for x in a],
            n_futures=FUTURES_N, max_new=16, uniforms=fu))
        ora = ring_reference_futures(params, cfg, t, a, n=FUTURES_N,
                                     max_new=16, uniforms=fu,
                                     slots=HTTP_KNOBS["slots"],
                                     max_context=HTTP_KNOBS["max_context"],
                                     device=DEVICE)
        if [(x.tokens, x.ages) for x in fr.trajectories] != \
                [(list(k), [float(y) for y in g]) for k, g in ora]:
            raise AssertionError("/v1/futures != ring_reference_futures")
    finally:
        server.stop()
    return {"generate_events": events,
            "futures_events": sum(len(x.tokens) for x in fr.trajectories)}


def http_risk(url, params, cfg, prompts) -> float:
    """``/v1/risk`` for 4 prompts against ``core/risk.py`` on logits that
    the card computes here: each item's risk within 1e-5 relative, and the
    items the top ones (up to ties within that tolerance).  Returns the
    largest relative difference."""
    import numpy as np
    import torch
    from repro_torch.api import Client
    from repro_torch.core.risk import analytic_next_event_risk_np
    from repro_torch.models import cast_params, forward
    remote = Client.connect(url)
    wp = cast_params(params, cfg)
    worst = 0.0
    for t, a in prompts[:HTTP_RISKS]:
        rep = remote.risk(t, a, horizon=5.0, top=10)
        S = max(cfg.max_seq_len, len(t))
        tok = np.zeros((1, S), np.int32)
        tok[0, :len(t)] = t
        age = np.full((1, S), a[-1], np.float32)
        age[0, :len(a)] = a
        with torch.no_grad():
            lg = forward(wp, cfg, {
                "tokens": torch.from_numpy(tok).to(DEVICE),
                "ages": torch.from_numpy(age).to(DEVICE)},
                mode="train")["logits"][0, len(t) - 1]
        want = analytic_next_event_risk_np(lg.float().cpu().numpy(), 5.0)
        got = np.asarray([i.risk for i in rep.items])
        ids = [i.token for i in rep.items]
        rel = np.abs(got - want[ids]) / np.maximum(want[ids], 1e-30)
        kth = np.sort(want)[::-1][len(ids) - 1]
        if len(ids) != 10 or rel.max() > 1e-5 or \
                want[ids].min() < kth * (1 - 1e-5):
            raise AssertionError(f"/v1/risk != core/risk.py: {rel.max()}")
        worst = max(worst, float(rel.max()))
    return worst


class CliServer:
    """``python -m repro_torch.serve.server <source> --port 0 --device
    cuda`` as a subprocess (``--config delphi-2m``: the CLI's fp32 route;
    ``--artifact DIR``: an exported artifact), started here so that it
    boots while its phase goes on; :meth:`check` then waits for its
    address line and holds ``/v1/healthz`` (the engine running) or
    ``/v1/manifest`` (the FAIR manifest of an artifact), one
    ``/v1/generate``, SIGINT, exit code 0.  The process is killed on any
    failure."""

    def __init__(self, source=("--config", "delphi-2m")):
        import queue
        import threading
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.serve.server", *source,
             "--port", "0", "--device", DEVICE],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")),
            cwd=ROOT)
        self.lines: "queue.Queue" = queue.Queue()

        def read():
            # each line with the seconds since the start (the boot's end
            # is the address line's arrival, however late it is read)
            for ln in self.proc.stdout:
                self.lines.put((time.perf_counter() - self.t0, ln))
        self.reader = threading.Thread(target=read, daemon=True)
        self.reader.start()

        self.url, self.seen, self.boot_s = None, [], None

    def booted(self) -> str:
        """Wait (up to 180 s) for the address line; its URL."""
        import queue
        deadline = time.monotonic() + 180
        while self.url is None and time.monotonic() < deadline:
            try:
                self.boot_s, ln = self.lines.get(
                    timeout=max(deadline - time.monotonic(), 0.1))
            except queue.Empty:
                break
            self.seen.append(ln.rstrip())
            if " backend on http://" in ln:
                self.url = ln.split(" backend on ")[1].split()[0]
        if self.url is None:
            self.close()
            raise AssertionError("the server CLI printed no address: "
                                 + " | ".join(self.seen))
        return self.url

    def check(self, backend: str = "engine") -> dict:
        import signal
        from urllib.request import urlopen
        from repro_torch.api import Client
        try:
            url = self.booted()
            if backend == "engine":
                with urlopen(url + "/v1/healthz", timeout=60) as r:
                    health = json.loads(r.read())
                if not health["engine"]["running"]:
                    raise AssertionError(f"healthz: {health}")
            else:
                with urlopen(url + "/v1/manifest", timeout=60) as r:
                    manifest = json.loads(r.read())
                if (manifest["backend"] != backend
                        or "provenance" not in manifest.get("artifact", {})):
                    raise AssertionError(f"manifest: {manifest}")
            res = Client.connect(url).generate(tokens=[3, 10, 20],
                                               ages=[0.0, 15.0, 28.0],
                                               max_new=8)
            if res.backend != f"remote[{backend}]":
                raise AssertionError(f"CLI generate: {res}")
            self.proc.send_signal(signal.SIGINT)
            rc = self.proc.wait(timeout=60)
            if rc != 0:
                raise AssertionError(f"the server CLI exited {rc} on SIGINT")
        finally:
            self.close()
        return {"boot_s": self.boot_s, "lines": self.seen[:2],
                "events": len(res.tokens), "exit_code": rc}

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=60)
        self.reader.join(timeout=10)
        self.proc.stdout.close()


def http_path(params, cfg, patients) -> dict:
    """Phase 3g: Delphi-2M behind ``InferenceServer`` on the card."""
    import torch
    from repro_torch.api import FuturesRequest, RemoteBackend
    from repro_torch.kernels import ops
    from repro_torch.serve import server as server_mod
    from repro_torch.serve.server import InferenceServer
    prompts = http_prompts()
    backend = serving_backend(params, cfg)
    server = InferenceServer(backend, port=0).start()
    inproc = serving_backend(params, cfg)
    inproc.engine.start()
    # the same traffic's streams against a server with the stdlib's listen
    # backlog of 5 (the JAX package's server), over the in-process engine
    port_backlog = server_mod._TrackingHTTPServer.request_queue_size
    server_mod._TrackingHTTPServer.request_queue_size = 5
    try:
        backlog5 = InferenceServer(inproc, port=0).start()
    finally:
        server_mod._TrackingHTTPServer.request_queue_size = port_backlog
    eng = backend.engine
    cli = None
    try:
        url = server.address
        # first use of every shape, on both engines
        generate_traffic(lambda: RemoteBackend(url), prompts[:8], cfg)
        generate_traffic(lambda: inproc, prompts[:8], cfg)
        t0, s0, a0 = eng.ticks, eng.host_syncs, eng.admit_batches
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        first = generate_traffic(lambda: RemoteBackend(url), prompts, cfg)
        counts = ops.launch_counts()
        for name in DELPHI_KERNELS:
            if counts[name] <= 0:
                raise AssertionError(f"{name} never launched over HTTP")
        turns = [("http", first["events_per_s"])]
        for mode in ("inprocess", "inprocess", "http"):
            mk = ((lambda: RemoteBackend(url)) if mode == "http"
                  else (lambda: inproc))
            turns.append((mode, generate_traffic(mk, prompts,
                                                 cfg)["events_per_s"]))
        ttfe = {port_backlog: [], 5: []}
        for backlog in (5, port_backlog, port_backlog, 5):
            at = url if backlog == port_backlog else backlog5.address
            ttfe[backlog] += stream_traffic(at, prompts[:HTTP_STREAMS],
                                            cfg)["ttfe_s"]
        prof = path_profile(
            lambda: generate_traffic(lambda: RemoteBackend(url), prompts,
                                     cfg)["wall_s"], first["wall_s"])
        # the server CLI boots while the futures, risk and exactness
        # checks run (none of them timed)
        cli = CliServer()
        futs = []
        remote = RemoteBackend(url)
        for t, a in patients:
            fr = remote.sample_futures(FuturesRequest(
                tokens=[int(x) for x in t], ages=[float(x) for x in a],
                n_futures=FUTURES_N, max_new=FUTURES_MAX_NEW))
            for r in fr.trajectories:
                check_result(r, cfg, FUTURES_MAX_NEW)
            futs.append(sum(len(r.tokens) for r in fr.trajectories))
        risk_err = http_risk(url, params, cfg, prompts)
        health = remote.healthz()
        remote.close()
    except BaseException:
        if cli is not None:
            cli.close()
        raise
    finally:
        server.stop()
        backlog5.stop()
        inproc.engine.stop()
    if eng.host_syncs != eng.ticks + eng.admit_batches:
        raise AssertionError(f"host_syncs {eng.host_syncs} != ticks "
                             f"{eng.ticks} + admit_batches "
                             f"{eng.admit_batches}")
    if any(r is not None for r in eng.slot_req) or eng.pending:
        raise AssertionError("the server's engine did not drain")
    eng.drop_prefix_cache()
    if eng.allocator.used or eng.pool._refs:
        raise AssertionError("the server's engine leaked blocks")
    try:
        exact = http_exact(params, cfg, prompts, patients)
    except BaseException:
        cli.close()
        raise
    cli_res = cli.check()
    return {"events": first["events"], "wall_s": first["wall_s"],
            "events_per_s": first["events_per_s"],
            "ticks": eng.ticks - t0, "host_syncs": eng.host_syncs - s0,
            "admit_batches": eng.admit_batches - a0,
            "launches": counts, "turns": turns,
            "http_over_inprocess": (
                sum(r for m, r in turns if m == "http")
                / sum(r for m, r in turns if m == "inprocess")),
            "sse_ttfe_p50_ms": 1e3 * pct(ttfe[port_backlog], 50),
            "sse_ttfe_p95_ms": 1e3 * pct(ttfe[port_backlog], 95),
            "sse_streams": len(ttfe[port_backlog]),
            "sse_backlog": port_backlog,
            "sse_ttfe_backlog5_p50_ms": 1e3 * pct(ttfe[5], 50),
            "sse_ttfe_backlog5_p95_ms": 1e3 * pct(ttfe[5], 95),
            "sse_ttfe_s": {str(k): v for k, v in ttfe.items()},
            "futures_events": futs, "risk_max_rel_err": risk_err,
            "profile": prof, "exact": exact, "cli": cli_res,
            "healthz_engine": health["engine"]}


def router_path(params, cfg, patients) -> dict:
    """Phase 3h: ``RouterServer`` over 2 in-process paged replicas on the
    card (the reference's ``--replica-mode inprocess``)."""
    import threading
    from repro_torch.api import Client, GenerateRequest, RemoteBackend
    from repro_torch.serve.router import ReplicaSupervisor, RouterServer
    from repro_torch.serve.server import InferenceServer
    import numpy as np
    prompts = http_prompts()
    V = cfg.vocab_size

    def replicas():
        return ReplicaSupervisor.in_process(
            lambda i: serving_backend(params, cfg), 2, probe_interval=0.2)
    # affinity: each patient's futures twice
    sup = replicas()
    router = RouterServer(sup, port=0).start()
    t0 = time.perf_counter()
    try:
        remote = Client.connect(router.address)
        visits = []
        for rnd in range(2):
            a0 = router.scheduler.stats()["affinity_routed"]
            hits0 = {r.name: r.server.backend.engine.prefix.hits
                     for r in sup.replicas}
            names = []
            for t, a in patients:
                fr = remote.sample_futures(
                    tokens=[int(x) for x in t], ages=[float(x) for x in a],
                    n_futures=FUTURES_N, max_new=FUTURES_MAX_NEW)
                for r in fr.trajectories:
                    check_result(r, cfg, FUTURES_MAX_NEW)
                names.append(fr.backend.split("router[")[1].split(":")[0])
            hits = {r.name: r.server.backend.engine.prefix.hits - hits0[
                r.name] for r in sup.replicas}
            visits.append({"replicas": names, "prefix_hits": hits,
                           "affinity_routed": router.scheduler.stats()[
                               "affinity_routed"] - a0})
        first, second = visits
        if second["replicas"] != first["replicas"] or \
                second["affinity_routed"] != len(patients):
            raise AssertionError(f"second visits not routed by affinity: "
                                 f"{visits}")
        for name in set(first["replicas"]):
            if second["prefix_hits"][name] != first["replicas"].count(name):
                raise AssertionError(f"the holder's prefix hits did not "
                                     f"rise: {visits}")
        # drain one replica under load: every request is answered
        out, errs = {}, []

        def client(k):
            try:
                rb = RemoteBackend(router.address)
                for i in range(k, 16, 8):
                    t, a = prompts[i]
                    out[i] = rb.generate(GenerateRequest(
                        tokens=t, ages=a, max_new=HTTP_MAX_NEW))
            except Exception as e:              # noqa: BLE001
                errs.append(e)
        ts = [threading.Thread(target=client, args=(k,)) for k in range(8)]
        for t in ts:
            t.start()
        time.sleep(0.05)
        drained = router.drain_replica("r0", timeout=120.0)
        for t in ts:
            t.join(timeout=300)
        if errs or len(out) != 16 or not drained:
            raise AssertionError(f"drain: {len(out)} of 16 answered, "
                                 f"drained {drained}, errors {errs[:1]}")
        for r in out.values():
            check_result(r, cfg, HTTP_MAX_NEW)
        after = [remote.generate(tokens=t, ages=a, max_new=8).backend
                 for t, a in prompts[16:20]]
        if not all("router[r1:" in b for b in after):
            raise AssertionError(f"after the drain: {after}")
        sched = router.scheduler.stats()
    finally:
        router.stop()
    wall = time.perf_counter() - t0
    # router == a direct server, one request at a time, both fresh
    sup = replicas()
    router = RouterServer(sup, port=0).start()
    direct = InferenceServer(serving_backend(params, cfg), port=0).start()
    try:
        rng = np.random.default_rng(SEED + 43)
        via_r, via_d = Client.connect(router.address), Client.connect(
            direct.address)
        for t, a in prompts[:HTTP_EXACT]:
            u = rng.random((HTTP_MAX_NEW, V), dtype=np.float32)
            x = via_r.generate(tokens=t, ages=a, max_new=HTTP_MAX_NEW,
                               uniforms=u)
            y = via_d.generate(tokens=t, ages=a, max_new=HTTP_MAX_NEW,
                               uniforms=u)
            if not x.tokens or (x.tokens, x.ages) != (y.tokens, y.ages):
                raise AssertionError(f"router {x.tokens} != direct "
                                     f"{y.tokens}")
    finally:
        router.stop()
        direct.stop()
    return {"visits": visits, "scheduler": sched, "drained": drained,
            "wall_s": wall, "exact_prompts": HTTP_EXACT}


# ---------------------------------------------------------------------------
# phases 6a-6d and 3i: training, federated fine-tuning, the cohort sweep and
# the canary loop on the card
# ---------------------------------------------------------------------------
# 6b's steps cut from 200 to 100 to make room for 6j, 6k and 3v
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_PATIENTS = 32, 128, 100, 2048
# card against CPU, fp32 with TF32 off: the same arithmetic summed in other
# orders (cuBLAS, reductions) and sin/cos of the ~1e4-1e5 rad age angles on
# two libraries (the frequency table itself is the same bits, built on the
# host); a gradient off by more than this share of its leaf's largest
# element is a fault, not rounding
GRAD_CARD_REL = 1e-3
FED_CLIENTS, FED_ROUNDS, FED_LOCAL_STEPS, FED_CLIP = 3, 2, 2, 2.0
SWEEP_PATIENTS, SWEEP_FUTURES, SWEEP_MAX_NEW = 32, 8, 32
# assert_sweep_parity's patients cut from 8 to 4 to make room for 6j,
# 6k and 3v
SWEEP_IN_FLIGHT, SWEEP_EXACT, SWEEP_SEED = 4, 4, 13
CANARIES, CANARY_SECRET, CANARY_PREFIX, CANARY_REPEATS = 8, 3, 6, 8
CANARY_STEPS, CANARY_BATCH, CANARY_SEQ = 150, 32, 48


def train_batches(n: int, seed: int) -> list:
    """``n`` full-width training batches (32 x 128) from
    ``pack_trajectories`` over freshly simulated patients."""
    from repro_torch.data import (SimulatorConfig, batches,
                                  generate_dataset, pack_trajectories)
    trajs, _ = generate_dataset(SimulatorConfig(
        n_train=n * TRAIN_BATCH, n_val=1, seed=seed))
    it = batches(pack_trajectories(trajs, TRAIN_SEQ), TRAIN_BATCH, seed=seed)
    return [next(it) for _ in range(n)]


def grads_path() -> dict:
    """Phase 6a: one full-width train step in fp32 (TF32 off) on the card;
    its loss and every gradient against the CPU port's on the same batch."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import init_params
    from repro_torch.train import (OptimizerConfig, init_opt_state,
                                   loss_and_grads, make_loss_fn,
                                   make_train_step)
    from repro_torch.train.trainer import to_device
    cfg = get_config("delphi-2m").replace(dtype="float32")
    host = init_params(cfg, seed=SEED, device="cpu")
    params = {k: v.to(DEVICE) for k, v in host.items()}
    batch = train_batches(1, SEED + 31)[0]
    loss_fn = make_loss_fn(cfg, "delphi")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    g_card, m_card = loss_and_grads(loss_fn, params, to_device(batch, DEVICE))
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    g_cpu, m_cpu = loss_and_grads(loss_fn, host, to_device(batch, "cpu"))
    worst, worst_key = 0.0, None
    for k, g in g_card.items():
        if g is None or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"6a: {k}: no finite gradient on the card")
        want = g_cpu[k].numpy()
        got = g.cpu().numpy()
        scale = float(np.abs(want).max())
        if float(np.abs(got).max()) == 0.0 and scale > 0.0:
            raise AssertionError(f"6a: {k}: all-zero gradient on the card")
        rel = float(np.abs(got - want).max()) / max(scale, 1e-30)
        if rel > worst:
            worst, worst_key = rel, k
    loss_rel = abs(float(m_card["loss"]) - float(m_cpu["loss"])) \
        / abs(float(m_cpu["loss"]))
    if worst > GRAD_CARD_REL or loss_rel > 1e-5:
        raise AssertionError(f"6a: card vs CPU: loss rel {loss_rel:.3g}, "
                             f"gradient {worst_key} {worst:.3g} of its "
                             f"largest element (allowed {GRAD_CARD_REL})")
    counts = ops.launch_counts()
    if any(counts.values()):
        raise AssertionError(f"6a: the training route launched a kernel: "
                             f"{counts}")
    new, state, m = make_train_step(cfg, OptimizerConfig(), "delphi")(
        params, init_opt_state(params), to_device(batch, DEVICE))
    if not all(bool(torch.isfinite(v).all()) and not v.requires_grad
               for v in new.values()) or int(state["step"]) != 1:
        raise AssertionError("6a: the updated parameters are not finite")
    if float(m["loss"]) != float(m_card["loss"]):
        raise AssertionError("6a: make_train_step's loss != loss_and_grads'")
    return {"loss_card": float(m_card["loss"]),
            "loss_cpu": float(m_cpu["loss"]), "loss_rel_err": loss_rel,
            "grad_max_rel_err": worst, "grad_worst_leaf": worst_key,
            "leaves": len(g_card), "grad_seconds": sec,
            "targets": float(batch["loss_mask"].sum())}


def train_path(out_dir: str) -> dict:
    """Phase 6b: ``python -m repro_torch.launch.train --arch delphi-2m``
    (its ``main``, in this process) for 100 steps of 32 x 128 in bf16
    activations over fp32 masters; the loss falls, no kernel launches on
    the training route; 10 steps once more for the device's idle share;
    the port's server boots on ``--ckpt`` and answers a generate."""
    import numpy as np
    import torch
    from repro_torch.api import Client
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    from repro_torch.serve import server as server_mod
    from repro_torch.train import (OptimizerConfig, init_opt_state,
                                   make_train_step)
    from repro_torch.train.trainer import to_device
    # the training's own peak: what the earlier phases still hold (their
    # models and pools) is allocated before it starts
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ops.reset_launch_counts()
    res = launch_train.main([
        "--arch", "delphi-2m", "--steps", str(TRAIN_STEPS),
        "--patients", str(TRAIN_PATIENTS), "--batch", str(TRAIN_BATCH),
        "--seq-len", str(TRAIN_SEQ), "--seed", str(SEED), "--out", out_dir,
        "--device", DEVICE])
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() - base
    if any(counts.values()):
        raise AssertionError(f"6b: training launched a kernel: {counts}")
    hist, cfg, sec = res["history"], res["cfg"], res["seconds"]
    if cfg.dtype != "bfloat16" or not all(
            v.dtype == torch.float32 and not v.requires_grad
            for v in res["params"].values()):
        raise AssertionError("6b: not bf16 activations over fp32 masters")
    steps = np.asarray(hist["step"])
    loss = np.asarray(hist["loss"])
    if not np.isfinite(loss).all():
        raise AssertionError(f"6b: loss {loss}")
    first = loss[steps < 20].mean()
    last = loss[steps >= TRAIN_STEPS - 20].mean()
    if not last < first:
        raise AssertionError(f"6b: the loss did not fall: first 20 steps "
                             f"{first:.4f}, last 20 {last:.4f}")
    # the same step function, 10 steps, without and with the profiler
    step = make_train_step(cfg, OptimizerConfig(lr=1e-5), "delphi")
    batches = [to_device(b, DEVICE) for b in train_batches(10, SEED + 41)]

    def ten():
        p, o = res["params"], init_opt_state(res["params"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in batches:
            p, o, _ = step(p, o, b)
        torch.cuda.synchronize()
        return time.perf_counter() - t0
    ten()
    wall10 = ten()
    prof = path_profile(ten, wall10)
    # the port's server on the checkpoint (its CLI's build path)
    backend = server_mod._build_backend(server_mod.parse_args(
        ["--config", "delphi-2m", "--ckpt", out_dir, "--device", DEVICE,
         "--cache", "paged"]))
    for k, v in res["params"].items():
        if not torch.equal(backend.params[k], v):
            raise AssertionError(f"6b: --ckpt served other weights ({k})")
    server = server_mod.InferenceServer(backend, port=0).start()
    try:
        r = Client.connect(server.address).generate(
            tokens=[3, 10, 20], ages=[0.0, 15.0, 28.0], max_new=8)
    finally:
        server.stop()
    if not r.tokens or len(r.tokens) != len(r.ages):
        raise AssertionError(f"6b: the served checkpoint answered {r}")
    return {"steps": TRAIN_STEPS, "seconds": sec,
            "steps_per_s": TRAIN_STEPS / sec,
            "target_tokens": res["target_tokens"],
            "target_tokens_per_s": res["target_tokens"] / sec,
            "peak_memory_bytes": peak, "loss_first20": float(first),
            "loss_last20": float(last), "history": hist,
            "ten_steps_wall_s": wall10, "profile": prof,
            "served_events": len(r.tokens), "params": res["params"],
            "cfg": cfg}


def federated_path() -> dict:
    """Phase 6c: FedAvg over 3 clients (their own patients, 64 each), 2
    rounds of 2 local steps at full width with delta clipping, from
    ``init_params(seed)``; the mean client loss falls."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import (SimulatorConfig, batches,
                                  generate_dataset, pack_trajectories)
    from repro_torch.federated import FedConfig, federated_finetune
    from repro_torch.models import init_params
    cfg = get_config("delphi-2m")
    trajs, _ = generate_dataset(SimulatorConfig(
        n_train=FED_CLIENTS * 2 * TRAIN_BATCH, n_val=1, seed=SEED + 53))
    iters = [batches(pack_trajectories(trajs[i::FED_CLIENTS], TRAIN_SEQ),
                     TRAIN_BATCH, seed=i) for i in range(FED_CLIENTS)]
    fed = FedConfig(n_rounds=FED_ROUNDS, local_steps=FED_LOCAL_STEPS,
                    local_lr=2e-3, clip_delta_norm=FED_CLIP)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED)
    rounds = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, hist = federated_finetune(
        init_params(cfg, seed=SEED, device=DEVICE), cfg, iters, fed,
        generator=gen, log_fn=lambda s: rounds.append(
            (s, time.perf_counter())), device=DEVICE)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    loss = hist["client_loss"]
    if not loss[-1] < loss[0] or not all(
            bool(torch.isfinite(v).all()) for v in params.values()):
        raise AssertionError(f"6c: mean client loss {loss}")
    return {"clients": FED_CLIENTS, "rounds": FED_ROUNDS,
            "local_steps": FED_LOCAL_STEPS, "clip_delta_norm": FED_CLIP,
            "client_loss": loss, "seconds": sec,
            "seconds_per_round": sec / FED_ROUNDS}


def sweep_patients() -> list:
    """The first halves of ``patient(i, SimulatorConfig(seed=7))``, i <
    ``SWEEP_PATIENTS``: each history's present, whose futures the sweep
    samples."""
    from repro_torch.data import SimulatorConfig, patient
    sim = SimulatorConfig(seed=7)
    out = []
    for i in range(SWEEP_PATIENTS):
        t, a = patient(i, sim)
        half = max(len(t) // 2, 1)
        out.append((t[:half], a[:half]))
    return out


def sweep_run(params, cfg, patients):
    from repro_torch.cohort import ScenarioEngine
    se = ScenarioEngine(serving_backend(params, cfg),
                        max_in_flight=SWEEP_IN_FLIGHT, seed=SWEEP_SEED)
    res = se.sweep(patients, n_futures=SWEEP_FUTURES, max_new=SWEEP_MAX_NEW,
                   horizon=10.0)
    if res.n_failed:
        raise AssertionError(f"3i: {res.n_failed} patients failed: "
                             f"{[p.error for p in res.results if not p.ok]}")
    return res


def sweep_parity(res, params, cfg, patients) -> dict:
    """``assert_sweep_parity`` on the sweep's first ``SWEEP_EXACT``."""
    import dataclasses
    from repro_torch.cohort import assert_sweep_parity
    head = dataclasses.replace(res, results=res.results[:SWEEP_EXACT])
    return assert_sweep_parity(
        head, params, cfg, patients, seed=SWEEP_SEED,
        n_futures=SWEEP_FUTURES, max_new=SWEEP_MAX_NEW, horizon=10.0,
        slots=HTTP_KNOBS["slots"], max_context=HTTP_KNOBS["max_context"],
        device=DEVICE)


def cohort_path(params, cfg) -> dict:
    """Phase 3i: a ``ScenarioEngine`` sweep of 32 patients x 8 futures x
    32 events through ``EngineBackend`` (its background loop, 4 patients
    in flight) in bf16; ``assert_sweep_parity`` bit for bit on the first 4
    patients in bf16 and in fp32; a paired counterfactual hits the prefix
    cache once per arm; the sweep once more (its first 16 patients) under
    the profiler for the idle share."""
    import numpy as np
    import torch
    from repro_torch.cohort import CounterfactualEdit, ScenarioEngine
    from repro_torch.data import SimulatorConfig, patient
    from repro_torch.data import vocab as V
    from repro_torch.kernels import ops
    patients = sweep_patients()
    sweep_run(params, cfg, patients[:4])                   # first use
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    res = sweep_run(params, cfg, patients)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    for name in DELPHI_KERNELS:
        if counts[name] <= 0:
            raise AssertionError(f"3i: {name} never launched on the sweep")
    exact = {"bfloat16": sweep_parity(res, params, cfg, patients)}
    cfg32 = cfg.replace(dtype="float32")
    res32 = sweep_run(params, cfg32, patients[:SWEEP_EXACT])
    exact["float32"] = sweep_parity(res32, params, cfg32, patients)
    # a paired counterfactual on a fresh engine: each edited arm shares
    # the baseline's blocks before its edit point
    sim = SimulatorConfig(seed=7)
    i = SWEEP_PATIENTS
    while True:
        toks, ages = patient(i, sim)
        if len(toks) >= 40 and toks[-1] != V.DEATH:
            break
        i += 1
    toks, ages = toks[:40], ages[:40]
    be = serving_backend(params, cfg)
    edits = [CounterfactualEdit("remove", int(toks[-1])),
             CounterfactualEdit("insert", int(V.DISEASE0 + 7),
                                age=float(ages[-2]))]
    reps = ScenarioEngine(be, seed=SWEEP_SEED).counterfactual(
        toks, ages, edits, n_futures=SWEEP_FUTURES, max_new=SWEEP_MAX_NEW,
        horizon=10.0)
    pc = be.engine.pool_stats()["prefix_cache"]
    arm_hits = pc["hits"] + pc["partial_hits"]
    if arm_hits != len(edits) or not all(
            r.shared_prefix_len >= len(toks) - 2 for r in reps):
        raise AssertionError(f"3i: counterfactual arms and the prefix "
                             f"cache: {pc}")
    prof = path_profile(
        lambda: sweep_run(params, cfg, patients[:16]).wall_s,
        sweep_run(params, cfg, patients[:16]).wall_s)
    lat = np.asarray([p.latency_s for p in res.results])
    return {"patients": res.n_patients, "futures": SWEEP_FUTURES,
            "max_new": SWEEP_MAX_NEW, "in_flight": SWEEP_IN_FLIGHT,
            "wall_s": res.wall_s, "patients_per_s": res.patients_per_s,
            "events": res.events_total, "events_per_s": res.events_per_s,
            "prefix_hit_rate": res.prefix_hit_rate,
            "patient_latency_p50_s": float(np.median(lat)),
            "patient_latency_p95_s": float(np.quantile(lat, 0.95)),
            "launches": counts, "exact": exact,
            "counterfactual": {"arms": len(reps), "arm_hits": arm_hits,
                               "history": len(toks),
                               "shared": [r.shared_prefix_len
                                          for r in reps]},
            "profile": prof}


def audit_subprocess(url: str, out: str) -> dict:
    """``python -m repro_torch.privacy.audit --url URL`` as a subprocess
    over the canary spec of phase 6d; its exit code, stderr summary and
    the report."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.privacy.audit", "--url", url,
         "--canaries", str(CANARIES), "--secret-len", str(CANARY_SECRET),
         "--prefix-events", str(CANARY_PREFIX), "--sim-seed", "0",
         "--seed", "0", "--n-futures", "8", "--max-new", "16",
         "--n-boot", "200", "--out", out],
        capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
    sec = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"6d: the audit exited {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    with open(out) as f:
        report = json.load(f)
    return {"report": report, "seconds": sec,
            "summary": proc.stderr.strip().splitlines()[-1]}


def canary_path(tmp: str) -> dict:
    """Phase 6d: plant 4 member canaries of 8 (3 secret codes, 8 repeats)
    into 512 simulated patients, train full-width Delphi on the card, serve
    it through ``EngineBackend`` behind ``InferenceServer`` and audit it
    over HTTP with the audit CLI as a subprocess."""
    from repro_torch.configs import get_config
    from repro_torch.data import (SimulatorConfig, batches,
                                  generate_dataset, pack_trajectories)
    from repro_torch.kernels import ops
    from repro_torch.models import init_params
    from repro_torch.privacy import inject_canaries, make_canaries
    from repro_torch.serve.server import InferenceServer
    from repro_torch.train import OptimizerConfig, train_loop
    cfg = get_config("delphi-2m")
    sim = SimulatorConfig(n_train=512, n_val=1, seed=0)
    train, _ = generate_dataset(sim)
    canaries = make_canaries(CANARIES, sim, seed=0,
                             secret_len=CANARY_SECRET,
                             prefix_events=CANARY_PREFIX)
    train = inject_canaries(train, canaries, repeats=CANARY_REPEATS)
    t0 = time.perf_counter()
    params, hist = train_loop(
        init_params(cfg, seed=SEED, device=DEVICE), cfg,
        OptimizerConfig(lr=1e-3, warmup_steps=10, total_steps=CANARY_STEPS),
        batches(pack_trajectories(train, CANARY_SEQ), CANARY_BATCH, seed=0),
        steps=CANARY_STEPS, log_every=CANARY_STEPS // 3,
        log_fn=lambda s: None, device=DEVICE)
    train_s = time.perf_counter() - t0
    server = InferenceServer(serving_backend(params, cfg), port=0).start()
    try:
        ops.reset_launch_counts()
        audit = audit_subprocess(server.address,
                                 os.path.join(tmp, "audit.json"))
        counts = ops.launch_counts()
    finally:
        server.stop()
    rep = audit["report"]
    lo, hi = rep["mi_auc_ci"]
    if not (rep["backend"] == "remote" and rep["n_members"] == 4
            and rep["n_nonmembers"] == 4 and 0.0 <= rep["mi_auc"] <= 1.0
            and 0.0 <= lo <= hi <= 1.0
            and all(0.0 <= rep[k] <= 1.0 for k in (
                "member_extraction_rate", "nonmember_extraction_rate"))):
        raise AssertionError(f"6d: invalid audit report: {rep}")
    for name in DELPHI_KERNELS:
        if counts[name] <= 0:
            raise AssertionError(f"6d: {name} never launched on the audit")
    return {"train_steps": CANARY_STEPS, "train_s": train_s,
            "loss": hist["loss"], "audit_s": audit["seconds"],
            "mi_auc": rep["mi_auc"], "mi_auc_ci": [lo, hi],
            "member_extraction_rate": rep["member_extraction_rate"],
            "nonmember_extraction_rate": rep["nonmember_extraction_rate"],
            "extraction_gap": rep["extraction_gap"],
            "member_scores": rep["member_scores"],
            "nonmember_scores": rep["nonmember_scores"],
            "launches": counts, "summary": audit["summary"]}


# ---------------------------------------------------------------------------
# phases 3k-3n and 6e: the dense knobs at full width (TinyLlama-1.1B,
# H2O-Danube-1.8B, Delphi-100M)
# ---------------------------------------------------------------------------
# 3k's request count cut from 16 to 8 to keep the whole call in its time
DENSE_SLOTS, DENSE_REQUESTS, DENSE_MAX_NEW, DENSE_CONTEXT = 8, 8, 32, 1024
DENSE_CHUNK = 64
DANUBE_PROMPT, DANUBE_CONTEXT, DANUBE_MAX_NEW = 4600, 5120, 32
# 3l's depth cut from 24 layers to keep the whole call in its time (its
# gates do not depend on depth; the host's numpy draws of 24 layers took
# ~35 s)
DANUBE_LAYERS = 8
# bf16 logits of the whole model against the fp32 model (TF32 off): the
# kernels' route may be off by at most this multiple of the plain route's
# own bf16 error (the plain version rounds the attention scores to bf16,
# as the JAX package's jnp route does; the flash kernel keeps them in fp32)
DENSE_LOGITS_VS_PLAIN = 1.5
LM_ARTIFACT_LAYERS, LM_ARTIFACT_SEQ, LM_ARTIFACT_MAX_NEW = 2, 256, 16
# Gumbel scores of the bf16 artifact against the eager bf16 model's full
# forward: a token whose score is within this of the best is a near-tie
LM_MARGIN = 5e-2
LONG_BATCH, LONG_SEQ, LONG_STEPS, LONG_PATIENTS = 8, 1024, 20, 512


class plain_route:
    """Inside the block every kernel entry point of ``kernels.ops`` takes
    its plain PyTorch version, on the card's tensors too (the reference
    route of a whole model on the card)."""

    def __enter__(self):
        from repro_torch.kernels import ops
        self._real = ops._on_cuda
        ops._on_cuda = lambda t: False

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        ops._on_cuda = self._real


def free_card() -> None:
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def solo_prompts(prompts):
    """Indices of the prompts on which chunked == unchunked is held, each
    request served alone: the shortest, the shortest whose last chunk of
    ``DENSE_CHUNK`` is ragged, and the longest."""
    import numpy as np
    order = [int(i) for i in np.argsort([len(p) for p in prompts])]
    ragged = [i for i in order if len(prompts[i]) % DENSE_CHUNK]
    if not ragged:
        raise AssertionError("no prompt has a ragged last chunk")
    return [order[0], ragged[0], order[-1]]


def lm_long_prompts(vocab: int):
    """``DENSE_REQUESTS`` prompts of seeded random token ids, 64 to 768
    tokens, in seeded order."""
    import numpy as np
    rng = np.random.default_rng(SEED + 7)
    lens = np.linspace(64, 768, DENSE_REQUESTS).astype(int)
    rng.shuffle(lens)
    return [rng.integers(0, vocab, int(S)).astype(np.int32) for S in lens]


def lm_uniforms(n: int, max_new: int, vocab: int, seed: int):
    import numpy as np
    rng = np.random.default_rng(seed)
    return [rng.random((max_new, vocab), dtype=np.float32) for _ in range(n)]


def lm_serve(params, cfg, prompts, *, max_new: int, slots: int,
             max_context: int, uniforms=None, **kw):
    """Serve ``prompts`` on a fresh engine (generator uniforms unless
    ``uniforms`` are given); returns (engine, requests, seconds of
    ``run()`` ending in a synchronise, launches counted over the run)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serve import BatchedEngine, Request
    eng = BatchedEngine(params, cfg, slots=slots, max_context=max_context,
                        seed=SEED, device=DEVICE, **kw)
    reqs = [Request(tokens=t, max_new=max_new,
                    uniforms=None if uniforms is None else uniforms[i])
            for i, t in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    return eng, reqs, sec, ops.launch_counts()


def check_lm_run(eng, reqs, counts, cfg, max_new: int, what: str) -> None:
    """Every request got its ``max_new`` tokens (no ages), one host copy a
    tick and an admission batch, the paged kernel once a layer a tick,
    ``tte_sample`` never, flash once a layer an admission batch (chunked:
    once a layer a chunk, by position), and a paged pool drained."""
    L = cfg.n_layers
    for r in reqs:
        if not (r.done and r.error is None and len(r.out_tokens) == max_new
                and not r.out_ages and all(0 <= t < cfg.vocab_size
                                           for t in r.out_tokens)):
            raise AssertionError(f"{what}: bad request {r.error} "
                                 f"{len(r.out_tokens)} {r.out_ages[:2]}")
    if eng.host_syncs != eng.ticks + eng.admit_batches:
        raise AssertionError(f"{what}: host_syncs {eng.host_syncs} != ticks "
                             f"{eng.ticks} + admit_batches "
                             f"{eng.admit_batches}")
    want_flash = L * (eng.prefill_chunks if eng.prefill_chunk_tokens
                      else eng.admit_batches)
    if (counts["paged_decode_attention"], counts["flash_attention"],
            counts["tte_sample"]) != (L * eng.ticks, want_flash, 0):
        raise AssertionError(f"{what}: launches {counts} over {eng.ticks} "
                             f"ticks, {eng.admit_batches} admission batches")
    if eng.paged:
        eng.drop_prefix_cache()
        if eng.allocator.used or eng.pool._refs or eng.preemptions:
            raise AssertionError(f"{what}: pool not drained: "
                                 f"{eng.pool_stats()}")


def layer0(eng) -> tuple:
    """Layer 0 of a ring engine's cache and the slots' steps, as the run
    left them (the paged kernel's inputs on that path), cloned: (k, v,
    pos, step)."""
    lc = eng.cache["self"]
    return (lc.k[0].clone(), lc.v[0].clone(), lc.pos[0].clone(),
            eng._state["step"].clone())


def tinyllama_path() -> dict:
    """Phase 3k: TinyLlama-1.1B at full width in bf16 on the ring, then on
    the prefix-cached paged cache; under injected uniforms ring == paged
    bit for bit over all 8 requests, and chunked (64 tokens a step) ==
    unchunked bit for bit on the shortest, the shortest ragged (its last
    chunk short of 64 tokens) and the longest request, each served alone
    (the concurrent chunked run's agreement is counted); one profiled ring
    run."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_params_on_device
    cfg = get_config("tinyllama-1.1b")
    t0 = time.perf_counter()
    # made on the card: the host's numpy draws of 1.1 B weights took ~20 s
    params = init_params_on_device(cfg, seed=SEED, device=DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = lm_long_prompts(cfg.vocab_size)
    kw = dict(max_new=DENSE_MAX_NEW, slots=DENSE_SLOTS,
              max_context=DENSE_CONTEXT)
    # first use of cuBLAS at these shapes, through the same entry point
    lm_serve(params, cfg, prompts[:2], max_new=2, slots=DENSE_SLOTS,
             max_context=DENSE_CONTEXT)
    runs = {}
    for name, extra in (("ring", {}),
                        ("paged", dict(cache="paged", prefix_cache=True))):
        eng, reqs, sec, counts = lm_serve(params, cfg, prompts, **kw,
                                          **extra)
        check_lm_run(eng, reqs, counts, cfg, DENSE_MAX_NEW, f"3k {name}")
        runs[name] = {"engine": eng, "seconds": sec, "launches": counts,
                      "tokens": len(reqs) * DENSE_MAX_NEW,
                      "tokens_per_s": len(reqs) * DENSE_MAX_NEW / sec,
                      "ticks": eng.ticks, "admit_batches": eng.admit_batches,
                      "host_syncs": eng.host_syncs,
                      "prefill_shapes": sorted(eng.prefill_shapes)}
    us = lm_uniforms(len(prompts), DENSE_MAX_NEW, cfg.vocab_size, SEED + 9)
    exact = {}
    chunked = dict(cache="paged", prefill_chunk_tokens=DENSE_CHUNK)
    for name, extra in (("ring", {}), ("paged", dict(cache="paged")),
                        ("chunked", chunked)):
        eng, reqs, _, counts = lm_serve(params, cfg, prompts, uniforms=us,
                                        **kw, **extra)
        check_lm_run(eng, reqs, counts, cfg, DENSE_MAX_NEW,
                     f"3k injected {name}")
        exact[name] = [r.out_tokens for r in reqs]
    if exact["ring"] != exact["paged"]:
        raise AssertionError("3k: ring and paged tokens differ")
    # chunked against unchunked, each request alone: a prompt's K/V are
    # then computed at the same products' shapes by both (in a concurrent
    # run the monolithic admission batches 8 prompts padded to 1024
    # tokens, and the bf16 products' bits follow the batch's row count)
    solo = solo_prompts(prompts)
    for i in solo:
        one = {}
        for name, extra in (("paged", dict(cache="paged")),
                            ("chunked", chunked)):
            eng, reqs, _, counts = lm_serve(params, cfg, [prompts[i]],
                                            uniforms=[us[i]], **kw, **extra)
            check_lm_run(eng, reqs, counts, cfg, DENSE_MAX_NEW,
                         f"3k solo {name}")
            one[name] = reqs[0].out_tokens
        if one["paged"] != one["chunked"]:
            raise AssertionError(f"3k: request {i} alone: chunked tokens "
                                 f"differ from unchunked")
    ring = runs["ring"]
    prof = path_profile(lambda: lm_serve(params, cfg, prompts, **kw)[2],
                        ring["seconds"])
    saved = layer0(ring["engine"])
    shapes = ring["prefill_shapes"]
    for r in runs.values():
        r.pop("engine")
    del params
    free_card()
    return {"runs": runs, "profile": prof, "layer0": saved,
            "prefill_shapes": shapes, "init_s": init_s,
            "exact_tokens": sum(len(t) for t in exact["ring"]),
            "solo_prompt_lengths": [len(prompts[i]) for i in solo],
            "concurrent_chunked_equal": sum(
                a == b for a, b in zip(exact["chunked"], exact["ring"])),
            "cfg": cfg}


def danube_path() -> dict:
    """Phase 3l: H2O-Danube-1.8B at full width (``DANUBE_LAYERS`` deep) in
    bf16, one 4,600-token prompt (past the window of 4,096) with
    ``max_context`` 5,120: the last
    prefill position's logits through the kernels against the plain route
    on the card, and against a run with no window; then the prompt served
    on the ring (the window's 4,096 wide) and on the paged cache (each
    slot's table 5,120 wide) under injected uniforms.  The two decode walks
    visit the window's positions in other orders, so their bf16 outputs
    may part in the last bit: each run's tokens are held step by step
    against the model's full forward (teacher forcing), a step whose
    Gumbel score gap is within twice the kernels' measured bf16 logits
    error a near-tie, and the tokens equal before their first divergence
    are counted."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import parity as par
    from repro_torch.kernels import ops
    from repro_torch.models import cast_params, forward, init_params
    cfg = get_config("h2o-danube-1.8b").replace(n_layers=DANUBE_LAYERS)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=SEED, device=DEVICE)
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED + 11)
    prompt = rng.integers(0, cfg.vocab_size, DANUBE_PROMPT).astype(np.int32)
    w = cast_params(params, cfg)
    toks = torch.from_numpy(prompt[None]).to(DEVICE)

    def last_logits(c, p=w):
        with torch.no_grad():
            return forward(p, c, {"tokens": toks}, mode="prefill",
                           cache_width=DANUBE_CONTEXT)["logits"][0, 0]
    last_logits(cfg)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    kern = last_logits(cfg)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    if counts["flash_attention"] != cfg.n_layers:
        raise AssertionError(f"3l: flash launched {counts} in one prefill")
    with plain_route():
        plain = last_logits(cfg)
        exact = last_logits(cfg.replace(dtype="float32"), params)
    no_window = last_logits(cfg.replace(sliding_window=None))
    scale = float(exact.abs().max())
    err = float((kern - exact).abs().max())
    plain_err = float((plain - exact).abs().max())
    bite = float((kern - no_window).abs().max())
    if not (torch.isfinite(kern).all()
            and err <= DENSE_LOGITS_VS_PLAIN * plain_err):
        raise AssertionError(f"3l: against the fp32 model the kernels' "
                             f"route is off by {err}, the plain route by "
                             f"{plain_err} (allowed {DENSE_LOGITS_VS_PLAIN}"
                             f"x it)")
    if not bite > 10 * max(err, plain_err):
        raise AssertionError(f"3l: the window does not bite: no-window "
                             f"logits within {bite} (bf16 error {err})")
    del w
    free_card()
    u = lm_uniforms(1, DANUBE_MAX_NEW, cfg.vocab_size, SEED + 12)
    kw = dict(max_new=DANUBE_MAX_NEW, slots=1, max_context=DANUBE_CONTEXT,
              uniforms=u)
    runs = {}
    for name, extra in (("ring", {}), ("paged", dict(cache="paged"))):
        eng, reqs, sec, c = lm_serve(params, cfg, [prompt], **kw, **extra)
        check_lm_run(eng, reqs, c, cfg, DANUBE_MAX_NEW, f"3l {name}")
        runs[name] = {"tokens": reqs[0].out_tokens, "seconds": sec,
                      "launches": c, "ticks": eng.ticks,
                      "prefill_shapes": sorted(eng.prefill_shapes)}
        if name == "ring":
            saved = layer0(eng)
            runs[name]["layer0_width"] = saved[0].shape[2]
        del eng
    if runs["ring"]["layer0_width"] != cfg.sliding_window:
        raise AssertionError(f"3l: the ring is {runs['ring']['layer0_width']}"
                             f" wide, not the window's {cfg.sliding_window}")
    margin = 2 * err
    held = {name: par.check_lm_trajectories(
        [prompt], [r["tokens"]], u, par.port_logits_fn(params, cfg),
        margin_tol=margin) for name, r in runs.items()}
    free = par.compare_runs([(runs["ring"]["tokens"], [])],
                            [(runs["paged"]["tokens"], [])], age_rtol=0.0)
    del params
    free_card()
    return {"init_s": init_s, "prefill_s": prefill_s, "logits_err": err,
            "plain_err": plain_err, "kernel_vs_plain": float(
                (kern - plain).abs().max()),
            "logits_scale": scale, "no_window_diff": bite, "runs": runs,
            "layer0": saved, "prefill_launches": counts, "cfg": cfg,
            "margin": margin,
            "held_steps": {k: h["steps"] for k, h in held.items()},
            "near_ties": {k: len(h["near_ties"]) for k, h in held.items()},
            "equal_before_divergence": free["compared"],
            "divergences": free["divergences"]}


def delphi100m_path() -> dict:
    """Phase 3m: Delphi-100M served at full width through
    ``repro_torch.launch.serve`` with phase 3's knobs (32 synthetic patient
    prompts, 16 slots, 48 new events, ring, bf16): every request finishes,
    one host copy a tick and an admission batch, all three Delphi kernels
    launched."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launch

    def args(n, m):
        return launch.parse_args(["--arch", "delphi-100m", "--requests",
                                  str(n), "--slots", "16", "--max-new",
                                  str(m), "--seed", str(SEED), "--device",
                                  DEVICE])
    launch.serve(args(4, 4))
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    out = launch.serve(args(32, 48))
    counts = ops.launch_counts()
    eng, done = out["engine"], out["done"]
    if len(done) != 32 or not all(r.done and r.error is None for r in done):
        raise AssertionError(f"3m: {len(done)} of 32 requests completed")
    if eng.host_syncs != eng.ticks + eng.admit_batches:
        raise AssertionError(f"3m: host_syncs {eng.host_syncs}")
    if counts["paged_decode_attention"] != eng.cfg.n_layers * eng.ticks or any(
            counts[k] <= 0 for k in DELPHI_KERNELS):
        raise AssertionError(f"3m: launches {counts} in {eng.ticks} ticks")
    for r in done:
        ages = np.asarray(r.out_ages, np.float64)
        if not (np.isfinite(ages).all() and (ages <= 85.0).all()
                and (np.diff(ages) >= 0).all()):
            raise AssertionError(f"3m: bad ages {ages}")
    res = {"events": out["events"], "seconds": out["seconds"],
           "events_per_s": out["events"] / out["seconds"],
           "ticks": eng.ticks, "admit_batches": eng.admit_batches,
           "host_syncs": eng.host_syncs, "launches": counts,
           "prefill_shapes": sorted(eng.prefill_shapes),
           "max_context": eng.max_context}
    del out, eng, done
    free_card()
    return res


def lm_artifact_config():
    from repro_torch.configs import get_config
    return get_config("tinyllama-1.1b").replace(n_layers=LM_ARTIFACT_LAYERS)


def lm_artifact_export(d: str) -> dict:
    """3n's export into ``d``: ``init_params(seed)`` of
    ``lm_artifact_config`` exported by ``artifact_export`` (spec v2, bf16,
    ``seq_len`` ``LM_ARTIFACT_SEQ``, traced on the CPU)."""
    from repro_torch.models import init_params
    cfg = lm_artifact_config()
    return artifact_export(init_params(cfg, seed=SEED, device=DEVICE), cfg,
                           d, "2", seq_len=LM_ARTIFACT_SEQ)


def lm_artifact_path(tmp: str, ex=None) -> dict:
    """Phase 3n: TinyLlama at full width cut to 2 layers, exported by
    ``export_model`` (spec v2, bf16, ``seq_len`` 256, traced on the CPU;
    ``ex``: the numbers of ``lm_artifact_export`` made before into
    ``tmp/tinyllama``, else it exports here) and loaded with
    ``ArtifactBackend`` on the card.  On two prompts: the
    full, prefill and 8 decode-step graphs' logits == the eager functions'
    bit for bit, flash launched 2 times a full or prefill call and paged 2
    times a decode step through the ``repro_torch::`` operators, the decode
    graph taking ``(token, step)``; then ``ArtifactBackend`` ==
    ``LocalBackend.stream`` token for token and held margin-aware against
    the eager model's full forward (Gumbel scores, ``LM_MARGIN``)."""
    import numpy as np
    import torch
    from repro_torch.api import (ArtifactBackend, GenerateRequest,
                                 LocalBackend)
    from repro_torch.core import parity as par
    from repro_torch.kernels import ops
    from repro_torch.models import init_params
    from repro_torch.sdk import build_inference_fns, read_manifest
    cfg = lm_artifact_config()
    params = init_params(cfg, seed=SEED, device=DEVICE)
    d = os.path.join(tmp, "tinyllama")
    if ex is None:
        ex = lm_artifact_export(d)
    sig = read_manifest(d)["graphs"]["decode_step"]["inputs"]
    if [i["name"] for i in sig] != ["cache", "token", "step"]:
        raise AssertionError(f"3n: decode graph inputs {sig}")
    t0 = time.perf_counter()
    art = ArtifactBackend(d, device=DEVICE)
    load_s = time.perf_counter() - t0
    if art.seq_len != LM_ARTIFACT_SEQ:
        raise AssertionError(f"3n: the artifact's axis is {art.seq_len}")
    local = LocalBackend(params, cfg, seq_len=LM_ARTIFACT_SEQ, device=DEVICE)
    rt, fns = art.runtime, build_inference_fns(cfg, LM_ARTIFACT_SEQ)
    L = cfg.n_layers

    def dev(*arrays):
        return [torch.from_numpy(np.asarray(x)).to(DEVICE) for x in arrays]

    def counted(fn, want_flash, want_paged, what):
        ops.reset_launch_counts()
        out = fn()
        c = ops.launch_counts()
        if (c["flash_attention"], c["paged_decode_attention"],
                c["tte_sample"]) != (want_flash, want_paged, 0):
            raise AssertionError(f"3n {what}: launches {c}")
        return out
    rng = np.random.default_rng(SEED + 21)
    prompts = [rng.integers(0, cfg.vocab_size, S).astype(np.int32)
               for S in (40, 100)]
    steps = 0
    for toks in prompts:
        (t,) = art._pad_inputs(toks, None)
        got = counted(lambda: rt.run(t), L, 0, "full graph")
        with torch.no_grad():
            want = fns["full"](params, *dev(t)).cpu().numpy()
        if not np.array_equal(got, want):
            raise AssertionError(f"3n: full graph != eager: "
                                 f"{float(np.abs(got - want).max())}")
        last = np.asarray([len(toks) - 1], np.int32)
        lg, cache = counted(lambda: rt.prefill(t, last), L, 0, "prefill")
        with torch.no_grad():
            lg_e, cache_e = fns["prefill"](params, *dev(t, last))
        if not np.array_equal(lg, lg_e.cpu().numpy()):
            raise AssertionError("3n: prefill graph != eager prefill")
        for k in range(ARTIFACT_DECODE_STEPS):
            args = (np.asarray([[rng.integers(0, cfg.vocab_size)]], np.int32),
                    np.asarray([len(toks) + k], np.int32))
            lg, cache = counted(lambda: rt.decode_step(cache, *args), 0, L,
                                "decode step")
            with torch.no_grad():
                lg_e, cache_e = fns["decode"](params, cache_e, *dev(*args))
            if not np.array_equal(lg, lg_e.cpu().numpy()):
                raise AssertionError(
                    f"3n: prompt of {len(toks)} tokens, decode step {k} != "
                    f"eager: max diff "
                    f"{float(np.abs(lg - lg_e.float().cpu().numpy()).max())}"
                    f", caches equal "
                    f"{[torch.equal(x, y) for x, y in zip(cache, cache_e)]}")
            steps += 1
        if not all(torch.equal(x, y) for x, y in zip(cache, cache_e)):
            raise AssertionError("3n: artifact cache != eager cache")
    us = lm_uniforms(len(prompts), LM_ARTIFACT_MAX_NEW, cfg.vocab_size,
                     SEED + 22)
    outs = []
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for toks, u in zip(prompts, us):
        outs.append(art.generate(GenerateRequest(
            tokens=[int(x) for x in toks], max_new=LM_ARTIFACT_MAX_NEW,
            uniforms=u)).tokens)
    torch.cuda.synchronize()
    drive_s = time.perf_counter() - t0
    drive = ops.launch_counts()
    t0 = time.perf_counter()
    for toks, u, o in zip(prompts, us, outs):
        mine = [e.token for e in local.stream(GenerateRequest(
            tokens=[int(x) for x in toks], max_new=LM_ARTIFACT_MAX_NEW,
            uniforms=u))]
        if mine != o:
            raise AssertionError("3n: ArtifactBackend != LocalBackend.stream")
    torch.cuda.synchronize()
    local_s = time.perf_counter() - t0
    held = par.check_lm_trajectories(
        prompts, outs, us, par.port_logits_fn(params, cfg),
        margin_tol=LM_MARGIN)
    n = len(prompts) * LM_ARTIFACT_MAX_NEW
    res = {"export": ex, "load_s": load_s, "decode_steps": steps,
           "launches": drive, "tokens": n,
           "ms_per_token": 1e3 * drive_s / n,
           "local_ms_per_token": 1e3 * local_s / n,
           "held_steps": held["steps"], "near_ties": len(held["near_ties"])}
    del art, local, params
    free_card()
    return res


def long_grads_path() -> dict:
    """Phase 6e, first part: Delphi-100M at full width cut to 2 layers, one
    fp32 step (TF32 off) of 2 x 1024 (the blocked attention route) on the
    card; its loss and every gradient against the CPU port's."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import (SimulatorConfig, generate_dataset,
                                  pack_trajectories)
    from repro_torch.kernels import ops
    from repro_torch.models import init_params
    from repro_torch.train import loss_and_grads, make_loss_fn
    from repro_torch.train.trainer import to_device
    cfg = get_config("delphi-100m").replace(n_layers=2, dtype="float32")
    host = init_params(cfg, seed=SEED, device="cpu")
    params = {k: v.to(DEVICE) for k, v in host.items()}
    trajs, _ = generate_dataset(SimulatorConfig(n_train=2, n_val=1,
                                                seed=SEED + 51))
    batch = pack_trajectories(trajs, LONG_SEQ)
    loss_fn = make_loss_fn(cfg, "delphi")
    ops.reset_launch_counts()
    g_card, m_card = loss_and_grads(loss_fn, params, to_device(batch, DEVICE))
    g_cpu, m_cpu = loss_and_grads(loss_fn, host, to_device(batch, "cpu"))
    if any(ops.launch_counts().values()):
        raise AssertionError("6e: the training route launched a kernel")
    worst, worst_key = 0.0, None
    for k, g in g_card.items():
        got, want = g.cpu().numpy(), g_cpu[k].numpy()
        scale = float(np.abs(want).max())
        if not np.isfinite(got).all() or (scale > 0 and not got.any()):
            raise AssertionError(f"6e: {k}: gradient not finite or zero")
        rel = float(np.abs(got - want).max()) / max(scale, 1e-30)
        if rel > worst:
            worst, worst_key = rel, k
    loss_rel = abs(float(m_card["loss"]) - float(m_cpu["loss"])) \
        / abs(float(m_cpu["loss"]))
    if worst > GRAD_CARD_REL or loss_rel > 1e-5:
        raise AssertionError(f"6e: card vs CPU: loss rel {loss_rel:.3g}, "
                             f"gradient {worst_key} {worst:.3g}")
    del params
    free_card()
    return {"loss_card": float(m_card["loss"]),
            "loss_cpu": float(m_cpu["loss"]), "loss_rel_err": loss_rel,
            "grad_max_rel_err": worst, "grad_worst_leaf": worst_key,
            "leaves": len(g_card)}


def long_train_path() -> dict:
    """Phase 6e, second part: ``python -m repro_torch.launch.train --arch
    delphi-100m --seq-len 1024`` (its ``main``) for 20 bf16 steps of 8 x
    1024 over fp32 masters at full width: the loss finite; steps/s, target
    tokens/s and the training's peak memory."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    free_card()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ops.reset_launch_counts()
    res = launch_train.main([
        "--arch", "delphi-100m", "--steps", str(LONG_STEPS), "--patients",
        str(LONG_PATIENTS), "--batch", str(LONG_BATCH), "--seq-len",
        str(LONG_SEQ), "--seed", str(SEED), "--device", DEVICE])
    peak = torch.cuda.max_memory_allocated() - base
    if any(ops.launch_counts().values()):
        raise AssertionError("6e: training launched a kernel")
    loss = np.asarray(res["history"]["loss"])
    if res["cfg"].dtype != "bfloat16" or not np.isfinite(loss).all():
        raise AssertionError(f"6e: dtype {res['cfg'].dtype}, loss {loss}")
    sec = res["seconds"]
    out = {"steps": LONG_STEPS, "seconds": sec,
           "steps_per_s": LONG_STEPS / sec,
           "target_tokens": res["target_tokens"],
           "target_tokens_per_s": res["target_tokens"] / sec,
           "peak_memory_bytes": peak, "loss_first": float(loss[0]),
           "loss_last": float(loss[-1])}
    del res
    free_card()
    return out


# ---------------------------------------------------------------------------
# phases 3o, 6f and 6g: Zamba2-1.2B served, Mamba2 and Zamba2 trained
# ---------------------------------------------------------------------------
ZAMBA_SLOTS, ZAMBA_MAX_NEW, ZAMBA_CONTEXT = 8, 32, 4096
ZAMBA_FORKS, ZAMBA_FORK_NEW = 4, 8
# phases 6f/6g: the CLI's batch at full depth, and the card-vs-CPU step's
# (the CLI's steps cut from 10 to 5 to make room for 6j, 6k and 3v)
SSM_TRAIN_BATCH, SSM_TRAIN_SEQ, SSM_TRAIN_STEPS = 4, 512, 5
SSM_GRAD_BATCH, SSM_GRAD_SEQ, SSM_GRAD_LAYERS = 2, 256, 2
SSM_ROUTE_SEQ, SSM_ROUTE_TOL = 1024, 1e-4


def zamba2_config():
    from repro_torch.configs import get_config
    return get_config("zamba2-1.2b")


def zamba2_forks(params, cfg, prompts) -> dict:
    """A held parent, forked into ``ZAMBA_FORKS`` children after another
    request has decoded beside it for 6 ticks (the parked rows advance its
    Mamba state and write a discarded token into its rings), against
    ``sample_futures``' immediate forks on a fresh engine: the same tokens
    bit for bit under injected uniforms."""
    import numpy as np
    from repro_torch.serve import BatchedEngine, Request
    V = cfg.vocab_size
    rng = np.random.default_rng(SEED + 13)
    us = rng.random((ZAMBA_FORKS, ZAMBA_FORK_NEW, V), dtype=np.float32)
    prompt, side = sorted(prompts, key=len)[:2]

    def engine():
        return BatchedEngine(params, cfg, slots=ZAMBA_SLOTS,
                             max_context=ZAMBA_CONTEXT, seed=SEED,
                             device=DEVICE)
    now = engine().sample_futures(prompt, n=ZAMBA_FORKS,
                                  max_new=ZAMBA_FORK_NEW, uniforms=us)
    eng = engine()
    parent = Request(tokens=prompt, max_new=ZAMBA_FORK_NEW, hold=True)
    other = Request(tokens=side, max_new=16,
                    uniforms=rng.random((16, V), dtype=np.float32))
    eng.submit(parent)
    eng.submit(other)
    for _ in range(6):
        eng.step()
    kids = [Request(tokens=prompt, max_new=ZAMBA_FORK_NEW, uniforms=us[i])
            for i in range(ZAMBA_FORKS)]
    eng.fork(parent.request_id, children=kids)
    eng.run()
    held = [k.out_tokens for k in kids]
    if held != [k.out_tokens for k in now] or not all(
            len(t) == ZAMBA_FORK_NEW for t in held) or not other.done:
        raise AssertionError(f"3o: held-parent forks {held} differ from "
                             f"immediate forks {[k.out_tokens for k in now]}")
    return {"forks": ZAMBA_FORKS, "tokens": sum(len(t) for t in held),
            "parked_ticks": 6, "prompt_tokens": len(prompt)}


def zamba2_logits(params, cfg, prompt) -> dict:
    """The last prefill position's logits of one prompt through the
    kernels (bf16) against the fp32 model made from the same draws
    (``init_params_on_device`` at ``dtype="float32"``: plain route, TF32
    off), beside the plain route's own bf16 error, as phase 3l holds
    H2O-Danube."""
    import torch
    from repro_torch.models import forward, init_params_on_device
    toks = torch.from_numpy(prompt[None]).to(DEVICE)

    def last(c, p=params):
        with torch.no_grad():
            return forward(p, c, {"tokens": toks}, mode="prefill",
                           cache_width=ZAMBA_CONTEXT)["logits"][0, 0]
    kern = last(cfg)
    with plain_route():
        plain = last(cfg)
        c32 = cfg.replace(dtype="float32")
        p32 = init_params_on_device(c32, seed=SEED, device=DEVICE)
        exact = last(c32, p32)
        del p32
    err = float((kern - exact).abs().max())
    plain_err = float((plain - exact).abs().max())
    if not (bool(torch.isfinite(kern).all())
            and err <= DENSE_LOGITS_VS_PLAIN * plain_err):
        raise AssertionError(f"3o: against the fp32 model the kernels' "
                             f"route is off by {err}, the plain route by "
                             f"{plain_err} (allowed {DENSE_LOGITS_VS_PLAIN}"
                             f"x it)")
    return {"prompt_tokens": len(prompt), "logits_err": err,
            "plain_err": plain_err,
            "kernel_vs_plain": float((kern - plain).abs().max()),
            "logits_scale": float(exact.abs().max())}


def zamba2_path() -> dict:
    """Phase 3o: Zamba2-1.2B at full width in bf16 on
    ``BatchedEngine(slots=8, max_context=4096)`` (the ring): 16 requests of
    seeded random ids (96-1024 tokens), 32 new tokens each, generator
    uniforms.  Every request gets its tokens, one host copy a tick and an
    admission, every prefill ``(1, S)``, ``ssd_intra`` 38 launches an
    admission, flash 7 an admission and paged 7 a tick, ``tte_sample``
    none; a held parent's forks == immediate forks bit for bit; one
    prompt's last logits against the fp32 model; a profiled window."""
    import torch
    from repro_torch.models import (init_params_on_device, n_attn_apps,
                                    ring_width)
    cfg = zamba2_config()
    napps = n_attn_apps(cfg)
    stage = {}
    t0 = time.perf_counter()
    # made on the card: the host's numpy draws of 1.2 B weights took ~20 s
    params = init_params_on_device(cfg, seed=SEED, device=DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    stage["init"] = init_s
    prompts = mamba_prompts(cfg.vocab_size)
    kw = dict(max_new=ZAMBA_MAX_NEW, slots=ZAMBA_SLOTS,
              max_context=ZAMBA_CONTEXT)
    # first use of cuBLAS at these shapes, through the same entry point
    t0 = time.perf_counter()
    lm_serve(params, cfg, prompts[:2], max_new=2, slots=ZAMBA_SLOTS,
             max_context=ZAMBA_CONTEXT)
    stage["warmup"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng, reqs, sec, counts = lm_serve(params, cfg, prompts, **kw)
    stage["serve"] = time.perf_counter() - t0
    for r in reqs:
        if not (r.done and r.error is None
                and len(r.out_tokens) == ZAMBA_MAX_NEW and not r.out_ages
                and all(0 <= t < cfg.vocab_size for t in r.out_tokens)):
            raise AssertionError(f"3o: bad request {r.error} "
                                 f"{len(r.out_tokens)}")
    if eng.host_syncs != eng.ticks + eng.admit_batches:
        raise AssertionError(f"3o: host_syncs {eng.host_syncs} != ticks "
                             f"{eng.ticks} + admit_batches "
                             f"{eng.admit_batches}")
    if eng.prefill_shapes != {(1, len(p)) for p in prompts} \
            or eng.admit_batches != len(prompts):
        raise AssertionError(f"3o: prefill shapes "
                             f"{sorted(eng.prefill_shapes)}")
    want = {"ssd_intra": cfg.n_layers * eng.admit_batches,
            "flash_attention": napps * eng.admit_batches,
            "paged_decode_attention": napps * eng.ticks, "tte_sample": 0}
    if {k: counts[k] for k in want} != want:
        raise AssertionError(f"3o: launches {counts}, expected {want}")
    lc = eng.cache["attn"]
    if tuple(lc.k.shape) != (napps, ZAMBA_SLOTS, cfg.n_kv_heads,
                             ring_width(cfg, ZAMBA_CONTEXT), cfg.head_dim):
        raise AssertionError(f"3o: rings {tuple(lc.k.shape)}")
    ring0 = (lc.k[0].clone(), lc.v[0].clone(), lc.pos[0].clone(),
             eng._state["step"].clone())
    run = {"seconds": sec, "launches": counts,
           "tokens": len(reqs) * ZAMBA_MAX_NEW,
           "tokens_per_s": len(reqs) * ZAMBA_MAX_NEW / sec,
           "ticks": eng.ticks, "admit_batches": eng.admit_batches,
           "host_syncs": eng.host_syncs,
           "prefill_shapes": sorted(eng.prefill_shapes),
           "prompt_lengths": sorted(len(p) for p in prompts)}
    del eng
    t0 = time.perf_counter()
    prof = window_profile(lambda: lm_serve(
        params, cfg, prompts[:PROFILE_REQUESTS], max_new=PROFILE_MAX_NEW,
        slots=ZAMBA_SLOTS, max_context=ZAMBA_CONTEXT)[2])
    stage["profile"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    forks = zamba2_forks(params, cfg, prompts)
    stage["forks"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    logits = zamba2_logits(params, cfg, max(prompts, key=len))
    stage["logits"] = time.perf_counter() - t0
    del params
    free_card()
    torch.cuda.synchronize()
    return {"run": run, "profile": prof, "forks": forks, "logits": logits,
            "ring0": ring0, "init_s": init_s, "cfg": cfg, "napps": napps,
            "stage_s": stage}


# ---------------------------------------------------------------------------
# phase 3t: the recurrent artifact (Mamba2-780M, Zamba2-1.2B) on the card
# ---------------------------------------------------------------------------
# depth cuts at full width (48 and 38 Mamba2 layers served whole by 3b and
# 3o): Zamba2's 7 keep 2 applications of the shared block (before layers 0
# and 6), so both kinds of cache leaves.  Export and load time follow the
# graphs' node counts: cuts of 8 and 12 layers made the phase take 212.7 s
# on an H100 host (700 W card), against ~120 s it may add to this script
SSM_ARTIFACT_LAYERS = {"mamba2-780m": 4, "zamba2-1.2b": 7}
SSM_ARTIFACT_SEQ, SSM_ARTIFACT_MAX_NEW = 1024, 16
# under one chunk, ending inside a chunk, no padding
SSM_ARTIFACT_PROMPTS = (96, 500, 1024)


def ssm_artifact_op_us() -> dict:
    """Host microseconds a call of ``ssd_intra`` at 3b's prefill shape (a
    1024-token prompt: 8 chunks x 48 heads, fp32 xdt, bf16 B/C through a
    stride-0 head axis), through its wrapper (the eager path) and through
    ``repro_torch::ssd_intra`` (the artifact's graphs): 500 calls ending in
    a synchronise, in turns (wrapper, operator, operator, wrapper)."""
    import torch
    from repro_torch.kernels import ssd_scan as sk
    g = torch.Generator(device=DEVICE)
    g.manual_seed(SEED + 31)
    xdt = torch.randn(1, 8, 128, 48, 64, generator=g, device=DEVICE)
    bc = torch.randn(2, 1, 8, 128, 1, 128, generator=g,
                     device=DEVICE).to(torch.bfloat16)
    Bm, Cm = (t.expand(1, 8, 128, 48, 128) for t in bc)
    cum = -torch.cumsum(0.01 * torch.rand(1, 8, 128, 48, generator=g,
                                          device=DEVICE), dim=2)
    calls = {"wrapper": lambda: sk.ssd_intra_cuda(xdt, Bm, Cm, cum),
             "operator": lambda: torch.ops.repro_torch.ssd_intra(
                 xdt, Bm, Cm, cum)}
    turns = []
    for mode in ("wrapper", "operator", "operator", "wrapper"):
        fn = calls[mode]
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(500):
            fn()
        torch.cuda.synchronize()
        turns.append((mode, 1e6 * (time.perf_counter() - t0) / 500))
    return {"ssd_intra": turns}


def ssm_artifact_export(arch: str, d: str) -> dict:
    """3t's export of ``arch`` into ``d``: fp32 weights made on the card
    (seeded) and exported (spec v2, bf16, ``seq_len``
    ``SSM_ARTIFACT_SEQ``, traced on the CPU): ``artifact_export``'s
    seconds and bytes, and the weights' making seconds."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_params_on_device
    cfg = get_config(arch).replace(n_layers=SSM_ARTIFACT_LAYERS[arch])
    t0 = time.perf_counter()
    p32 = init_params_on_device(cfg.replace(dtype="float32"), seed=SEED,
                                device=DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ex = artifact_export(p32, cfg, d, "2", seq_len=SSM_ARTIFACT_SEQ)
    del p32
    return dict(ex, init_s=init_s)


def side_exports(tmp: str) -> dict:
    """3t's two exports (``ssm_artifact_export``, keyed by arch) and 3n's
    (``lm_artifact_export``, key ``3n``) into ``tmp``."""
    out = {a: ssm_artifact_export(a, os.path.join(tmp, a))
           for a in SSM_ARTIFACT_LAYERS}
    out["3n"] = lm_artifact_export(os.path.join(tmp, "tinyllama"))
    return out


def start_ssm_artifact_exports(tmp: str):
    """3t's and 3n's exports (``side_exports``) in a process of their
    own, started in phase 1: they trace on the CPU beside ``nvcc`` and
    phase 3j's exports (a thread would share this process's interpreter
    lock)."""
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); "
            "import chip_smoke as cs; "
            "print(json.dumps(cs.side_exports(sys.argv[2])))")
    return subprocess.Popen(
        [sys.executable, "-c", code, ROOT, tmp], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))


def finish_ssm_artifact_exports(proc) -> dict:
    """Wait for :func:`start_ssm_artifact_exports`' process: {arch or
    ``3n``: its export's numbers}, from the last line it printed."""
    out, err = proc.communicate(timeout=900)
    if proc.returncode != 0:
        raise AssertionError(f"3t's exports exited {proc.returncode}: "
                             f"{err[-3000:]}")
    return json.loads(out.strip().splitlines()[-1])


def ssm_artifact_path(arch: str, tmp: str, ex=None) -> dict:
    """Phase 3t for one model: at full width, its depth cut to
    ``SSM_ARTIFACT_LAYERS``, fp32 weights made on the card, exported by
    ``export_model`` (spec v2, bf16, ``seq_len`` 1,024, traced on the CPU),
    ``verify_checksums`` strict, loaded with ``ArtifactBackend`` on the
    card.  On seeded prompts of 96, 500 and 1,024 tokens: the full and
    prefill graphs == the eager functions bit for bit (logits and every
    cache leaf), and, on the prompts shorter than the axis, 8 decode steps
    too; ``ssd_intra`` launched once a Mamba layer a full or prefill call
    and never in a decode step, Zamba2's flash once an application a full
    or prefill call and paged once an application a decode step,
    ``tte_sample`` never.  The masked prefill against the exact prompt:
    the prefill's last logits and one decode step after it, against the
    fp32 model's exact-length prefill and step (plain route, TF32 off),
    within ``DENSE_LOGITS_VS_PLAIN`` times the eager kernel route's own
    bf16 error at the exact length (3l's rule); the control, the same
    padded prompt prefilled with no ``last_index`` (the state after the
    padding, the reference's artifact), farther off than that limit at the
    decode step on the padded prompts.  Then ``ArtifactBackend`` ==
    ``LocalBackend.stream`` token for token under injected uniforms, held
    margin-aware against the eager model's scores (``LM_MARGIN``); the
    launches of that drive (counts zeroed just before, read just after);
    ms a token of a v2 decode step against an eager one, in turns; one
    drive's idle share under the profiler."""
    import numpy as np
    import torch
    from repro_torch.api import (ArtifactBackend, GenerateRequest,
                                 LocalBackend)
    from repro_torch.configs import get_config
    from repro_torch.core import parity as par
    from repro_torch.kernels import ops
    from repro_torch.models import (decode_step, forward,
                                    mask_padded_positions, n_attn_apps)
    from repro_torch.sdk import build_inference_fns, read_manifest
    cfg = get_config(arch).replace(n_layers=SSM_ARTIFACT_LAYERS[arch])
    hybrid = cfg.arch_type == "hybrid"
    napps = n_attn_apps(cfg) if hybrid else 0
    L, S = cfg.n_layers, SSM_ARTIFACT_SEQ
    c32 = cfg.replace(dtype="float32")
    d = os.path.join(tmp, arch)
    if ex is None:       # not exported yet (phase 1 exports for the script)
        ex = ssm_artifact_export(arch, d)
    stage = {"init": ex["init_s"], "export": ex["export_s"]}
    leaves = read_manifest(d)["graphs"]["cache"]["leaves"]
    if len(leaves) != (5 if hybrid else 2):
        raise AssertionError(f"3t {arch}: cache leaves {leaves}")
    t0 = time.perf_counter()
    art = ArtifactBackend(d, device=DEVICE)
    load_s = time.perf_counter() - t0
    stage["load"] = load_s
    # the eager functions on the weights the graphs were given
    params = art.runtime._params
    rt, fns = art.runtime, build_inference_fns(cfg, S)

    def dev(*arrays):
        return [torch.from_numpy(np.asarray(x)).to(DEVICE) for x in arrays]

    def counted(fn, want, what):
        ops.reset_launch_counts()
        out = fn()
        c = ops.launch_counts()
        if c != want:
            raise AssertionError(f"3t {arch} {what}: launches {c}, "
                                 f"expected {want}")
        return out

    def want(ssd, flash, paged):
        return {"tte_sample": 0, "flash_attention": flash,
                "paged_decode_attention": paged, "ssd_intra": ssd}
    rng = np.random.default_rng(SEED + 41)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in SSM_ARTIFACT_PROMPTS]
    t0 = time.perf_counter()
    steps, gates = 0, []
    for toks in prompts:
        (t,) = art._pad_inputs(toks, None)
        last = np.asarray([len(toks) - 1], np.int32)
        got = counted(lambda: rt.run(t), want(L, napps, 0), "full graph")
        with torch.no_grad():
            ref_full = fns["full"](params, *dev(t)).cpu().numpy()
        if not np.array_equal(got, ref_full):
            raise AssertionError(f"3t {arch}: full graph != eager: "
                                 f"{float(np.abs(got - ref_full).max())}")
        lg, cache = counted(lambda: rt.prefill(t, last), want(L, napps, 0),
                            "prefill")
        with torch.no_grad():
            lg_e, cache_e = fns["prefill"](params, *dev(t, last))
        if not (np.array_equal(lg, lg_e.cpu().numpy()) and all(
                torch.equal(x, y) for x, y in zip(cache, cache_e))):
            raise AssertionError(f"3t {arch}: prefill graph != eager")
        # the masked prefill against the exact prompt, and the control
        tok = np.asarray([[int(rng.integers(0, cfg.vocab_size))]], np.int32)
        step = np.asarray([len(toks)], np.int32)
        exact = dev(toks[None])[0]

        def exact_route(c, p=params):
            with torch.no_grad():
                out = forward(p, c, {"tokens": exact}, mode="prefill",
                              cache_width=S)
                d1 = decode_step(p, c, out["cache"], {"tokens": dev(tok)[0]},
                                 dev(step)[0])
            return out["logits"][0, 0], d1["logits"][0, 0]
        with plain_route():
            ref0, ref1 = exact_route(c32)
        kern0, kern1 = exact_route(cfg)
        gate = {"prompt_tokens": len(toks),
                "logits_scale": float(ref0.abs().max())}
        if len(toks) < S:
            with torch.no_grad():
                art1 = torch.from_numpy(rt.decode_step(
                    [x.clone() for x in cache], tok, step)[0])[0]
                out = forward(params, cfg, {"tokens": dev(t)[0]},
                              mode="prefill", cache_width=S)
                ctl = decode_step(params, cfg, mask_padded_positions(
                    out["cache"], dev(last)[0]), {"tokens": dev(tok)[0]},
                    dev(step)[0])["logits"][0, 0]
            gate["control_err"] = float((ctl - ref1).abs().max())
        else:
            art1 = None
        for k, (a, kern, ref) in enumerate(((torch.from_numpy(lg)[0], kern0,
                                             ref0), (art1, kern1, ref1))):
            if a is None:
                continue
            err = float((a.to(DEVICE) - ref).abs().max())
            eager = float((kern - ref).abs().max())
            gate[("prefill", "decode")[k]] = {"artifact_err": err,
                                              "eager_err": eager}
            if not (np.isfinite(err) and err <= DENSE_LOGITS_VS_PLAIN * eager):
                raise AssertionError(
                    f"3t {arch} {len(toks)} tokens: the padded prompt's "
                    f"{('prefill', 'decode step')[k]} logits are off the "
                    f"fp32 model's by {err}, the eager exact-length route's "
                    f"by {eager} (allowed {DENSE_LOGITS_VS_PLAIN}x it)")
        if "control_err" in gate and not gate["control_err"] > \
                DENSE_LOGITS_VS_PLAIN * gate["decode"]["eager_err"]:
            raise AssertionError(
                f"3t {arch} {len(toks)} tokens: the unmasked control is off "
                f"by only {gate['control_err']}: the mask does not bite")
        gates.append(gate)
        if len(toks) >= S:
            continue
        for k in range(ARTIFACT_DECODE_STEPS):
            args = (np.asarray([[rng.integers(0, cfg.vocab_size)]], np.int32),
                    np.asarray([len(toks) + k], np.int32))
            lg, cache = counted(lambda: rt.decode_step(cache, *args),
                                want(0, 0, napps), "decode step")
            with torch.no_grad():
                lg_e, cache_e = fns["decode"](params, cache_e, *dev(*args))
            if not np.array_equal(lg, lg_e.cpu().numpy()):
                raise AssertionError(
                    f"3t {arch}: prompt of {len(toks)} tokens, decode step "
                    f"{k} != eager")
            steps += 1
        if not all(torch.equal(x, y) for x, y in zip(cache, cache_e)):
            raise AssertionError(f"3t {arch}: artifact cache != eager")
    stage["gates"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    served = [p for p in prompts if len(p) < S]
    us = lm_uniforms(len(served), SSM_ARTIFACT_MAX_NEW, cfg.vocab_size,
                     SEED + 42)
    reqs = [GenerateRequest(tokens=[int(x) for x in toks],
                            max_new=SSM_ARTIFACT_MAX_NEW, uniforms=u)
            for toks, u in zip(served, us)]

    def drive():
        t1 = time.perf_counter()
        outs = [art.generate(r).tokens for r in reqs]
        torch.cuda.synchronize()
        return time.perf_counter() - t1, outs
    drive()
    ops.reset_launch_counts()
    drive_s, outs = drive()
    counts = ops.launch_counts()
    n = len(reqs) * SSM_ARTIFACT_MAX_NEW
    decodes = len(reqs) * (SSM_ARTIFACT_MAX_NEW - 1)
    if counts != want(L * len(reqs), napps * len(reqs), napps * decodes) \
            or [len(o) for o in outs] != [SSM_ARTIFACT_MAX_NEW] * len(reqs):
        raise AssertionError(f"3t {arch}: drive launches {counts}, tokens "
                             f"{[len(o) for o in outs]}")
    local = LocalBackend(params, cfg, seq_len=S, device=DEVICE)
    for r, o in zip(reqs, outs):
        if [e.token for e in local.stream(r)] != o:
            raise AssertionError(f"3t {arch}: ArtifactBackend != "
                                 f"LocalBackend.stream")
    held = par.check_lm_trajectories(
        served, outs, us, par.port_logits_fn(params, cfg),
        margin_tol=LM_MARGIN)
    stage["drive"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    turns = ssm_artifact_step_ms(art, fns, params, served[-1])
    prof = path_profile(lambda: drive()[0], drive_s)
    stage["times"] = time.perf_counter() - t0
    res = {"arch": arch, "layers": L, "napps": napps, "export": ex,
           "load_s": load_s, "decode_steps": steps, "gates": gates,
           "launches": counts, "tokens": n, "drive_s": drive_s,
           "ms_per_token": 1e3 * drive_s / n, "turns": turns,
           "held_steps": held["steps"],
           "near_ties": len(held["near_ties"]), "profile": prof,
           "stage_s": stage}
    del art, local, params, rt
    free_card()
    return res


def ssm_artifact_step_ms(art, fns, params, toks) -> list:
    """Host wall per decode step, each ending in its logits' copy to the
    host (what a client waits for a token): the v2 decode graph through
    the runtime against the eager decode function (what
    ``LocalBackend.stream`` calls), ``SSM_ARTIFACT_MAX_NEW - 1`` steps each
    after one prefill, in turns (v2, eager, eager, v2)."""
    import numpy as np
    import torch
    (t,) = art._pad_inputs(toks, None)
    last = np.asarray([len(toks) - 1], np.int32)
    steps = [(np.asarray([[3 + k]], np.int32),
              np.asarray([len(toks) + k], np.int32))
             for k in range(SSM_ARTIFACT_MAX_NEW - 1)]

    def v2():
        _, cache = art.runtime.prefill(t, last)
        t0 = time.perf_counter()
        for args in steps:
            _, cache = art.runtime.decode_step(cache, *args)
        return time.perf_counter() - t0

    def eager():
        with torch.no_grad():
            _, cache = fns["prefill"](params, *[
                torch.from_numpy(x).to(DEVICE) for x in (t, last)])
            t0 = time.perf_counter()
            for args in steps:
                lg, cache = fns["decode"](
                    params, cache,
                    *[torch.from_numpy(x).to(DEVICE) for x in args])
                lg.cpu().numpy()
        return time.perf_counter() - t0
    runs = {"v2": v2, "eager": eager}
    turns = []
    for mode in ("v2", "eager", "eager", "v2"):
        torch.cuda.synchronize()
        turns.append((mode, 1e3 * runs[mode]() / len(steps)))
    return turns


def log_ssm_artifact(res: dict, smi: str) -> None:
    """Phase 3t's lines for one model."""
    ex = res["export"]
    log(f"  {res['arch']} ({res['layers']} layers"
        + (f", {res['napps']} shared-block applications" if res["napps"]
           else "") + f"): exported in {ex['export_s']:.1f}s "
        f"({ex['bytes']} bytes), loaded in {res['load_s']:.1f}s; full, "
        f"prefill and {res['decode_steps']} decode steps == eager bit for "
        f"bit through the repro_torch:: operators")
    for g in res["gates"]:
        dec = g.get("decode")
        log(f"    {g['prompt_tokens']} tokens against the fp32 model "
            f"(largest |logit| {g['logits_scale']:.4g}): prefill "
            f"{g['prefill']['artifact_err']:.4g} (eager exact "
            f"{g['prefill']['eager_err']:.4g})"
            + (f", decode step {dec['artifact_err']:.4g} (eager exact "
               f"{dec['eager_err']:.4g}), unmasked control "
               f"{g['control_err']:.4g}" if dec else "")
            + f" (allowed {DENSE_LOGITS_VS_PLAIN}x the eager error)")
    pr = res["profile"]
    idle = ("not measured" if pr["idle_share"] is None
            else format(pr["idle_share"], ".3f"))
    log(f"    ArtifactBackend == LocalBackend.stream, {res['held_steps']} "
        f"tokens held against the eager model ({res['near_ties']} "
        f"near-ties, margin {LM_MARGIN}); {res['ms_per_token']:.2f} ms a "
        f"token on the drive; launches {res['launches']}; ms a decode step "
        f"in turns {[(m, round(v, 3)) for m, v in res['turns']]}; drive "
        f"under the profiler: device busy {pr['device_busy_s']:.4f}s of "
        f"{pr['wall_s']:.3f}s, idle share {idle}; stages "
        + ", ".join(f"{k} {v:.1f}s" for k, v in res["stage_s"].items())
        + f" ({smi})")


def log_ssm_artifact_phase(res: dict, phase: str, smi: str,
                           t_start: float) -> None:
    """Phase 3t's lines: both models, then the operator's host cost."""
    for arch in SSM_ARTIFACT_LAYERS:
        log_ssm_artifact(res[arch], smi)
    log(f"  ssd_intra host us a call at 3b's prefill shape (wrapper, "
        f"operator in turns): "
        f"{[(m, round(v, 2)) for m, v in res['op_us']['ssd_intra']]}; "
        f"phase {phase} took {time.perf_counter() - t_start:.1f}s ({smi})")


def ssm_artifact_phase(tmp=None, exports=None) -> dict:
    """Phase 3t: both models, then the operator's host cost.  ``tmp`` and
    ``exports`` are the directory and numbers of exports made before
    (``start_ssm_artifact_exports``); without them the phase exports
    itself."""
    if tmp is None:
        with tempfile.TemporaryDirectory() as own:
            return ssm_artifact_phase(own, {})
    out = {arch: ssm_artifact_path(arch, tmp, exports.get(arch))
           for arch in SSM_ARTIFACT_LAYERS}
    out["op_us"] = ssm_artifact_op_us()
    return out


# ---------------------------------------------------------------------------
# phase 2's MoE check and phases 3p/3q: the MoE LMs at full width
# (OLMoE-1B-7B, Qwen2-MoE-A2.7B), with 3k's knobs
# ---------------------------------------------------------------------------
# apply_moe in bf16 against the same weights in fp32 (TF32 off): the error
# of the tokens whose routing cannot flip, relative to the fp32 output's
# largest |y| (the H100 measured 7.4e-3 at T 8 and 6.9e-3 at T 2,048)
MOE_BF16_REL = 1.5e-2
MOE_CHECK_TOKENS = (8, 2048)
# 3q's fp32 comparison: Qwen2-MoE's 57 GB of fp32 weights do not fit beside
# its bf16 model, so that model is cut to 2 layers at full width
MOE_FP32_LAYERS = 2


def check_moe(gen, cfg=None) -> dict:
    """``models/moe.py::apply_moe`` at Qwen2-MoE's widths (60 experts of
    1,408, top-4, 4 shared), one layer, at T 8 and T 2,048 tokens: the bf16
    route against the same weights in fp32 on the card, TF32 off.  A token
    whose top-k margin in fp32 (the k-th probability less the (k+1)-th) is
    below the bf16 router's largest probability error may route otherwise
    in bf16: such tokens are counted and left out of the error, which must
    stay within ``MOE_BF16_REL`` of the fp32 output's largest |y|."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import cast_params, init_params_on_device, moe
    from repro_torch.models.model import Block
    cfg = (cfg or get_config("qwen2-moe-a2.7b")).replace(n_layers=1)
    w32 = init_params_on_device(cfg.replace(dtype="float32"), seed=SEED,
                                device=DEVICE)
    blk32 = Block(w32, "layers/", 0)
    blk16 = Block(cast_params(w32, cfg), "layers/", 0)
    out = {}
    for T in MOE_CHECK_TOKENS:
        x = torch.randn((1, T, cfg.d_model), generator=gen, device=DEVICE)
        x16 = x.to(torch.bfloat16)
        y32, _ = moe.apply_moe(blk32, x, cfg.replace(dtype="float32"))
        y16, _ = moe.apply_moe(blk16, x16, cfg)
        router = blk32["moe/router"]
        p32 = torch.softmax(moe.router_logits(router, x[0]), dim=-1)
        p16 = torch.softmax(moe.router_logits(router, x16[0]), dim=-1)
        router_err = float((p16 - p32).abs().max())
        top = p32.sort(dim=-1, descending=True).values
        keep = (top[:, cfg.top_k - 1] - top[:, cfg.top_k]) >= router_err
        err_tok = (y16[0].float() - y32[0]).abs().amax(dim=-1)
        scale = float(y32.abs().max())
        err = float(err_tok[keep].max())
        torch.cuda.synchronize()
        if not (err <= MOE_BF16_REL * scale
                and bool(torch.isfinite(y16).all())):
            raise AssertionError(f"apply_moe T={T}: bf16 err {err} > "
                                 f"{MOE_BF16_REL} x {scale}")
        out[T] = {"err": err, "scale": scale, "router_err": router_err,
                  "near_ties": int((~keep).sum()),
                  "err_near_ties": float(err_tok.max())}
        log(f"  apply_moe T={T} (E={cfg.n_experts} top-{cfg.top_k} f="
            f"{cfg.moe_d_ff}, {cfg.n_shared_experts} shared; bf16 vs fp32): "
            f"max abs err {err:.3g} of |y| <= {scale:.3g} (tol "
            f"{MOE_BF16_REL} x it); router prob err {router_err:.3g}, "
            f"{out[T]['near_ties']} near-tie tokens left out (their err "
            f"<= {out[T]['err_near_ties']:.3g})")
    out["dispatch"] = check_moe_dispatch(gen, w32, cfg)
    del w32, blk32, blk16
    free_card()
    return out


# phase 2's MoE dispatch check: ``ragged`` and ``dense_einsum`` against
# ``dense_scan`` at Qwen2-MoE's widths; in fp32 (TF32 off) within the CPU
# test's tolerance (tests/test_torch_moe_impl.py), in bf16 against the fp32
# ``dense_scan`` within MOE_BF16_REL on the tokens whose routing cannot flip
MOE_DISPATCH_FP32_ATOL = 1e-5
MOE_DISPATCH_MS_ITERS = 10


def check_moe_dispatch(gen, w32, cfg) -> dict:
    """``apply_moe``'s ``ragged`` and ``dense_einsum`` against its default
    ``dense_scan`` on one layer (``w32``, fp32 weights; ``cfg`` the bf16
    config) at T 8 and T 2,048: fp32 within ``MOE_DISPATCH_FP32_ATOL``; bf16
    against the fp32 ``dense_scan`` within ``MOE_BF16_REL`` of its largest
    |y|, the near-tie tokens counted and left out (as :func:`check_moe`).
    Prints which grouped product ``ragged`` ran, each route's ms a layer in
    bf16 (CUDA events, ``MOE_DISPATCH_MS_ITERS`` calls) and whether
    ``ragged``'s rows keep their bits across T (the first 8 tokens at T 8
    and inside T 2,048)."""
    import torch
    from repro_torch.models import cast_params, moe
    from repro_torch.models.model import Block
    c32 = cfg.replace(dtype="float32")
    blk32 = Block(w32, "layers/", 0)
    blk16 = Block(cast_params(w32, cfg), "layers/", 0)
    x_all = torch.randn((1, max(MOE_CHECK_TOKENS), cfg.d_model),
                        generator=gen, device=DEVICE)
    out, rows = {}, {}
    routes = ("dense_scan", "dense_einsum", "ragged")
    for T in MOE_CHECK_TOKENS:
        x = x_all[:, :T]
        x16 = x.to(torch.bfloat16)
        y32 = {r: moe.apply_moe(blk32, x, c32, impl=r)[0] for r in routes}
        y16 = {r: moe.apply_moe(blk16, x16, cfg, impl=r)[0] for r in routes}
        router = blk32["moe/router"]
        p32 = torch.softmax(moe.router_logits(router, x[0]), dim=-1)
        p16 = torch.softmax(moe.router_logits(router, x16[0]), dim=-1)
        router_err = float((p16 - p32).abs().max())
        top = p32.sort(dim=-1, descending=True).values
        keep = (top[:, cfg.top_k - 1] - top[:, cfg.top_k]) >= router_err
        scale = float(y32["dense_scan"].abs().max())
        res = {"near_ties": int((~keep).sum()), "scale": scale}
        for r in ("dense_einsum", "ragged"):
            e32 = float((y32[r] - y32["dense_scan"]).abs().max())
            e16 = float((y16[r][0].float() - y32["dense_scan"][0]).abs()
                        .amax(dim=-1)[keep].max())
            ok = (e32 <= MOE_DISPATCH_FP32_ATOL
                  and e16 <= MOE_BF16_REL * scale
                  and bool(torch.isfinite(y16[r]).all()))
            if not ok:
                raise AssertionError(
                    f"apply_moe impl={r} T={T}: fp32 err {e32} (tol "
                    f"{MOE_DISPATCH_FP32_ATOL}), bf16 err {e16} (tol "
                    f"{MOE_BF16_REL} x {scale})")
            res[r] = {"fp32_err": e32, "bf16_err": e16}
        rows[T] = y16["ragged"][0]
        flat16 = x16.reshape(-1, cfg.d_model)
        res["grouped_product"] = moe.grouped_route(flat16,
                                                   blk16["moe/w_gate"])
        res["ms"] = {r: cuda_ms(lambda r=r: moe.apply_moe(blk16, x16, cfg,
                                                          impl=r),
                                iters=MOE_DISPATCH_MS_ITERS, warmup=2)
                     for r in routes}
        out[T] = res
        log(f"  apply_moe dispatch T={T} (bf16 and fp32, TF32 off): ragged "
            f"fp32 err {res['ragged']['fp32_err']:.3g}, dense_einsum fp32 "
            f"err {res['dense_einsum']['fp32_err']:.3g} (tol "
            f"{MOE_DISPATCH_FP32_ATOL}); against the fp32 dense_scan in "
            f"bf16: ragged {res['ragged']['bf16_err']:.3g}, dense_einsum "
            f"{res['dense_einsum']['bf16_err']:.3g} of |y| <= {scale:.3g} "
            f"(tol {MOE_BF16_REL} x it; {res['near_ties']} near-tie tokens "
            f"left out); ragged's grouped product: "
            f"{res['grouped_product']}; ms a layer in bf16: " + ", ".join(
                f"{r} {v:.4f}" for r, v in res["ms"].items()))
    lo, hi = min(MOE_CHECK_TOKENS), max(MOE_CHECK_TOKENS)
    same = bool(torch.equal(rows[lo], rows[hi][:lo]))
    out["ragged_rows_keep_bits"] = same
    log(f"  ragged's first {lo} rows at T={hi} == at T={lo} bit for bit: "
        f"{same}")
    return out


class routing:
    """Inside the block ``models.moe.route`` records each call's experts
    (one call a layer, in order) in ``seen``; with ``held`` (a list of
    (T, k) expert tensors, one a layer) it takes those experts in place of
    its own top-k, with their renormalised probabilities as the combine
    weights: a run held to another run's routing (the aux loss stays the
    route's own; the logits do not read it)."""

    def __init__(self, held=None):
        self.held, self.seen = held, []

    def __enter__(self):
        import torch
        from repro_torch.models import moe
        self._real = real = moe.route

        def route(router, x, k):
            w, e, aux = real(router, x, k)
            if self.held is not None:
                e = self.held[len(self.seen)]
                probs = torch.softmax(moe.router_logits(router, x), dim=-1)
                w = probs.gather(1, e)
                w = w / w.sum(dim=-1, keepdim=True)
            self.seen.append(e)
            return w, e, aux
        moe.route = route
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.route = self._real


def moe_logits(params, cfg, prompt) -> dict:
    """The bf16 model's last prefill position's logits of one prompt
    against the fp32 model made from the same draws
    (``init_params_on_device`` at ``dtype="float32"``: plain route, TF32
    off), through the kernels and through the plain route.  A token whose
    top-k margin is within bf16's error routes otherwise in bf16, and a
    flipped expert moves that token's output by far more than rounding
    does; the flips follow the attention outputs' last bits, so the two
    bf16 routes flip different tokens.  The gate (phase 3l's rule,
    ``DENSE_LOGITS_VS_PLAIN``) therefore holds both bf16 routes to the fp32
    model's routing (``routing(held=...)``): the kernels' route's error
    may be at most that multiple of the plain route's.  The free-routing
    errors and the router choices the bf16 model flips against fp32, layer
    by layer (tokens whose top-k set differs), are measured beside it."""
    import torch
    from repro_torch.models import forward, init_params_on_device
    toks = torch.from_numpy(prompt[None]).to(DEVICE)

    def last(c, p, held=None):
        with routing(held) as r, torch.no_grad():
            lg = forward(p, c, {"tokens": toks}, mode="prefill")[
                "logits"][0, 0]
        return lg, r.seen
    c32 = cfg.replace(dtype="float32")
    with plain_route():
        p32 = init_params_on_device(c32, seed=SEED, device=DEVICE)
        exact, e32 = last(c32, p32)
        del p32
        free_card()
        plain, _ = last(cfg, params, e32)
        plain_free, _ = last(cfg, params)
    kern, _ = last(cfg, params, e32)
    kern_free, e16 = last(cfg, params)

    def off(a):
        return float((a - exact).abs().max())
    err, plain_err = off(kern), off(plain)
    flips = [int((a.sort(dim=-1).values != b.sort(dim=-1).values)
                 .any(dim=-1).sum()) for a, b in zip(e16, e32)]
    if not (bool(torch.isfinite(kern).all())
            and bool(torch.isfinite(kern_free).all())
            and err <= DENSE_LOGITS_VS_PLAIN * plain_err):
        raise AssertionError(f"{cfg.name}: held to the fp32 model's routing,"
                             f" the kernels' route is off by {err}, the "
                             f"plain route by {plain_err} (allowed "
                             f"{DENSE_LOGITS_VS_PLAIN}x it)")
    return {"prompt_tokens": len(prompt), "layers": cfg.n_layers,
            "logits_err": err, "plain_err": plain_err,
            "kernel_vs_plain": float((kern - plain).abs().max()),
            "free_logits_err": off(kern_free),
            "free_plain_err": off(plain_free),
            "logits_scale": float(exact.abs().max()),
            "router_flips_by_layer": flips}


def dense_logits(params, cfg, prompts) -> dict:
    """Each prompt's last prefill position's logits, through the kernels and
    through the plain route in bf16, against the fp32 model at full depth
    on the same weights (``core.parity.layered_prefill_logits``: one layer
    upcast at a time, plain route, TF32 off: the fp32 tree of Qwen2.5-32B,
    131 GB, does not fit the card).  3l's rule for each prompt: the
    kernels' route may be off by at most ``DENSE_LOGITS_VS_PLAIN`` times
    the plain route's own bf16 error."""
    import torch
    from repro_torch.core import parity as par
    from repro_torch.models import forward
    rows = []
    for prompt in prompts:
        toks = torch.from_numpy(prompt[None]).to(DEVICE)

        def last():
            with torch.no_grad():
                return forward(params, cfg, {"tokens": toks},
                               mode="prefill")["logits"][0, 0]
        kern = last()
        with plain_route():
            plain = last()
        exact = par.layered_prefill_logits(params, cfg, toks)[0, 0]
        err = float((kern - exact).abs().max())
        plain_err = float((plain - exact).abs().max())
        if not (bool(torch.isfinite(kern).all())
                and err <= DENSE_LOGITS_VS_PLAIN * plain_err):
            raise AssertionError(f"{cfg.name}: a {len(prompt)}-token "
                                 f"prompt's logits against the fp32 model: "
                                 f"the kernels' route off by {err}, the "
                                 f"plain route by {plain_err} (allowed "
                                 f"{DENSE_LOGITS_VS_PLAIN}x it)")
        rows.append({"prompt_tokens": len(prompt), "logits_err": err,
                     "plain_err": plain_err,
                     "kernel_vs_plain": float((kern - plain).abs().max()),
                     "logits_scale": float(exact.abs().max())})
        del kern, plain, exact
        free_card()
    return {"layers": cfg.n_layers, "prompts": rows,
            "logits_err": max(r["logits_err"] for r in rows),
            "plain_err": max(r["plain_err"] for r in rows)}


def lm_cli_drive(arch: str) -> dict:
    """``python -m repro_torch.launch.serve --arch ARCH --max-context 1024
    --slots 8 --requests 8`` in this process (its ``main``): the weights
    made on the card in their use dtypes (``launch.serve.init_weights``),
    every request served with the CLI's 48 new tokens, flash once a layer
    an admission batch and paged once a layer a tick; the device's peak
    allocation against the bf16 tree, the ring and one fp32 piece (an fp32
    copy of the model would add twice the tree), and the process's host
    memory after it.  The engine and its weights are freed before
    returning."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launch
    from repro_torch.models.params import use_dtype
    free_card()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    argv = ["--arch", arch, "--max-context", str(DENSE_CONTEXT), "--slots",
            str(DENSE_SLOTS), "--requests", str(DENSE_REQUESTS), "--device",
            DEVICE]
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = launch.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    eng = out["engine"]
    cfg = eng.cfg
    max_new = launch.parse_args(argv).max_new
    check_lm_run(eng, out["done"], counts, cfg, max_new, f"{arch} CLI")
    wrong = [k for k, v in eng.params.items()
             if v.device.type != eng.device.type
             or v.dtype != use_dtype(cfg, k)]
    tree = sum(v.numel() * v.element_size() for v in eng.params.values())
    peak = torch.cuda.max_memory_allocated() - base
    limit = tree + eng.cache_bytes + largest_fp32_piece(cfg) + 4 * 2**30
    if wrong or len(out["done"]) != DENSE_REQUESTS or not peak < limit:
        raise AssertionError(f"{arch} CLI: leaves off the card or not in "
                             f"their use dtype {wrong[:4]}, "
                             f"{len(out['done'])} requests, device peak "
                             f"{peak} against {limit}")
    res = {"argv": argv, "wall_s": wall, "seconds": out["seconds"],
           "tokens": out["events"],
           "tokens_per_s": out["events"] / out["seconds"],
           "ticks": eng.ticks, "admit_batches": eng.admit_batches,
           "launches": counts, "tree_bytes": tree, "ring_bytes":
           eng.cache_bytes, "device_peak_bytes": peak,
           "device_peak_limit": limit, **launch._host_memory()}
    del out, eng
    free_card()
    return res


# 3w's long prompt: one request of 16,352 seeded ids and 8 new tokens, 1
# slot, max_context 16,384 (the largest power-of-two bucket beside
# Qwen2.5-32B's 61 GiB of bf16 weights: the ring 4 GiB, the prefill's own
# rings 4 GiB, MLP activations ~2.5 GiB; 32,768 would need ~82 GiB), on
# the ring and on the paged pool (1,024 blocks of 16); the first
# LM_LONG_HELD tokens held teacher-forced against prefills
LM_LONG_PROMPT, LM_LONG_CONTEXT, LM_LONG_MAX_NEW = 16352, 16384, 8
LM_LONG_HELD = 2
# 3w's profiled window: its first PROFILE_REQUESTS prompts, this many new
# tokens (64 layers make ~4,300 device activities a tick: the profiler took
# ~20 s to fold the 34,000 of a window of PROFILE_MAX_NEW tokens)
LM_PROFILE_MAX_NEW_3W = 4


def lm_long_drive(params, cfg, margin: float) -> dict:
    """The long prompt served alone on the ring, then on the paged pool,
    under injected uniforms: the two runs' tokens equal bit for bit; then
    the first ``LM_LONG_HELD`` tokens held teacher-forced against the
    kernels' prefill of the prompt and of the prompt extended by the first
    token (``core.parity.check_lm_steps``: the argmax of the Gumbel scores,
    or within ``margin`` of it), and the largest difference between that
    second prefill's logits and a ``decode_step`` after the first prefill's
    cache.  The peak allocation of the drive (weights included) against
    the card's."""
    import numpy as np
    import torch
    from repro_torch.core import parity as par
    from repro_torch.models import decode_step, forward
    rng = np.random.default_rng(SEED + 23)
    prompt = rng.integers(0, cfg.vocab_size, LM_LONG_PROMPT).astype(np.int32)
    u = lm_uniforms(1, LM_LONG_MAX_NEW, cfg.vocab_size, SEED + 24)
    free_card()
    held_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    runs = {}
    for name, extra in (("ring", {}), ("paged", dict(cache="paged"))):
        eng, reqs, sec, c = lm_serve(params, cfg, [prompt], uniforms=u,
                                     max_new=LM_LONG_MAX_NEW, slots=1,
                                     max_context=LM_LONG_CONTEXT, **extra)
        check_lm_run(eng, reqs, c, cfg, LM_LONG_MAX_NEW, f"long {name}")
        runs[name] = {"tokens": reqs[0].out_tokens, "seconds": sec,
                      "launches": c, "ticks": eng.ticks,
                      "prefill_shapes": sorted(eng.prefill_shapes),
                      "cache_bytes": (eng.pool_stats()["cache_bytes"]
                                      if eng.paged else eng.cache_bytes)}
        if eng.paged:
            runs[name]["blocks"] = eng.pool_stats()["blocks"]
        else:
            saved = layer0(eng)
        del eng, reqs
        free_card()
    if runs["ring"]["tokens"] != runs["paged"]["tokens"]:
        raise AssertionError("long prompt: ring and paged tokens differ")
    serve_peak = torch.cuda.max_memory_allocated()
    out = runs["ring"]["tokens"]
    toks = torch.from_numpy(prompt[None].astype(np.int64)).to(DEVICE)
    first = torch.tensor([[out[0]]], dtype=torch.int64, device=DEVICE)
    with torch.no_grad():
        pre = forward(params, cfg, {"tokens": toks}, mode="prefill",
                      cache_width=LM_LONG_CONTEXT)
        row0 = pre["logits"][0, 0]
        dec = decode_step(params, cfg, pre["cache"], {"tokens": first},
                          torch.tensor([LM_LONG_PROMPT], dtype=torch.int32,
                                       device=DEVICE))["logits"][0, 0]
        del pre
        free_card()
        row1 = forward(params, cfg, {"tokens": torch.cat([toks, first], 1)},
                       mode="prefill")["logits"][0, 0]
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    card = torch.cuda.get_device_properties(0).total_memory
    held = par.check_lm_steps(
        [torch.stack([row0, row1]).float().cpu().numpy()],
        [out[:LM_LONG_HELD]], [u[0]], margin_tol=margin)
    if not peak < card:
        raise AssertionError(f"long prompt: peak memory {peak} past the "
                             f"card's {card}")
    res = {"prompt_tokens": LM_LONG_PROMPT, "max_context": LM_LONG_CONTEXT,
           "runs": runs, "equal_tokens": len(out), "layer0": saved,
           "held_steps": held["steps"], "near_ties": len(held["near_ties"]),
           "margin": margin,
           "decode_vs_prefill": float((dec - row1).abs().max()),
           "logits_scale": float(row1.abs().max()),
           "held_before_bytes": held_bytes, "serve_peak_bytes": serve_peak,
           "peak_bytes": peak, "card_memory_bytes": card}
    del row0, row1, dec
    free_card()
    return res


def lm_path(arch: str, phase: str, fp32_layers=None, cli: bool = False,
            long: bool = False, profile_max_new=None) -> dict:
    """Phases 3p (OLMoE-1B-7B), 3q (Qwen2-MoE-A2.7B), 3w (Qwen2.5-32B) and
    3x (DeepSeek-7B): the model at full width and depth in bf16, its
    weights made on the card (``init_params_on_device``), served with 3k's
    knobs (8 slots, ``max_context`` 1,024, 8 random-id prompts of 64-768
    tokens, 32 new tokens): the ring, then the prefix-cached paged cache;
    under injected uniforms ring == paged bit for bit on all 8 requests and
    chunked (64 tokens a step) == unchunked bit for bit on the shortest, the
    shortest ragged (its last chunk short of 64 tokens) and the longest,
    each served alone; one host copy a tick and an admission
    batch, the pool drained, flash 1 launch a layer an admission batch (a
    chunk when chunked), paged 1 a layer a tick, ``tte_sample`` none; the
    peak memory under the card's; a profiled ring window (3o's, or
    ``profile_max_new`` tokens a prompt); the last
    logits against the fp32 model: an MoE LM's longest prompt held to the
    fp32 model's routing (``moe_logits``; with ``fp32_layers``, of a model
    cut to that depth at full width: 3q's), a dense LM's shortest and
    longest prompts against the layer-at-a-time fp32 reference at full
    depth (``dense_logits``).  With ``cli`` the serving CLI runs first
    (``lm_cli_drive``, its weights freed before the phase makes its own);
    with ``long`` the long prompt is served last (``lm_long_drive``)."""
    import torch
    from repro_torch.configs import MOE, get_config
    from repro_torch.models import init_params_on_device
    cfg = get_config(arch)
    stage = {}
    cli_res = None
    if cli:
        t0 = time.perf_counter()
        cli_res = lm_cli_drive(arch)
        stage["cli"] = time.perf_counter() - t0
    free_card()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = init_params_on_device(cfg, seed=SEED, device=DEVICE)
    torch.cuda.synchronize()
    init_s = stage["init"] = time.perf_counter() - t0
    weight_bytes = sum(v.numel() * v.element_size() for v in params.values())
    prompts = lm_long_prompts(cfg.vocab_size)
    kw = dict(max_new=DENSE_MAX_NEW, slots=DENSE_SLOTS,
              max_context=DENSE_CONTEXT)
    t0 = time.perf_counter()
    # first use of cuBLAS at these shapes, through the same entry point
    lm_serve(params, cfg, prompts[:2], max_new=2, slots=DENSE_SLOTS,
             max_context=DENSE_CONTEXT)
    stage["warmup"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    runs = {}
    for name, extra in (("ring", {}),
                        ("paged", dict(cache="paged", prefix_cache=True))):
        eng, reqs, sec, counts = lm_serve(params, cfg, prompts, **kw,
                                          **extra)
        check_lm_run(eng, reqs, counts, cfg, DENSE_MAX_NEW,
                     f"{phase} {name}")
        runs[name] = {"seconds": sec, "launches": counts,
                      "tokens": len(reqs) * DENSE_MAX_NEW,
                      "tokens_per_s": len(reqs) * DENSE_MAX_NEW / sec,
                      "ticks": eng.ticks, "admit_batches": eng.admit_batches,
                      "host_syncs": eng.host_syncs,
                      "prefill_shapes": sorted(eng.prefill_shapes)}
        if name == "ring":
            saved = layer0(eng)
        del eng
    stage["serve"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    us = lm_uniforms(len(prompts), DENSE_MAX_NEW, cfg.vocab_size, SEED + 9)
    exact = {}
    chunked = dict(cache="paged", prefill_chunk_tokens=DENSE_CHUNK)
    for name, extra in (("ring", {}), ("paged", dict(cache="paged"))):
        eng, reqs, _, counts = lm_serve(params, cfg, prompts, uniforms=us,
                                        **kw, **extra)
        check_lm_run(eng, reqs, counts, cfg, DENSE_MAX_NEW,
                     f"{phase} injected {name}")
        exact[name] = [r.out_tokens for r in reqs]
        del eng
    if exact["ring"] != exact["paged"]:
        raise AssertionError(f"{phase}: ring and paged tokens differ")
    solo = solo_prompts(prompts)
    for i in solo:
        one = {}
        for name, extra in (("paged", dict(cache="paged")),
                            ("chunked", chunked)):
            eng, reqs, _, counts = lm_serve(params, cfg, [prompts[i]],
                                            uniforms=[us[i]], **kw, **extra)
            check_lm_run(eng, reqs, counts, cfg, DENSE_MAX_NEW,
                         f"{phase} solo {name}")
            one[name] = reqs[0].out_tokens
            del eng
        if one["paged"] != one["chunked"]:
            raise AssertionError(f"{phase}: request {i} alone: chunked "
                                 f"tokens differ from unchunked")
    stage["exact"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    profile_max_new = profile_max_new or PROFILE_MAX_NEW
    prof = window_profile(lambda: lm_serve(
        params, cfg, prompts[:PROFILE_REQUESTS], max_new=profile_max_new,
        slots=DENSE_SLOTS, max_context=DENSE_CONTEXT)[2])
    prof["max_new"] = profile_max_new
    stage["profile"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    card = torch.cuda.get_device_properties(0).total_memory
    if not peak < card:
        raise AssertionError(f"{phase}: peak memory {peak} past the card's "
                             f"{card}")
    t0 = time.perf_counter()
    if cfg.arch_type != MOE:
        # the shortest and the longest prompt
        logits = dense_logits(params, cfg, [prompts[solo[0]],
                                            prompts[solo[-1]]])
    elif fp32_layers is not None:
        del params
        free_card()
        cut = cfg.replace(n_layers=fp32_layers)
        params = init_params_on_device(cut, seed=SEED, device=DEVICE)
        logits = moe_logits(params, cut, prompts[solo[-1]])
    else:
        logits = moe_logits(params, cfg, prompts[solo[-1]])
    stage["logits"] = time.perf_counter() - t0
    long_res = None
    if long:
        t0 = time.perf_counter()
        long_res = lm_long_drive(params, cfg, 2 * logits["logits_err"])
        stage["long"] = time.perf_counter() - t0
    del params
    free_card()
    return {"runs": runs, "profile": prof, "layer0": saved,
            "init_s": init_s, "weight_bytes": weight_bytes,
            "peak_memory_bytes": peak, "card_memory_bytes": card,
            "exact_tokens": sum(len(t) for t in exact["ring"]),
            "solo_prompt_lengths": [len(prompts[i]) for i in solo],
            "logits": logits, "cli": cli_res, "long": long_res, "cfg": cfg,
            "stage_s": stage}


def log_lm(res: dict, phase: str, smi: str, t_start: float) -> None:
    cfg = res["cfg"]
    c = res["cli"]
    if c is not None:
        host = ("" if c["host_rss_bytes"] is None else
                f"; host {c['host_rss_kind']} "
                f"{c['host_rss_bytes'] / 2**30:.2f} GiB after it")
        log(f"  python -m repro_torch.launch.serve {' '.join(c['argv'])}: "
            f"{c['tokens']} tokens in {c['seconds']:.3f}s: "
            f"{c['tokens_per_s']:.1f} tokens/s, {c['ticks']} ticks, "
            f"{c['admit_batches']} admission batches, launches "
            f"{c['launches']}; the call {c['wall_s']:.1f}s; weights made on "
            f"the card in their use dtypes ({c['tree_bytes'] / 1e9:.2f} GB); "
            f"device peak {c['device_peak_bytes'] / 2**30:.2f} GiB (limit "
            f"{c['device_peak_limit'] / 2**30:.2f}: the tree, the ring's "
            f"{c['ring_bytes'] / 2**30:.2f} GiB, one fp32 piece, 4 GiB)"
            f"{host}")
    for name, r in res["runs"].items():
        log(f"  {name}: {r['tokens']} tokens, {r['ticks']} ticks, "
            f"{r['admit_batches']} admission batches in {r['seconds']:.3f}s:"
            f" {r['tokens_per_s']:.1f} tokens/s; host_syncs "
            f"{r['host_syncs']}; prefill shapes {r['prefill_shapes']}; "
            f"launches {r['launches']} ({cfg.n_layers} flash an admission "
            f"batch, {cfg.n_layers} paged a tick, no tte_sample)")
    p, lg = res["profile"], res["logits"]
    idle = ("not measured" if p["idle_share"] is None
            else format(p["idle_share"], ".3f"))
    log(f"  under injected uniforms: ring == paged bit for bit "
        f"({res['exact_tokens']} tokens); chunked ({DENSE_CHUNK} tokens a "
        f"step) == unchunked bit for bit on the requests of "
        f"{res['solo_prompt_lengths']} tokens served alone; pool drained")
    log(f"  weights made on the card in {res['init_s']:.1f}s "
        f"({res['weight_bytes'] / 1e9:.2f} GB); peak memory "
        f"{res['peak_memory_bytes'] / 2**30:.2f} GiB of the card's "
        f"{res['card_memory_bytes'] / 2**30:.2f} GiB")
    log(f"  the first {PROFILE_REQUESTS} prompts x {p['max_new']} tokens "
        f"on the ring under the profiler: device busy "
        f"{p['device_busy_s']:.4f}s of {p['wall_s']:.3f}s wall, idle share "
        f"{idle}, {p['launches']} device activities; top by device time:")
    for t in p["top"]:
        log(f"    {t['ms']:9.3f} ms  {t['launches']:6d}x  {t['kernel']}")
    if "prompts" in lg:
        for r in lg["prompts"]:
            log(f"  last prefill position's logits of a "
                f"{r['prompt_tokens']}-token prompt ({lg['layers']} layers) "
                f"against the fp32 model one layer at a time (plain route, "
                f"TF32 off; largest |logit| {r['logits_scale']:.4g}): "
                f"kernels' route in bf16 off by {r['logits_err']:.4g}, the "
                f"plain route in bf16 by {r['plain_err']:.4g} (allowed "
                f"{DENSE_LOGITS_VS_PLAIN}x it), kernels vs plain "
                f"{r['kernel_vs_plain']:.4g}")
    else:
        log(f"  last prefill position's logits of a {lg['prompt_tokens']}-"
            f"token prompt ({lg['layers']} layers) against the fp32 model "
            f"(plain route, TF32 off; largest |logit| "
            f"{lg['logits_scale']:.4g}), held to its routing: kernels' route "
            f"in bf16 off by {lg['logits_err']:.4g}, the plain route in bf16 "
            f"by {lg['plain_err']:.4g} (allowed {DENSE_LOGITS_VS_PLAIN}x "
            f"it), kernels vs plain {lg['kernel_vs_plain']:.4g}; routing "
            f"freely: kernels {lg['free_logits_err']:.4g}, plain "
            f"{lg['free_plain_err']:.4g}; router choices the bf16 model "
            f"flips against fp32, by layer, of {lg['prompt_tokens']} tokens:"
            f" {lg['router_flips_by_layer']}")
    lr = res["long"]
    if lr is not None:
        for name, r in lr["runs"].items():
            log(f"  long prompt on the {name} ({lr['prompt_tokens']} tokens, "
                f"max_context {lr['max_context']}, "
                f"{r['cache_bytes'] / 2**30:.2f} GiB of cache"
                + (f", {r['blocks']} blocks" if "blocks" in r else "")
                + f"): {LM_LONG_MAX_NEW} tokens, {r['ticks']} ticks in "
                f"{r['seconds']:.3f}s; prefill shapes {r['prefill_shapes']}; "
                f"launches {r['launches']}")
        log(f"  long prompt: ring == paged bit for bit ({lr['equal_tokens']} "
            f"tokens); the first {lr['held_steps']} tokens held teacher-"
            f"forced against the kernels' prefills ({lr['near_ties']} "
            f"near-ties, score margin {lr['margin']:.4g}); a decode step "
            f"against the prefill of the extended prompt: largest logit "
            f"difference {lr['decode_vs_prefill']:.4g} (largest |logit| "
            f"{lr['logits_scale']:.4g}); peak memory "
            f"{lr['peak_bytes'] / 2**30:.2f} GiB (serving "
            f"{lr['serve_peak_bytes'] / 2**30:.2f} GiB; held before it "
            f"{lr['held_before_bytes'] / 2**30:.2f} GiB, reckoned ~72 GiB) "
            f"of the card's {lr['card_memory_bytes'] / 2**30:.2f} GiB")
    log(f"  phase {phase} took {time.perf_counter() - t_start:.1f}s (" +
        ", ".join(f"{k} {v:.1f}s" for k, v in res["stage_s"].items())
        + f"; {smi})")


LM_PHASES = (
    ("3w", "qwen2.5-32b", "64 layers, d_model 5120, 40/8 heads of 128, QKV "
     "biases, SwiGLU d_ff 27648, V 152064, rope theta 1e6; 65.53 GB in "
     "bf16"),
    ("3x", "deepseek-7b", "30 layers, d_model 4096, 32/32 heads of 128, "
     "SwiGLU d_ff 11008, V 102400; 13.82 GB in bf16"))


def lm_child() -> dict:
    """3w and 3x (``lm_path``) and their rows (``lm_rows``) in the process
    ``lm_phases`` starts: the phases' results and the rows, with no
    tensor left in them."""
    import torch
    from repro_torch.kernels import build
    build.library()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED)
    out = {}
    for ph, arch, desc in LM_PHASES:
        log(f"== phase {ph}: {arch} at full width and depth ({desc}; weights"
            f" made on the card), BatchedEngine(slots={DENSE_SLOTS}, "
            f"max_context={DENSE_CONTEXT}): {DENSE_REQUESTS} requests of "
            f"seeded random ids (64-768 tokens), {DENSE_MAX_NEW} new tokens "
            f"each, ring then prefix-cached paged"
            + ("; first the serving CLI, last a "
               f"{LM_LONG_PROMPT}-token prompt at max_context "
               f"{LM_LONG_CONTEXT}" if ph == "3w" else ""))
        t0 = time.perf_counter()
        out[ph] = lm_path(arch, ph, cli=ph == "3w", long=ph == "3w",
                          profile_max_new=(LM_PROFILE_MAX_NEW_3W
                                           if ph == "3w" else None))
        log_lm(out[ph], ph, smi, t0)
    t0 = time.perf_counter()
    rows = lm_rows(gen, out["3w"], out["3x"])
    log(f"  3w's and 3x's rows timed in {time.perf_counter() - t0:.1f}s")
    out["3w"]["long"].pop("layer0")
    for r in out.values():
        r.pop("layer0")
        r["cfg"] = r["cfg"].name
    return {**out, "rows": rows}


def lm_child_boot() -> None:
    """3w's and 3x's process before it is let go: the port imported, the
    card's context made and the profiler run once (a process's first
    trace costs seconds), beside phase 1's build."""
    import torch
    import repro_torch.launch.serve  # noqa: F401
    device_kernels(lambda: torch.zeros(1, device=DEVICE).zero_())


def start_lm_child():
    """Start ``lm_child``'s process: it boots (``lm_child_boot``) and waits
    for a line on its stdin; it exits at once if the line is not "go" (this
    process ended first: its end of the pipe closed)."""
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); "
            "import chip_smoke; chip_smoke.lm_child_boot(); "
            "go = sys.stdin.readline().strip() == 'go'; "
            "go and print(json.dumps(chip_smoke.lm_child()))")
    return subprocess.Popen(
        [sys.executable, "-c", code, ROOT], stdin=subprocess.PIPE,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))


def lm_phases(proc) -> dict:
    """Let ``start_lm_child``'s process run ``lm_child`` and relay its
    lines: the long prompt's ~72 GiB need a card that holds nothing else
    (the later phases leave ~5 GiB on it), and its own profiler keeps the
    windows' activities out of this process's later traces.  Fails as the
    child fails."""
    free_card()
    try:
        out, err = proc.communicate("go\n", timeout=900)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    lines = out.strip().splitlines()
    for line in lines[:-1]:
        log(line)
    if proc.returncode != 0:
        raise AssertionError(f"3w/3x: the child exited {proc.returncode}: "
                             f"{err[-3000:]}")
    return json.loads(lines[-1])


# ---------------------------------------------------------------------------
# phases 3r and 3s: the rest of the zoo at full width (InternVL2-26B,
# SeamlessM4T-large-v2) through the model-level path
# ---------------------------------------------------------------------------
ZOO_ROWS, ZOO_MAX_NEW = 8, 32
# InternVL2: 64-768 text tokens after 256 patches, right-padded to 768
# (S' 1,024), rings 1,280 wide; SeamlessM4T: decoder prompts of 16-64
# tokens, right-padded to 64, self rings 128 wide, over dec_enc_len frames
VLM_TEXT, VLM_CONTEXT = (64, 768), 1280
AUDIO_PROMPT, AUDIO_CONTEXT = (16, 64), 128


def zoo_inputs(cfg):
    """The phase's batch on the card and each row's last valid token:
    ``ZOO_ROWS`` rows of seeded random ids (lengths spread evenly over the
    phase's range, in seeded order, right-padded with id 0), and seeded
    N(0, 1) fp32 embeddings of the frontend: 256 patches a row for the
    VLM, ``dec_enc_len`` frames a row for the encoder-decoder."""
    import numpy as np
    import torch
    vlm = cfg.frontend == "vision_patches"
    lo, hi = VLM_TEXT if vlm else AUDIO_PROMPT
    rng = np.random.default_rng(SEED + 13)
    lens = np.linspace(lo, hi, ZOO_ROWS).astype(int)
    rng.shuffle(lens)
    toks = np.zeros((ZOO_ROWS, hi), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, cfg.vocab_size, n)
    g = torch.Generator(device=DEVICE)
    g.manual_seed(SEED + 13)
    shape = ((ZOO_ROWS, cfg.n_frontend_tokens, cfg.d_model) if vlm
             else (ZOO_ROWS, cfg.dec_enc_len, cfg.d_model))
    batch = {"tokens": torch.from_numpy(toks).to(DEVICE),
             "patches" if vlm else "frames": torch.randn(
                 shape, generator=g, device=DEVICE)}
    last = torch.from_numpy((lens - 1).astype(np.int32)).to(DEVICE)
    return batch, last


def zoo_generate(params, cfg, batch, last, max_new: int, width: int,
                 keep_cross: bool = False) -> dict:
    """The model-level path of ``tests/test_models_smoke.py``: ``forward``
    in prefill mode at ``last_index``, ``mask_padded_positions``, then a
    greedy ``decode_step`` loop at each row's own step (``text_offset`` +
    the text position) until every row has ``max_new`` new tokens, under
    ``no_grad``.  One host copy, of the tokens after the loop.  Returns
    the tokens, the seconds from the prefill's launch to that copy, the
    launches of the prefill and of each decode step (counts zeroed just
    before each), the cache, the final steps and, with ``keep_cross``,
    whether the cross rings came out of the loop bit for bit as the
    prefill made them."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import decode_step, forward, mask_padded_positions
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        pre = forward(params, cfg, batch, mode="prefill", cache_width=width,
                      last_index=last)
        pre_counts = ops.launch_counts()
        off = pre["text_offset"]
        cache = mask_padded_positions(pre["cache"], last + off)
        cross0 = ([t.clone() for t in cache["cross"]]
                  if keep_cross else None)
        tok = pre["logits"][:, 0].argmax(dim=-1)
        out, steps = [tok], []
        step = last + off + 1
        for _ in range(max_new - 1):
            ops.reset_launch_counts()
            d = decode_step(params, cfg, cache, {"tokens": tok[:, None]},
                            step)
            steps.append(ops.launch_counts())
            tok = d["logits"][:, 0].argmax(dim=-1)
            out.append(tok)
            step = step + 1
    toks = torch.stack(out, dim=1).cpu()
    sec = time.perf_counter() - t0
    cross_same = (None if cross0 is None else
                  all(torch.equal(a, b) for a, b in zip(cross0,
                                                        cache["cross"])))
    total = {k: pre_counts[k] + sum(s[k] for s in steps) for k in pre_counts}
    return {"tokens": toks, "seconds": sec, "prefill_launches": pre_counts,
            "step_launches": steps, "launches": total, "cache": cache,
            "step": step, "text_offset": off, "cross_unchanged": cross_same}


def check_zoo_run(run, cfg, max_new: int, what: str) -> None:
    """Every row got its ``max_new`` tokens, ids of the vocabulary; flash
    once a layer of each attention in the prefill (the encoder's, the
    decoder's self and cross attentions for an encoder-decoder), the paged
    kernel once a layer of each attention a decode step, ``tte_sample``
    and ``ssd_intra`` never; an encoder-decoder's cross rings unchanged."""
    L = cfg.n_layers
    enc_dec = cfg.n_encoder_layers > 0
    toks = run["tokens"]
    if not (tuple(toks.shape) == (ZOO_ROWS, max_new)
            and bool(((toks >= 0) & (toks < cfg.vocab_size)).all())):
        raise AssertionError(f"{what}: tokens {tuple(toks.shape)}")
    want_pre = {"tte_sample": 0, "ssd_intra": 0, "paged_decode_attention": 0,
                "flash_attention": (cfg.n_encoder_layers + 2 * L if enc_dec
                                    else L)}
    want_step = {"tte_sample": 0, "ssd_intra": 0, "flash_attention": 0,
                 "paged_decode_attention": 2 * L if enc_dec else L}
    if run["prefill_launches"] != want_pre:
        raise AssertionError(f"{what}: prefill launches "
                             f"{run['prefill_launches']}, want {want_pre}")
    for i, s in enumerate(run["step_launches"]):
        if s != want_step:
            raise AssertionError(f"{what}: decode step {i} launches {s}, "
                                 f"want {want_step}")
    if run["cross_unchanged"] is False:
        raise AssertionError(f"{what}: the decode loop changed a cross ring")


def zoo_row(batch, last, i: int) -> dict:
    """Row ``i`` of the batch alone, its padding cut off."""
    n = int(last[i]) + 1
    return {k: (v[i:i + 1, :n] if k == "tokens" else v[i:i + 1])
            for k, v in batch.items()}


def zoo_logits(p16, cfg, row: dict, width: int) -> dict:
    """One row's last prefill position's logits, and the logits of one
    ``decode_step`` after a prefill of the row's tokens but the last
    (``tests/test_models_smoke.py``'s decode parity), through the kernels
    in bf16 against the fp32 model made from the same draws
    (``init_params_on_device`` at ``dtype="float32"``: plain route, TF32
    off) at the whole row's prefill; each within
    ``DENSE_LOGITS_VS_PLAIN`` times the plain route's own bf16 error
    (phase 3l's rule)."""
    import torch
    from repro_torch.models import decode_step, forward, init_params_on_device

    def logits(c, p, decode: bool):
        with torch.no_grad():
            if not decode:
                return forward(p, c, row, mode="prefill", cache_width=width
                               )["logits"][0, 0]
            head = dict(row, tokens=row["tokens"][:, :-1])
            pre = forward(p, c, head, mode="prefill", cache_width=width)
            n = row["tokens"].shape[1]
            step = torch.full((1,), n - 1 + pre["text_offset"],
                              dtype=torch.int32, device=DEVICE)
            return decode_step(p, c, pre["cache"],
                               {"tokens": row["tokens"][:, -1:]}, step
                               )["logits"][0, 0]
    kern, kern_dec = logits(cfg, p16, False), logits(cfg, p16, True)
    with plain_route():
        plain, plain_dec = logits(cfg, p16, False), logits(cfg, p16, True)
        c32 = cfg.replace(dtype="float32")
        p32 = init_params_on_device(c32, seed=SEED, device=DEVICE)
        exact = logits(c32, p32, False)
        del p32
    free_card()

    def off(a):
        return float((a - exact).abs().max())
    res = {"prompt_tokens": int(row["tokens"].shape[1]),
           "layers": cfg.n_layers, "logits_err": off(kern),
           "plain_err": off(plain),
           "kernel_vs_plain": float((kern - plain).abs().max()),
           "decode_err": off(kern_dec), "plain_decode_err": off(plain_dec),
           "logits_scale": float(exact.abs().max())}
    for a, e, pe in ((kern, "logits_err", "plain_err"),
                     (kern_dec, "decode_err", "plain_decode_err")):
        if not (bool(torch.isfinite(a).all())
                and res[e] <= DENSE_LOGITS_VS_PLAIN * res[pe]):
            raise AssertionError(f"{cfg.name}: {e} {res[e]} against the "
                                 f"fp32 model, the plain route's "
                                 f"{res[pe]} (allowed "
                                 f"{DENSE_LOGITS_VS_PLAIN}x it)")
    return res


def zoo_path(arch: str, phase: str, fp32_layers=None) -> dict:
    """Phases 3r (InternVL2-26B) and 3s (SeamlessM4T-large-v2): the model
    at full width and depth in bf16, its weights made on the card
    (``init_params_on_device``), driven through ``zoo_generate`` on
    ``zoo_inputs``' 8 rows, 32 new tokens each (a warm drive, then the
    timed one), each drive held by ``check_zoo_run``; for the VLM, the
    patches move the longest row's last logits (``tests/test_models_
    smoke.py::test_vlm_frontend_prepended``'s check); the peak memory under
    the card's; a profiled window (the first ``PROFILE_REQUESTS`` rows,
    ``PROFILE_MAX_NEW`` tokens); ``zoo_logits`` on the longest row (with
    ``fp32_layers``, of a model cut to that depth at full width: 3r's)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_params_on_device
    cfg = get_config(arch)
    vlm = cfg.frontend == "vision_patches"
    width = VLM_CONTEXT if vlm else AUDIO_CONTEXT
    stage = {}
    free_card()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = init_params_on_device(cfg, seed=SEED, device=DEVICE)
    torch.cuda.synchronize()
    init_s = stage["init"] = time.perf_counter() - t0
    weight_bytes = sum(v.numel() * v.element_size() for v in params.values())
    batch, last = zoo_inputs(cfg)
    t0 = time.perf_counter()
    warm = zoo_generate(params, cfg, batch, last, ZOO_MAX_NEW, width)
    check_zoo_run(warm, cfg, ZOO_MAX_NEW, f"{phase} warm")
    del warm
    stage["warmup"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    run = zoo_generate(params, cfg, batch, last, ZOO_MAX_NEW, width,
                       keep_cross=not vlm)
    check_zoo_run(run, cfg, ZOO_MAX_NEW, phase)
    stage["drive"] = time.perf_counter() - t0
    cache = run.pop("cache")
    ring = cache["self" if vlm else "cross"]
    cross_w = cfg.dec_enc_len - 1
    layer0 = (ring.k[0].clone(), ring.v[0].clone(), ring.pos[0].clone(),
              run["step"].clone() if vlm else torch.full(
                  (ZOO_ROWS,), cross_w, dtype=torch.int32, device=DEVICE))
    del cache, ring
    longest = int(torch.argmax(last))
    row = zoo_row(batch, last, longest)
    patch_diff = None
    if vlm:
        from repro_torch.models import forward
        with torch.no_grad():
            a = forward(params, cfg, row, mode="prefill")["logits"]
            b = forward(params, cfg, dict(row, patches=row["patches"] + 1.0),
                        mode="prefill")["logits"]
        patch_diff = float((a - b).abs().max())
        if not patch_diff > 1e-3:
            raise AssertionError(f"{phase}: the patches do not move the text "
                                 f"logits ({patch_diff})")
    t0 = time.perf_counter()
    sub = {k: v[:PROFILE_REQUESTS] for k, v in batch.items()}
    prof = window_profile(lambda: zoo_generate(
        params, cfg, sub, last[:PROFILE_REQUESTS], PROFILE_MAX_NEW,
        width)["seconds"])
    stage["profile"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    card = torch.cuda.get_device_properties(0).total_memory
    if not peak < card:
        raise AssertionError(f"{phase}: peak memory {peak} past the card's "
                             f"{card}")
    t0 = time.perf_counter()
    if fp32_layers is not None:
        del params
        free_card()
        cfg = cfg.replace(n_layers=fp32_layers)
        params = init_params_on_device(cfg, seed=SEED, device=DEVICE)
    logits = zoo_logits(params, cfg, row, width)
    stage["logits"] = time.perf_counter() - t0
    del params, batch
    free_card()
    toks = run.pop("tokens")
    n = ZOO_ROWS * ZOO_MAX_NEW
    return {"run": {**{k: v for k, v in run.items()
                       if k not in ("step", "step_launches")},
                    "tokens": n, "tokens_per_s": n / run["seconds"],
                    "distinct_tokens": int(toks.unique().numel())},
            "prompt_lengths": [int(x) + 1 for x in last.tolist()],
            "profile": prof, "layer0": layer0, "init_s": init_s,
            "weight_bytes": weight_bytes, "peak_memory_bytes": peak,
            "card_memory_bytes": card, "patch_logits_diff": patch_diff,
            "logits": logits, "cfg": get_config(arch), "stage_s": stage}


def log_zoo(res: dict, phase: str, smi: str, t_start: float) -> None:
    cfg, r = res["cfg"], res["run"]
    p, lg = res["profile"], res["logits"]
    log(f"  {r['tokens']} tokens ({ZOO_ROWS} rows x {ZOO_MAX_NEW}; "
        f"{r['distinct_tokens']} distinct) in {r['seconds']:.3f}s: "
        f"{r['tokens_per_s']:.1f} tokens/s (prefill, then the greedy decode "
        f"loop; prompts {res['prompt_lengths']}); launches {r['launches']} "
        f"(prefill {r['prefill_launches']}; every decode step "
        f"{2 * cfg.n_layers if cfg.n_encoder_layers else cfg.n_layers} "
        f"paged, no flash, tte_sample or ssd_intra)")
    if r["cross_unchanged"] is not None:
        log(f"  the cross rings ({cfg.n_layers} layers x {cfg.dec_enc_len} "
            f"memory positions) bit for bit unchanged by the decode loop")
    if res["patch_logits_diff"] is not None:
        log(f"  the patches move the longest row's last logits by "
            f"{res['patch_logits_diff']:.4g} (patches + 1.0)")
    idle = ("not measured" if p["idle_share"] is None
            else format(p["idle_share"], ".3f"))
    log(f"  weights made on the card in {res['init_s']:.3f}s "
        f"({res['weight_bytes'] / 1e9:.2f} GB); peak memory "
        f"{res['peak_memory_bytes'] / 2**30:.2f} GiB of the card's "
        f"{res['card_memory_bytes'] / 2**30:.2f} GiB")
    log(f"  the first {PROFILE_REQUESTS} rows x {PROFILE_MAX_NEW} tokens under "
        f"the profiler: device busy {p['device_busy_s']:.4f}s of "
        f"{p['wall_s']:.3f}s wall, idle share {idle}, {p['launches']} device "
        f"activities; top by device time:")
    for t in p["top"]:
        log(f"    {t['ms']:9.3f} ms  {t['launches']:6d}x  {t['kernel']}")
    log(f"  the longest row ({lg['prompt_tokens']} tokens, {lg['layers']} "
        f"layers) against the fp32 model (plain route, TF32 off; largest "
        f"|logit| {lg['logits_scale']:.4g}): last prefill logits, kernels' "
        f"route in bf16 off by {lg['logits_err']:.4g}, the plain route by "
        f"{lg['plain_err']:.4g}; one decode step after a prefill of all but "
        f"the last token: kernels {lg['decode_err']:.4g}, plain "
        f"{lg['plain_decode_err']:.4g} (allowed {DENSE_LOGITS_VS_PLAIN}x "
        f"the plain route's); kernels vs plain {lg['kernel_vs_plain']:.4g}")
    log(f"  phase {phase} took {time.perf_counter() - t_start:.1f}s (" +
        ", ".join(f"{k} {v:.1f}s" for k, v in res["stage_s"].items())
        + f"; {smi})")


def zoo_rows(gen, r3r: dict, r3s: dict) -> dict:
    """Phase 5's rows at the new shapes: flash at 3r's prefill (B 8, GQA
    48/8, S 1,024, hd 128, causal) and paged on the ring the 3r run left
    (B 8, Hkv 8, G 6, hd 128, W 1,280); flash at 3s's encoder (B 8, MHA
    16/16, S = T = 4,096, hd 64, bidirectional) and cross-attention prefill
    (64 queries over the 4,096 memory keys), and paged on the cross ring
    the 3s run left (B 8, Hkv 16, G 1, hd 64, W 4,096, step W - 1)."""
    rc, sc = r3r["cfg"], r3s["cfg"]
    M, S = sc.dec_enc_len, AUDIO_PROMPT[1]
    return {
        "flash_attention 3r": flash_row(
            gen, ZOO_ROWS, rc.n_heads, rc.n_frontend_tokens + VLM_TEXT[1],
            rc.head_dim, Hkv=rc.n_kv_heads),
        "paged_decode_attention 3r": paged_row(
            gen, *r3r["layer0"], "phase 3r's ring", G=rc.q_per_kv),
        "flash_attention 3s encoder": flash_row(
            gen, ZOO_ROWS, sc.n_heads, M, sc.head_dim, causal=False),
        "flash_attention 3s cross": flash_row(
            gen, ZOO_ROWS, sc.n_heads, S, sc.head_dim, causal=False, tb=M),
        "paged_decode_attention 3s cross": paged_row(
            gen, *r3s["layer0"], "phase 3s's cross ring", G=sc.q_per_kv)}


def ssm_grads(arch: str) -> dict:
    """Phase 6f/6g, first part: the arch at full width cut to
    ``SSM_GRAD_LAYERS`` layers, one fp32 ``lm`` step (TF32 off) of
    ``SSM_GRAD_BATCH`` x ``SSM_GRAD_SEQ`` seeded random ids on the card
    against the CPU port's (``card_vs_cpu_grads``)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.train.trainer import to_device
    cfg = get_config(arch).replace(n_layers=SSM_GRAD_LAYERS, dtype="float32")
    params = init_params(cfg, seed=SEED, device=DEVICE)
    rng = np.random.default_rng(SEED + 61)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (
        SSM_GRAD_BATCH, SSM_GRAD_SEQ)).astype(np.int32)}
    out = card_vs_cpu_grads(cfg, params, to_device(batch, DEVICE), arch)
    del params
    free_card()
    return out


def ssd_route_check(arch: str) -> dict:
    """The plain (differentiable) SSD route against the kernel route at the
    arch's full width and an ``SSM_ROUTE_SEQ``-token sequence, one layer's
    call as the model makes it: x fp32, dt the softplus of N(0, 0.5) plus
    the init's ``dt_bias`` (dt ~ 0.01), A from the init's ``A_log``, B and
    C bf16 (N(0, 0.5)); ``y`` and the final state within
    ``SSM_ROUTE_TOL``."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import ssm as ssm_lib
    cfg = get_config(arch)
    H, P, N, S = cfg.ssm_n_heads, cfg.ssm_head_dim, cfg.ssm_state, \
        SSM_ROUTE_SEQ
    g = torch.Generator(device=DEVICE)
    g.manual_seed(SEED + 71)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=DEVICE)
    x = rnd(1, S, H, P)
    dt = F.softplus(0.5 * rnd(1, S, H)
                    + float(np.log(np.expm1(np.float32(0.01)))))
    A = -torch.exp(torch.log(torch.linspace(1.0, 16.0, H, device=DEVICE)))
    Bm, Cm = ((0.5 * rnd(1, S, N)).to(torch.bfloat16) for _ in range(2))
    ops.reset_launch_counts()
    with torch.no_grad():
        yk, hk = ssm_lib.ssd_chunked(x, dt, A, Bm, Cm, cfg.ssm_chunk)
        yp, hp = ssm_lib.ssd_chunked(x, dt, A, Bm, Cm, cfg.ssm_chunk,
                                     differentiable=True)
    torch.cuda.synchronize()
    launched = ops.launch_counts()["ssd_intra"]
    err_y = float((yk - yp).abs().max())
    err_h = float((hk - hp).abs().max())
    if not (launched == 1 and max(err_y, err_h) <= SSM_ROUTE_TOL
            and bool(torch.isfinite(yp).all())):
        raise AssertionError(f"{arch}: plain SSD route vs kernel route: y "
                             f"{err_y}, h {err_h} (tol {SSM_ROUTE_TOL}), "
                             f"ssd_intra launched {launched}")
    return {"shape": f"b=1 S={S} H={H} P={P} N={N} Q={cfg.ssm_chunk}",
            "err_y": err_y, "err_h": err_h,
            "y_scale": float(yp.abs().max()), "h_scale": float(hp.abs().max())}


def ssm_train_cli(arch: str) -> dict:
    """Phase 6f/6g, last part: ``python -m repro_torch.launch.train --arch
    ARCH`` (its ``main``) at full depth for ``SSM_TRAIN_STEPS`` bf16 steps
    of ``SSM_TRAIN_BATCH`` x ``SSM_TRAIN_SEQ`` seeded random ids over fp32
    masters: no kernel launched, the loss finite; steps/s, target tokens/s,
    the training's peak memory, and one step of the same step function
    once more without and with the profiler for the device's idle share
    (a step makes ~15,000 device activities)."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    from repro_torch.train import (OptimizerConfig, init_opt_state,
                                   make_train_step)
    from repro_torch.train.trainer import to_device
    free_card()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ops.reset_launch_counts()
    t_cli = time.perf_counter()
    res = launch_train.main([
        "--arch", arch, "--steps", str(SSM_TRAIN_STEPS), "--batch",
        str(SSM_TRAIN_BATCH), "--seq-len", str(SSM_TRAIN_SEQ), "--seed",
        str(SEED), "--device", DEVICE])
    peak = torch.cuda.max_memory_allocated() - base
    counts = ops.launch_counts()
    if any(counts.values()):
        raise AssertionError(f"{arch}: training launched a kernel: {counts}")
    cfg = res["cfg"]
    loss = np.asarray(res["history"]["loss"])
    if cfg.dtype != "bfloat16" or not np.isfinite(loss).all():
        raise AssertionError(f"{arch}: dtype {cfg.dtype}, loss {loss}")
    cli_s = time.perf_counter() - t_cli
    step = make_train_step(cfg, OptimizerConfig(lr=1e-5), "lm")
    rng = np.random.default_rng(SEED + 81)
    batch = to_device({"tokens": rng.integers(0, cfg.vocab_size, (
        SSM_TRAIN_BATCH, SSM_TRAIN_SEQ)).astype(np.int32)}, DEVICE)
    opt = init_opt_state(res["params"])

    def one():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(res["params"], opt, batch)
        torch.cuda.synchronize()
        return time.perf_counter() - t0
    prof = window_profile(one)
    sec = res["seconds"]
    out = {"steps": SSM_TRAIN_STEPS, "batch": SSM_TRAIN_BATCH,
           "seq": SSM_TRAIN_SEQ, "seconds": sec,
           "steps_per_s": SSM_TRAIN_STEPS / sec,
           "target_tokens": res["target_tokens"],
           "target_tokens_per_s": res["target_tokens"] / sec,
           "peak_memory_bytes": peak, "loss_first": float(loss[0]),
           "loss_last": float(loss[-1]), "launches": counts,
           "profile": prof,
           "cli_wall_s": cli_s}
    del res, batch, opt
    free_card()
    return out


def ssm_train_path(arch: str) -> dict:
    """Phase 6f (``mamba2-780m``) or 6g (``zamba2-1.2b``): the step against
    the CPU, the plain SSD route against the kernel route, the CLI."""
    out, stage = {}, {}
    for name, fn in (("grads", ssm_grads), ("route", ssd_route_check),
                     ("cli", ssm_train_cli)):
        t0 = time.perf_counter()
        out[name] = fn(arch)
        stage[name] = time.perf_counter() - t0
    out["stage_s"] = stage
    return out


def sdpa_gqa(q, k, v, **kw):
    """One ``scaled_dot_product_attention`` call with G = Hq / Hkv query
    heads a key head (``enable_gqa`` where G > 1)."""
    import torch.nn.functional as F
    if q.shape[1] != k.shape[1]:
        kw["enable_gqa"] = True
    return F.scaled_dot_product_attention(q, k, v, **kw)


# ---------------------------------------------------------------------------
# phase 7: the eight examples and the paged-parity and router round trips
# ---------------------------------------------------------------------------
# examples run this many at a time (each in its own interpreter; their
# models are small, and each process spends ~8 s reaching the card)
EXAMPLE_JOBS = 4
ROUND_TRIPS = ("torch_paged_parity.py", "torch_router_roundtrip.py")
EXAMPLES_TIMEOUT_S = 420


def start_examples():
    """Start phase 7's scripts, each in a process of its own (and its own
    process group, so that the example runner's children stop with it),
    with ``src`` on the path and their output in files: the example runner
    (``EXAMPLE_JOBS`` at a time, ``--device cuda``, its table in
    ``chiprun_out/examples_smoke.json``) and the two round trips.  ->
    (table path, [(argv, process, stdout file, stderr file)], start time)."""
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    table = os.path.join(out_dir, "examples_smoke.json")
    argvs = [["scripts/torch_examples_smoke.py", "--device", "cuda",
              "--jobs", str(EXAMPLE_JOBS), "--json", table]]
    argvs += [["scripts/" + n] for n in ROUND_TRIPS]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    # beside phase 4's checks on the CPU: two threads a process
    env.setdefault("OMP_NUM_THREADS", "2")
    procs = []
    for argv in argvs:
        so, se = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
        procs.append((argv, subprocess.Popen(
            [sys.executable] + argv, cwd=ROOT, env=env, stdout=so, stderr=se,
            text=True, start_new_session=True), so, se))
    return table, procs, time.perf_counter()


def stop_examples(started) -> None:
    """Kill what :func:`start_examples` started that still runs."""
    import signal
    for _, proc, _, _ in started[1]:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait(timeout=60)


def examples_path(started=None) -> dict:
    """Phase 7: ``scripts/torch_examples_smoke.py --device cuda`` (the eight
    ``examples/torch_*.py``, ``EXAMPLE_JOBS`` at a time, each in its own
    interpreter with its fast arguments; the runner fails an example whose
    path launched none of one of its kernels) and, beside it,
    ``scripts/torch_paged_parity.py`` and ``scripts/torch_router_roundtrip.py``
    on the card: the scripts :func:`start_examples` started (``started``,
    else started here), waited for within ``EXAMPLES_TIMEOUT_S``.  Any
    non-zero exit fails the phase.  -> per-example seconds and launch
    counts, each script's seconds from the start to its exit, each round
    trip's last line."""
    table, procs, t0 = started or start_examples()
    ends = {}
    try:
        while len(ends) < len(procs):
            if time.perf_counter() - t0 > EXAMPLES_TIMEOUT_S:
                raise AssertionError(f"7: still running after "
                                     f"{EXAMPLES_TIMEOUT_S} s")
            for i, (_, proc, _, _) in enumerate(procs):
                if i not in ends and proc.poll() is not None:
                    ends[i] = time.perf_counter() - t0
            time.sleep(0.2)
    finally:
        stop_examples((table, procs, t0))
    outs = []
    for argv, proc, so, se in procs:
        so.seek(0)
        se.seek(0)
        out, err = so.read(), se.read()
        so.close()
        se.close()
        if proc.returncode != 0:
            raise AssertionError(
                f"7: {os.path.basename(argv[0])} exit code "
                f"{proc.returncode}:\n{out[-3000:]}{err[-3000:]}")
        outs.append(out)
    with open(table) as f:
        examples = json.load(f)
    trips = {n: {"seconds": ends[i + 1],
                 "last_line": outs[i + 1].strip().splitlines()[-1]}
             for i, n in enumerate(ROUND_TRIPS)}
    launches = {k: sum(e["launch_counts"][k] for e in examples)
                for k in REPLACES}
    return {"examples": examples, "examples_s": ends[0],
            "round_trips": trips, "launches": launches}


def log_examples(res: dict, smi: str) -> None:
    log(f"  the eight examples on the card ({EXAMPLE_JOBS} at a time, the "
        f"round trips beside them) in {res['examples_s']:.1f}s from their "
        f"start [{smi}]:")
    for e in res["examples"]:
        log(f"    {e['name']:30s} {e['seconds']:6.1f}s launches "
            f"{json.dumps(e['launch_counts'])}")
    for name, t in res["round_trips"].items():
        log(f"  {name} {t['seconds']:.1f}s: {t['last_line']}")


# ---------------------------------------------------------------------------
# phase 5: times
# ---------------------------------------------------------------------------
# ---------------------------------------------------------------------------
# phase 3j: the SDK artifact on the card
# ---------------------------------------------------------------------------
ARTIFACT_DECODE_STEPS, ARTIFACT_MAX_NEW = 8, 32
# the artifacts' depths (Delphi-2M has 12 layers): cut to keep the whole
# call in its time (the bf16 export's tracing is phase 1's longest task)
ARTIFACT_BF16_LAYERS, ARTIFACT_FP32_LAYERS = 4, 2


def artifact_export(params, cfg, d: str, spec: str, seq_len=None) -> dict:
    """``export_model`` (traced on the CPU; graphs of ``seq_len`` tokens,
    by default the config's ``max_seq_len``), then ``verify_checksums``
    strict: seconds and bytes of the artifact."""
    from repro_torch.sdk import export_model, verify_checksums
    t0 = time.perf_counter()
    export_model(params, cfg, d, spec_version=spec, seq_len=seq_len)
    sec = time.perf_counter() - t0
    verify_checksums(d, strict=True)
    return {"export_s": sec, "bytes": sum(
        os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))}


def artifact_uniforms(cfg, i: int):
    """Seeded uniforms that never sample Death: a request runs its budget."""
    import numpy as np
    u = np.random.default_rng(SEED + 100 + i).uniform(
        size=(ARTIFACT_MAX_NEW, cfg.vocab_size)).astype(np.float32)
    u[:, cfg.death_token] = 1e-12
    return u


def artifact_gates(params, cfg, art, full, local, patients) -> dict:
    """On the card, for one dtype: the full graph == eager
    ``forward(mode="train")`` bit for bit (v1's == v2's), prefill and
    ``ARTIFACT_DECODE_STEPS`` decode steps == the same functions run
    eagerly (``build_inference_fns``, what ``LocalBackend.stream`` calls),
    logits and cache bit for bit, flash launched once a layer per full or
    prefill call and the paged kernel once a layer per decode step (counts
    zeroed just before each call and read just after); then
    ``ArtifactBackend`` == ``LocalBackend.stream`` token for token and age
    for age under injected uniforms, one request at a time."""
    import numpy as np
    import torch
    from repro_torch.api import GenerateRequest
    from repro_torch.kernels import ops
    from repro_torch.sdk import build_inference_fns
    rt, S = art.runtime, art.seq_len
    L = cfg.n_layers
    fns = build_inference_fns(cfg, S)

    def dev(*arrays):
        return [torch.from_numpy(np.asarray(x)).to(DEVICE) for x in arrays]

    def counted(fn, want_flash, want_paged, what):
        ops.reset_launch_counts()
        out = fn()
        c = ops.launch_counts()
        if (c["flash_attention"], c["paged_decode_attention"],
                c["tte_sample"]) != (want_flash, want_paged, 0):
            raise AssertionError(f"artifact {what}: launches {c}, want "
                                 f"flash {want_flash}, paged {want_paged}")
        return out
    rng = np.random.default_rng(SEED + 31)
    steps = 0
    for toks, ags in patients:
        t, a = art._pad_inputs(toks, ags)
        got = counted(lambda: rt.run(t, a), L, 0, "full graph")
        with torch.no_grad():
            want = fns["full"](params, *dev(t, a)).cpu().numpy()
        if not np.array_equal(got, want):
            raise AssertionError(
                f"artifact full graph != eager forward: max diff "
                f"{float(np.abs(got - want).max())}")
        if full is not None and not np.array_equal(full.runtime.run(t, a),
                                                   got):
            raise AssertionError("v1 full graph != v2 full graph")
        last = np.asarray([len(toks) - 1], np.int32)
        lg, cache = counted(lambda: rt.prefill(t, a, last), L, 0, "prefill")
        with torch.no_grad():
            lg_e, cache_e = fns["prefill"](params, *dev(t, a, last))
        if not np.array_equal(lg, lg_e.cpu().numpy()):
            raise AssertionError("artifact prefill != eager prefill")
        age = float(ags[-1])
        for k in range(ARTIFACT_DECODE_STEPS):
            age += float(rng.uniform(0.1, 2.0))
            args = (np.asarray([[rng.integers(3, cfg.vocab_size)]], np.int32),
                    np.asarray([[age]], np.float32),
                    np.asarray([len(toks) + k], np.int32))
            lg, cache = counted(lambda: rt.decode_step(cache, *args), 0, L,
                                "decode step")
            with torch.no_grad():
                lg_e, cache_e = fns["decode"](params, cache_e, *dev(*args))
            if not np.array_equal(lg, lg_e.cpu().numpy()):
                raise AssertionError(f"artifact decode step {k} != eager")
            steps += 1
        if not all(torch.equal(x, y) for x, y in zip(cache, cache_e)):
            raise AssertionError("artifact cache != eager cache")
    events = 0
    for i, (toks, ags) in enumerate(patients):
        req = GenerateRequest(tokens=[int(x) for x in toks],
                              ages=[float(x) for x in ags],
                              max_new=ARTIFACT_MAX_NEW, max_age=1e9,
                              uniforms=artifact_uniforms(cfg, i))
        got = art.generate(req)
        want = list(local.stream(req))
        if (got.tokens, got.ages) != ([e.token for e in want],
                                      [e.age for e in want]):
            raise AssertionError(f"ArtifactBackend != LocalBackend.stream "
                                 f"on patient {i}")
        events += len(got.tokens)
    return {"prompts": len(patients), "decode_steps": steps,
            "generate_events": events, "layers": L}


def artifact_drive(backend, cfg, patients, stream: bool = False) -> dict:
    """Every patient through ``backend`` one request at a time
    (``ARTIFACT_MAX_NEW`` events, injected uniforms): wall per event."""
    import torch
    from repro_torch.api import GenerateRequest
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    events = 0
    for i, (toks, ags) in enumerate(patients):
        req = GenerateRequest(tokens=[int(x) for x in toks],
                              ages=[float(x) for x in ags],
                              max_new=ARTIFACT_MAX_NEW, max_age=1e9,
                              uniforms=artifact_uniforms(cfg, i))
        events += (len(list(backend.stream(req))) if stream
                   else len(backend.generate(req).tokens))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"events": events, "wall_s": wall,
            "ms_per_event": 1e3 * wall / max(events, 1)}


def artifact_step_ms(art, params, cfg, patient) -> dict:
    """Host wall per call, each call ending in its logits' copy to the
    host (what a client waits for a token): a v2 decode step and an eager
    decode step (the function ``LocalBackend.stream`` calls),
    ``ARTIFACT_MAX_NEW - 1`` calls each after one prefill, in turns (v2,
    eager, eager, v2).  Then the decode graph's ``forward``
    against the eager decode function on inputs already on the card, with
    no copy to the host and one synchronise at the end (the graph's own
    execution, without the runtime's input copies and checks), in turns;
    and the graphs' node counts."""
    import numpy as np
    import torch
    from repro_torch.sdk import build_inference_fns
    fns = build_inference_fns(cfg, art.seq_len)
    toks, ags = patient
    t, a = art._pad_inputs(toks, ags)
    last = np.asarray([len(toks) - 1], np.int32)
    n = ARTIFACT_MAX_NEW - 1
    steps = [(np.asarray([[3 + k]], np.int32),
              np.asarray([[float(ags[-1]) + 0.5 * (k + 1)]], np.float32),
              np.asarray([len(toks) + k], np.int32)) for k in range(n)]

    prefill_ms = []

    def v2():
        t0 = time.perf_counter()
        _, cache = art.runtime.prefill(t, a, last)
        t1 = time.perf_counter()
        prefill_ms.append(1e3 * (t1 - t0))
        for args in steps:
            _, cache = art.runtime.decode_step(cache, *args)
        return time.perf_counter() - t1

    def eager():
        dev = [torch.from_numpy(x).to(DEVICE) for x in (t, a, last)]
        with torch.no_grad():
            _, cache = fns["prefill"](params, *dev)
            t0 = time.perf_counter()
            for args in steps:
                lg, cache = fns["decode"](
                    params, cache,
                    *[torch.from_numpy(x).to(DEVICE) for x in args])
                lg.cpu().numpy()
        return time.perf_counter() - t0
    dev_steps = [[torch.from_numpy(x).to(DEVICE) for x in args]
                 for args in steps]
    graph = art.runtime._calls["decode_step"]

    def graph_forward():
        _, cache = art.runtime.prefill(t, a, last)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            for args in dev_steps:
                _, cache = graph.forward(art.runtime._params, cache, *args)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def eager_fn():
        dev = [torch.from_numpy(x).to(DEVICE) for x in (t, a, last)]
        with torch.no_grad():
            _, cache = fns["prefill"](params, *dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for args in dev_steps:
                _, cache = fns["decode"](params, cache, *args)
        torch.cuda.synchronize()
        return time.perf_counter() - t0
    runs = {"v2": v2, "eager": eager, "graph.forward": graph_forward,
            "eager fn": eager_fn}
    turns = []
    for mode in ("v2", "eager", "eager", "v2", "graph.forward", "eager fn",
                 "eager fn", "graph.forward"):
        torch.cuda.synchronize()
        turns.append((mode, 1e3 * runs[mode]() / n))
    nodes = {name: len(list(g.graph.nodes))
             for name, g in art.runtime._calls.items()}
    return {"turns": turns, "v2_prefill_ms": prefill_ms,
            "graph_nodes": nodes}


def artifact_op_us() -> dict:
    """Host microseconds a call of each attention kernel at a batch-1
    request's shapes (bf16; flash at S 256, the paged kernel over a ring
    of 256), called through its wrapper (the eager path) and through its
    ``repro_torch::`` operator (the artifact's graphs): 500 calls ending in
    a synchronise, in turns (wrapper, operator, operator, wrapper)."""
    import torch
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import paged_attention as pk
    bf = dict(device=DEVICE, dtype=torch.bfloat16)
    qf = torch.randn(1, 12, 256, 10, **bf)
    q = torch.randn(1, 12, 1, 10, **bf)
    kp = torch.randn(1, 12, 256, 10, **bf)
    table = torch.zeros(1, 1, dtype=torch.int32, device=DEVICE)
    pos = torch.arange(256, dtype=torch.int32, device=DEVICE)[None]
    step = torch.tensor([255], dtype=torch.int32, device=DEVICE)
    calls = {
        "flash_attention": (
            lambda: fk.flash_attention_cuda(qf, qf, qf, causal=True),
            lambda: torch.ops.repro_torch.flash_attention(qf, qf, qf, True,
                                                          None)),
        "paged_decode_attention": (
            lambda: pk.paged_decode_attention_cuda(q, kp, kp, table, pos,
                                                   step),
            lambda: torch.ops.repro_torch.paged_decode_attention(
                q, kp, kp, table, pos, step, None))}
    out = {}
    for name, (wrapper, op) in calls.items():
        turns = []
        for mode in ("wrapper", "operator", "operator", "wrapper"):
            fn = wrapper if mode == "wrapper" else op
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(500):
                fn()
            torch.cuda.synchronize()
            turns.append((mode, 1e6 * (time.perf_counter() - t0) / 500))
        out[name] = turns
    return out


def artifact_config(dtype: str):
    """Phase 3j's config in ``dtype``: full-width Delphi-2M, its depth cut
    to ``ARTIFACT_BF16_LAYERS`` or ``ARTIFACT_FP32_LAYERS``."""
    from repro_torch.configs import get_config
    cfg = get_config("delphi-2m").replace(dtype=dtype)
    return cfg.replace(n_layers=ARTIFACT_BF16_LAYERS if dtype == "bfloat16"
                       else ARTIFACT_FP32_LAYERS)


def artifact_exports(tmp: str) -> dict:
    """Phase 3j's exports, traced on the CPU (no kernel is needed, so
    ``main`` runs this while ``nvcc`` builds the kernels): spec v2 in
    bf16 at ``ARTIFACT_BF16_LAYERS`` layers, and spec v2 and v1 in fp32 at
    ``ARTIFACT_FP32_LAYERS`` layers (the pair that holds v1 == v2 on the
    card).  Returns {dtype: {"v2": dir, "v1": dir or None, "export_v2":
    ..., "export_v1": ...}}."""
    from repro_torch.models import init_params
    out = {}
    for dtype in ("bfloat16", "float32"):
        cfg = artifact_config(dtype)
        params = init_params(cfg, seed=SEED, device="cpu")
        d2 = os.path.join(tmp, f"artifact_{dtype}_v2")
        d1 = os.path.join(tmp, f"artifact_{dtype}_v1")
        res = {"v2": d2, "export_v2": artifact_export(params, cfg, d2, "2"),
               "v1": None, "export_v1": None}
        if dtype == "float32":
            res["v1"] = d1
            res["export_v1"] = artifact_export(params, cfg, d1, "1")
        out[dtype] = res
    return out


def artifact_path(exports: dict) -> dict:
    """Phase 3j: full-width Delphi-2M's artifacts (``artifact_exports``)
    loaded with ``Runtime(device="cuda")`` and gated against the eager
    model and ``LocalBackend`` (v1 == v2 in fp32); the kernels' launches on
    one drive of the bf16 v2 artifact (counts zeroed just before, read
    just after); the per-event time of v2 decode and
    ``LocalBackend.stream`` in turns; the server CLI on ``--artifact``
    (the fp32 v2 artifact: the CLI's route does not depend on the depth),
    booted in a subprocess while the fp32 artifact is loaded and gated,
    after every timed drive."""
    import torch
    from repro_torch.api import ArtifactBackend, LocalBackend
    from repro_torch.kernels import ops
    from repro_torch.models import init_params
    patients = futures_patients()
    out = {"dtypes": {}}
    stage = out["stage_s"] = {}
    t_stage = [time.perf_counter()]

    def staged(name):
        now = time.perf_counter()
        stage[name] = now - t_stage[0]
        t_stage[0] = now
    cli = None
    try:
        for dtype in ("bfloat16", "float32"):
            cfg = artifact_config(dtype)
            ex = exports[dtype]
            if dtype == "float32":
                cli = CliServer(("--artifact", ex["v2"]))
            params = init_params(cfg, seed=SEED, device=DEVICE)
            t0 = time.perf_counter()
            art = ArtifactBackend(ex["v2"], device=DEVICE)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            full = (ArtifactBackend(ex["v1"], device=DEVICE) if ex["v1"]
                    else None)
            if not (art.use_decode_graph
                    and (full is None or not full.use_decode_graph)):
                raise AssertionError("v2 must decode, v1 must fall back")
            local = LocalBackend(params, cfg, device=DEVICE)
            gates = artifact_gates(params, cfg, art, full, local, patients)
            staged(f"{dtype} load and gates")
            res = {"export_v2": ex["export_v2"], "export_v1": ex["export_v1"],
                   "load_v2_s": load_s, "gates": gates}
            if dtype == "float32":
                res["cli"] = cli.check("artifact")
                staged("fp32 CLI")
            else:
                # the kernels' launches on one drive, its idle share, the
                # operators' host cost and the times (one dtype)
                ops.reset_launch_counts()
                drive = artifact_drive(art, cfg, patients)
                res["launches"] = ops.launch_counts()
                n, L = len(patients), cfg.n_layers
                want = {"flash_attention": L * n, "tte_sample": 0,
                        "paged_decode_attention": L * (drive["events"] - n)}
                if any(res["launches"][k] != v for k, v in want.items()):
                    raise AssertionError(f"artifact drive: launches "
                                         f"{res['launches']}, want {want}")
                one = patients[:1]
                res["profile"] = path_profile(
                    lambda: artifact_drive(art, cfg, one)["wall_s"],
                    artifact_drive(art, cfg, one)["wall_s"])
                staged("bf16 drive and profile")
                res["op_us"] = artifact_op_us()
                two = patients[:2]
                turns = []
                for mode in ("v2", "local", "local", "v2"):
                    r = (artifact_drive(local, cfg, two, stream=True)
                         if mode == "local"
                         else artifact_drive(art, cfg, two))
                    turns.append((mode, r["ms_per_event"]))
                res["ms_per_event_turns"] = turns
                staged("bf16 ms an event")
                res["ms_per_call"] = artifact_step_ms(art, params, cfg,
                                                      patients[0])
                staged("bf16 ms a call")
            out["dtypes"][dtype] = res
    finally:
        if cli is not None:
            cli.close()
    return out


def log_artifact(art: dict) -> None:
    """Phase 3j's lines."""
    for dtype, r in art["dtypes"].items():
        g = r["gates"]
        v1 = r["export_v1"]
        log(f"  {dtype}: export v2 {r['export_v2']['export_s']:.2f}s "
            f"({r['export_v2']['bytes']} bytes), "
            + (f"v1 {v1['export_s']:.2f}s ({v1['bytes']} bytes)" if v1
               else "no v1")
            + f" (traced on the CPU during the kernels' build); load v2 "
            f"{r['load_v2_s']:.2f}s; full graph == eager "
            f"{'and v1 == v2 ' if v1 else ''}on {g['prompts']} prompts, "
            f"prefill + {g['decode_steps']} decode steps == eager bit for "
            f"bit, {g['layers']} flash launches a full or prefill call and "
            f"{g['layers']} paged a decode step ({g['layers']} layers); "
            f"ArtifactBackend == LocalBackend.stream on "
            f"{g['generate_events']} events")
    bart = art["dtypes"]["bfloat16"]
    cli = art["dtypes"]["float32"]["cli"]
    log("  bf16, ms per event of a request (v2 ArtifactBackend, "
        "LocalBackend.stream; 2 requests), in turns: " + ", ".join(
            f"{m} {v:.4f}" for m, v in bart["ms_per_event_turns"]))
    mc = bart["ms_per_call"]
    log("  bf16, ms per call (v2 decode step, eager decode step, each to "
        "the host's logits; then the decode graph's forward and the eager "
        "decode function on the card's inputs), in turns: "
        + ", ".join(f"{m} {v:.4f}" for m, v in mc["turns"])
        + "; v2 prefill " + ", ".join(f"{v:.4f}" for v in mc["v2_prefill_ms"])
        + f"; graph nodes {mc['graph_nodes']}")
    log(f"  launches on the bf16 v2 drive ({FUTURES_PATIENTS} requests x "
        f"{ARTIFACT_MAX_NEW} events): {bart['launches']}; the CLI on "
        f"--artifact (fp32 v2) booted in {cli['boot_s']:.1f}s, answered "
        f"/v1/manifest and a generate, exit {cli['exit_code']} on SIGINT")
    log("  stage seconds: " + ", ".join(
        f"{k} {v:.1f}" for k, v in art["stage_s"].items()))
    ap = bart["profile"]
    log(f"  one bf16 v2 request under the profiler: device busy "
        f"{ap['device_busy_s']:.4f}s of {ap['wall_s']:.3f}s wall, idle "
        f"share {'not measured' if ap['idle_share'] is None else format(ap['idle_share'], '.3f')}"
        f", {ap['launches']} device activities")
    for name, turns in bart["op_us"].items():
        log(f"  {name}: host us a call, wrapper against repro_torch:: "
            f"operator, in turns: " + ", ".join(
                f"{m} {v:.1f}" for m, v in turns))


def cuda_ms(fn, iters: int = 200, warmup: int = 10) -> float:
    """Per-call time by CUDA events around a warmed run of ``iters`` calls:
    what a caller pays, host overhead included when launches are
    host-bound."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def device_kernels(fn) -> dict:
    """Run ``fn`` under ``torch.profiler`` and return {device activity
    (kernel, copy, set) name: (count, device ms)}; empty if the profiler
    saw no device activity.  Only the device's activity is traced: the
    host's op events are not read here, and folding them into the trace
    took several times as long as the device's alone."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            out[e.key] = (e.count, us / 1e3)
    return out


def device_ms(fn, iters: int = 50, warmup: int = 10):
    """Device time per call of ``fn`` (all its kernels, summed), from the
    profiler; None where the profiler sees no device activity, or where it
    lost some: each call launches the same kernels, so every activity's
    count is a multiple of ``iters`` unless records went missing.  Once a
    process has traced tens of thousands of activities, later traces lose
    records (the sum would then under-read the time)."""
    for _ in range(warmup):
        fn()

    def run():
        for _ in range(iters):
            fn()
    acts = device_kernels(run)
    if not acts or any(n % iters for n, _ in acts.values()):
        return None
    return sum(ms for _, ms in acts.values()) / iters


# milliseconds of calls that each of measure's two timings may take
MEASURE_BUDGET_MS = 250.0


def measure(fn) -> dict:
    """``device_ms`` and ``cuda_ms`` of ``fn``, their iteration and warm-up
    counts cut (to no fewer than 3) where one call is slow enough that the
    defaults would overrun ``MEASURE_BUDGET_MS``."""
    once = cuda_ms(fn, 1, 1)

    def n(default):
        return max(3, min(default, int(MEASURE_BUDGET_MS / max(once, 1e-3))))
    return {"device_ms": device_ms(fn, n(50), n(10)),
            "call_ms": cuda_ms(fn, n(200), n(10))}


def cold_device_ms(fn, kernel: str, iters: int = 20, warmup: int = 3,
                   flush_mb: int = 128, flush: str = "write"):
    """Device time per launch of the kernels whose name holds ``kernel``,
    each call of ``fn`` made after a pass over ``flush_mb`` MB (more than
    twice the 50 MB L2), so that its inputs come from device memory.  Only
    that kernel's activity is counted, not the flush; None where the
    profiler sees none.  ``flush="write"`` fills the buffer, which leaves
    the L2 full of dirty lines: the kernel's reads then also pay for their
    write-back.  ``flush="read"`` sums it, which leaves clean lines."""
    import torch
    buf = torch.ones(flush_mb << 18, dtype=torch.float32, device=DEVICE)
    sweep = (lambda: buf.fill_(1.0)) if flush == "write" else buf.sum

    def run(n):
        for _ in range(n):
            sweep()
            fn()
    run(warmup)
    acts = [v for name, v in device_kernels(lambda: run(iters)).items()
            if kernel in name]
    n = sum(c for c, _ in acts)
    return sum(ms for _, ms in acts) / n if n else None


def bound(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def tte_row(gen, B: int, V: int, cold: bool = False) -> dict:
    """``tte_sample`` on (B, V) fp32 logits and uniforms against its plain
    version; the bound counts each input read once and (event, t_min)
    written once, and exp, log and a multiply an element on the CUDA
    cores.  With ``cold`` the kernel's device time is taken after an L2
    flush that writes 128 MB (``cold_device_ms``), and beside it after one
    that reads 128 MB, and warm."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import tte_sample as tk
    lg = torch.randn((B, V), generator=gen, device=DEVICE) * 3 - 8
    u = torch.rand((B, V), generator=gen, device=DEVICE)
    b_ms, b_by = bound(2 * B * V * 4 + B * 8, 3 * B * V, "float32_simt")

    def fn():
        return tk.tte_sample_cuda(lg, u)
    row = {"shape": f"B={B} V={V} fp32" + (", L2 cold" if cold else ""),
           "plan": tk.plan(B, V), "kernel": measure(fn),
           "plain": measure(lambda: ref.tte_sample_ref(lg, u)),
           "library": None, "bound_ms": b_ms, "bound_by": b_by}
    if cold:
        row["kernel warm"] = row["kernel"]
        row["kernel"] = {"device_ms": cold_device_ms(fn, "tte_sample"),
                         "call_ms": None}
        row["kernel cold, read flush"] = {
            "device_ms": cold_device_ms(fn, "tte_sample", flush="read"),
            "call_ms": None}
    return row


def flash_ref_blocks(q, k, v, block: int):
    """``ref.flash_attention_ref`` causal (no window), ``block`` queries at
    a time over the keys up to the block's last, by position: the same
    function, with a block's rows of scores live at once (the whole score
    matrix of 40 heads at 16,384 tokens would take 43 GB in fp32)."""
    import torch
    from repro_torch.kernels import ref
    B, S = q.shape[0], q.shape[2]
    pos = torch.arange(S, dtype=torch.int32, device=q.device).expand(B, S)
    return torch.cat([ref.flash_attention_ref(
        q[:, :, s0:s0 + block], k[:, :, :s0 + block], v[:, :, :s0 + block],
        q_pos=pos[:, s0:s0 + block], k_pos=pos[:, :s0 + block])
        for s0 in range(0, S, block)], 2)


def flash_row(gen, nb: int, H: int, sb: int, hd: int, Hkv=None,
              window=None, causal: bool = True, tb=None,
              q_block=None) -> dict:
    """``flash_attention`` at one prefill bucket: (nb, H, sb, hd) bf16
    queries over (nb, Hkv, tb, hd) keys (``Hkv`` defaults to H, ``tb`` to
    sb), causal within ``window`` where given, or with ``causal=False``
    every key for every query; against its plain version and SDPA (GQA by
    ``enable_gqa``; a window as a boolean band mask made once, outside the
    timed call).  With ``q_block`` (causal, no window) the plain version
    runs ``q_block`` queries at a time (``flash_ref_blocks``) and SDPA
    takes the key/value heads repeated to the query heads once, outside
    the timed call (its fused routes at any length).  The bound counts q,
    k, v and the output once and the products of the (query, key) pairs
    the mask keeps."""
    import torch
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import ref
    Hkv = Hkv or H
    tb = tb or sb
    q = torch.randn((nb, H, sb, hd), generator=gen, device=DEVICE
                    ).to(torch.bfloat16)
    k, v = (torch.randn((nb, Hkv, tb, hd), generator=gen, device=DEVICE
                        ).to(torch.bfloat16) for _ in range(2))
    i = torch.arange(sb, device=DEVICE)
    band = i[:, None] >= i[None, :]
    if window is not None:
        band &= (i[:, None] - i[None, :]) < window
    pairs = nb * (int(band.sum()) if causal else sb * tb)
    b_ms, b_by = bound(2 * nb * hd * (2 * H * sb + 2 * Hkv * tb),
                       4 * pairs * H * hd, "bfloat16")
    if q_block is None:
        def plain(a, b, c):
            return ref.flash_attention_ref(a, b, c, causal=causal,
                                           window=window)
    else:
        del band

        def plain(a, b, c):
            return flash_ref_blocks(a, b, c, q_block)
        kx, vx = (t.repeat_interleave(H // Hkv, 1) for t in (k, v))
    out = fk.flash_attention_cuda(q, k, v, causal=causal, window=window)
    want = plain(q.float(), k.float(), v.float())
    err = float((out.float() - want).abs().max())
    tol = _tol(torch.bfloat16, want)
    del want
    if not err <= tol:
        raise AssertionError(f"flash at {(nb, H, Hkv, sb, tb, hd, window)}: "
                             f"err {err} > {tol}")

    def library():
        if q_block is not None:
            return sdpa_gqa(q, kx, vx, is_causal=True)
        if not causal:
            return sdpa_gqa(q, k, v)
        if window is None:
            return sdpa_gqa(q, k, v, is_causal=True)
        return sdpa_gqa(q, k, v, attn_mask=band)
    return {
        "shape": f"B={nb} H={H}" + ("" if Hkv == H else f"/{Hkv}")
                 + f" S={sb}" + ("" if tb == sb else f" T={tb}")
                 + f" hd={hd} " + ("causal" if causal else "bidirectional")
                 + ("" if window is None else f" window={window}") + " bf16"
                 + ("" if q_block is None else
                    f"; plain {q_block} queries a call, SDPA on the K/V "
                    f"heads repeated"),
        "kernel": measure(lambda: fk.flash_attention_cuda(
            q, k, v, causal=causal, window=window)),
        "plain": measure(lambda: plain(q, k, v)),
        "library": measure(library), "bound_ms": b_ms,
        "bound_by": b_by, "max_abs_err": err}


def flash_pos_row(gen, B: int = 1, Sc: int = 64, C: int = 128, H: int = 12,
                  hd: int = 10) -> dict:
    """``flash_attention`` with position masks at phase 3e's chunk: B 1, 64
    queries at positions 128..191 over 128 context keys and the chunk's 64
    (192 keys), 12 heads, hd 10, bf16, on the concatenated K/V that
    ``ops.suffix_prefill_attention`` hands the kernel.  The bound counts
    q, k, v and the output once, both position arrays, and the products of
    the valid (query, key) pairs only (each query sees the context and the
    chunk up to itself).  The plain version is
    ``ref.flash_attention_ref`` with the positions; the library call builds
    the boolean mask from the positions and runs SDPA with it."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import ref
    T = C + Sc
    q = torch.randn((B, Sc, H, hd), generator=gen, device=DEVICE
                    ).to(torch.bfloat16).transpose(1, 2)
    k, v = (torch.randn((B, T, H, hd), generator=gen, device=DEVICE
                        ).to(torch.bfloat16).transpose(1, 2)
            for _ in range(2))
    kpos = torch.arange(T, dtype=torch.int32, device=DEVICE)[None].expand(
        B, T).contiguous()
    qpos = kpos[:, C:].contiguous()
    pairs = B * sum(C + i + 1 for i in range(Sc))
    nbytes = 2 * (2 * B * H * Sc * hd + 2 * B * H * T * hd) + 4 * B * (Sc + T)
    b_ms, b_by = bound(nbytes, 4 * H * hd * pairs, "bfloat16")

    def library():
        m = (kpos[:, None, :] <= qpos[:, :, None]) & (kpos[:, None, :] >= 0)
        return F.scaled_dot_product_attention(q, k, v,
                                              attn_mask=m[:, None])
    out = fk.flash_attention_cuda(q, k, v, q_pos=qpos, k_pos=kpos)
    want = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                   q_pos=qpos, k_pos=kpos)
    torch.cuda.synchronize()
    err = float((out.float() - want).abs().max())
    tol = _tol(torch.bfloat16, want)
    if not err <= tol:
        raise AssertionError(f"flash_attention positions row: err {err} > "
                             f"{tol}")
    return {
        "shape": f"B={B} H={H} Sc={Sc} keys={C}+{Sc} hd={hd} bf16, by "
                 f"position, {pairs} valid pairs a head",
        "kernel": measure(lambda: fk.flash_attention_cuda(
            q, k, v, q_pos=qpos, k_pos=kpos)),
        "plain": measure(lambda: ref.flash_attention_ref(
            q, k, v, q_pos=qpos, k_pos=kpos)),
        "library": measure(library), "bound_ms": b_ms, "bound_by": b_by,
        "max_abs_err": err}


def paged_row(gen, kl, vl, pos, step, note: str, G: int = 1,
              window=None) -> dict:
    """``paged_decode_attention`` on one layer's ring viewed as a pool of
    one block per slot, G query heads a KV head, within ``window`` where
    given; against its plain version and SDPA with the mask (GQA by
    ``enable_gqa``).  The bound counts q in and out, the K/V rows of the
    valid tokens only, the positions and the steps."""
    import torch
    from repro_torch.kernels import paged_attention as pk
    from repro_torch.kernels import ref
    Bs, Hkv, W, hd = kl.shape
    table = torch.arange(Bs, dtype=torch.int32, device=DEVICE)[:, None]
    q4 = torch.randn((Bs, Hkv, G, hd), generator=gen, device=DEVICE
                     ).to(kl.dtype)
    st = step[:, None]
    valid = (pos >= 0) & (pos <= st) & (pos > st - W)
    if window is not None:
        valid &= pos > st - window
    n_valid = int(valid.sum())
    nbytes = (q4.numel() * 2 * 2 + 2 * n_valid * Hkv * hd * 2
              + pos.numel() * 4 + Bs * 8)
    b_ms, b_by = bound(nbytes, 4 * n_valid * Hkv * G * hd, "bfloat16")
    out = pk.paged_decode_attention_cuda(q4, kl, vl, table, pos, step,
                                         window=window)
    want = ref.paged_decode_attention_ref(q4, kl, vl, table, pos, step,
                                          window=window)
    err = float((out.float() - want).abs().max())
    tol = _tol(torch.bfloat16, want)
    if not err <= tol:
        raise AssertionError(f"paged at {tuple(q4.shape)}: err {err} > {tol}")
    qs = q4.reshape(Bs, Hkv * G, 1, hd)
    mask = valid[:, None, None, :]
    return {
        "shape": f"B={Bs} Hkv={Hkv} G={G} hd={hd} bs=W={W} nbs=1 bf16"
                 + ("" if window is None else f" window={window}")
                 + f", {n_valid} valid tokens ({note})",
        "kernel": measure(lambda: pk.paged_decode_attention_cuda(
            q4, kl, vl, table, pos, step, window=window)),
        "plain": measure(lambda: ref.paged_decode_attention_ref(
            q4, kl, vl, table, pos, step, window=window)),
        "library": measure(lambda: sdpa_gqa(qs, kl, vl, attn_mask=mask)),
        "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err}


def paged_pool_row(gen, eng) -> dict:
    """``paged_decode_attention`` at the paged Delphi path's pool: the
    tokens of layer 0 of the ring run's cache (phase 3, whose tokens the
    paged run of phase 3c reproduces) laid out in 16-token blocks scattered
    at random over a 257-block pool, table columns of blocks with no valid
    token -1, and the trash block 0 holding positions that no table points
    at.  Held against the plain version and, bit for bit, against the
    kernel on the ring.  The bound counts q in and out, the valid tokens'
    K/V rows, the table, the allocated blocks' positions and the steps.
    The library call is the pool gathered through the table and SDPA with
    the mask."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import paged_attention as pk
    from repro_torch.kernels import ref
    lc = eng.cache["self"]
    kl, vl, rpos = lc.k[0], lc.v[0], lc.pos[0]
    step = eng._state["step"]
    B, Hkv, W, hd = kl.shape
    bs = 16
    nbs, NB = W // bs, 1 + B * (W // bs)
    valid = (rpos >= 0) & (rpos <= step[:, None]) & (rpos > step[:, None] - W)
    used = valid.reshape(B, nbs, bs).any(-1)
    perm = (torch.randperm(NB - 1, generator=gen, device=DEVICE) + 1
            ).reshape(B, nbs).to(torch.int32)
    table = torch.where(used, perm, torch.full_like(perm, -1))
    kp = torch.randn((NB, Hkv, bs, hd), generator=gen, device=DEVICE
                     ).to(kl.dtype)
    vp = torch.randn_like(kp)
    pp = torch.full((NB, bs), -1, dtype=torch.int32, device=DEVICE)
    ids = table[used].long()
    kp[ids] = kl.reshape(B, Hkv, nbs, bs, hd).permute(0, 2, 1, 3, 4)[used]
    vp[ids] = vl.reshape(B, Hkv, nbs, bs, hd).permute(0, 2, 1, 3, 4)[used]
    pp[ids] = rpos.reshape(B, nbs, bs)[used]
    pp[0] = step[0] - torch.arange(bs, dtype=torch.int32, device=DEVICE)
    q4 = torch.randn((B, Hkv, 1, hd), generator=gen, device=DEVICE
                     ).to(kl.dtype)
    n_valid, n_alloc = int(valid.sum()), int(used.sum())
    nbytes = (q4.numel() * 2 * 2 + 2 * n_valid * Hkv * hd * 2
              + table.numel() * 4 + n_alloc * bs * 4 + B * 4)
    b_ms, b_by = bound(nbytes, 4 * n_valid * Hkv * hd, "bfloat16")
    out = pk.paged_decode_attention_cuda(q4, kp, vp, table, pp, step)
    ring = pk.paged_decode_attention_cuda(
        q4, kl, vl, torch.arange(B, dtype=torch.int32, device=DEVICE)[:, None],
        rpos, step)
    want = ref.paged_decode_attention_ref(q4, kp, vp, table, pp, step)
    torch.cuda.synchronize()
    err = float((out.float() - want).abs().max())
    tol = _tol(torch.bfloat16, want)
    if not (err <= tol and torch.equal(out, ring)):
        raise AssertionError(f"paged pool: err {err} (tol {tol}), equal to "
                             f"the ring's: {torch.equal(out, ring)}")

    def library():
        safe = table.clamp(min=0).long()
        kk = kp[safe].permute(0, 2, 1, 3, 4).reshape(B, Hkv, W, hd)
        vv = vp[safe].permute(0, 2, 1, 3, 4).reshape(B, Hkv, W, hd)
        p = torch.where(table[:, :, None] >= 0, pp[safe], -1).reshape(B, W)
        m = (p >= 0) & (p <= step[:, None]) & (p > step[:, None] - W)
        return F.scaled_dot_product_attention(q4, kk, vv,
                                              attn_mask=m[:, None, None, :])
    return {
        "shape": f"B={B} Hkv={Hkv} G=1 hd={hd} bs={bs} nbs={nbs} NB={NB} "
                 f"bf16, {n_valid} valid tokens in {n_alloc} blocks (the "
                 f"run's tokens, paged)",
        "kernel": measure(lambda: pk.paged_decode_attention_cuda(
            q4, kp, vp, table, pp, step)),
        "plain": measure(lambda: ref.paged_decode_attention_ref(
            q4, kp, vp, table, pp, step)),
        "library": measure(library), "bound_ms": b_ms, "bound_by": b_by,
        "max_abs_err": err}


def moe_rows(gen, cfg, ring) -> dict:
    """Phase 5's rows at the MoE LMs' shapes: flash at their largest
    prefill bucket (B 8, MHA 16/16, S 1,024, hd 128, causal, bf16) and
    paged on a ring the 3q run left (B 8, Hkv 16, G 1, hd 128, W 1,024)."""
    return {"flash_attention 3q": flash_row(gen, DENSE_SLOTS, cfg.n_heads,
                                            DENSE_CONTEXT, cfg.head_dim),
            "paged_decode_attention 3q": paged_row(
                gen, *ring, "phase 3q's ring", G=cfg.q_per_kv)}


def lm_rows(gen, w: dict, x: dict) -> dict:
    """Phase 5's rows at 3w's and 3x's shapes: flash at 3w's largest
    prefill bucket (GQA 40/8, hd 128), at B 1 S 4,096 and at the long
    prompt's bucket (B 1, S 16,384), paged on 3w's ring after the run (G
    5, W 1,024) and on the long prompt's ring after its run (G 5, W
    16,384); flash at 3x's largest bucket (MHA 32/32, hd 128) and paged on
    its ring (G 1 over 32 kv heads)."""
    wc, xc = w["cfg"], x["cfg"]

    def bucket(res):
        return max(res["runs"]["ring"]["prefill_shapes"],
                   key=lambda s: s[0] * s[1] * s[1])
    (wb, ws), (xb, xs) = bucket(w), bucket(x)
    return {
        "flash_attention 3w": flash_row(gen, wb, wc.n_heads, ws, wc.head_dim,
                                        Hkv=wc.n_kv_heads),
        "flash_attention 3w S=4096": flash_row(
            gen, 1, wc.n_heads, 4096, wc.head_dim, Hkv=wc.n_kv_heads),
        "flash_attention 3w long": flash_row(
            gen, 1, wc.n_heads, LM_LONG_CONTEXT, wc.head_dim,
            Hkv=wc.n_kv_heads, q_block=1024),
        "paged_decode_attention 3w": paged_row(
            gen, *w["layer0"], "phase 3w's ring", G=wc.q_per_kv),
        "paged_decode_attention 3w long": paged_row(
            gen, *w["long"]["layer0"], "3w's long prompt's ring",
            G=wc.q_per_kv),
        "flash_attention 3x": flash_row(gen, xb, xc.n_heads, xs, xc.head_dim,
                                        Hkv=xc.n_kv_heads),
        "paged_decode_attention 3x": paged_row(
            gen, *x["layer0"], "phase 3x's ring", G=xc.q_per_kv)}


def dense_rows(gen, tl: dict, dn: dict) -> dict:
    """Phase 5's rows at the dense LMs' shapes: TinyLlama's largest prefill
    bucket of phase 3k and its ring after the run (G 8); H2O-Danube's
    4,608-token prefill (window 4,096, hd 80) and its ring after phase 3l
    (G 4)."""
    tc, dc = tl["cfg"], dn["cfg"]
    nb, sb = max(tl["prefill_shapes"], key=lambda s: s[0] * s[1] * s[1])
    return {
        "flash_attention 3k": flash_row(gen, nb, tc.n_heads, sb, tc.head_dim,
                                        Hkv=tc.n_kv_heads),
        "flash_attention 3l": flash_row(
            gen, 1, dc.n_heads, 4608, dc.head_dim, Hkv=dc.n_kv_heads,
            window=dc.sliding_window),
        "paged_decode_attention 3k": paged_row(
            gen, *tl["layer0"], "phase 3k's ring", G=tc.q_per_kv),
        "paged_decode_attention 3l": paged_row(
            gen, *dn["layer0"], "phase 3l's ring", G=dc.q_per_kv,
            window=dc.sliding_window)}


def zamba2_rows(gen, zb: dict) -> dict:
    """Phase 5's rows at Zamba2's shapes (phase 3o): one layer's
    ``ssd_intra`` at a 1024-token prompt (N 64, 64 heads), the shared
    block's flash at the longest prompt (MHA 32/32; the window of 4,096
    does not bite below 4,096 tokens) and its ring after the run (G 1, 32
    kv heads, W 4,096)."""
    zc = zb["cfg"]
    return {
        "ssd_intra 3o": ssd_row(gen, zc, 1024),
        "flash_attention 3o": flash_row(gen, 1, zc.n_heads, 1024,
                                        zc.head_dim),
        "paged_decode_attention 3o": paged_row(
            gen, *zb["ring0"], "phase 3o's ring", G=zc.q_per_kv,
            window=zc.sliding_window)}


def times(main: dict, mamba: dict, gen, dense=None) -> dict:
    """Kernel, plain version and library call at the main paths' shapes:
    device time per call (profiler) and per-call time (CUDA events).  The
    first four keys are the ``kernels`` line's rows; ``launch floor`` is
    PyTorch's smallest kernel (a one-element ``zero_()``) timed the same
    way, the least a launch costs, below which no bound can be seen."""
    import torch
    eng = main["engine"]
    res = {}

    # tte_sample: one tick's sampling, (slots, V) fp32, L2-warm as on the
    # path (the head's logits were just written)
    B, V = eng.slots, eng.cfg.vocab_size
    res["tte_sample"] = tte_row(gen, B, V)

    # flash_attention: the largest prefill bucket the main path ran
    nb, sb = max(eng.prefill_shapes, key=lambda s: s[0] * s[1] * s[1])
    H, hd = eng.cfg.n_heads, eng.cfg.head_dim
    res["flash_attention"] = flash_row(gen, nb, H, sb, hd)

    # paged_decode_attention: one layer of one tick on the main path's ring
    # (layer 0's K/V and positions as the run left them)
    lc = eng.cache["self"]
    kl, vl, pos = lc.k[0], lc.v[0], lc.pos[0]
    step = eng._state["step"]
    res["paged_decode_attention"] = paged_row(gen, kl, vl, pos, step,
                                              "the run's ring")
    # the same tokens in the paged path's pool (phase 3c)
    res["paged_decode_attention paged pool"] = paged_pool_row(gen, eng)

    # ssd_intra: one layer's call at a 1024-token prompt (the main row) and
    # at a one-chunk prompt
    for key, S in (("ssd_intra", 1024), ("ssd_intra S=128", 128)):
        res[key] = ssd_row(gen, mamba["cfg"], S)

    # the longest prefill bucket the engine admits at max_context 256
    res["flash_attention S=256"] = flash_row(gen, 4, H, eng.max_context, hd)
    # the position-masked route at phase 3e's chunk
    res["flash_attention positions"] = flash_pos_row(gen, H=H, hd=hd)
    # a full ring: every slot holds W valid positions (a long history
    # decoding near max_context), on the same K/V
    W = kl.shape[2]
    full_step = (W + 44 + 37 * torch.arange(kl.shape[0], device=DEVICE)
                 ).to(torch.int32)
    j = torch.arange(W, device=DEVICE)
    full_pos = (full_step[:, None] - torch.remainder(
        full_step[:, None] - j[None, :], W)).to(torch.int32)
    res["paged_decode_attention full ring"] = paged_row(
        gen, kl, vl, full_pos, full_step, "full ring")

    # the zoo's largest vocabulary (seamless, 256,206 tokens) at the same
    # slots: device time with a cold L2, kernel only; warm beside it
    res["tte_sample V=256206"] = tte_row(gen, B, 256206, cold=True)

    if dense is not None:
        res.update(dense_rows(gen, dense["3k"], dense["3l"]))
        res.update(zamba2_rows(gen, dense["3o"]))

    z = torch.zeros(1, device=DEVICE)
    res["launch floor"] = {"shape": "one-element zero_()",
                           "kernel": measure(lambda: z.zero_())}
    return res


def ssd_bound(xdt, Bm, cum) -> dict:
    """Bound of one ``ssd_intra`` call from what its inputs need: each input
    read once (B and C once per batch row where their head stride is 0),
    y and the states written once; C.B^T and G.xdt over their causal
    triangle only (L is 0 above the diagonal), C.B^T once per (batch row,
    chunk) where the heads share B/C, the state product in full.  The
    operations term is at the fp32-accurate tensor-core rate (three TF32
    passes); the fp32 CUDA-core term is returned beside it."""
    b, c, Q, H, P = xdt.shape
    N = Bm.shape[-1]
    hb = 1 if Bm.stride(3) == 0 else H
    nbytes = (2 * xdt.numel() * xdt.element_size()          # xdt in, y out
              + 2 * b * c * Q * hb * N * Bm.element_size()  # B, C
              + cum.numel() * 4 + b * c * H * N * P * 4)      # cum, states
    flops = b * c * (hb * Q * (Q + 1) * N
                     + H * (Q * (Q + 1) * P + 2 * Q * N * P))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS["float32_3xtf32"] * 1e3
    return {"bytes": nbytes, "flops": flops, "bytes_ms": t_bytes,
            "ops_ms": t_ops,
            "ops_simt_ms": flops / PEAK_FLOPS["float32_simt"] * 1e3,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def ssd_row(gen, mc, S: int) -> dict:
    """``ssd_intra`` at an S-token prompt in the model's layout: fp32 xdt;
    bf16 B and C sliced out of xBC and broadcast over the heads by a 0
    stride."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as sk
    Q, H, P, N, di = (mc.ssm_chunk, mc.ssm_n_heads, mc.ssm_head_dim,
                      mc.ssm_state, mc.d_inner)
    c = S // Q
    xBC = torch.randn((1, S, di + 2 * N), generator=gen, device=DEVICE
                      ).to(torch.bfloat16)
    Bm = xBC[..., di:di + N].reshape(1, c, Q, 1, N).expand(1, c, Q, H, N)
    Cm = xBC[..., di + N:].reshape(1, c, Q, 1, N).expand(1, c, Q, H, N)
    xdt = torch.randn((1, c, Q, H, P), generator=gen, device=DEVICE)
    cum = -torch.cumsum(0.05 * torch.rand((1, c, Q, H), generator=gen,
                                          device=DEVICE), dim=2)
    bd = ssd_bound(xdt, Bm, cum)
    return {
        "shape": f"S={S}: b=1 C={c} Q={Q} H={H} P={P} N={N}, xdt fp32, "
                 f"B/C bf16 shared by the heads",
        "kernel": measure(lambda: sk.ssd_intra_cuda(xdt, Bm, Cm, cum)),
        "plain": measure(lambda: ref.ssd_intra_ref(
            xdt.transpose(2, 3), Bm[:, :, :, :1].transpose(2, 3),
            Cm[:, :, :, :1].transpose(2, 3), cum.transpose(2, 3))),
        "library": None, "bound_ms": bd["bound_ms"],
        "bound_by": bd["bound_by"], "bound_terms": bd}


def path_profile(run, wall: float) -> dict:
    """A path once more, the same requests and seed, under the profiler
    (``run()`` returns the wall seconds of its engine run): the device's
    busy time against ``wall`` (the same run without the profiler, whose
    host-side tracing slows the launches), and the kernels that take the
    device time."""
    box = {}

    def go():
        box["seconds"] = run()
    kernels = device_kernels(go)
    busy = sum(ms for _, ms in kernels.values()) / 1e3
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:8]
    ssd = [v for name, v in kernels.items() if "ssd_intra" in name]
    return {"wall_s": wall, "profiled_wall_s": box["seconds"],
            "device_busy_s": busy,
            "ssd_intra": {"launches": sum(n for n, _ in ssd),
                          "ms": sum(ms for _, ms in ssd)},
            "idle_share": (1.0 - busy / wall) if busy else None,
            "launches": sum(n for n, _ in kernels.values()),
            "top": [{"kernel": name[:80], "launches": n, "ms": ms}
                    for name, (n, ms) in top]}


# the recurrent paths' profiled window: their first PROFILE_REQUESTS
# prompts, PROFILE_MAX_NEW new tokens each (a whole 16-request run makes
# ~200,000 device activities, whose trace the profiler takes minutes to
# fold); its wall time is taken from the same window run without the
# profiler
PROFILE_REQUESTS, PROFILE_MAX_NEW = 4, 8


def window_profile(run) -> dict:
    """``path_profile`` of ``run()`` (which returns its wall seconds), the
    wall time from one unprofiled run after a warm one (the window's
    admissions take shapes the whole drive may not have taken)."""
    run()
    return path_profile(run, run())


# ---------------------------------------------------------------------------
# phase 3u: the reference engine; phase 6h: MoE training; the launch check
# ---------------------------------------------------------------------------
# benchmarks/run.py's bench_serving_engine knobs: 8 slots, max_context 128
REF_SLOTS, REF_CONTEXT = 8, 128
REF_PROMPTS, REF_MAX_EVENTS, REF_MAX_NEW = 16, 64, 24


def reference_prompts(n: int, seed: int):
    """``n`` synthetic patient histories (seeded), each cut to at most
    ``REF_MAX_EVENTS`` events."""
    from repro_torch.data import SimulatorConfig, generate_dataset
    trajs, _ = generate_dataset(SimulatorConfig(n_train=n, n_val=1,
                                                seed=seed))
    return [(t[:REF_MAX_EVENTS], a[:REF_MAX_EVENTS]) for t, a in trajs]


def reference_drive(eng, prompts) -> dict:
    """Submit every prompt (``REF_MAX_NEW`` events each) and tick until all
    are done; wall seconds ending in a synchronise, ticks that decoded."""
    import torch
    from repro_torch.serve import Request
    reqs = [Request(tokens=t, ages=a, max_new=REF_MAX_NEW)
            for t, a in prompts]
    for r in reqs:
        eng.submit(r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    decodes = 0
    if hasattr(eng, "slot_step"):     # ReferenceEngine: count its decodes
        while eng.pending or any(r is not None for r in eng.slot_req):
            decodes += bool(eng.step())
    else:
        eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    events = sum(len(r.out_tokens) for r in reqs)
    return {"reqs": reqs, "wall_s": wall, "events": events,
            "events_per_s": events / wall, "decodes": decodes}


def reference_engine_path() -> dict:
    """Phase 3u: the seed host-loop ``ReferenceEngine`` (full-width
    Delphi-2M, bf16, ``REF_SLOTS`` slots, ``max_context`` ``REF_CONTEXT``)
    on ``REF_PROMPTS`` synthetic prompts of at most ``REF_MAX_EVENTS``
    events, ``REF_MAX_NEW`` new events each, after a warm drive of 4 on the
    same instance.  Gates (counts zeroed just before the timed drive and
    read just after): every request done; flash 12 launches an admission
    (one admission a request); paged 12 a decode call; ``tte_sample`` one
    an emitted event (each slot sampled on its own).  Then the ring
    ``BatchedEngine`` (the same knobs, generator uniforms) on the same
    prompts, warmed the same way: events/s of both, in turns (reference,
    batched, batched, reference), and each engine's idle share over one
    more drive (:func:`window_profile`)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import init_params
    from repro_torch.serve import BatchedEngine, ReferenceEngine
    cfg = get_config("delphi-2m")
    params = init_params(cfg, seed=SEED, device=DEVICE)
    prompts = reference_prompts(REF_PROMPTS, SEED + 91)
    warm = reference_prompts(4, SEED + 92)
    ref = ReferenceEngine(params, cfg, slots=REF_SLOTS,
                          max_context=REF_CONTEXT, seed=SEED, device=DEVICE)
    bat = BatchedEngine(params, cfg, slots=REF_SLOTS, max_context=REF_CONTEXT,
                        seed=SEED, device=DEVICE)
    for eng in (ref, bat):
        reference_drive(eng, warm)
    ops.reset_launch_counts()
    run = reference_drive(ref, prompts)
    counts = ops.launch_counts()
    L = cfg.n_layers
    want = {"flash_attention": L * len(prompts),
            "paged_decode_attention": L * run["decodes"],
            "tte_sample": run["events"], "ssd_intra": 0}
    done = [r for r in run["reqs"] if r.done]
    if len(done) != len(prompts) or counts != want:
        raise AssertionError(f"reference engine: {len(done)} of "
                             f"{len(prompts)} done; launches {counts}, "
                             f"want {want}")
    turns = [("reference", run["events_per_s"])]
    for eng, name in ((bat, "batched"), (bat, "batched"), (ref, "reference")):
        turns.append((name, reference_drive(eng, prompts)["events_per_s"]))
    rate = {n: [v for m, v in turns if m == n]
            for n in ("reference", "batched")}
    prof = {name: window_profile(
        lambda e=eng: reference_drive(e, prompts)["wall_s"])
        for eng, name in ((ref, "reference"), (bat, "batched"))}
    out = {"requests": len(prompts), "events": run["events"],
           "wall_s": run["wall_s"], "decodes": run["decodes"],
           "launches": counts, "turns": turns,
           "batched_over_reference": (sum(rate["batched"])
                                      / sum(rate["reference"])),
           "idle_share": {n: p["idle_share"] for n, p in prof.items()},
           "device_busy_s": {n: p["device_busy_s"] for n, p in prof.items()},
           "profiled_wall_s": {n: p["wall_s"] for n, p in prof.items()}}
    del ref, bat, params
    free_card()
    return out


# phase 6h: Qwen2-MoE-A2.7B at full width cut to MOE_TRAIN_LAYERS layers,
# MOE_TRAIN_BATCH x MOE_TRAIN_SEQ seeded random ids, bf16 over fp32 masters;
# the two dispatches' losses within MOE_TRAIN_LOSS_REL of each other (their
# bf16 products round differently)
MOE_TRAIN_LAYERS, MOE_TRAIN_BATCH, MOE_TRAIN_SEQ = 2, 2, 256
MOE_TRAIN_LOSS_REL = 1e-2
# 6h's gradient gate, at one MoE layer (layer 0 of 6h's weights) on
# MOE_TRAIN_BATCH x MOE_TRAIN_SEQ seeded tokens and a seeded cotangent: the
# bf16 gradients of both dispatches against the fp32 dense_scan ones (TF32
# off), each leaf's largest difference over its largest |g| (the input's
# gradient a leaf too) within MOE_GRAD_REL; a token whose top-k experts
# differ between the fp32 and the bf16 router is left out (its cotangent
# is zero, so it adds nothing to any gradient).  On the H100 the sound
# routes read 0.0144 and ragged with a backward whose weight gradient
# takes group boundaries one row off (:func:`grouped_mm_rows_off`, run
# beside the gate, which must miss the limit) 0.92; the 2-layer model's
# gradients with ragged held to dense_scan's experts are held to the same
# limit
MOE_GRAD_REL = 3e-2
MOE_GRAD_LEAVES = ("moe/router", "moe/w_gate", "moe/w_up", "moe/w_down",
                   "moe/shared/w_gate", "moe/shared/w_up",
                   "moe/shared/w_down")


def grouped_mm_rows_off(shift: int):
    """A stand-in for ``models.moe.grouped_mm`` with the same forward and
    a faulty backward: the weight gradient of group e sums the rows
    between the boundaries ``offs`` moved ``shift`` rows down (each
    group's first rows counted to the group before).  The control that
    :func:`moe_layer_grads` holds against ``MOE_GRAD_REL``."""
    import torch
    from repro_torch.models import moe
    real = moe.grouped_mm

    class RowsOff(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, w, offs):
            ctx.save_for_backward(x, w, offs)
            return real(x, w, offs)

        @staticmethod
        def backward(ctx, gy):
            x, w, offs = ctx.saved_tensors
            b = offs.tolist()
            bw = [max(h - shift, 0) for h in b[:-1]] + b[-1:]
            gx, gw = torch.zeros_like(x), torch.zeros_like(w)
            lo = low = 0
            for e in range(len(b)):
                if b[e] > lo:
                    gx[lo:b[e]] = gy[lo:b[e]] @ w[e].t()
                if bw[e] > low:
                    gw[e] = x[low:bw[e]].t() @ gy[low:bw[e]]
                lo, low = b[e], bw[e]
            return gx, gw, None
    return lambda x, w, offs, bounds=None: RowsOff.apply(x, w, offs)


def moe_layer_grads(params, cfg, gen) -> dict:
    """The readings of 6h's gradient gate (``MOE_GRAD_REL``, which the
    caller holds): for ``dense_scan`` and ``ragged`` in bf16, and for
    ``ragged`` through :func:`grouped_mm_rows_off` (one row), each leaf's
    largest gradient difference from the fp32 ``dense_scan`` over that
    leaf's largest |g|; the tokens left out as flips."""
    import torch
    from repro_torch.models import moe
    from repro_torch.models.model import Block
    blk = Block(params, "layers/", 0)
    names = [n for n in MOE_GRAD_LEAVES if n in blk]
    T = MOE_TRAIN_BATCH * MOE_TRAIN_SEQ
    x = torch.randn((1, T, cfg.d_model), generator=gen, device=DEVICE)
    x16 = x.to(torch.bfloat16)
    router = blk["moe/router"]
    e32 = moe.route(router, x[0], cfg.top_k)[1].sort(dim=-1).values
    e16 = moe.route(router, x16[0], cfg.top_k)[1].sort(dim=-1).values
    keep = (e32 == e16).all(dim=-1)
    dy = (torch.randn((1, T, cfg.d_model), generator=gen, device=DEVICE)
          * keep[None, :, None])

    def grads(xin, c, impl):
        leaves = {n: blk[n].detach().requires_grad_(True) for n in names}
        xi = xin.detach().requires_grad_(True)
        with torch.enable_grad():
            y, _ = moe.apply_moe(leaves, xi, c, impl=impl)
            g = torch.autograd.grad(y, [xi, *leaves.values()],
                                    grad_outputs=dy.to(y.dtype))
        return dict(zip(["input", *names], g))

    def faulty(xin, c, impl):
        real = moe.grouped_mm
        moe.grouped_mm = grouped_mm_rows_off(1)
        try:
            return grads(xin, c, impl)
        finally:
            moe.grouped_mm = real

    g32 = grads(x, cfg.replace(dtype="float32"), "dense_scan")
    out = {"tokens": T, "flips": int((~keep).sum())}
    for impl, run in (("dense_scan", grads), ("ragged", grads),
                      ("ragged_rows_off", faulty)):
        g16 = run(x16, cfg, impl.split("_rows")[0])
        rel = {}
        for n, g in g32.items():
            if not bool(torch.isfinite(g16[n]).all()):
                raise AssertionError(f"6h: {impl} {n}: gradient not finite")
            rel[n] = (float((g16[n].float() - g).abs().max())
                      / float(g.abs().max()))
        worst = max(rel, key=rel.get)
        out[impl] = {"rel": rel, "worst": rel[worst], "worst_leaf": worst}
        del g16
    del g32
    return out


def moe_train_path() -> dict:
    """Phase 6h: Qwen2-MoE-A2.7B at full width, ``MOE_TRAIN_LAYERS``
    layers (~1.8 B parameters; fp32 masters made on the card).  First the
    gradient gate at one layer (:func:`moe_layer_grads`, within
    ``MOE_GRAD_REL``).  Then one bf16 ``lm`` gradient each with
    ``moe_impl="dense_scan"`` and ``"ragged"`` from the same weights and
    batch: the losses within ``MOE_TRAIN_LOSS_REL`` of each other (a loose
    gate: an untrained model's loss sits near ln V whatever its MoE layers
    return; the layer gate holds the dispatch), every gradient finite, the
    largest difference of a leaf's gradients relative to its largest |g|
    stated, with the tokens whose experts differ between the two runs
    counted by layer; with ``ragged`` held to ``dense_scan``'s experts
    (:class:`routing`) every leaf's difference within ``MOE_GRAD_REL``
    (without the hold, the few tokens that flip in layer 1 move whole
    rows of an expert's gradient); no kernel launched.  Then
    one AdamW step of each dispatch with ``remat`` off and on (a warm step
    first): each step's wall seconds and peak memory above what was held
    before it."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import init_params_on_device, moe
    from repro_torch.train import (OptimizerConfig, init_opt_state,
                                   loss_and_grads, make_loss_fn,
                                   make_train_step)
    from repro_torch.train.trainer import to_device
    free_card()
    cfg = get_config("qwen2-moe-a2.7b").replace(n_layers=MOE_TRAIN_LAYERS)
    t0 = time.perf_counter()
    params = init_params_on_device(cfg.replace(dtype="float32"), seed=SEED,
                                   device=DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(v.numel() for v in params.values())
    rng = np.random.default_rng(SEED + 101)
    batch = to_device({"tokens": rng.integers(0, cfg.vocab_size, (
        MOE_TRAIN_BATCH, MOE_TRAIN_SEQ)).astype(np.int32)}, DEVICE)
    ops.reset_launch_counts()
    layer = moe_layer_grads(params, cfg, torch.Generator(DEVICE)
                            .manual_seed(SEED + 102))
    for impl in ("dense_scan", "ragged"):
        r = layer[impl]
        if not r["worst"] <= MOE_GRAD_REL:
            raise AssertionError(f"6h: one layer's {impl} bf16 gradient of "
                                 f"{r['worst_leaf']} off the fp32 "
                                 f"dense_scan's by {r['worst']:.3g} of its "
                                 f"largest |g| (> {MOE_GRAD_REL})")
    if not layer["ragged_rows_off"]["worst"] > MOE_GRAD_REL:
        raise AssertionError(f"6h: a ragged backward one row off reads "
                             f"{layer['ragged_rows_off']['worst']:.3g}, "
                             f"inside the gate's {MOE_GRAD_REL}")
    with routing() as seen_d:
        g_d, m_d = loss_and_grads(make_loss_fn(cfg, "lm"), params, batch)
    with routing() as seen_r:
        g_r, m_r = loss_and_grads(make_loss_fn(cfg, "lm", moe_impl="ragged"),
                                  params, batch)
    # the same ragged gradient with each layer held to dense_scan's experts
    with routing(held=seen_d.seen):
        g_h, _ = loss_and_grads(make_loss_fn(cfg, "lm", moe_impl="ragged"),
                                params, batch)
    flips = [int((a.sort(dim=-1).values != b.sort(dim=-1).values)
                 .any(dim=-1).sum())
             for a, b in zip(seen_d.seen, seen_r.seen)]
    worst, worst_key, held = 0.0, None, {}
    for k, g in g_d.items():
        scale = float(g.abs().max())
        if not (bool(torch.isfinite(g_r[k]).all()) and scale > 0):
            raise AssertionError(f"6h: {k}: gradient not finite or zero")
        rel = float((g_r[k] - g).abs().max()) / scale
        held[k] = float((g_h[k] - g).abs().max()) / scale
        if rel > worst:
            worst, worst_key = rel, k
    del g_d, g_r, g_h
    held_key = max(held, key=held.get)
    if held[held_key] > MOE_GRAD_REL:
        raise AssertionError(f"6h: ragged held to dense_scan's experts: "
                             f"{held_key}'s gradient off by "
                             f"{held[held_key]:.3g} of its largest |g| "
                             f"(> {MOE_GRAD_REL})")
    loss_d, loss_r = float(m_d["loss"]), float(m_r["loss"])
    loss_rel = abs(loss_r - loss_d) / abs(loss_d)
    if loss_rel > MOE_TRAIN_LOSS_REL or not np.isfinite(loss_r):
        raise AssertionError(f"6h: ragged loss {loss_r} vs dense_scan "
                             f"{loss_d} (rel {loss_rel:.3g} > "
                             f"{MOE_TRAIN_LOSS_REL})")
    runs = {}
    ocfg = OptimizerConfig(lr=1e-5)
    for impl in ("dense_scan", "ragged"):
        for remat in (False, True):
            step = make_train_step(cfg.replace(remat=remat), ocfg, "lm",
                                   moe_impl=impl)
            opt = init_opt_state(params)
            step(params, opt, batch)            # warm: cuBLAS plans, caches
            free_card()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t1 = time.perf_counter()
            _, _, m = step(params, opt, batch)
            loss = float(m["loss"])
            torch.cuda.synchronize()
            runs[f"{impl} remat {'on' if remat else 'off'}"] = {
                "step_s": time.perf_counter() - t1, "loss": loss,
                "peak_memory_bytes": torch.cuda.max_memory_allocated()
                - base}
            del opt
    counts = ops.launch_counts()
    if any(counts.values()):
        raise AssertionError(f"6h: training launched a kernel: {counts}")
    grouped = moe.grouped_route(
        torch.empty((1, cfg.d_model), dtype=torch.bfloat16, device=DEVICE),
        params["layers/moe/w_gate"][0].to(torch.bfloat16))
    out = {"layers": MOE_TRAIN_LAYERS, "n_params": n_params,
           "batch": MOE_TRAIN_BATCH, "seq": MOE_TRAIN_SEQ, "init_s": init_s,
           "loss_dense_scan": loss_d, "loss_ragged": loss_r,
           "loss_rel_err": loss_rel, "grad_max_rel_err": worst,
           "grad_worst_leaf": worst_key, "flips_by_layer": flips,
           "grad_held_rel_err": held[worst_key],
           "grad_held_max_rel_err": max(held.values()), "layer": layer,
           "grouped_product": grouped, "runs": runs}
    del params, batch
    free_card()
    return out


def launch_check_child() -> dict:
    """Run in its own process (``launch_check``): a process group of one on
    the card (NCCL, the loopback address from ``MASTER_ADDR``/
    ``MASTER_PORT``), ``ensure_distributed(expect_devices=1)``, an
    all-reduce, the 1 x 1 ``DeviceMesh`` on ``cuda``, full-width
    Delphi-2M's parameters placed by ``param_shardings`` as DTensors (each
    placement ``Replicate``); a bf16 forward through the placed
    parameters' local tensors against the plain parameters' logits, bit
    for bit (a smoke test of ``distribute_tensor``/``to_local``: on 1 x 1
    the local tensors are the parameters), and the tied head (embedding
    gather, product with the table, bias) run on the DTensors themselves
    against the same ops on the plain tensors, bit for bit."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, distribute_tensor
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.distributed import ensure_distributed
    from repro_torch.launch.mesh import device_mesh, make_host_mesh
    from repro_torch.models import forward, init_params
    torch.cuda.set_device(0)
    dist.init_process_group(
        "nccl", init_method=(f"tcp://{os.environ['MASTER_ADDR']}:"
                             f"{os.environ['MASTER_PORT']}"),
        world_size=int(os.environ["WORLD_SIZE"]),
        rank=int(os.environ["RANK"]), device_id=torch.device("cuda", 0))
    try:
        n = ensure_distributed(expect_devices=1)
        one = torch.ones(1, device=DEVICE)
        dist.all_reduce(one)
        mesh = make_host_mesh()
        dm = device_mesh(mesh, "cuda")
        cfg = get_config("delphi-2m")
        params = init_params(cfg, seed=SEED, device=DEVICE)
        placed, kinds = {}, set()
        for k, spec in sh.param_shardings(mesh, params).items():
            pl = sh.to_placements(spec, dm)
            kinds.update(type(p).__name__ for p in pl)
            if pl != [Replicate(), Replicate()]:
                raise AssertionError(f"{k}: placements {pl} on 1 x 1")
            placed[k] = distribute_tensor(params[k], dm, pl)
        rng = np.random.default_rng(SEED + 111)
        toks = rng.integers(3, cfg.vocab_size, (4, 48)).astype(np.int32)
        ages = np.sort(rng.uniform(30, 70, (4, 48)), axis=1)
        batch = {"tokens": torch.from_numpy(toks).to(DEVICE),
                 "ages": torch.from_numpy(ages.astype(np.float32)).to(DEVICE)}
        with torch.no_grad():
            want = forward(params, cfg, batch)["logits"]
            got = forward({k: v.to_local() for k, v in placed.items()}, cfg,
                          batch)["logits"]
            # the tied head on the DTensors themselves: the embedding
            # gather, the bf16 product with the table and the output bias
            tok = distribute_tensor(batch["tokens"], dm, pl)

            def head(emb, bias, t):
                e16 = emb.to(torch.bfloat16)
                return (torch.nn.functional.embedding(t, e16) @ e16.t()
                        + bias.to(torch.bfloat16))
            dt_out = head(placed["embed/embed"], placed["embed/out_bias"],
                          tok)
            dt_equal = bool(torch.equal(
                dt_out.full_tensor(), head(params["embed/embed"],
                                           params["embed/out_bias"],
                                           batch["tokens"])))
        equal = bool(torch.equal(got, want))
        if not (equal and dt_equal and n == 1 and float(one) == 1.0):
            raise AssertionError(f"launch check: devices {n}, all-reduce "
                                 f"{float(one)}, logits equal {equal}, "
                                 f"DTensor head equal {dt_equal}")
        leaves = len(placed)
        del params, placed, got, want
        torch.cuda.empty_cache()
        return {"devices": n, "mesh": str(dm), "placements": sorted(kinds),
                "leaves": leaves, "logits_equal": equal,
                "dtensor_head_equal": dt_equal,
                "dtensor_head_type": type(dt_out).__name__,
                "all_reduce": float(one),
                "sharded": sharded_drive(dm, SHARD_ARCH),
                "moe_sharded": sharded_drive(
                    dm, MOE_SHARD_ARCH, MOE_SHARD_LAYERS, MOE_SHARD_IMPLS,
                    "ragged", SEED + 32),
                "moe_train": moe_train_drive(dm)}
    finally:
        dist.destroy_process_group()


# phase 6i's sharded drives: full-width TinyLlama-1.1B in bf16 under the
# default dispatch; full-width OLMoE-1B-7B cut to 2 of its 16 layers, bf16,
# under both grouped dispatches against the plain ragged route
SHARD_ARCH = "tinyllama-1.1b"
SHARD_BATCH, SHARD_SEQ, SHARD_STEPS = 8, 1024, 8
MOE_SHARD_ARCH, MOE_SHARD_LAYERS = "olmoe-1b-7b", 2
MOE_SHARD_IMPLS = ("ragged_local", "ragged")


def sharded_drive(dm, arch: str, layers=None,
                  impls=("dense_scan",), plain_impl: str = "dense_scan",
                  seed: int = SEED + 29) -> dict:
    """Phase 6i's sharded step on the 1 x 1 ``DeviceMesh`` ``dm`` (its
    one-rank NCCL group): ``arch`` at full width (cut to ``layers`` layers
    where given) in bf16, parameters, batch and a ring cache placed by
    ``launch.sharding.distribute_tree``, a prefill of ``SHARD_BATCH`` x
    ``SHARD_SEQ`` and ``SHARD_STEPS`` decode steps (tokens from ``seed``)
    run on the DTensors themselves (each rank's shards through
    ``repro_torch.sharded``'s ``local_map``) under each MoE dispatch of
    ``impls``, against the plain route under ``plain_impl`` on the same
    weights and tokens: every step's logits, the prefill's rings and the
    rings after the last step equal bit for bit.  The decode starts from
    the plain prefill's rings (which the DTensor prefill's equal) placed
    by ``distribute_tree``.  The drives (prefill and decode on DTensors,
    the collective counter on) launch ``flash_attention`` once a layer a
    prefill and ``paged_decode_attention`` once a layer a step, counted
    from 0 just before them and read just after, and send no collective
    (one rank).  Each drive is timed with the counter on, and again
    without it, beside the plain route's prefill and decode after a warm
    drive of it (each a host clock around work that ends in a
    synchronise)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.collectives import CollectiveCounter
    from repro_torch.launch.mesh import describe
    from repro_torch.models import decode_step, forward, init_params_on_device
    from repro_torch.models.attention import LayerCache
    cfg = get_config(arch)
    if layers is not None:
        cfg = cfg.replace(n_layers=layers)
    mesh = describe(dm)
    B, S, n = SHARD_BATCH, SHARD_SEQ, SHARD_STEPS
    W = S + n
    params = init_params_on_device(cfg, seed=SEED, device=DEVICE)
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S + n))
                            .astype(np.int32)).to(DEVICE)
    batch = {"tokens": toks[:, :S]}

    def clone(cache):
        return {k: LayerCache(*(t.clone() for t in v))
                for k, v in cache.items()}

    def decode(p, cache, impl):
        out = []
        for i in range(n):
            step = torch.full((B,), S + i, dtype=torch.int32, device=DEVICE)
            d = decode_step(p, cfg, cache, {"tokens": toks[:, S + i:S + i + 1]},
                            step, moe_impl=impl)
            out.append(d["logits"])
        return out

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def plain():
        r = forward(params, cfg, batch, mode="prefill", cache_width=W,
                    moe_impl=plain_impl)
        return r, clone(r["cache"]), decode(params, r["cache"], plain_impl)

    res = {"arch": arch, "layers": cfg.n_layers, "batch": B, "seq": S,
           "steps": n, "plain_impl": plain_impl, "drives": {}}
    with torch.no_grad():
        plain()                                     # warm
        (ref, ring0, ref_steps), res["plain_seconds"] = timed(plain)
        dparams = sh.distribute_tree(params, sh.param_shardings(mesh, params),
                                     dm)
        dbatch = sh.distribute_tree(batch, sh.batch_shardings(mesh, batch),
                                    dm)

        def sharded(impl):
            out = forward(dparams, cfg, dbatch, mode="prefill",
                          cache_width=W, moe_impl=impl)
            dring = sh.distribute_tree(
                clone(ring0), sh.cache_shardings(mesh, ring0), dm)
            return out, dring, decode(dparams, dring, impl)
        ops.reset_launch_counts()
        with CollectiveCounter() as cc:
            for impl in impls:
                (out, dring, steps), secs = timed(lambda: sharded(impl))
                local = {k: LayerCache(*(t.to_local() for t in v))
                         for k, v in out["cache"].items()}
                res["drives"][impl] = {
                    "seconds": secs,
                    "prefill_equal": bool(torch.equal(
                        out["logits"].to_local(), ref["logits"])),
                    "prefill_rings_equal": all(
                        torch.equal(a, b) for k in local
                        for a, b in zip(local[k], ring0[k])),
                    "steps_equal": all(torch.equal(a.to_local(), b)
                                       for a, b in zip(steps, ref_steps)),
                    "rings_equal": all(
                        torch.equal(a.to_local(), b) for k in dring
                        for a, b in zip(dring[k], ref["cache"][k])),
                    "logits_type": type(out["logits"]).__name__}
                del out, dring, steps, local
        counts = ops.launch_counts()
        for impl in impls:                          # warm, the counter off
            res["drives"][impl]["seconds_no_counter"] = timed(
                lambda: sharded(impl))[1]
    want = {"flash_attention": len(impls) * cfg.n_layers,
            "paged_decode_attention": len(impls) * cfg.n_layers * n}
    res["launches"] = {k: counts[k] for k in want}
    res["collective_total"] = cc.total
    del params, dparams, ref, ring0, ref_steps
    free_card()
    bad = [impl for impl, r in res["drives"].items()
           if not (r["prefill_equal"] and r["prefill_rings_equal"]
                   and r["steps_equal"] and r["rings_equal"]
                   and r["logits_type"] == "DTensor")]
    if bad or res["launches"] != want or cc.total != 0:
        raise AssertionError(f"sharded drive of {arch}: {bad} failed; "
                             f"{res}, launches wanted {want}")
    return res


# phase 6i's MoE train step: one step of MOE_SHARD_TRAIN (batch, tokens)
# over fp32 masters of the MoE drive's model, the DTensor step under each
# grouped dispatch against the plain ragged one.  The sharded training
# route is not the plain one's bits on one rank (its attention is
# sharded_chunked_attention, and on the CPU a 1 x 1 train step of reduced
# TinyLlama with dense_scan parts from the plain one too), so the step is
# held to limits: the loss, CE and aux within MOE_SHARD_LOSS_REL of each,
# every leaf's AdamW moments within MOE_SHARD_GRAD_REL of the leaf's
# largest element (the first moment is the clipped gradient times 1 -
# b1), the largest parameter update difference printed in units of lr.
# Measured on an H100 (700 W): loss, CE and aux 0.0, moments 1.83e-2 of a
# leaf's largest (the embedding's second moment; the CPU's reduced OLMoE
# 1.1e-2), updates 0.020 lr; the limits leave ~3x room for another host's
# sums
MOE_SHARD_TRAIN = (2, 256)
MOE_SHARD_LOSS_REL = 1e-5
MOE_SHARD_GRAD_REL = 5e-2


def moe_train_drive(dm) -> dict:
    """Phase 6i's MoE train step on the 1 x 1 ``DeviceMesh`` ``dm``:
    full-width OLMoE-1B-7B cut to ``MOE_SHARD_LAYERS`` layers, one train
    step (AdamW, bf16 activations over fp32 masters made on the card) on
    DTensors under each of ``MOE_SHARD_IMPLS`` against the plain
    ``ragged`` step from the same masters and batch (the first
    ``MOE_SHARD_TRAIN`` tokens of the MoE serving drive's): the loss, its
    CE and aux loss within ``MOE_SHARD_LOSS_REL`` (on one rank
    ``ragged_local``'s mean over the data shards is the global aux), every
    leaf's moments within ``MOE_SHARD_GRAD_REL`` of its largest element,
    the largest update difference reported in units of lr.  Each step is
    timed after a warm one (a host clock around work that ends in a
    synchronise), beside the plain step."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import describe
    from repro_torch.models import init_params_on_device
    from repro_torch.train import (OptimizerConfig, init_opt_state,
                                   make_train_step)
    cfg = get_config(MOE_SHARD_ARCH).replace(n_layers=MOE_SHARD_LAYERS)
    mesh = describe(dm)
    tb, ts = MOE_SHARD_TRAIN
    rng = np.random.default_rng(SEED + 32)
    toks = rng.integers(0, cfg.vocab_size, (SHARD_BATCH,
                                            SHARD_SEQ + SHARD_STEPS))
    tbatch = {"tokens": torch.from_numpy(toks[:tb, :ts].astype(np.int32))
              .to(DEVICE)}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0
    masters = init_params_on_device(cfg.replace(dtype="float32"), seed=SEED,
                                    device=DEVICE)
    ocfg = OptimizerConfig()
    opt = init_opt_state(masters)
    plain_step = make_train_step(cfg, ocfg, "lm", moe_impl="ragged")
    plain_step(masters, opt, tbatch)                # warm
    (want_p, want_o, want_m), plain_s = timed(
        lambda: plain_step(masters, opt, tbatch))
    pshard = sh.param_shardings(mesh, masters)
    dmasters = sh.distribute_tree(masters, pshard, dm)
    dopt = sh.distribute_tree(opt, sh.opt_state_shardings(mesh, opt, pshard),
                              dm)
    dtb = sh.distribute_tree(tbatch, sh.batch_shardings(mesh, tbatch), dm)
    res = {"plain_seconds": plain_s}
    lr = float(ocfg.lr)

    def local(t):
        return (t.to_local() if hasattr(t, "to_local") else t).float()

    def rel(a, b):
        scale = float(b.float().abs().max())
        err = float((local(a) - b.float()).abs().max())
        return err / scale if scale > 0 else err
    for impl in MOE_SHARD_IMPLS:
        step = make_train_step(cfg, ocfg, "lm", moe_impl=impl)
        step(dmasters, dopt, dtb)                   # warm
        (got_p, got_o, got_m), secs = timed(
            lambda: step(dmasters, dopt, dtb))
        moments = {f"{m}/{k}": rel(got_o[m][k], want_o[m][k])
                   for m in ("mu", "nu") for k in want_o[m]}
        worst = max(moments, key=moments.get)
        res[impl] = {
            "seconds": secs,
            "loss": float(local(got_m["loss"])),
            "aux_loss": float(local(got_m["aux_loss"])),
            "metrics_rel": max(rel(got_m[k], want_m[k])
                               for k in ("loss", "event_ce", "aux_loss")),
            "moment_rel": moments[worst], "moment_worst": worst,
            "update_lr": max(float((local(got_p[k]) - want_p[k].float())
                                   .abs().max()) for k in want_p) / lr,
            "bit_equal": all(
                torch.equal(local(got_p[k]), want_p[k].float())
                for k in want_p) and max(moments.values()) == 0}
        del got_p, got_o, got_m
    res["plain_loss"] = float(want_m["loss"])
    res["plain_aux_loss"] = float(want_m["aux_loss"])
    del masters, dmasters, opt, dopt, want_p, want_o
    free_card()
    bad = [impl for impl in MOE_SHARD_IMPLS
           if not (res[impl]["metrics_rel"] <= MOE_SHARD_LOSS_REL
                   and res[impl]["moment_rel"] <= MOE_SHARD_GRAD_REL)]
    if bad:
        raise AssertionError(f"MoE train step: {bad} failed; {res}")
    return res


def start_launch_check():
    """:func:`launch_check_child` started in its own process (a process
    group is the process's for good) with a world of one on a free
    loopback port: (the process, its start time)."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               WORLD_SIZE="1", RANK="0",
               PYTHONPATH=os.path.join(ROOT, "src"))
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); "
            "import chip_smoke; "
            "print(json.dumps(chip_smoke.launch_check_child()))")
    return (subprocess.Popen([sys.executable, "-c", code, ROOT], env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True, cwd=ROOT), time.perf_counter())


def launch_check(started=None) -> dict:
    """The launch layer on the card: the result of the process that
    :func:`start_launch_check` started (``started``, else one started
    here), the last line it prints, with its wall seconds."""
    proc, t0 = started or start_launch_check()
    try:
        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    if proc.returncode != 0:
        raise AssertionError(f"launch check exited {proc.returncode}: "
                             f"{err[-3000:]}")
    res = json.loads(out.strip().splitlines()[-1])
    res["wall_s"] = time.perf_counter() - t0
    return res


# ---------------------------------------------------------------------------
# phases 6j and 6k: SeamlessM4T-large-v2 and InternVL2-26B trained; phase
# 3v: a full-width OLMoE-1B-7B checkpoint served through the CLI
# ---------------------------------------------------------------------------
# the fp32 card-against-CPU step (TF32 off; the loss within 1e-5, each
# gradient within GRAD_CARD_REL of its leaf's largest element): SeamlessM4T
# at full width cut to 2 encoder and 2 decoder layers, 2 x 128 tokens over
# 16 frames (S // enc_len_ratio); InternVL2 cut to 1 layer, 1 x (256
# patches + 64 text tokens).  The bf16 steps over fp32 masters with AdamW
# (one warm step, then ZOO_TRAIN_STEPS): SeamlessM4T at full depth (24 +
# 24), 4 x 512 tokens over 64 frames; InternVL2 cut to 2 layers (1.92 B
# parameters; its 48 layers' masters and AdamW state would not fit the
# card), 2 x (256 + 768), 3r's bucket.  (layers, batch, text tokens)
ZOO_GRAD = {"seamless-m4t-large-v2": (2, 2, 128), "internvl2-26b": (1, 1, 64)}
ZOO_TRAIN = {"seamless-m4t-large-v2": (None, 4, 512),
             "internvl2-26b": (2, 2, 768)}
ZOO_TRAIN_STEPS = 10
# 3v: OLMoE-1B-7B's fp32 masters (27.7 GB) saved by the port's save and
# served by the CLI from --ckpt with 3p's knobs; the load's device peak
# within the bf16 tree + its largest fp32 piece (a layer slice) + this
CKPT_ARCH, CKPT_PEAK_SLACK = "olmoe-1b-7b", 2**30


def zoo_cut(cfg, layers):
    """``cfg`` cut to ``layers`` decoder layers (and as many encoder layers
    for an encoder-decoder); ``None`` keeps the full depth."""
    if layers is None:
        return cfg
    enc = {"n_encoder_layers": layers} if cfg.n_encoder_layers else {}
    return cfg.replace(n_layers=layers, **enc)


def zoo_train_batch(cfg, B: int, S: int, seed: int) -> dict:
    """A training batch on the card: (B, S) seeded random ids and the
    frontend's seeded N(0, 1) fp32 embeddings, 256 patches a row for the
    VLM, ``S // enc_len_ratio`` frames a row for the encoder-decoder."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    g = torch.Generator(device=DEVICE)
    g.manual_seed(seed)
    vlm = cfg.frontend == "vision_patches"
    n = cfg.n_frontend_tokens if vlm else S // cfg.enc_len_ratio
    return {"tokens": torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (B, S)).astype(np.int32)).to(DEVICE),
            "patches" if vlm else "frames": torch.randn(
                (B, n, cfg.d_model), generator=g, device=DEVICE)}


def card_vs_cpu_grads(cfg, params, batch, what: str) -> dict:
    """One fp32 ``lm`` gradient (TF32 off) of ``params`` on the card and of
    their CPU copy, on ``batch`` (on the card) and its CPU copy: no kernel
    launched on the card, every gradient finite and non-zero, the losses
    within 1e-5 of each other and each gradient within ``GRAD_CARD_REL`` of
    its leaf's largest element (the differences taken on the card, the
    CPU's gradients copied there: exact fp32 arithmetic either side)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.train import loss_and_grads, make_loss_fn
    loss_fn = make_loss_fn(cfg, "lm")
    ops.reset_launch_counts()
    g_card, m_card = loss_and_grads(loss_fn, params, batch)
    if any(ops.launch_counts().values()):
        raise AssertionError(f"{what}: the training route launched a kernel")
    g_cpu, m_cpu = loss_and_grads(
        loss_fn, {k: v.cpu() for k, v in params.items()},
        {k: v.cpu() for k, v in batch.items()})
    worst, worst_key = 0.0, None
    for k, got in g_card.items():
        want = g_cpu.pop(k).to(DEVICE)
        scale = float(want.abs().max())
        if not bool(torch.isfinite(got).all()) or (
                scale > 0 and not bool(got.any())):
            raise AssertionError(f"{what}: {k}: gradient not finite or zero")
        rel = float((got - want).abs().max()) / max(scale, 1e-30)
        if rel > worst:
            worst, worst_key = rel, k
    loss_rel = abs(float(m_card["loss"]) - float(m_cpu["loss"])) \
        / abs(float(m_cpu["loss"]))
    if worst > GRAD_CARD_REL or loss_rel > 1e-5:
        raise AssertionError(f"{what}: card vs CPU: loss rel {loss_rel:.3g}, "
                             f"gradient {worst_key} {worst:.3g}")
    return {"loss_card": float(m_card["loss"]),
            "loss_cpu": float(m_cpu["loss"]), "loss_rel_err": loss_rel,
            "grad_max_rel_err": worst, "grad_worst_leaf": worst_key,
            "leaves": len(g_card)}


def largest_fp32_piece(cfg) -> int:
    """Bytes of the largest piece ``load_checkpoint`` reads of an fp32
    checkpoint of ``cfg``: a layer slice of a stacked leaf, or an
    unstacked leaf whole."""
    import math
    from repro_torch.models.params import STACKS, param_shapes
    return 4 * max(math.prod(s[1:] if k.startswith(STACKS) else s)
                   for k, s in param_shapes(cfg).items())


def checkpoint_roundtrip(cfg, masters, what: str) -> dict:
    """6j's last part: ``masters`` saved by ``train.checkpoint.save`` and
    read back by ``load_checkpoint`` in ``cfg.dtype`` (bf16): every leaf
    equal to its master in its use dtype bit for bit, the load's device
    peak within the tree + its largest fp32 piece + ``CKPT_PEAK_SLACK``, no
    kernel launched by either; then 3s's model-level prefill
    (``zoo_inputs``, ``last_index``) on the loaded tree gives the logits it
    gives on ``cast_params(masters)`` bit for bit."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import (cast_params, forward, load_checkpoint)
    from repro_torch.models.params import use_dtype
    from repro_torch.train import checkpoint
    ops.reset_launch_counts()
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        checkpoint.save(d, masters, cfg)
        save_s = time.perf_counter() - t0
        nbytes = os.path.getsize(os.path.join(d, "params.npz"))
        free_card()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        loaded = load_checkpoint(d, cfg, DEVICE)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
    if any(ops.launch_counts().values()):
        raise AssertionError(f"{what}: save or load launched a kernel")
    for k, v in masters.items():
        want = v.to(use_dtype(cfg, k))
        if loaded[k].dtype != want.dtype or not torch.equal(loaded[k], want):
            raise AssertionError(f"{what}: loaded {k} ({loaded[k].dtype}) != "
                                 f"its master in {want.dtype}")
    tree = sum(v.numel() * v.element_size() for v in loaded.values())
    piece = largest_fp32_piece(cfg)
    if peak > tree + piece + CKPT_PEAK_SLACK:
        raise AssertionError(f"{what}: the load's device peak {peak} past "
                             f"the tree {tree} + a piece {piece} + "
                             f"{CKPT_PEAK_SLACK}")
    batch, last = zoo_inputs(cfg)
    with torch.no_grad():
        a = forward(loaded, cfg, batch, mode="prefill",
                    cache_width=AUDIO_CONTEXT, last_index=last)["logits"]
        del loaded
        b = forward(cast_params(masters, cfg), cfg, batch, mode="prefill",
                    cache_width=AUDIO_CONTEXT, last_index=last)["logits"]
    if not (bool(torch.isfinite(a).all()) and torch.equal(a, b)):
        raise AssertionError(f"{what}: the loaded tree's prefill logits "
                             f"differ from the in-memory tree's")
    return {"file_bytes": nbytes, "save_s": save_s, "load_s": load_s,
            "load_peak_bytes": peak, "tree_bytes": tree,
            "largest_fp32_piece_bytes": piece,
            "logits_shape": list(a.shape)}


def zoo_train_path(arch: str, phase: str) -> dict:
    """Phases 6j (SeamlessM4T-large-v2) and 6k (InternVL2-26B), on the
    plain training route (``chunked_attention``; no kernel has a
    backward): ``card_vs_cpu_grads`` at ``ZOO_GRAD``'s cut and batch; then
    at ``ZOO_TRAIN``'s, fp32 masters made on the card
    (``init_params_on_device``), bf16 activations, ``make_train_step``
    (AdamW): one warm step, then ``ZOO_TRAIN_STEPS`` steps on fresh
    seeded batches, every loss finite; steps/s, target tokens/s, the peak
    memory of the masters, the AdamW state and the steps, and the idle
    share of one step under the profiler; launch counts zeroed before the
    first step and read after the last: none.  6j then saves the trained
    masters and loads them in bf16 (``checkpoint_roundtrip``)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import init_params_on_device
    from repro_torch.train import (OptimizerConfig, init_opt_state,
                                   make_train_step)
    full = get_config(arch)
    stage = {}
    t0 = time.perf_counter()
    layers, B, S = ZOO_GRAD[arch]
    c32 = zoo_cut(full, layers).replace(dtype="float32")
    p32 = init_params_on_device(c32, seed=SEED, device=DEVICE)
    grads = card_vs_cpu_grads(c32, p32, zoo_train_batch(c32, B, S, SEED + 111),
                              phase)
    del p32
    free_card()
    stage["grads"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    layers, B, S = ZOO_TRAIN[arch]
    cfg = zoo_cut(full, layers)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    masters = init_params_on_device(cfg.replace(dtype="float32"), seed=SEED,
                                    device=DEVICE)
    n_params = sum(v.numel() for v in masters.values())
    batches = [zoo_train_batch(cfg, B, S, SEED + 121 + i)
               for i in range(ZOO_TRAIN_STEPS + 1)]
    step = make_train_step(cfg, OptimizerConfig(lr=1e-5), "lm")
    opt = init_opt_state(masters)
    ops.reset_launch_counts()
    masters, opt, m = step(masters, opt, batches[0])       # warm
    losses = [m["loss"]]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for b in batches[1:]:
        masters, opt, m = step(masters, opt, b)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    sec = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated() - base
    counts = ops.launch_counts()
    losses = torch.stack(losses).tolist()
    if any(counts.values()) or not np.isfinite(losses).all():
        raise AssertionError(f"{phase}: launches {counts}, losses {losses}")
    stage["train"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    def one():
        torch.cuda.synchronize()
        t = time.perf_counter()
        step(masters, opt, batches[1])
        torch.cuda.synchronize()
        return time.perf_counter() - t
    prof = window_profile(one)
    stage["profile"] = time.perf_counter() - t0
    targets = ZOO_TRAIN_STEPS * B * (S - 1)
    out = {"grads": grads, "layers": cfg.n_layers,
           "encoder_layers": cfg.n_encoder_layers, "n_params": n_params,
           "batch": B, "seq": S, "frontend_tokens": max(
               v.shape[1] for k, v in batches[0].items() if k != "tokens"),
           "steps": ZOO_TRAIN_STEPS, "seconds": sec,
           "steps_per_s": ZOO_TRAIN_STEPS / sec,
           "target_tokens_per_s": targets / sec,
           "peak_memory_bytes": peak, "loss_first": losses[0],
           "loss_last": losses[-1], "launches": counts, "profile": prof}
    del opt, batches
    free_card()
    if cfg.n_encoder_layers:
        t0 = time.perf_counter()
        out["checkpoint"] = checkpoint_roundtrip(cfg, masters, phase)
        stage["checkpoint"] = time.perf_counter() - t0
    del masters
    free_card()
    out["stage_s"] = stage
    return out


def log_zoo_train(res: dict, phase: str, smi: str, t_start: float) -> None:
    g, p = res["grads"], res["profile"]
    log(f"  one fp32 step against the CPU port (TF32 off; {g['leaves']} "
        f"gradients): loss card {g['loss_card']:.6f}, CPU "
        f"{g['loss_cpu']:.6f} (rel {g['loss_rel_err']:.3g}); largest "
        f"gradient difference {g['grad_max_rel_err']:.3g} of its leaf's "
        f"largest element ({g['grad_worst_leaf']}; allowed {GRAD_CARD_REL}); "
        f"no kernel launched")
    enc = (f" + {res['encoder_layers']} encoder" if res["encoder_layers"]
           else "")
    idle = ("not measured" if p["idle_share"] is None
            else format(p["idle_share"], ".3f"))
    log(f"  {res['layers']}{enc} layers, {res['n_params'] / 1e9:.3f} B "
        f"parameters: {res['steps']} bf16 steps of {res['batch']} x "
        f"{res['seq']} tokens (+ {res['frontend_tokens']} frontend "
        f"embeddings a row) in {res['seconds']:.3f}s: "
        f"{res['steps_per_s']:.2f} steps/s, {res['target_tokens_per_s']:.1f}"
        f" target tokens/s; peak memory {res['peak_memory_bytes'] / 2**30:.2f}"
        f" GiB (masters, AdamW state, steps); loss {res['loss_first']:.4f} "
        f"-> {res['loss_last']:.4f}; launches {res['launches']}")
    log(f"  one step: {p['wall_s']:.4f}s wall, device busy "
        f"{p['device_busy_s']:.4f}s, idle share {idle}, {p['launches']} "
        f"device activities; top by device time:")
    for t in p["top"]:
        log(f"    {t['ms']:9.3f} ms  {t['launches']:6d}x  {t['kernel']}")
    if "checkpoint" in res:
        c = res["checkpoint"]
        log(f"  the trained masters saved ({c['file_bytes'] / 1e9:.3f} GB in "
            f"{c['save_s']:.2f}s) and loaded in bf16 ({c['load_s']:.2f}s, "
            f"device peak {c['load_peak_bytes'] / 2**30:.3f} GiB: the tree "
            f"{c['tree_bytes'] / 2**30:.3f} + a piece "
            f"{c['largest_fp32_piece_bytes'] / 2**30:.3f}): every leaf == its "
            f"master in its use dtype bit for bit; 3s's prefill logits "
            f"{c['logits_shape']} on the loaded tree == on cast_params("
            f"masters) bit for bit")
    log(f"  phase {phase} took {time.perf_counter() - t_start:.1f}s (" +
        ", ".join(f"{k} {v:.1f}s" for k, v in res["stage_s"].items())
        + f"; {smi})")


def ckpt_child_boot() -> None:
    """3v's child before its checkpoint exists: the port imported and the
    card's context made."""
    import torch
    import repro_torch.launch.serve  # noqa: F401
    torch.zeros(1, device=DEVICE)
    torch.cuda.synchronize()


def ckpt_serve_child(ckpt: str) -> dict:
    """3v's child process: ``python -m repro_torch.launch.serve --arch
    olmoe-1b-7b --ckpt CKPT`` with 3p's knobs (8 slots, ``max_context``
    1,024, 8 requests, 32 new tokens), through the CLI's ``main``; every
    request served with 3p's gates (``check_lm_run``, launch counts zeroed
    before ``main`` and read after), the engine holding the loaded
    tensors as its working weights (one copy), every loaded leaf ==
    ``init_params_on_device(cfg, SEED)`` in bf16 bit for bit (the same
    draws rounded), and the load's device peak within the tree + its
    largest fp32 piece + ``CKPT_PEAK_SLACK``."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launch
    from repro_torch.models import init_params_on_device
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = launch.main([
        "--arch", CKPT_ARCH, "--ckpt", ckpt, "--slots", str(DENSE_SLOTS),
        "--max-context", str(DENSE_CONTEXT), "--requests",
        str(DENSE_REQUESTS), "--max-new", str(DENSE_MAX_NEW), "--seed",
        str(SEED)])
    main_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    eng, load = out["engine"], out["load"]
    cfg = eng.cfg
    check_lm_run(eng, out["done"], counts, cfg, DENSE_MAX_NEW, "3v")
    if len(out["done"]) != DENSE_REQUESTS:
        raise AssertionError(f"3v: {len(out['done'])} requests served")
    held = eng.params
    if any(eng._wparams[k].data_ptr() != v.data_ptr()
           for k, v in held.items()):
        raise AssertionError("3v: the engine holds a cast copy of the model")
    ref = init_params_on_device(cfg, seed=SEED, device=DEVICE)
    for k, v in ref.items():
        if held[k].dtype != v.dtype or not torch.equal(held[k], v):
            raise AssertionError(f"3v: loaded {k} != init_params_on_device's")
    del ref
    piece = largest_fp32_piece(cfg)
    bound = load["tree_bytes"] + piece + CKPT_PEAK_SLACK
    if load["device_peak_bytes"] > bound:
        raise AssertionError(f"3v: the load's device peak "
                             f"{load['device_peak_bytes']} past {bound}")
    return {**load, "main_s": main_s,
            "checks_s": time.perf_counter() - t0 - main_s,
            "largest_fp32_piece_bytes": piece, "peak_bound": bound,
            "requests": len(out["done"]), "tokens": out["events"],
            "serve_s": out["seconds"], "ticks": eng.ticks,
            "admit_batches": eng.admit_batches, "host_syncs": eng.host_syncs,
            "launches": counts, "leaves": len(held)}


def ckpt_serve_path() -> dict:
    """Phase 3v: full-width OLMoE-1B-7B's fp32 masters made on the card
    (``init_params_on_device``, seeded) and saved by the port's
    ``train.checkpoint.save`` (one leaf, one layer slice at a time; the
    free disk under the temporary directory checked first), then served
    from ``--ckpt`` by the CLI in a subprocess (``ckpt_serve_child``,
    started first: it imports the port and makes its card context while
    the checkpoint is written); no kernel launched by the save; the save's
    and the load's seconds and rates, the load's device peak and the
    child's host memory."""
    import shutil
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import init_params_on_device
    from repro_torch.train import checkpoint
    cfg = get_config(CKPT_ARCH)
    free_card()
    # the child imports torch and starts CUDA while the checkpoint is
    # made, then waits for a line on its stdin before it runs the CLI
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); "
            "import chip_smoke; chip_smoke.ckpt_child_boot(); "
            "sys.stdin.readline(); "
            "print(json.dumps(chip_smoke.ckpt_serve_child(sys.argv[2])))")
    with tempfile.TemporaryDirectory() as d:
        proc = subprocess.Popen(
            [sys.executable, "-c", code, ROOT, d], stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=ROOT, env=dict(os.environ,
                               PYTHONPATH=os.path.join(ROOT, "src")))
        try:
            disk_free = shutil.disk_usage(d).free
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            p32 = init_params_on_device(cfg.replace(dtype="float32"),
                                        seed=SEED, device=DEVICE)
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            need = sum(v.numel() * v.element_size() for v in p32.values())
            if disk_free < need + 2**30:
                raise AssertionError(f"3v: {disk_free} bytes free under {d}, "
                                     f"the checkpoint needs {need}")
            t0 = time.perf_counter()
            checkpoint.save(d, p32, cfg)
            save_s = time.perf_counter() - t0
            del p32
            free_card()
            if any(ops.launch_counts().values()):
                raise AssertionError("3v: the save launched a kernel")
            nbytes = os.path.getsize(os.path.join(d, "params.npz"))
            t0 = time.perf_counter()
            out, err = proc.communicate("go\n", timeout=600)
            child_s = time.perf_counter() - t0
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
    if proc.returncode != 0:
        raise AssertionError(f"3v: the serving CLI exited {proc.returncode}: "
                             f"{err[-3000:]}")
    lines = out.strip().splitlines()
    res = json.loads(lines[-1])
    return {**res, "cli_lines": [ln for ln in lines[:-1]
                                 if ln.startswith(("loaded", "served"))],
            "disk_free_bytes": disk_free, "file_bytes": nbytes,
            "init_s": init_s, "save_s": save_s,
            "write_bytes_per_s": nbytes / save_s,
            "read_bytes_per_s": nbytes / res["seconds"], "child_s": child_s,
            "fp32_tree_bytes": need}


def log_ckpt_serve(res: dict, smi: str, t_start: float) -> None:
    gib = 2**30
    log(f"  fp32 masters made on the card in {res['init_s']:.2f}s; saved "
        f"{res['file_bytes'] / 1e9:.2f} GB in {res['save_s']:.2f}s "
        f"({res['write_bytes_per_s'] / 1e9:.2f} GB/s; "
        f"{res['disk_free_bytes'] / 1e9:.1f} GB were free)")
    for ln in res["cli_lines"]:
        log(f"  CLI: {ln}")
    log(f"  loaded in {res['seconds']:.2f}s ({res['read_bytes_per_s'] / 1e9:.2f}"
        f" GB/s, the file written just before: a warm read): device peak "
        f"{res['device_peak_bytes'] / gib:.3f} GiB (gate: the bf16 tree "
        f"{res['tree_bytes'] / gib:.3f} + a piece "
        f"{res['largest_fp32_piece_bytes'] / gib:.3f} + 1 = "
        f"{res['peak_bound'] / gib:.3f} GiB; fp32 tree and a cast copy "
        f"{(res['fp32_tree_bytes'] + res['tree_bytes']) / gib:.3f}); the "
        f"child's {res['host_rss_kind']} after the load "
        f"{res['host_rss_bytes'] / gib:.3f} GiB")
    log(f"  {res['requests']} requests, {res['tokens']} tokens in "
        f"{res['serve_s']:.3f}s, {res['ticks']} ticks, "
        f"{res['admit_batches']} admission batches, host_syncs "
        f"{res['host_syncs']}; launches {res['launches']}; {res['leaves']} "
        f"leaves == init_params_on_device's bf16 bit for bit, held once; the "
        f"child took {res['child_s']:.1f}s after the save (the CLI's main "
        f"{res['main_s']:.1f}s, the checks {res['checks_s']:.1f}s); phase 3v "
        f"took "
        f"{time.perf_counter() - t_start:.1f}s ({smi})")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    smi = nvidia_smi()
    # phases 3w and 3x run after phase 2 in a process of their own, which
    # boots beside the build
    lm_proc = start_lm_child()
    log("== phase 1: environment")
    log(f"  card: {smi}; {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} visible")
    log(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    # nvcc runs in its own processes: phase 3j's exports, which trace on
    # the CPU and need no kernel, run meanwhile (the build's wall time)
    built = {}

    def build_kernels():
        try:
            build.library()
        except BaseException as e:  # noqa: BLE001  (re-raised below)
            built["error"] = e
    build_thread = threading.Thread(target=build_kernels, daemon=True)
    build_thread.start()
    ssm_tmp = tempfile.TemporaryDirectory()
    ssm_proc = start_ssm_artifact_exports(ssm_tmp.name)
    try:
        art_tmp = tempfile.TemporaryDirectory()
        exports = artifact_exports(art_tmp.name)
        log(f"  phase 3j's exports traced in {time.perf_counter() - t0:.1f}s"
            f" while the kernels built")
        build_thread.join()
        if "error" in built:
            raise built["error"]
        ssm_exports = finish_ssm_artifact_exports(ssm_proc)
    finally:
        if ssm_proc.poll() is None:
            ssm_proc.kill()
            ssm_proc.wait(timeout=60)
    log(f"  phase 3t's and 3n's exports (a process of their own) done at "
        f"{time.perf_counter() - t0:.1f}s: " + ", ".join(
            f"{a} {e['export_s']:.1f}s" for a, e in ssm_exports.items()))
    log(f"  kernels built in {time.perf_counter() - t0:.1f}s "
        f"(nvcc {build.last_build.get('seconds', 0.0):.1f}s)")
    for line in str(build.last_build.get("log", "")).splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            log("    " + line.strip())

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED)
    phase_done("1")
    log("== phase 2: kernels against their plain versions on the card")
    errs = {"tte_sample": check_tte(gen), "flash_attention": check_flash(gen),
            "flash_attention positions": check_flash_positions(gen),
            "paged_decode_attention": check_paged(gen)}
    ssd_errs = check_ssd(gen)
    errs["ssd_intra"] = ssd_errs["main"]
    moe_check = check_moe(gen)

    phase_done("2")
    log("== phases 3w, 3x: the last dense LMs of the zoo at full width and "
        "depth, with their timing rows, in a process of their own (a card "
        "with nothing else on it: 3w's long prompt needs ~72 GiB)")
    lm = lm_phases(lm_proc)
    phase_done("3w 3x")
    log("== phase 3: Delphi path (Delphi-2M bf16, ring BatchedEngine, 16 "
        "slots)")
    main_res = main_path()
    eng, sec = main_res["engine"], main_res["seconds"]
    log(f"  {len(main_res['done'])} requests, {main_res['events']} events, "
        f"{eng.ticks} ticks, {eng.admit_batches} admission batches in "
        f"{sec:.3f}s: {main_res['events'] / sec:.1f} events/s, "
        f"{eng.ticks / sec:.1f} ticks/s; host_syncs {eng.host_syncs}; "
        f"prefill shapes {sorted(eng.prefill_shapes)}; launches "
        f"{main_res['launches']}")

    phase_done("3")
    log("== phase 3c: paged Delphi path (Delphi-2M bf16, paged "
        "BatchedEngine, 16 slots, 16-token blocks, 257 blocks)")
    paged = main_path("paged")
    peng, psec = paged["engine"], paged["seconds"]
    if [(r.out_tokens, r.out_ages) for r in paged["done"]] != \
            [(r.out_tokens, r.out_ages) for r in main_res["done"]]:
        raise AssertionError("the paged path's trajectories differ from the "
                             "ring path's")
    pst = peng.pool_stats()
    log(f"  {len(paged['done'])} requests, {paged['events']} events, "
        f"{peng.ticks} ticks, {peng.admit_batches} admission batches in "
        f"{psec:.3f}s: {paged['events'] / psec:.1f} events/s, "
        f"{peng.ticks / psec:.1f} ticks/s (ring, phase 3: "
        f"{main_res['events'] / sec:.1f} events/s, {eng.ticks / sec:.1f} "
        f"ticks/s); host_syncs {peng.host_syncs}; paged_decode_attention "
        f"{paged['launches']['paged_decode_attention'] / peng.ticks:.1f} "
        f"launches a tick; blocks_peak_used {pst['blocks_peak_used']} of "
        f"{pst['blocks'] - 1}; cache_bytes {pst['cache_bytes']} (ring "
        f"{eng.cache_bytes}); trajectories equal phase 3's; launches "
        f"{paged['launches']}")
    # wall time varies with the host: ring and paged in turns, one call
    from repro_torch.launch import serve as launch
    turns = []
    for cache in ("ring", "paged", "paged", "ring"):
        o = launch.serve(serve_args(32, 48, cache))
        turns.append((cache, o["events"] / o["seconds"]))
    log("  in turns, events/s: " + ", ".join(f"{c} {r:.1f}"
                                             for c, r in turns))

    phase_done("3c")
    log("== phase 3d: futures (Delphi-2M bf16, prefix-cached paged "
        f"BatchedEngine, 16 slots): {FUTURES_PATIENTS} patients x "
        f"{FUTURES_N} futures x {FUTURES_MAX_NEW} events, each patient twice")
    fut = futures_path()
    feng, fsec, fst = fut["engine"], fut["seconds"], fut["stats"]
    log(f"  {len(fut['prompt_lengths'])} patients (prompts "
        f"{fut['prompt_lengths']} events), {fut['events']} future events, "
        f"{feng.ticks} ticks, {feng.admit_batches} admission batches in "
        f"{fsec:.3f}s: {fut['events'] / fsec:.1f} events/s, "
        f"{feng.ticks / fsec:.1f} ticks/s; host_syncs {feng.host_syncs}; "
        f"forks {fst['forks']}, cow_copies {fst['cow_copies']}, "
        f"shared_blocks_peak {fst['shared_blocks_peak']}, blocks_peak_used "
        f"{fst['blocks_peak_used']} (64 unshared admissions: "
        f"{fut['unshared_blocks']} blocks for their prompts alone); prefix "
        f"hits {fst['prefix_cache']['hits']} of 8 parents, prefill shapes "
        f"{sorted(feng.prefill_shapes)}; launches {fut['launches']}; no "
        f"block or refcount left after drop_prefix_cache()")

    phase_done("3d")
    log(f"== phase 3e: mixed long/short traffic (Delphi-2M bf16, paged "
        f"BatchedEngine, {MIXED_SLOTS} slots, max_context 256, 16-token "
        f"blocks, {MIXED_BLOCKS} blocks): {MIXED_SHORT} short requests "
        f"(6-event prompts, 48 new) and {MIXED_LONG} long ones "
        f"({MIXED_S_LONG}-event prompts, 4 new), one long every 8 steps from "
        f"step 3; monolithic and chunked ({MIXED_CHUNK} tokens a step) in "
        f"turns")
    mixed = mixed_path()
    for mode, r in mixed["runs"]:
        log(f"  {mode}: {r['events']} events in {r['wall_s']:.3f}s: "
            f"{r['events_per_s']:.1f} events/s; short requests' per-event "
            f"latency p50 {r['p50_ms']:.3f} ms, p95 {r['p95_ms']:.3f} ms "
            f"({r['short_events']} events); {r['ticks']} ticks, "
            f"{r['admit_batches']} admission batches, host_syncs "
            f"{r['host_syncs']} (= ticks + admission batches); chunks "
            f"{r['chunks']}; pool drained")
    mst = mixed["stats"]
    log(f"  chunked engine over its 3 drives: chunked_prefills "
        f"{mst['chunked_prefills']}, prefill_chunks {mst['prefill_chunks']}, "
        f"chunk shapes (kind, context blocks, width) "
        f"{mixed['chunk_shapes']}; monolithic prefill shapes "
        f"{mixed['monolithic_shapes']}; launches of the first timed chunked "
        f"drive {mixed['launches']}")

    phase_done("3e")
    log("== phase 3f: partial-hit suffix prefill (prefix-cached chunked "
        "engine): a 200-event prompt, then a 240-event prompt extending it")
    sfx = suffix_path(fut["params"], fut["cfg"])
    log(f"  suffix_tokens_saved {sfx['stats']['suffix_tokens_saved']} (the "
        f"matched block-aligned prefix: {sfx['matched']}), the suffix in "
        f"{sfx['suffix_chunks']} chunk; prefix partial hits "
        f"{sfx['stats']['prefix_cache']['partial_hits']}; shapes "
        f"{sfx['shapes']}; no block left after drop_prefix_cache()")

    phase_done("3f")
    log("== phase 3g: HTTP serving (Delphi-2M bf16, EngineBackend on its "
        "background loop behind InferenceServer: 16 slots, paged, prefix "
        f"cache): {HTTP_REQUESTS} prompts x {HTTP_MAX_NEW} events from "
        f"{HTTP_CLIENTS} clients, {HTTP_STREAMS} streams, futures, risk")
    t3g = time.perf_counter()
    http = http_path(fut["params"], fut["cfg"], fut["patients"])
    hp = http["profile"]
    log(f"  /v1/generate: {http['events']} events in {http['wall_s']:.3f}s:"
        f" {http['events_per_s']:.1f} events/s; {http['ticks']} ticks, "
        f"{http['admit_batches']} admission batches, host_syncs "
        f"{http['host_syncs']}; launches {http['launches']}")
    log("  in turns, events/s: " + ", ".join(
        f"{m} {r:.1f}" for m, r in http["turns"])
        + f"; HTTP / in-process {http['http_over_inprocess']:.3f}")
    log(f"  SSE time to first event over {http['sse_streams']} streams "
        f"(listen backlog {http['sse_backlog']}): p50 "
        f"{http['sse_ttfe_p50_ms']:.2f} ms, p95 "
        f"{http['sse_ttfe_p95_ms']:.2f} ms; with the stdlib's backlog of 5, "
        f"in turns (5, {http['sse_backlog']}, {http['sse_backlog']}, 5): p50 "
        f"{http['sse_ttfe_backlog5_p50_ms']:.2f} ms, p95 "
        f"{http['sse_ttfe_backlog5_p95_ms']:.2f} ms; futures events "
        f"{http['futures_events']}; /v1/risk == core/risk.py (max rel err "
        f"{http['risk_max_rel_err']:.3g})")
    log(f"  one HTTP run under the profiler: device busy "
        f"{hp['device_busy_s']:.4f}s of {hp['wall_s']:.3f}s wall, idle share"
        f" {'not measured' if hp['idle_share'] is None else format(hp['idle_share'], '.3f')}")
    log(f"  fresh server == twin engine bit for bit on {HTTP_EXACT} "
        f"prompts ({http['exact']['generate_events']} events), stream == "
        f"generate, futures == ring_reference_futures "
        f"({http['exact']['futures_events']} events); CLI booted in "
        f"{http['cli']['boot_s']:.1f}s, exit {http['cli']['exit_code']} on "
        f"SIGINT ({http['cli']['lines'][0]})")
    log(f"  phase 3g took {time.perf_counter() - t3g:.1f}s")
    phase_done("3g")
    log("== phase 3h: the router on one card (RouterServer over 2 "
        "in-process paged replicas)")
    t3h = time.perf_counter()
    rtr = router_path(fut["params"], fut["cfg"], fut["patients"])
    log(f"  futures visits: first {rtr['visits'][0]}, second "
        f"{rtr['visits'][1]}; scheduler {rtr['scheduler']}; drained r0 "
        f"under load with every request answered; router == direct bit "
        f"for bit on {rtr['exact_prompts']} prompts")
    log(f"  phase 3h took {time.perf_counter() - t3h:.1f}s")
    phase_done("3h")
    log(f"== phase 3i: cohort sweep (Delphi-2M bf16, ScenarioEngine over "
        f"EngineBackend, phase 3d's knobs): {SWEEP_PATIENTS} patients x "
        f"{SWEEP_FUTURES} futures x {SWEEP_MAX_NEW} events, "
        f"{SWEEP_IN_FLIGHT} in flight")
    t3i = time.perf_counter()
    coh = cohort_path(fut["params"], fut["cfg"])
    cp = coh["profile"]
    log(f"  {coh['patients']} patients, {coh['events']} events in "
        f"{coh['wall_s']:.3f}s: {coh['patients_per_s']:.2f} patients/s, "
        f"{coh['events_per_s']:.1f} events/s; per-patient latency p50 "
        f"{coh['patient_latency_p50_s']:.3f}s, p95 "
        f"{coh['patient_latency_p95_s']:.3f}s; prefix hit rate "
        f"{coh['prefix_hit_rate']:.3f}; launches {coh['launches']}")
    log(f"  assert_sweep_parity bit for bit on the first {SWEEP_EXACT} "
        f"patients: bf16 {coh['exact']['bfloat16']}, fp32 "
        f"{coh['exact']['float32']}; counterfactual: "
        f"{coh['counterfactual']['arms']} arms over a "
        f"{coh['counterfactual']['history']}-event history, prefix hits "
        f"{coh['counterfactual']['arm_hits']} (one per arm), shared "
        f"{coh['counterfactual']['shared']}")
    log(f"  the first 16 patients' sweep under the profiler: device busy "
        f"{cp['device_busy_s']:.4f}s of {cp['wall_s']:.3f}s wall, idle share"
        f" {'not measured' if cp['idle_share'] is None else format(cp['idle_share'], '.3f')}")
    log(f"  phase 3i took {time.perf_counter() - t3i:.1f}s ({smi})")
    phase_done("3i")
    log(f"== phase 3u: the reference engine (the seed host-loop "
        f"ReferenceEngine, full-width Delphi-2M bf16, {REF_SLOTS} slots, "
        f"max_context {REF_CONTEXT}): {REF_PROMPTS} synthetic prompts of at "
        f"most {REF_MAX_EVENTS} events, {REF_MAX_NEW} new events each; the "
        f"ring BatchedEngine on the same prompts")
    refe = reference_engine_path()
    log(f"  {refe['requests']} requests, {refe['events']} events in "
        f"{refe['wall_s']:.3f}s, {refe['decodes']} decode calls; launches "
        f"{refe['launches']} (12 flash an admission, 12 paged a decode "
        f"call, one tte_sample an event)")
    log("  in turns, events/s: " + ", ".join(
        f"{m} {v:.1f}" for m, v in refe["turns"])
        + f"; batched / reference {refe['batched_over_reference']:.2f}x "
        f"({smi})")
    log("  idle share of a drive: " + ", ".join(
        f"{n} {refe['idle_share'][n]} (device busy "
        f"{refe['device_busy_s'][n]:.4f}s of {refe['profiled_wall_s'][n]:.3f}"
        f"s)" for n in ("reference", "batched")))
    phase_done("3u")
    log(f"== phase 3j: the SDK artifact (full-width Delphi-2M through "
        f"torch.export, spec v2 in bf16 at {ARTIFACT_BF16_LAYERS} layers, v2 "
        f"and v1 in fp32 at {ARTIFACT_FP32_LAYERS}, traced on the CPU in "
        f"phase 1; "
        f"Runtime on the card)")
    t3j = time.perf_counter()
    art = artifact_path(exports)
    art_tmp.cleanup()
    bart = art["dtypes"]["bfloat16"]
    log_artifact(art)
    log(f"  phase 3j took {time.perf_counter() - t3j:.1f}s ({smi})")

    phase_done("3j")
    log(f"== phase 3k: TinyLlama-1.1B at full width (22 layers, d_model "
        f"2048, 32/4 heads, hd 64, V 32000; bf16), BatchedEngine("
        f"slots={DENSE_SLOTS}, max_context={DENSE_CONTEXT}): "
        f"{DENSE_REQUESTS} requests of seeded random ids (64-768 tokens), "
        f"{DENSE_MAX_NEW} new tokens each, ring then prefix-cached paged")
    t3k = time.perf_counter()
    tiny = tinyllama_path()
    for name, r in tiny["runs"].items():
        log(f"  {name}: {r['tokens']} tokens, {r['ticks']} ticks, "
            f"{r['admit_batches']} admission batches in {r['seconds']:.3f}s:"
            f" {r['tokens_per_s']:.1f} tokens/s; host_syncs "
            f"{r['host_syncs']}; prefill shapes {r['prefill_shapes']}; "
            f"launches {r['launches']} (22 flash an admission batch, 22 "
            f"paged a tick, no tte_sample)")
    tp = tiny["profile"]
    log(f"  under injected uniforms: ring == paged bit for bit "
        f"({tiny['exact_tokens']} tokens); chunked ({DENSE_CHUNK} tokens a "
        f"step) == unchunked bit for bit on the requests of "
        f"{tiny['solo_prompt_lengths']} tokens served alone; served "
        f"together, {tiny['concurrent_chunked_equal']} of {DENSE_REQUESTS} "
        f"chunked requests equal their monolithic run's; pool drained; one "
        f"ring run under the profiler: device busy "
        f"{tp['device_busy_s']:.4f}s of {tp['wall_s']:.3f}s wall, idle share"
        f" {'not measured' if tp['idle_share'] is None else format(tp['idle_share'], '.3f')}"
        f"; weights made in {tiny['init_s']:.1f}s; phase 3k took "
        f"{time.perf_counter() - t3k:.1f}s ({smi})")
    phase_done("3k")
    log(f"== phase 3l: H2O-Danube-1.8B at full width ({DANUBE_LAYERS} of 24 "
        f"layers, d_model "
        f"2560, 32/8 heads, hd 80, window 4096; bf16): one "
        f"{DANUBE_PROMPT}-token prompt, max_context {DANUBE_CONTEXT}, "
        f"{DANUBE_MAX_NEW} new tokens, ring and paged")
    t3l = time.perf_counter()
    danube = danube_path()
    log(f"  last prefill position's logits against the fp32 model (plain "
        f"route, TF32 off; largest |logit| {danube['logits_scale']:.4g}): "
        f"kernels' route in bf16 off by {danube['logits_err']:.4g}, the "
        f"plain route in bf16 by {danube['plain_err']:.4g} (allowed "
        f"{DENSE_LOGITS_VS_PLAIN}x it), kernels vs plain "
        f"{danube['kernel_vs_plain']:.4g}; against no window: "
        f"{danube['no_window_diff']:.4g} (the window bites); one prefill "
        f"{danube['prefill_s']:.3f}s, launches {danube['prefill_launches']}")
    for name, r in danube["runs"].items():
        log(f"  {name}: {DANUBE_MAX_NEW} tokens, {r['ticks']} ticks in "
            f"{r['seconds']:.3f}s; prefill shapes {r['prefill_shapes']}; "
            f"launches {r['launches']}")
    log(f"  ring ({danube['runs']['ring']['layer0_width']} wide, the window)"
        f" and paged ({DANUBE_CONTEXT:,}-token tables): "
        f"{danube['equal_before_divergence']}"
        f" tokens equal before the first divergence (divergences "
        f"{danube['divergences']}); each run held step by step against the "
        f"model's full forward: {danube['held_steps']} steps, near-ties "
        f"{danube['near_ties']} (score margin {danube['margin']:.4g}, twice "
        f"the kernels' bf16 logits error); phase 3l took "
        f"{time.perf_counter() - t3l:.1f}s ({smi})")
    phase_done("3l")
    log("== phase 3m: Delphi-100M served at full width (16 layers, d_model "
        "768, hd 64; bf16) through repro_torch.launch.serve: 32 patient "
        "prompts, 16 slots, 48 new events, ring")
    t3m = time.perf_counter()
    d100 = delphi100m_path()
    log(f"  {d100['events']} events, {d100['ticks']} ticks, "
        f"{d100['admit_batches']} admission batches in {d100['seconds']:.3f}"
        f"s: {d100['events_per_s']:.1f} events/s; host_syncs "
        f"{d100['host_syncs']}; prefill shapes {d100['prefill_shapes']}; "
        f"launches {d100['launches']}; took "
        f"{time.perf_counter() - t3m:.1f}s")
    phase_done("3m")
    log(f"== phase 3n: the generic-LM artifact (TinyLlama at full width, "
        f"depth cut to {LM_ARTIFACT_LAYERS} layers, spec v2, bf16, seq_len "
        f"{LM_ARTIFACT_SEQ})")
    t3n = time.perf_counter()
    lmart = lm_artifact_path(ssm_tmp.name, ssm_exports["3n"])
    log(f"  exported in {lmart['export']['export_s']:.1f}s (phase 1) "
        f"({lmart['export']['bytes']} bytes), loaded in "
        f"{lmart['load_s']:.1f}s; full, prefill and "
        f"{lmart['decode_steps']} decode steps == eager bit for bit through "
        f"the repro_torch:: operators; ArtifactBackend == "
        f"LocalBackend.stream, {lmart['held_steps']} tokens held against "
        f"the eager model ({lmart['near_ties']} near-ties, margin "
        f"{LM_MARGIN}); {lmart['ms_per_token']:.2f} ms a token (local "
        f"stream {lmart['local_ms_per_token']:.2f}); launches on the drive "
        f"{lmart['launches']}; took {time.perf_counter() - t3n:.1f}s "
        f"({smi})")

    phase_done("3n")
    log(f"== phase 3o: Zamba2-1.2B at full width (38 Mamba2 layers, d_model "
        f"2048, N 64, 64 SSD heads; one shared attention block, 32/32 heads "
        f"of 64, window 4096, applied 7 times; V 32000; bf16), BatchedEngine("
        f"slots={ZAMBA_SLOTS}, max_context={ZAMBA_CONTEXT}): phase 3b's "
        f"{MAMBA_REQUESTS} prompts of seeded random ids (96-1024 tokens), "
        f"{ZAMBA_MAX_NEW} new tokens each, ring")
    t3o = time.perf_counter()
    zamba = zamba2_path()
    zr, zp, zl = zamba["run"], zamba["profile"], zamba["logits"]
    log(f"  {zr['tokens']} tokens, {zr['ticks']} ticks, "
        f"{zr['admit_batches']} admissions in {zr['seconds']:.3f}s: "
        f"{zr['tokens_per_s']:.1f} tokens/s; host_syncs {zr['host_syncs']}; "
        f"prefill shapes (1, S) for S in {zr['prompt_lengths']}; launches "
        f"{zr['launches']} (38 ssd_intra and 7 flash an admission, 7 paged "
        f"a tick, no tte_sample)")
    log(f"  a held parent ({zamba['forks']['prompt_tokens']} tokens, parked "
        f"{zamba['forks']['parked_ticks']} ticks beside other traffic) "
        f"forked into {ZAMBA_FORKS} children == {ZAMBA_FORKS} immediate "
        f"forks bit for bit ({zamba['forks']['tokens']} tokens, injected "
        f"uniforms)")
    log(f"  last prefill position's logits of a {zl['prompt_tokens']}-token "
        f"prompt against the fp32 model (plain route, TF32 off; largest "
        f"|logit| {zl['logits_scale']:.4g}): kernels' route in bf16 off by "
        f"{zl['logits_err']:.4g}, the plain route in bf16 by "
        f"{zl['plain_err']:.4g} (allowed {DENSE_LOGITS_VS_PLAIN}x it), "
        f"kernels vs plain {zl['kernel_vs_plain']:.4g}")
    zidle = ("not measured" if zp["idle_share"] is None
             else format(zp["idle_share"], ".3f"))
    log(f"  the first {PROFILE_REQUESTS} prompts x {PROFILE_MAX_NEW} tokens "
        f"under the profiler: device busy "
        f"{zp['device_busy_s']:.4f}s of {zp['wall_s']:.3f}s wall, idle share"
        f" {zidle}"
        f", {zp['launches']} device activities; weights made in "
        f"{zamba['init_s']:.1f}s; phase 3o took "
        f"{time.perf_counter() - t3o:.1f}s (" + ", ".join(
            f"{k} {v:.1f}s" for k, v in zamba["stage_s"].items())
        + f"; {smi})")
    for t in zp["top"]:
        log(f"    {t['ms']:9.3f} ms  {t['launches']:6d}x  {t['kernel']}")

    phase_done("3o")
    log(f"== phase 3t: the recurrent artifact at full width (Mamba2-780M "
        f"cut to {SSM_ARTIFACT_LAYERS['mamba2-780m']} layers, Zamba2-1.2B "
        f"to {SSM_ARTIFACT_LAYERS['zamba2-1.2b']}; spec v2, bf16, seq_len "
        f"{SSM_ARTIFACT_SEQ}), prompts of {SSM_ARTIFACT_PROMPTS} tokens")
    t3t = time.perf_counter()
    ssmart = ssm_artifact_phase(ssm_tmp.name, ssm_exports)
    ssm_tmp.cleanup()
    log_ssm_artifact_phase(ssmart, "3t", smi, t3t)

    phase_done("3t")
    log("== phase 3b: Mamba2 path (Mamba2-780M bf16, BatchedEngine, 8 "
        "slots)")
    mamba = mamba_path()
    meng, msec = mamba["engine"], mamba["seconds"]
    log(f"  {MAMBA_REQUESTS} requests, {mamba['tokens']} tokens, "
        f"{meng.ticks} ticks, {meng.admit_batches} admissions in {msec:.3f}s"
        f": {mamba['tokens'] / msec:.1f} tokens/s, {meng.ticks / msec:.1f} "
        f"ticks/s; host_syncs {meng.host_syncs}; prefill shapes "
        f"{sorted(meng.prefill_shapes)}; launches {mamba['launches']}")

    phase_done("3b")
    log("== phase 4: end-to-end parity, fp32, card vs CPU")
    # phase 6i's subprocess and phase 7's scripts run beside phase 4's
    # untimed checks
    launch_started = start_launch_check()
    examples_started = start_examples()
    try:
        par = parity()
        mpar = mamba_parity()
        log("== phase 4 (paged): ring == paged and fork == oracle on the "
            "card, injected uniforms")
        ppar = paged_parity()
        log("== phase 4 (chunked): the paged engine == chunked_reference_"
            "trajectory on the card, injected uniforms")
        cpar = chunked_parity()
        log("== phase 4 (risk): risk on the card")
        rsk = risk_checks(fut)
    except BaseException:
        launch_started[0].kill()
        launch_started[0].wait(timeout=60)
        stop_examples(examples_started)
        raise
    try:
        lch = launch_check(launch_started)
    except BaseException:
        stop_examples(examples_started)
        raise

    phase_done("4")
    log("== phase 7: the eight examples (scripts/torch_examples_smoke.py "
        "--device cuda) and, beside them, the paged-parity and router round "
        "trips, each in its own process, started beside phase 4")
    exm = examples_path(examples_started)
    log_examples(exm, smi)
    phase_done("7")
    log("== phase 6a: gradients on the card (Delphi-2M fp32, TF32 off, "
        f"{TRAIN_BATCH} x {TRAIN_SEQ}) against the CPU port")
    t6 = time.perf_counter()
    grd = grads_path()
    log(f"  loss card {grd['loss_card']:.6f}, CPU {grd['loss_cpu']:.6f} "
        f"(rel {grd['loss_rel_err']:.3g}); {grd['leaves']} gradients finite "
        f"and non-zero, largest difference {grd['grad_max_rel_err']:.3g} of "
        f"its leaf's largest element ({grd['grad_worst_leaf']}; allowed "
        f"{GRAD_CARD_REL}); no kernel launched; took "
        f"{time.perf_counter() - t6:.1f}s")
    phase_done("6a")
    log(f"== phase 6b: training at full width (python -m "
        f"repro_torch.launch.train --arch delphi-2m, bf16 over fp32 "
        f"masters, {TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ}, "
        f"{TRAIN_PATIENTS} patients)")
    t6 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        trn = train_path(os.path.join(tmp, "run"))
        tp = trn["profile"]
        log(f"  {trn['steps']} steps in {trn['seconds']:.3f}s: "
            f"{trn['steps_per_s']:.2f} steps/s, "
            f"{trn['target_tokens_per_s']:.1f} target tokens/s "
            f"({trn['target_tokens']} targets, evaluations included); peak "
            f"memory {trn['peak_memory_bytes'] / 2**20:.1f} MiB above what "
            f"the earlier phases hold; loss first "
            f"20 steps {trn['loss_first20']:.4f}, last 20 "
            f"{trn['loss_last20']:.4f}; no kernel launched")
        log(f"  10 steps: {trn['ten_steps_wall_s']:.4f}s wall, device busy "
            f"{tp['device_busy_s']:.4f}s, idle share "
            f"{'not measured' if tp['idle_share'] is None else format(tp['idle_share'], '.3f')}"
            f", {tp['launches']} device activities; top by device time:")
        for t in tp["top"]:
            log(f"    {t['ms']:9.3f} ms  {t['launches']:6d}x  {t['kernel']}")
        log(f"  the server on --ckpt answered a generate "
            f"({trn['served_events']} events); took "
            f"{time.perf_counter() - t6:.1f}s ({smi})")
        phase_done("6b")
        log(f"== phase 6c: federated fine-tuning ({FED_CLIENTS} clients, "
            f"{FED_ROUNDS} rounds x {FED_LOCAL_STEPS} local steps, delta "
            f"clip {FED_CLIP})")
        fedr = federated_path()
        log(f"  mean client loss by round {fedr['client_loss']}; "
            f"{fedr['seconds_per_round']:.3f}s a round ({smi})")
        phase_done("6c")
        log(f"== phase 6d: the canary loop over HTTP ({CANARIES} canaries, "
            f"{CANARIES // 2} planted x {CANARY_REPEATS}, full-width Delphi "
            f"trained {CANARY_STEPS} steps, EngineBackend behind "
            f"InferenceServer, the audit CLI as a subprocess)")
        t6 = time.perf_counter()
        can = canary_path(tmp)
    log(f"  MI AUC {can['mi_auc']:.3f} [{can['mi_auc_ci'][0]:.3f}, "
        f"{can['mi_auc_ci'][1]:.3f}], extraction member "
        f"{can['member_extraction_rate']:.2f} vs held-out "
        f"{can['nonmember_extraction_rate']:.2f} (gap "
        f"{can['extraction_gap']:+.2f}); trained in {can['train_s']:.1f}s, "
        f"audit {can['audit_s']:.1f}s; launches on the audit "
        f"{can['launches']}; took {time.perf_counter() - t6:.1f}s ({smi})")
    trn.pop("params")
    trn.pop("cfg")
    phase_done("6d")
    log(f"== phase 6e: Delphi-100M training at S {LONG_SEQ} (the blocked "
        f"attention route)")
    t6 = time.perf_counter()
    lgr = long_grads_path()
    log(f"  one fp32 step, 2 x {LONG_SEQ}, depth cut to 2 layers, TF32 "
        f"off: loss card {lgr['loss_card']:.6f}, CPU {lgr['loss_cpu']:.6f} "
        f"(rel {lgr['loss_rel_err']:.3g}); {lgr['leaves']} gradients, "
        f"largest difference {lgr['grad_max_rel_err']:.3g} of its leaf's "
        f"largest element ({lgr['grad_worst_leaf']}; allowed "
        f"{GRAD_CARD_REL})")
    ltr = long_train_path()
    log(f"  python -m repro_torch.launch.train --arch delphi-100m --seq-len "
        f"{LONG_SEQ}: {ltr['steps']} bf16 steps of {LONG_BATCH} x "
        f"{LONG_SEQ} in {ltr['seconds']:.3f}s: {ltr['steps_per_s']:.2f} "
        f"steps/s, {ltr['target_tokens_per_s']:.1f} target tokens/s; peak "
        f"memory {ltr['peak_memory_bytes'] / 2**20:.1f} MiB; loss "
        f"{ltr['loss_first']:.4f} -> {ltr['loss_last']:.4f}; took "
        f"{time.perf_counter() - t6:.1f}s ({smi})")

    phase_done("6e")
    ssm_train = {}
    for ph, arch in (("6f", "mamba2-780m"), ("6g", "zamba2-1.2b")):
        log(f"== phase {ph}: {arch} training (the plain SSD route)")
        t6 = time.perf_counter()
        st = ssm_train[ph] = ssm_train_path(arch)
        g, rt, c = st["grads"], st["route"], st["cli"]
        log(f"  one fp32 step, {SSM_GRAD_BATCH} x {SSM_GRAD_SEQ}, full width "
            f"cut to {SSM_GRAD_LAYERS} layers, TF32 off: loss card "
            f"{g['loss_card']:.6f}, CPU {g['loss_cpu']:.6f} (rel "
            f"{g['loss_rel_err']:.3g}); {g['leaves']} gradients, largest "
            f"difference {g['grad_max_rel_err']:.3g} of its leaf's largest "
            f"element ({g['grad_worst_leaf']}; allowed {GRAD_CARD_REL}); no "
            f"kernel launched")
        log(f"  plain SSD route vs the kernel route at full width "
            f"({rt['shape']}): y {rt['err_y']:.3g} (|y| <= "
            f"{rt['y_scale']:.3g}), h {rt['err_h']:.3g} (|h| <= "
            f"{rt['h_scale']:.3g}); tol {SSM_ROUTE_TOL}")
        cp = c["profile"]
        log(f"  python -m repro_torch.launch.train --arch {arch}: {c['steps']}"
            f" bf16 steps of {c['batch']} x {c['seq']} at full depth in "
            f"{c['seconds']:.3f}s: {c['steps_per_s']:.2f} steps/s, "
            f"{c['target_tokens_per_s']:.1f} target tokens/s; peak memory "
            f"{c['peak_memory_bytes'] / 2**20:.1f} MiB; loss "
            f"{c['loss_first']:.4f} -> {c['loss_last']:.4f}; launches "
            f"{c['launches']}")
        cidle = ("not measured" if cp["idle_share"] is None
                 else format(cp["idle_share"], ".3f"))
        log(f"  one step: {cp['wall_s']:.4f}s wall, device busy "
            f"{cp['device_busy_s']:.4f}s, idle share {cidle}"
            f", {cp['launches']} device activities; the CLI's call "
            f"{c['cli_wall_s']:.1f}s; took {time.perf_counter() - t6:.1f}s ("
            + ", ".join(f"{k} {v:.1f}s" for k, v in st["stage_s"].items())
            + f"; {smi})")
        for t in cp["top"]:
            log(f"    {t['ms']:9.3f} ms  {t['launches']:6d}x  {t['kernel']}")
        phase_done(ph)

    log(f"== phase 6h: MoE training (Qwen2-MoE-A2.7B at full width cut to "
        f"{MOE_TRAIN_LAYERS} layers, {MOE_TRAIN_BATCH} x {MOE_TRAIN_SEQ}, "
        f"bf16 over fp32 masters): moe_impl dense_scan and ragged, remat "
        f"off and on")
    mtr = moe_train_path()
    ly = mtr["layer"]
    log(f"  one layer, {ly['tokens']} tokens ({ly['flips']} whose experts "
        f"flip in bf16 left out), bf16 gradients against the fp32 "
        f"dense_scan's, largest difference of a leaf's largest |g| (allowed "
        f"{MOE_GRAD_REL}): " + "; ".join(
            f"{impl} {ly[impl]['worst']:.3g} ({ly[impl]['worst_leaf']}; "
            + ", ".join(f"{n.split('/', 1)[-1]} {v:.3g}"
                        for n, v in ly[impl]["rel"].items()) + ")"
            for impl in ("dense_scan", "ragged"))
        + f"; ragged with its weight gradient's group boundaries one row "
        f"off would read {ly['ragged_rows_off']['worst']:.3g} "
        f"({ly['ragged_rows_off']['worst_leaf']})")
    log(f"  {mtr['n_params'] / 1e9:.3f} B parameters made in "
        f"{mtr['init_s']:.1f}s; loss dense_scan {mtr['loss_dense_scan']:.6f},"
        f" ragged {mtr['loss_ragged']:.6f} (rel {mtr['loss_rel_err']:.3g}, "
        f"allowed {MOE_TRAIN_LOSS_REL}); largest gradient difference "
        f"{mtr['grad_max_rel_err']:.3g} of its leaf's largest |g| "
        f"({mtr['grad_worst_leaf']}); tokens whose experts differ by "
        f"layer {mtr['flips_by_layer']}; with ragged held to dense_scan's "
        f"experts {mtr['grad_held_rel_err']:.3g} on that leaf, "
        f"{mtr['grad_held_max_rel_err']:.3g} at most (allowed "
        f"{MOE_GRAD_REL}); ragged's grouped "
        f"product {mtr['grouped_product']}; no kernel launched")
    for name, r in mtr["runs"].items():
        log(f"  {name}: one step {r['step_s']:.3f}s, peak memory "
            f"{r['peak_memory_bytes'] / 2**30:.2f} GiB, loss "
            f"{r['loss']:.6f} ({smi})")
    phase_done("6h")
    log("== phase 6i: the launch layer on the card (a subprocess, run "
        "beside phase 4: NCCL group of one on the loopback address, "
        "ensure_distributed, 1 x 1 DeviceMesh, Delphi-2M's parameters as "
        "DTensors)")
    log(f"  devices {lch['devices']}, all-reduce {lch['all_reduce']}, "
        f"{lch['mesh']}, {lch['leaves']} leaves placed as "
        f"{lch['placements']}; logits through the placed parameters' local "
        f"tensors == the plain ones bit for bit: {lch['logits_equal']}; the "
        f"tied head on the DTensors ({lch['dtensor_head_type']} out) == on "
        f"the plain tensors bit for bit: {lch['dtensor_head_equal']}; "
        f"{lch['wall_s']:.1f}s")
    for key, what in (("sharded", "sharded step"),
                      ("moe_sharded", "MoE dispatches")):
        shd = lch[key]
        log(f"  {what}: {shd['arch']} at {shd['layers']} layers, bf16 on the "
            f"1 x 1 mesh, parameters, batch and ring cache placed by "
            f"distribute_tree; a prefill of {shd['batch']} x {shd['seq']} and "
            f"{shd['steps']} decode steps on the DTensors == the plain "
            f"{shd['plain_impl']} route bit for bit; launches "
            f"{shd['launches']}; collective total {shd['collective_total']} "
            f"B; the plain route's {shd['plain_seconds']:.3f}s ({smi})")
        for impl, r in shd["drives"].items():
            log(f"    {impl} ({r['logits_type']} logits): prefill "
                f"{r['prefill_equal']}, its rings {r['prefill_rings_equal']}, "
                f"steps {r['steps_equal']}, rings {r['rings_equal']}; "
                f"{r['seconds']:.3f}s with the collective counter on, "
                f"{r['seconds_no_counter']:.3f}s without")
    tr = lch["moe_train"]
    log(f"  MoE train step (fp32 masters, bf16, {MOE_SHARD_TRAIN[0]} x "
        f"{MOE_SHARD_TRAIN[1]}): plain loss {tr['plain_loss']:.6f}, aux "
        f"{tr['plain_aux_loss']:.6f} ({tr['plain_seconds']:.3f}s)")
    for impl in MOE_SHARD_IMPLS:
        r = tr[impl]
        log(f"    {impl} on DTensors: loss {r['loss']:.6f}, aux "
            f"{r['aux_loss']:.6f}, metrics off by {r['metrics_rel']:.3g} "
            f"(<= {MOE_SHARD_LOSS_REL}), moments {r['moment_rel']:.3g} of "
            f"a leaf's largest ({r['moment_worst']}; <= "
            f"{MOE_SHARD_GRAD_REL}), updates {r['update_lr']:.3g} lr, bit "
            f"for bit {r['bit_equal']}; {r['seconds']:.3f}s")
    phase_done("6i")

    log("== phase 5: times at the main paths' shapes")
    tm = times(main_res, mamba, gen, {"3k": tiny, "3l": danube, "3o": zamba})
    # phase 2 holds ssd_intra at 3o's tile; the timing row reuses its error
    tm["ssd_intra 3o"]["max_abs_err"] = ssd_errs["zamba2"]

    def fmt(m):
        if m is None:
            return "n/a"
        dev = ("not measured" if m["device_ms"] is None
               else f"{m['device_ms']:.5f} ms")
        if m["call_ms"] is None:
            return f"device {dev}"
        return f"device {dev} / per call {m['call_ms']:.5f} ms"
    floor = tm.pop("launch floor")["kernel"]
    floor_ms = floor["device_ms"]
    log(f"  launch floor [one-element zero_()]: {fmt(floor)}")
    floor_txt = ("not measured" if floor_ms is None
                 else f"{floor_ms:.6f} ms")
    def log_row(name, t):
        warm = (f" (after a read flush: {fmt(t['kernel cold, read flush'])};"
                f" warm: {fmt(t['kernel warm'])})" if "kernel warm" in t
                else "")
        plan = f" {t['plan']}" if "plan" in t else ""
        log(f"  {name} [{t['shape']}]{plan}: kernel {fmt(t['kernel'])}{warm};"
            f" plain {fmt(t['plain'])}; library {fmt(t['library'])}; bound "
            f"{t['bound_ms']:.6f} ms ({t['bound_by']}), launch floor "
            f"{floor_txt}")
        if "bound_terms" in t:
            bt = t["bound_terms"]
            log(f"    bound terms: {bt['bytes'] / 1e6:.3f} MB -> "
                f"{bt['bytes_ms']:.6f} ms at 3.35 TB/s; {bt['flops'] / 1e9:.4f}"
                f" GFLOP -> {bt['ops_ms']:.6f} ms at 165 TFLOP/s (3xTF32), "
                f"{bt['ops_simt_ms']:.6f} ms at 67 TFLOP/s (fp32 CUDA cores)")
    for name, t in tm.items():
        log_row(name, t)
    log("  (3w's and 3x's rows, timed in their subprocess after the phases)")
    for name, t in lm["rows"].items():
        tm[name] = t
        log_row(name, t)
    # the main path and the Mamba2 window once more under the profiler (the
    # paged, futures and mixed drives are not profiled again: each repeats
    # a drive phases 3c-3e timed, and together they took ~47 s)
    prof = path_profile(
        lambda: launch.serve(serve_args(32, 48))["seconds"], sec)
    mprof = window_profile(
        lambda: mamba_serve(mamba["params"], mamba["cfg"],
                            mamba["prompts"][:PROFILE_REQUESTS],
                            PROFILE_MAX_NEW)[2])
    for name, p, ph in (("Delphi", prof, "3"),
                        ("Mamba2", mprof, f"3b's first {PROFILE_REQUESTS} "
                         f"prompts x {PROFILE_MAX_NEW} tokens")):
        idle = ("not measured" if p["idle_share"] is None
                else f"{p['idle_share']:.3f}")
        log(f"  {name} path: device busy {p['device_busy_s']:.4f}s of "
            f"{p['wall_s']:.3f}s wall (phase {ph}), idle share {idle}; "
            f"{p['launches']} device activities ({p['profiled_wall_s']:.3f}"
            f"s wall under the profiler); top by device time:")
        for t in p["top"]:
            log(f"    {t['ms']:9.3f} ms  {t['launches']:6d}x  {t['kernel']}")
    log(f"  Mamba2 path: ssd_intra kernels {mprof['ssd_intra']['ms']:.3f} ms "
        f"of device time over {mprof['ssd_intra']['launches']} launches")

    phase_done("5")
    # the MoE LMs last: in one whole run with them ahead of phase 5 (their
    # whole ring runs profiled, ~50,000 and ~80,000 device activities)
    # every hand-written kernel's row there lost its profiler device time
    moe = {}
    for ph, arch, cut, desc in (
            ("3p", "olmoe-1b-7b", None, "16 layers, d_model 2048, 16/16 "
             "heads of 128, 64 experts of 1024, top-8, V 50304"),
            ("3q", "qwen2-moe-a2.7b", MOE_FP32_LAYERS, "24 layers, d_model "
             "2048, 16/16 heads of 128, QKV biases, 60 experts of 1408, "
             "top-4, 4 shared, V 151936")):
        log(f"== phase {ph}: {arch} at full width ({desc}; bf16, weights made"
            f" on the card), BatchedEngine(slots={DENSE_SLOTS}, max_context="
            f"{DENSE_CONTEXT}): {DENSE_REQUESTS} requests of seeded random "
            f"ids (64-768 tokens), {DENSE_MAX_NEW} new tokens each, ring "
            f"then prefix-cached paged")
        t_ph = time.perf_counter()
        moe[ph] = lm_path(arch, ph, fp32_layers=cut)
        log_lm(moe[ph], ph, smi, t_ph)
        phase_done(ph)

    # the rest of the zoo, through the model-level path, after the MoE LMs
    zoo = {}
    for ph, arch, cut, desc in (
            ("3r", "internvl2-26b", MOE_FP32_LAYERS, "48 layers, d_model "
             "6144, 48/8 heads of 128, SwiGLU d_ff 16384, V 92553, 256 patch "
             "embeddings before 64-768 text tokens, rings 1280 wide"),
            ("3s", "seamless-m4t-large-v2", None, "24 encoder + 24 decoder "
             "layers, d_model 1024, 16/16 heads of 64, GELU d_ff 8192, "
             "LayerNorm, V 256206; 4096 frame embeddings a row, decoder "
             "prompts of 16-64 tokens, self rings 128 wide")):
        log(f"== phase {ph}: {arch} at full width ({desc}; bf16, weights "
            f"made on the card): forward(prefill, last_index), "
            f"mask_padded_positions, then greedy decode_step at per-row "
            f"steps, {ZOO_ROWS} rows x {ZOO_MAX_NEW} new tokens")
        t_ph = time.perf_counter()
        zoo[ph] = zoo_path(arch, ph, fp32_layers=cut)
        log_zoo(zoo[ph], ph, smi, t_ph)
        phase_done(ph)

    log("== phase 5 (MoE): flash and paged at the MoE LMs' shapes")
    for name, t in moe_rows(gen, moe["3q"]["cfg"], moe["3q"]["layer0"]
                            ).items():
        tm[name] = t
        log_row(name, t)
    phase_done("5 MoE rows")
    log("== phase 5 (zoo): flash and paged at InternVL2's and SeamlessM4T's "
        "shapes")
    for name, t in zoo_rows(gen, zoo["3r"], zoo["3s"]).items():
        tm[name] = t
        log_row(name, t)
    phase_done("5 zoo rows")

    # the last single-card paths: the two families' training and a
    # full-width checkpoint served from --ckpt
    zoo_train = {}
    for ph, arch, desc in (
            ("6j", "seamless-m4t-large-v2", "24 encoder + 24 decoder layers, "
             "4 x 512 tokens over 64 frames"),
            ("6k", "internvl2-26b", "cut to 2 layers, 2 x (256 patches + "
             "768 text tokens)")):
        log(f"== phase {ph}: {arch} training at full width ({desc}; bf16 over "
            f"fp32 masters made on the card, AdamW; the plain route, no "
            f"kernel)")
        t_ph = time.perf_counter()
        zoo_train[ph] = zoo_train_path(arch, ph)
        log_zoo_train(zoo_train[ph], ph, smi, t_ph)
        phase_done(ph)
    log(f"== phase 3v: a full-width {CKPT_ARCH} checkpoint (fp32 masters, "
        f"the port's save) served by python -m repro_torch.launch.serve "
        f"--ckpt in a subprocess, 3p's knobs")
    t_ph = time.perf_counter()
    ckpt = ckpt_serve_path()
    log_ckpt_serve(ckpt, smi, t_ph)
    phase_done("3v")

    def timings(row):
        """The row's ms, plain_ms and library_ms: the profiler's device time
        where it read every call and not below the bound, else the per-call
        time (CUDA events); ``ms_from`` says which the kernel's ms is."""
        def pick(m):
            if m is None:
                return None, None
            d = m["device_ms"]
            if d is not None and d >= row["bound_ms"]:
                return d, "device"
            return m["call_ms"], "call"
        ms, ms_from = pick(row["kernel"])
        return {"ms": ms, "ms_from": ms_from,
                "plain_ms": pick(row["plain"])[0],
                "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                "library_ms": pick(row["library"])[0],
                "call_ms": row["kernel"]["call_ms"]}
    # each kernel's launches come from the run of its own path: this
    # slice's paged Delphi path (phase 3c) for the Delphi kernels, with the
    # paged kernel timed at the paged pool; the Mamba2 path for ssd_intra
    rows = dict(tm)
    rows["paged_decode_attention"] = tm["paged_decode_attention paged pool"]
    errs["paged_decode_attention"] = rows["paged_decode_attention"][
        "max_abs_err"]
    launches = {name: (mamba["launches"][name] if name == "ssd_intra"
                       else paged["launches"][name]) for name in REPLACES}
    dense_paths = {"3k": tiny["runs"]["ring"]["launches"],
                   "3l": danube["runs"]["ring"]["launches"],
                   "3m": d100["launches"], "3n": lmart["launches"],
                   "3o": zamba["run"]["launches"],
                   "3t": {k: sum(ssmart[a]["launches"][k]
                                 for a in SSM_ARTIFACT_LAYERS)
                          for k in REPLACES},
                   "3p": moe["3p"]["runs"]["ring"]["launches"],
                   "3q": moe["3q"]["runs"]["ring"]["launches"],
                   "3r": zoo["3r"]["run"]["launches"],
                   "3s": zoo["3s"]["run"]["launches"],
                   "6f": ssm_train["6f"]["cli"]["launches"],
                   "6g": ssm_train["6g"]["cli"]["launches"],
                   "6j": zoo_train["6j"]["launches"],
                   "6k": zoo_train["6k"]["launches"],
                   "3v": ckpt["launches"],
                   "3w": lm["3w"]["runs"]["ring"]["launches"],
                   "3w long": lm["3w"]["long"]["runs"]["ring"]["launches"],
                   "3x": lm["3x"]["runs"]["ring"]["launches"],
                   "7": exm["launches"]}

    def by_path(name):
        out = ({} if name == "ssd_intra" else
               {"3i": coh["launches"][name], "6d": can["launches"][name],
                "artifact": bart["launches"][name]})
        out.update({p: c[name] for p, c in dense_paths.items()})
        return out
    kernels = [{
        "name": name, "route": "cuda", "source": SOURCES[name],
        "replaces": REPLACES[name], "launches": launches[name],
        "path": "3b" if name == "ssd_intra" else "3c",
        "launches_by_path": by_path(name),
        "max_abs_err": errs[name], **timings(rows[name])}
        for name in REPLACES]
    # the flash kernel's position-masked route, on the chunked path (3e)
    prow = rows["flash_attention positions"]
    kernels.append({
        "name": "flash_attention positions", "route": "cuda",
        "source": SOURCES["flash_attention"],
        "replaces": REPLACES["flash_attention"],
        "launches": mixed["launches"]["flash_positions"], "path": "3e",
        "max_abs_err": errs["flash_attention positions"], **timings(prow)})
    # the two attention kernels at the dense LMs' shapes, with their
    # launches on those paths' ring runs (3k, 3l), at the MoE LMs' (3q's
    # ring run; 3p's launches are in launches_by_path), and the three
    # kernels of the Zamba2 path at its shapes (3o)
    # and at the zoo's (3r's prefill and ring; 3s's encoder and cross
    # prefill, whose flash launches on 3s are counted together, and its
    # cross ring)
    attention_rows = [(n, p) for n in ("flash_attention",
                                       "paged_decode_attention")
                      for p in ("3k", "3l", "3o", "3q", "3r", "3w",
                                "3w long", "3x")]
    attention_rows.append(("flash_attention", "3w S=4096"))
    zoo_rows_ = [("flash_attention", "3s encoder"),
                 ("flash_attention", "3s cross"),
                 ("paged_decode_attention", "3s cross")]
    for name, ph in attention_rows + zoo_rows_ + [("ssd_intra", "3o")]:
        row = rows[f"{name} {ph}"]
        path = ph if ph in dense_paths else ph.split()[0]
        kernels.append({
            "name": f"{name} {ph}", "route": "cuda",
            "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": dense_paths[path][name], "path": path,
            "shape": row["shape"], "max_abs_err": row["max_abs_err"],
            **timings(row)})
    for d in (tiny, danube):
        d.pop("layer0")
        d["cfg"] = d["cfg"].name
    zamba.pop("ring0")
    zamba["cfg"] = zamba["cfg"].name
    for m in list(moe.values()) + list(zoo.values()):
        m.pop("layer0")
        m["cfg"] = m["cfg"].name
    record = {
        "card": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
        "build_seconds": build.last_build.get("seconds"),
        "kernel_errors": errs, "times": tm, "launch_floor": floor,
        "kernels": kernels,
        "main_path_profile": prof, "mamba_path_profile": mprof,
        "paged_path": {"requests": len(paged["done"]),
                       "events": paged["events"], "seconds": psec,
                       "ticks": peng.ticks,
                       "admit_batches": peng.admit_batches,
                       "host_syncs": peng.host_syncs,
                       "prefill_shapes": sorted(peng.prefill_shapes),
                       "launches": paged["launches"], "pool": pst,
                       "ring_cache_bytes": eng.cache_bytes,
                       "events_per_s_in_turns": turns},
        "futures_path": {"events": fut["events"], "seconds": fsec,
                         "ticks": feng.ticks,
                         "admit_batches": feng.admit_batches,
                         "host_syncs": feng.host_syncs,
                         "prompt_lengths": fut["prompt_lengths"],
                         "prefill_shapes": sorted(feng.prefill_shapes),
                         "launches": fut["launches"], "pool": fst,
                         "unshared_prompt_blocks": fut["unshared_blocks"],
                         "index_blocks_freed": fut["index_blocks_freed"]},
        "paged_parity": ppar, "chunked_parity": cpar, "risk": rsk,
        "mixed_path": {"runs": mixed["runs"], "launches": mixed["launches"],
                       "pool": mst, "chunk_shapes": mixed["chunk_shapes"],
                       "monolithic_shapes": mixed["monolithic_shapes"]},
        "suffix_path": {"pool": sfx["stats"], "matched": sfx["matched"],
                        "suffix_chunks": sfx["suffix_chunks"]},
        "http_path": http, "router_path": rtr, "cohort_path": coh,
        "grads_path": grd, "train_path": trn, "federated_path": fedr,
        "canary_path": can, "artifact_path": art,
        "tinyllama_path": tiny, "danube_path": danube,
        "delphi100m_path": d100, "lm_artifact_path": lmart,
        "long_grads_path": lgr, "long_train_path": ltr,
        "zamba2_path": zamba, "ssm_artifact_path": ssmart,
        "ssm_train_paths": ssm_train,
        "moe_check": moe_check, "reference_engine_path": refe,
        "moe_train_path": mtr, "launch_check": lch,
        "olmoe_path": moe["3p"],
        "qwen2_moe_path": moe["3q"], "internvl2_path": zoo["3r"],
        "seamless_path": zoo["3s"], "zoo_train_paths": zoo_train,
        "ckpt_serve_path": ckpt, "qwen2_5_32b_path": lm["3w"],
        "deepseek_7b_path": lm["3x"], "examples_path": exm,
        "main_path": {"requests": len(main_res["done"]),
                      "events": main_res["events"], "seconds": sec,
                      "ticks": eng.ticks, "admit_batches": eng.admit_batches,
                      "host_syncs": eng.host_syncs,
                      "prefill_shapes": sorted(eng.prefill_shapes),
                      "launches": main_res["launches"]},
        "mamba_path": {"requests": MAMBA_REQUESTS, "tokens": mamba["tokens"],
                       "seconds": msec, "ticks": meng.ticks,
                       "admit_batches": meng.admit_batches,
                       "host_syncs": meng.host_syncs,
                       "prefill_shapes": sorted(meng.prefill_shapes),
                       "launches": mamba["launches"]},
        "mamba_parity": {"steps": mpar["held"]["steps"],
                         "near_ties": len(mpar["held"]["near_ties"]),
                         "free_compared": mpar["free"]["compared"],
                         "divergences": mpar["free"]["divergences"]},
        "parity": {"steps": par["held"]["steps"],
                   "near_ties": len(par["held"]["near_ties"]),
                   "max_age_rel_err": par["held"]["max_age_rel_err"],
                   "free_compared": par["free"]["compared"],
                   "divergences": par["free"]["divergences"]}}
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    phase_done("record")
    record["phase_seconds"] = PHASE_S
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
