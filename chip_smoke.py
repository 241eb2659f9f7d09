#!/usr/bin/env python3
"""Drive the PyTorch port of blockwise parallel decoding on an NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card.  Phases:

  1. device   — needs CUDA; prints the card's name and power limit.
  2. build    — compiles the seven CUDA kernels from src/repro_torch/kernels/csrc
                (one nvcc per source, all started together).
  3. kernels  — each kernel against its plain PyTorch version at the decode
                paths' shapes, bf16 and fp32 (tree shapes, 32-node trees,
                the split-KV plan's edges, a masked range, a query that
                sees no key, head dims 32 and 64, kq·G 64, the draft
                forwards' kq 1 and 2 over stale drafts at each draft's
                heads (32/8 of 128, 8/2 of 32, 4/2 of 16), shared and
                unmapped pages, fused_heads at T 1, 2, 4 and 8 on the tied
                table view, on rwkv6's untied row-major lm_head and at N 1,
                65 and 200, scans at S 1, 16, 17 and 37 and at logw -8,
                -20 and 0 beside -20, fused_verify on tie-heavy logits, on
                unaligned rows (V 49155) and at B 1, k 32, T 8); the
                three split-KV attention kernels bit for bit batch-invariant
                (kq 1 and 2 vs 8, B 1 vs 8), the tree kernel on a chain and the
                paged kernel on the gathered view kp[tbl] bit for bit equal
                to verify_attention; times kernel, plain version, the
                one-call PyTorch yardstick where there is one (for
                attention the faster of SDPA on repeated K/V and SDPA with
                enable_gqa), the fp32 time of every kernel beside its fp32
                bound (operations over the 67 TFLOP/s CUDA-core peak, or
                for fused_heads three TF32 products over the 495 TFLOP/s
                TF32 peak with its old CUDA-core bound beside it, or
                bytes) and its fp32 yardstick where there is one (SDPA;
                torch.mm with TF32 off, then torch.topk; torch.argmax,
                then the compare and scan), fused_heads at
                rwkv6's shape in bf16 and fp32, fused_heads and
                fused_verify beside a
                two-call comparator (torch.mm then torch.topk; torch.argmax
                then the compare and scan; not one call, so not
                library_ms), and the bound (bytes / 3.35 TB/s or FLOPs /
                peak, the larger); at head_dim 16 (the trained sweep
                model) the three split-KV kernels in bf16 and fp32, bit for
                bit batch-invariant, timed; verify_attention as the
                encoder-decoder's cross attention calls it (q_pos 0, the
                source at 0, masked tails at -1; kq 1 and 8, Se 24 and 64,
                heads 8 of 64 and 4 of 16), paper-mt-base's call timed
                beside SDPA; at head_dim 24 (computed at width 32) the
                three split-KV kernels at quickstart's heads (B 8, kq 4,
                4 over 2 KV heads) and the superres grid model's (4 over
                4), L 60 and 200, bf16 and fp32, bit for bit
                batch-invariant, each timed at quickstart's L 200 beside
                SDPA and the bound; fused_heads and fused_verify at vocab
                32 and 16 padded to 256 lanes; the dense text families
                (check_family_heads, check_family_vocab): the three
                split-KV kernels at stablelm-12b's 32/8 heads of 160
                (chain kq 1, 2, 8 at L 60, 256, 4096; trees of 8 and 32
                nodes) and at starcoder2-7b's 36/4 heads of 128, G 9 in
                row tiles (kq 7, 8, 32: 63, 72, 288 rows; kq 8 with the
                window of 4096 over a wrapped ring of 4352 slots; trees of
                8 and 32 nodes: 72 and 288 rows), paged with shared and
                unmapped pages, bf16 and fp32, bit for bit invariant in kq
                and B, timed beside SDPA and the bound; the same at the
                MoE models' 16/16 heads of 128 (kq 1, 2, 8 at L 256 and
                4096: kq 8 is 8 rows of a 16-row tile); fused_heads at
                nemotron-4-15b's (56, 6144) x (6144, 256000) untied
                lm_head (T 1, 4, 8), olmoe-1b-7b's (2048, 50432) at vocab
                50304 and qwen2-moe-a2.7b's (2048, 152064) at vocab 151936
                (T 1, 8), bf16 and fp32, beside torch.mm then torch.topk
                and the bound; fused_verify at (8, 8, V) for V 256000,
                50304 and 151936 under every criterion, and at the path's
                padded lanes with the pads at -1e9, bit for bit; hymba-1.5b
                (check_hymba_heads): verify_attention at 25/5 heads of 64
                (G 5: kq 8 is 40 rows of one 48-row tile) at kq 1, 2 and 8
                over L 512 and at kq 8 over its windowed layers' wrapped
                ring of 1280 slots (window 1024, 128 reserved meta slots),
                paged_verify_attention over 32 pages of 16, bf16 and fp32,
                bit for bit invariant in kq and B, timed beside SDPA and
                the bound; fused_heads at its untied (1600, 32256)
                lm_head, vocab 32001 (T 1, 8), and fused_verify at (8, 8,
                32001) under every criterion; llava-next-34b (the llava
                rows of FAMILY_HEADS and FAMILY_VOCABS): the three split-KV
                kernels at 56/8 heads of 128 (G 7: kq 8 is 56 rows of one
                64-row tile), the chain at kq 1, 2 and 8 over L 256 and
                3016 (2,880 patches + 64 + 64 + 8), trees of 8 and 32
                nodes (56 and 224 rows) at L 3016, the paged kernel over
                189 pages of 16, bf16 and fp32, bit for bit invariant in
                kq and B, timed at L 3016 beside SDPA and the bound;
                fused_heads at (56, 7168) x (7168, 64000) and at 28 rows
                (T 1, 8), fused_verify at (8, 8, 64000); rwkv6_scan with
                checkpoints every 16 and 32 steps in every scan case, y and
                the final state bit for bit those without; the reverse scan
                (rwkv6_scan_bwd) against its plain version from the same
                checkpoints at S 1, 16, 17, 37 and 512, D 16, 32, 64 and
                128, logw -8, -20 and 0 beside -20, f32 and bf16, with and
                without dstate, chunks of 16 and 32, timed at rwkv6-1.6b's
                training shape (fp32, B 4, S 512, H 32, D 64) beside the
                plain version and the bound, and each kernel of that call
                from a profiled one; the local shapes of phase 22's
                ranks (check_mesh_shapes): granite's 16/4 and 8/2 heads a
                rank, fused_heads on a rank's block of its tied table, and
                the families' (check_mesh_family_shapes): the three
                split-KV kernels at the MoE models' 8/8 heads of 128 a
                rank, fused_heads on olmoe's two (2048, 25216) lm_head
                blocks merged equal to one launch, rwkv6_scan at a rank's
                16 and 8 heads (B 8, S 512, D 64), each timed beside its
                plain version, SDPA where it applies and the bound; and
                phase 23's (check_input_shapes): the three split-KV
                kernels at paper-mt-base's 4/4 heads of 64 a rank (L 80)
                and llava's 28/4 heads of 128 (L 3016),
                the cross call at a rank's 4 heads over Se 64, fused_heads
                on each rank's block of paper-mt-base's (512, 32000) and
                llava's (7168, 64000) untied lm_heads merged equal to one
                launch, fused_verify at a data rank's (4, 8, 32000), each
                timed at model 2 beside its plain version, SDPA or
                torch.mm then torch.topk, and the bound.
  4. decode   — granite-3-8b at full width in fp32 (random weights, seed 0):
                greedy_decode and bpd_decode of 8 prompts x 64 new tokens;
                BPD must emit greedy's tokens, and the kernels' launch counts
                must match the forwards run.
  4b. paths   — phases 4b-5c, 14 and 15a-15d run granite-3-8b at full
                width and 4 of its 40 layers (seed 0; FAMILY_FP32_LAYERS),
                held to that model's own greedy: greedy on the paged
                cache, BPD exact on the paged cache, BPD topk_tree on the
                dense and the paged cache; each must emit greedy's tokens,
                each kernel launched once per layer and forward of its
                path.
  5. accepts  — one BPD iteration with greedy's own continuation as the
                proposals (k̂ = 8), then with slot j corrupted (k̂ = j).
  5b. tree    — hand-made tree proposals from greedy's continuation: node 1
                wrong and node 2 right (k̂ = 2), node 1's chain right
                (k̂ = 8 - fanout + 1); a second iteration gives greedy's
                tokens, dense and paged.
  5c. engine  — the same cut fp32 weights served by
                repro_torch.serving.ContinuousBatchingEngine with
                an exact and a topk_tree slot group of 4 slots each: 16
                requests (phase 4's 8 prompts, the first 32 tokens of four
                of them and the first 48 of the other four; budgets 16-64;
                arrivals in virtual time, so slots are evicted and
                refilled), once unified on the managed page pool (page
                size 16, one iteration per host read; copy-on-write prefix
                hits required and printed), once disaggregated (prefill
                batches of 4) on the dense slab with windows of 4
                iterations.  Each request's tokens must be greedy's (the
                cut model's greedy for the 64-token prompts, one
                greedy_decode per shorter length), except at reported
                near-ties; launches
                exactly as the engine's own forwards and prefills imply;
                every serving function built once; host reads equal group
                steps plus harvest reads.  k̂ per group, host wall, and one
                scheduler step's host wall and device busy printed.
  6. serve    — phase 4's full-depth weights cast for bf16
                (model.cast_for_compute), served by
                repro_torch.launch.serve (static batch, --full-config);
                k̂, iterations and BPD/greedy agreement reported.
  6b. serve   — the same with --policy topk_tree --cache-backend paged.
  6c. engine  — the same 16 requests through the engine on the
                bf16 weights and the paged pool: tokens/s beside phase 6's
                static serve, one scheduler step profiled; then
                repro_torch.serving.server on 127.0.0.1 (port 0) answers 8
                concurrent streamed requests from a client in this
                process: each stream must be byte-identical to its finish
                record; TTFT p50/p99 and agreement with the direct engine
                run reported.
  7. profile  — one bf16 BPD iteration of each serve (after 6 and after
                6b): host wall time against the summed kernel time
                torch.profiler sees (the device's idle share), and the
                attention kernels' and fused_heads' shares of it.
  8. rwkv     — granite freed; rwkv6-1.6b at full width in fp32 (random
                weights, seed 0): greedy and BPD exact of 8 prompts x 512
                tokens, 64 new each; BPD must emit greedy's tokens; launches
                exact (rwkv6_scan once per layer and prefill).
  8b. accepts — rwkv6 iterations with greedy's continuation (k̂ = 8) and with
                slot 3 corrupted (k̂ = 3), each followed by a second
                iteration on the committed recurrent state (greedy's tokens).
  9. serve    — rwkv6-1.6b cast for bf16 and served (--prompt-len 512);
                k̂, iterations and BPD/greedy agreement reported; one
                iteration profiled (fused_heads' share printed).
  10. mt      — rwkv6 freed; paper-mt-base (6 + 6 layers, d 512, 8 heads of
                64, vocab 32000) at full width in fp32 (random weights,
                seed 0): greedy_decode_seq2seq and bpd_decode_seq2seq under
                exact, adaptive, input_copy and topk_tree of 8 MarkovLM
                sources x 64 tokens, 64 new each; each must emit greedy's
                tokens; launches exact (self and cross attention once per
                layer and forward); hand-made accepts (k̂ = 8, slot 3
                corrupted k̂ = 3) and a second iteration.
  10b. mt bf16 — the same weights cast for bf16, exact and input_copy:
                k̂, iterations, tokens/s, agreement with bf16 greedy; one
                iteration of each profiled.
  10c. fixture — the trained policy-sweep model (tests/data/policy_sweep,
                head_dim 16) in fp32, each of its 16 sources decoded alone
                under exact, topk, distance, adaptive, input_copy and
                topk_tree: tokens, iterations and generated counts equal to
                reference.json (the JAX reference's decode of the same
                checkpoint) except at reported near-ties; the lossless
                policies emit exact's tokens; each k̂ beside the
                reference's.
  12. quickstart — examples/quickstart.py's model (head_dim 24): the
                pinned fixture tests/data/quickstart decoded in fp32, its
                8 prompts as one batch, greedy and BPD exact, tokens equal
                to reference.json under the near-tie rule, with equal
                tokens equal iterations, generated counts and k̂; then the
                port trains quickstart's recipe on the card (fp32, 300
                steps) and decodes: BPD emits greedy's tokens, k̂ > 1.5,
                fewer invocations than greedy.
  13. locality — the pinned image fixture tests/data/locality (8 x 8
                fields, stride 2, 16 levels; lattice and raster arms):
                13a fp32, each of 8 fields decoded alone under locality,
                locality_exact and locality_raster, rows equal to
                reference.json under the near-tie rule (with all rows
                equal: MAE, iterations per token and k̂ too), locality
                emitting locality_exact's tokens in fewer iterations than
                locality_raster; 13b the lattice model in bf16 (k̂ and
                iterations recorded); 13c the engine with a locality and an
                exact group of 2 slots, 16 requests, each equal to its
                static decode.
  14. kv_chunk — run inside phase_decode, on 4b's cut fp32 granite-3-8b
                weights: a 2048-token prefill with
                kv_chunk 512 and without (hidden states within 1e-4 of
                max|h|, each prefill's peak memory printed), greedy's 16
                new tokens equal, then BPD exact through
                DecodeSession(kv_chunk=512) on phase 4's batch emits the
                cut model's greedy tokens.
  15. draft   — the draft_model policy (a second model drafts each block,
                the verifier checks it; exact acceptance).  Inside
                phase_decode on 4b's cut fp32 weights: 15a granite drafts
                for itself (ModelBundle(params, cfg)), 8 prompts x 64 new
                tokens at block_k 8: greedy's tokens in 8 iterations, a
                block split only at a reported near-tie, 7 draft forwards
                an iteration; 15b a small random draft (granite's smoke
                geometry, 2 layers of d 256, at vocab 49155, seed 7):
                greedy's tokens, k̂ printed; each with launches exact (the
                verifier's attention per layer and iteration, the draft's
                verify_attention per draft layer and draft forward,
                fused_verify per iteration, no fused_heads); 15d 5c's 16
                requests through an engine with a draft_model and an exact
                group of 4 slots on the managed page pool, each greedy's,
                builds once, launches exact, first on 15b's draft, then on
                a self-draft in windows of 4 iterations, where each
                draft_model request's tokens and invocations equal its
                run-to-completion decode alone; after the cast, 15b in bf16
                through DecodeSession (tokens/s beside phase 6's, one
                iteration profiled).  Beside 10c: 15c the pinned distilled
                students (tests/data/draft_model, gold and scheduled
                sampling) drafting for the sweep teacher, each of 16 rows
                alone, equal to reference.json under the near-tie rule and
                to 10c's exact tokens, 7 draft forwards an iteration (1
                saved); 15e repro_torch.launch.serve --policy draft_model
                with the smoke primary and draft, static and --engine
                --policies exact=2,draft_model=2.
  16. families — everything earlier freed; stablelm-12b, starcoder2-7b and
                nemotron-4-15b at full width from seed 0, the fp32 decodes
                at a twentieth to a sixteenth of the depth
                (FAMILY_FP32_LAYERS: 2 of 40, 2 of 32 and 2 of 32 layers,
                cut so that the script with phase 22 stays within 75% of
                its time limit), each
                bf16 serve at
                full depth, phase 4's 8 prompts x 64 new tokens at
                block_k 8: greedy, then BPD exact and topk_tree on the
                dense and paged caches (nemotron: exact dense, topk_tree
                paged), each greedy's tokens (near-tie rule), its
                attention kernel launched once per layer and forward;
                16a stablelm-12b's fp32 engine (5c's 16 requests, exact
                and topk_tree groups of 4, unified on the managed page
                pool); 16b starcoder2-7b (every layer windowed at 4096:
                the paged backend keeps the dense ring) with 2 prompts of
                4,608 tokens prefilled through DecodeSession(kv_chunk=512),
                greedy and BPD exact equal, and a full forward over prompt
                + greedy's tokens (window on the full path) giving
                greedy's token at every generated position, past the
                4,352-slot ring; then each cast for bf16 and served by
                repro_torch.launch.serve --full-config (tokens/s, k̂, one
                iteration profiled); parameters and peak memory printed.
  17. moe     — after phase 16, before 11: olmoe-1b-7b (16 layers, 64
                experts top-8) and qwen2-moe-a2.7b (24 layers, 60 experts
                top-4 and a shared MLP) at full width from seed 0, the
                fp32 decodes at an eighth of the depth (2 of 16 and 3 of 24
                layers, FAMILY_FP32_LAYERS), each bf16 serve at full
                depth, phase
                4's prompts, 64 new tokens, block_k 8,
                every decode forward at full capacity: 17a olmoe greedy,
                exact and topk_tree on both caches and the fp32 engine
                (5c's 16 requests, unified on the managed page pool);
                17b qwen2-moe greedy, exact dense, topk_tree paged; each
                greedy's tokens, launches exact, the fp32 peak under 76
                GiB, then cast for bf16 and served (--full-config).  The
                near-tie rule's router extension: a divergence without a
                logit near-tie passes only if the first (position, layer)
                where the two runs' chosen experts differ (each run's
                router logits recorded through models.moe.ROUTER_TRACE;
                the other run's computation matched to greedy's as the
                closest within 1e-3 of max|router logit|) has a relative
                K-th / (K+1)-th router-probability gap below 1e-4 on both
                sides; admitted ties are printed and counted.  17c: one
                make_train_step card vs CPU at a narrow olmoe geometry (d
                1024, 16 experts top-4) where capacity drops assignments
                (loss, aux / z / dropped, every gradient and leaf, the
                same kept assignments on both sides), then olmoe-1b-7b
                fine-tuned at full width, depth cut to 8 layers (16 bytes
                a parameter must fit), 20 steps of B 4 x S 256: aux, z
                and dropped per step, the loss falling, step ms, tokens/s,
                peak.
  18. hymba   — after phase 17, before 11: hymba-1.5b (32 layers of
                attention beside Mamba heads, d 1600, 25/5 heads of 64,
                windows of 1024 outside layers 0, 15 and 31, 128 meta
                tokens, untied lm_head at vocab 32001) at full width from
                seed 0, the fp32 decodes at an eighth of the depth (4 of
                32 layers, layer 0 the only global one), the bf16 serve at
                full depth, phase 4's prompts, 64 new tokens, block_k 8:
                18a greedy, BPD exact, adaptive and topk (T 2) on the
                dense cache and exact on the paged cache (7
                verify_attention + 1 paged_verify_attention a forward),
                launches exact, exact and adaptive greedy's tokens (near-tie
                rule), topk's every token within p_1's top-2, the fp32
                peak; 18b 2 prompts of 1,536 tokens (128 + 1,536 + 16
                positions over a 1,280-slot ring): greedy and BPD exact
                equal, and a full forward over meta + prompt + greedy's
                tokens gives greedy's token at every new position; 18c
                hand-made accepts (k̂ = 8, slot 3 corrupted k̂ = 3), each
                followed by a second iteration on the committed Mamba
                state (greedy's tokens); 18d cast for bf16 (A_log, D and
                the norm scales stay fp32) and served (--full-config), one
                iteration and one prefill profiled with the Mamba scan's
                launches; 18e one make_train_step card vs CPU at a narrow
                hymba geometry (d 256, layer 1 windowed at 32, 8 meta
                tokens), then hymba-1.5b fine-tuned at full width on 8 of
                32 layers (only layer 0 global), 10 steps of B 4 x S 256:
                the loss falling, step ms, tokens/s, peak.
  19. llava   — after phase 18, before 11: llava-next-34b (60 layers, d
                7168, 56/8 heads of 128, vocab 64000, untied) behind the
                full 2,880-patch prefix (stub_frontend_inputs, seed 0)
                before the first 4 of phase 4's prompts, 64 new tokens,
                block_k 8.  19a fp32 at full width, depth cut to 4 of 60
                layers (full depth is 137 GiB in fp32), the chain paths
                prefilled in chunks of 512 keys: greedy, BPD exact on both
                caches, topk_tree paged (unchunked, as the reference
                refuses a tree with kv_chunk), each greedy's tokens (the
                near-tie check's full forward behind the row's patches),
                launches exact; draft_model with 15b's small text draft at
                vocab 64000 (a patch-prefixed primary, as the reference
                runs it) greedy's tokens, launches exact; one iteration
                with greedy's continuation as the proposals gives k̂ = 8.
                19b bf16 at full depth, the 36,737,948,672 parameters
                drawn in bf16 on the card before any workspace: BPD exact
                dense through DecodeSession(kv_chunk=256), tokens/s, k̂,
                iterations, launches exact; bf16 greedy, each first
                divergence a near-tie of at most BF16_TIE_ULPS; one
                iteration profiled; the peak (32 new tokens); then
                repro_torch.launch.serve --full-config with the
                reference's 4 zero patches on the same weights.
  20. hubert  — hubert-xlarge, encoder-only masked prediction (48 layers,
                d 1280, 16 heads of 80: attention in plain PyTorch, no
                hand-written kernel): 20a one make_train_step card vs CPU
                at a narrow geometry (d 320, 4 heads of 80, 2 layers,
                vocab 504) on MaskedFrames; 20b fp32 at full width and
                depth, AdamW, MaskedFrames batches of B 8 x S 512, 2
                warm-up steps, 10 timed and one profiled: step ms, frames
                per second, peak, losses finite; then
                repro_torch.launch.train --arch hubert-xlarge (smoke
                config) for 2 steps.
  21. rwkv train — after phase 20, before 11: 21a one make_train_step
                card vs CPU at a narrow rwkv6 geometry (d 256, 4 heads of
                64, 2 layers, d_ff 512, vocab 1024), frozen with scheduled
                sampling and self targets, then fine-tuned (the scan's
                backward on the card): loss, gradient norm and every
                gradient within rtol 1e-4 and atol 1e-5 of its max (u's
                within atol 1e-3 of its max: fp32 noise in y moves it
                most, tools/rwkv6_grad_noise.py), every updated leaf the
                CPU's update of the card's gradients; 21b rwkv6-1.6b at full width and
                depth in fp32, fine-tuned, AdamW, MarkovLM B 4 x S 512, 2
                warm-up steps, 10 timed and one profiled: the loss falls,
                each step launches rwkv6_scan (with checkpoints) and
                rwkv6_scan_bwd once a layer, step ms, tokens/s, peak, idle
                share, the cuBLAS and scan shares; 21c the quickstart
                recipe on rwkv6's smoke geometry at vocab 32 and k 4 (300
                steps): BPD exact greedy's tokens at k̂ > 1.5 in fewer
                invocations, beside the reference's CPU run; 21d
                examples/serve_bpd_torch.py's training and serving loop
                for granite-3-8b and rwkv6-1.6b and its --continuous
                engine for granite-3-8b, every row or request greedy's
                tokens (near-tie rule), launches exact; then
                examples/translate_bpd_torch.py --quick: BPD greedy's
                tokens on its batch, its trace more than a token a step.
  11. train   — everything earlier freed; the training path (make_train_step:
                the paper's §6 loss, backward, AdamW), fp32:
                11a: granite's attention width (d 4096, 32/8 heads of
                128) at 2 layers, d_ff, bpd_hidden and vocab 1024 / 1024 /
                4096, B 2 x S 64: one step on the card and one on the CPU
                from the same weights and batch, head index and swap mask
                injected, frozen (scheduled sampling, self targets) and
                fine-tuned: loss, gradient norm and every gradient agree
                (rtol 1e-4, atol 1e-5 of each leaf's max), and every leaf
                the card updated equals the CPU's optimizer applied to the
                card's gradients; elements where AdamW's g/(|g| + eps)
                takes the card further from the CPU's own step are counted.
                11b: granite-3-8b at full width and depth rebuilt from
                seed 0 (phase 4's weights), frozen base (§6.1, only the
                heads train, freeze_mask), B 4 x S 256 MarkovLM, 20 steps,
                then 20 with scheduled sampling and self targets: every
                base leaf bit for bit unchanged (checksums), the loss
                falls, greedy equals phase 4's tokens, BPD exact on the
                trained heads emits them (launches counted as in phase 4);
                k̂ before and after, step ms, tokens/s, peak memory, and
                one step of each run profiled (device busy, idle share,
                top kernels).
                11c: granite-3-8b at full width, depth cut to 4 layers
                (full depth's AdamW state does not fit in 80 GB), fine-
                tuned, 20 steps: the loss falls, embed/table and trunk
                leaves move; step ms, tokens/s, peak memory.
                11d: paper-mt-base at full size through
                repro_torch.launch.train (PhraseMT, seq2seq_loss, 20
                steps at --lr 3e-4, --ckpt-dir in a temporary directory):
                the restored
                checkpoint equals the trained weights bit for bit and
                decodes the same tokens (bpd_decode_seq2seq, 8 sources);
                a second run resumes from its step; then the launcher's
                step timed and one step profiled outside it.
  22. mesh    — last: granite-3-8b at full width over meshes of processes
                sharing the card (gloo), one spawn of four ranks: fp32 at 2
                of 40 layers, the static paths over two (1, 2) pairs side
                by side; the engine (phase 5c's 16 requests, exact and
                topk_tree groups of 4) unified dense and paged over (1, 2)
                beside (2, 1); the (2, 2) mesh's BPD exact dense; the
                disaggregated engine (prefill batches of 4, windows of 4)
                over the pod mesh (2, 1, 2), each pod prefilling its 2 rows
                and handing them over ``pod``: every sharded run's tokens
                and records equal to the single-device port's (computed in
                this process meanwhile), each rank's launches of the five
                decode kernels equal to one device's at (1, 2) and (2, 1);
                bf16 at full depth over (1, 2): the static serve beside
                phase 6 and the unified paged engine beside phase 6c
                (tokens/s, TTFT, host ms and collectives a scheduler step),
                each first divergence a near-tie; meanwhile
                repro_torch.launch.serve --mesh-model 2 --http --http-demo
                at its smoke config, the stream equal to both ranks'
                finish records.  The same spawn serves the MoE, RWKV-6
                and Hymba families (ROADMAP §1 item 8c(i)) in fp32 at
                FAMILY_FP32_LAYERS from seed 0 over the (1, 2) pair of
                ranks 2, 3: greedy and BPD exact dense for olmoe-1b-7b,
                qwen2-moe-a2.7b, rwkv6-1.6b and hymba-1.5b, olmoe also
                exact paged, topk_tree dense and phase 17's engine run
                (unified paged); olmoe's exact dense over (1, 4) (16
                experts a rank); each held against the one-device run of
                phases 17-18 (rwkv6-1.6b's decoded in this process beside
                the ranks' start): tokens, counters and each rank's
                launches equal (the near-tie rule and its router
                extension), every rank's expert ids of a forward equal;
                then olmoe's bf16 serve at full depth over (1, 2) beside
                phase 17's one-device serve (tokens/s, k̂, collectives an
                iteration, peak a rank, each first divergence a near-tie).
  23. inputs  — in phase 22's spawn, after its runs (ROADMAP §1 item
                8c(ii); phase 3's check_input_shapes holding the kernels
                at these ranks' shapes first): paper-mt-base fp32 at full
                width and depth over the (1, 2) pair of ranks 0, 1 under
                exact, topk_tree and input_copy and over (2, 2) under
                exact (phase 10's sources, 32 new tokens), and bf16 exact
                over ranks 0, 1 (tokens/s, k̂, collectives an iteration;
                not gated); llava-next-34b fp32 at 4 of 60 layers over the
                (1, 2) pair of ranks 2, 3 behind 19a's 2,880 patches,
                exact dense and paged, against 19a; granite's draft_model
                at 2 of 40 layers over (1, 2), a self-draft (its bundle
                the primary's sharded blocks) and 15b's small draft cut by
                the same rules (16 new tokens: the draft's cache read back
                across iterations), and an engine of a draft_model and
                an exact group of 2 slots (15d's first 8 requests,
                budgets cut to 8) unified over (1, 2) and disaggregated
                over (2, 1, 2); phase 13c's locality + exact engine on the
                first 3 fields over (1, 2) and (2, 1), and those fields as
                one batch over (2, 1) against 13a's rows; each against the
                same run on one device, made in this process beside the
                ranks' start: tokens, counters and each rank's launches
                equal (a rank whose vocab block holds pad lanes only
                launches no fused_heads), the near-tie rule as above.

Each kernel's launch count in the JSON line is read from one path's run,
the counts set to 0 just before it: verify_attention, fused_verify and
fused_heads from phase 6, tree_verify_attention from phase 6b,
paged_verify_attention from phase 4b's BPD exact run on the paged cache,
rwkv6_scan from phase 9, rwkv6_scan_bwd from phase 21b's training run
(every scan there with checkpoints and its backward, 24 of each a step;
phases 8-9 write no checkpoints and launch no backward).  The engine's path (phase 5c) is read the same
way, each of its two runs between a reset and a read, and checked exactly:
its group's attention kernel (paged_verify_attention or verify_attention
for exact, tree_verify_attention for topk_tree) once a layer per forward
the group dispatched, fused_verify once per forward, fused_heads once per
forward and per prefill forward; each of those five kernels must have run
in one of the two.  Phases 16-19 read each of their decode paths the same
way (hymba-1.5b's paged forward at 4 layers: 3 verify_attention + 1
paged_verify_attention).

Any failure exits non-zero.  The second-to-last lines are the kernels' JSON
and the card's name and power limit; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import gc
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12                 # H100 SXM
PEAK_FLOPS = {"bfloat16": 989e12,         # dense tensor-core rate
              "float32": 67e12,           # fp32 outside the tensor cores
              "tf32": 495e12}             # dense TF32 tensor-core rate
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
SCAN_TOL = 1e-4                           # relative, and of max|out| absolute:
                                          # fp32 sums in another order
TIE_MARGIN = 1e-4                         # of max|logit|: BPD/greedy near-ties
ROUTER_TIE_MARGIN = 1e-4                  # (p_K - p_K+1) / p_K: router near-ties
ROUTER_MATCH = 1e-3                       # of max|router logit|: one computation
HEADS_TIE_MARGIN = 1e-3                   # of max|logit|: fused-heads near-ties
BF16_TIE_ULPS = 8                         # bf16 ulps of max|logit|: reported
SPIN_CYCLES = 2_000_000                   # about 1 ms of device clock


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def stamp(t_start: float, done: str) -> None:
    log(f"[time] {done} done at {time.perf_counter() - t_start:.1f}s")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def time_ms(torch, fn, *, runs: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``runs`` calls, CUDA events around
    each; a 256 MB write before each call evicts the 50 MB L2, as the decode
    path (which streams GBs of weights between two calls) finds it.  A spin
    of about 1 ms on the device after the write keeps the stream busy while
    the host enqueues the call, so the time is the device's, not the
    wrapper's Python (a call whose host side takes longer than the spin,
    like a plain version's chain of small ops, is still timed with it)."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    del flush
    times.sort()
    return times[len(times) // 2]


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(byte_count: int, flops: float, dtype: str):
    t_bytes = byte_count / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fp32_row(ms, byte_count, flops, yardstick_ms=None, yardstick=None, *,
             peak="float32"):
    """A kernel's fp32 numbers for the kernel table: its time, its bound
    (bytes over 3.35 TB/s or the operations over the peak of the units
    that run them: the fp32 CUDA cores, or ``peak="tf32"`` for fp32 work
    done as TF32 products on the tensor cores) and, where there is one,
    the fp32 yardstick's time (TF32 off)."""
    bms, by = bound(byte_count, flops, peak)
    return {"ms": ms, "bound_ms": bms, "bound_by": by,
            "yardstick_ms": yardstick_ms, "yardstick": yardstick}


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def attention_case(torch, gen, b, kq, h, kvh, hd, l, dtype, *, length,
                   stale=0):
    """Cache of ``l`` slots holding positions 0..length+kq-1, a few stale
    slots (-1), slots past the block marked as stale speculative writes."""
    dt = getattr(torch, dtype)
    q = torch.randn((b, kq, h, hd), generator=gen, device="cuda").to(dt)
    k = torch.randn((b, l, kvh, hd), generator=gen, device="cuda").to(dt)
    v = torch.randn((b, l, kvh, hd), generator=gen, device="cuda").to(dt)
    base = torch.tensor(length, dtype=torch.int32, device="cuda")
    q_pos = base[:, None] + torch.arange(kq, dtype=torch.int32, device="cuda")
    slot = torch.arange(l, dtype=torch.int32, device="cuda")[None, :].expand(b, l)
    kv_pos = torch.where(slot < (base + kq)[:, None], slot, -1).contiguous()
    if stale:
        idx = torch.randint(0, l, (b, stale), generator=gen, device="cuda")
        kv_pos.scatter_(1, idx, -1)
    return q, k, v, q_pos, kv_pos


def sdpa_yardsticks(torch, q, k, v, mask):
    """The one-call yardstick two ways: scaled_dot_product_attention on K/V
    repeated per query head (the repeat outside the timed call), and with
    enable_gqa on the unrepeated K/V.  Returns (repeat_ms, gqa_ms); the
    faster is library_ms, the strongest single call."""
    g = q.shape[2] // k.shape[2]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt = q.transpose(1, 2)
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    kr = kt.repeat_interleave(g, dim=1)
    vr = vt.repeat_interleave(g, dim=1)
    repeat_ms = time_ms(torch, lambda: sdpa(qt, kr, vr, attn_mask=mask))
    gqa_ms = time_ms(torch, lambda: sdpa(qt, kt, vt, attn_mask=mask,
                                         enable_gqa=True))
    return repeat_ms, gqa_ms


def check_invariance(torch, name, fn, args, *, queries: bool):
    """Bit for bit: each batch row alone equals its row of the batch of 8,
    and (``queries``) each query alone, and each pair of neighbouring
    queries (the carry-over draft forward's kq 2), equals its rows of the
    block of kq."""
    full = fn(*args)
    for r in range(full.shape[0]):
        row = fn(*(t[r:r + 1].contiguous() for t in args))
        check(torch.equal(row, full[r:r + 1]),
              f"{name}: batch row {r} alone differs from its row at B = 8")
    if queries:
        q, k, v, q_pos, kv_pos = args
        kq = q.shape[1]
        for width in (w for w in (1, 2) if w < kq):
            for i in range(kq - width + 1):
                part = fn(q[:, i:i + width].contiguous(), k, v,
                          q_pos[:, i:i + width].contiguous(), kv_pos)
                check(torch.equal(part, full[:, i:i + width]),
                      f"{name}: queries {i}..{i + width - 1} at kq = "
                      f"{width} differ from their rows at kq = {kq}")


def check_attention(torch, gen, results):
    from repro_torch.kernels.block_attention import (split_plan,
                                                     verify_attention_cuda,
                                                     verify_attention_plain)

    cases = []   # (dtype, kq, L, window, meta, kind, H, KVH, hd)
    for dtype in ("bfloat16", "float32"):
        for kq in (1, 8):
            for l in (256, 4096):
                cases.append((dtype, kq, l, 0, 0, "path", 32, 8, 128))
        cases.append((dtype, 8, 256, 64, 4, "window+meta", 32, 8, 128))
        cases.append((dtype, 8, 256, 0, 0, "all-stale", 32, 8, 128))
        # the split plan's edges: one ragged range .. eight ranges
        for l in (1, 15, 16, 17, 63, 64, 65, 300):
            cases.append((dtype, 8, l, 0, 0, "split edge", 32, 8, 128))
        cases.append((dtype, 8, 256, 0, 0, "masked split", 32, 8, 128))
        cases.append((dtype, 8, 256, 0, 0, "blind row", 32, 8, 128))
        for hd in (32, 64):
            cases.append((dtype, 8, 300, 48, 3, f"hd {hd}", 32, 8, hd))
        cases.append((dtype, 16, 300, 0, 0, "kq·G 64", 32, 8, 128))
        cases.append((dtype, 16, 4096, 0, 0, "kq·G 64", 32, 8, 128))
        # the draft_model forwards (kq 1, and kq 2 with carry-over) over a
        # draft cache of 256 slots: granite-3-8b (15a), its smoke geometry
        # (15b, 15d, 15e) and the fixture's student (15c)
        for h, kvh, hd in ((32, 8, 128), (8, 2, 32), (4, 2, 16)):
            for kq in (1, 2):
                cases.append((dtype, kq, 256, 0, 0, "draft", h, kvh, hd))
    worst = 0.0
    path, draft = {}, []
    for dtype, kq, l, window, meta, kind, h, kvh, hd in cases:
        length = ([64 + 21 * i for i in range(8)] if kind == "draft"
                  else [l - kq - 3 * i for i in range(8)])
        q, k, v, q_pos, kv_pos = attention_case(torch, gen, 8, kq, h, kvh,
                                                hd, l, dtype, length=length,
                                                stale=5)
        if kind == "draft":
            # the k - 2 = 6 slots past the queries hold a rejected chain's
            # stale drafts at positions the queries must not see
            slot = torch.arange(l, dtype=torch.int32, device="cuda")[None]
            ahead = (slot > q_pos[:, -1:]) & (slot <= q_pos[:, -1:] + 6)
            kv_pos = torch.where(ahead, slot, kv_pos).contiguous()
        if kind == "all-stale":          # only the block itself is visible
            slot = torch.arange(l, dtype=torch.int32, device="cuda")[None]
            own = (slot >= q_pos[:, :1]) & (slot <= q_pos[:, -1:])
            kv_pos = torch.where(own, slot, -1).contiguous()
        elif kind == "masked split":     # range 1 of 4 sees nothing
            kv_pos[:, 64:128] = -1
        elif kind == "blind row":        # query 0 sees no key: the mean of V
            q_pos[:, 0] = -1
        got = verify_attention_cuda(q, k, v, q_pos, kv_pos, window=window,
                                    num_meta=meta)
        want = verify_attention_plain(q, k, v, q_pos, kv_pos, window=window,
                                      num_meta=meta)
        torch.cuda.synchronize()
        check(not torch.isnan(got).any(), f"verify_attention NaN ({kind})")
        err = (got.float() - want.float()).abs().max().item()
        tol = ATTN_TOL[dtype]
        ok = torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)
        log(f"  verify_attention {dtype} kq={kq} H={h}/{kvh} hd={hd} L={l} "
            f"(splits {split_plan(l)[0]}) {kind}: max_abs_err={err:.3g} "
            f"{'ok' if ok else 'FAIL'}")
        check(ok, f"verify_attention {dtype} kq={kq} L={l} {kind} "
                  f"differs from its plain version by {err}")
        worst = max(worst, err)
        if kind == "path" and kq == 8:
            path[(dtype, l)] = (q, k, v, q_pos, kv_pos)
        if kind == "draft" and kq == 2:
            draft.append((f"{dtype} {h}/{kvh} heads of {hd}",
                          (q, k, v, q_pos, kv_pos)))
    log(f"  verify_attention: max_abs_err over all {len(cases)} cases "
        f"{worst:.3g}")
    for (dtype, l), args in path.items():
        check_invariance(torch, f"verify_attention {dtype} L={l}",
                         verify_attention_cuda, args, queries=True)
        log(f"  verify_attention {dtype} L={l}: kq 1 == kq 2 == kq 8 and "
            f"B 1 == B 8 bit for bit ok")
    for tag, args in draft:
        check_invariance(torch, f"verify_attention draft {tag}",
                         verify_attention_cuda, args, queries=True)
        log(f"  verify_attention draft {tag}: kq 1 == kq 2 and B 1 == B 8 "
            f"bit for bit ok")

    # time at the serve path's shape: bf16, B=8, kq=8, L=256
    q, k, v, q_pos, kv_pos = path[("bfloat16", 256)]
    kernel_ms = time_ms(torch, lambda: verify_attention_cuda(q, k, v, q_pos, kv_pos))
    plain_ms = time_ms(torch, lambda: verify_attention_plain(q, k, v, q_pos, kv_pos))
    f32 = path[("float32", 256)]
    fp32_ms = time_ms(torch, lambda: verify_attention_cuda(*f32))
    # yardstick: one scaled_dot_product_attention call on the same values
    # (heads-first views, the mask from the positions: input preparation,
    # outside the timed call)
    b, kq, h, hd = q.shape
    l = k.shape[1]
    mask = ((kv_pos[:, None, :] >= 0)
            & (kv_pos[:, None, :] <= q_pos[:, :, None]))[:, None]
    repeat_ms, gqa_ms = sdpa_yardsticks(torch, q, k, v, mask)
    flops = 4 * b * kq * h * l * hd
    bms, by = bound(nbytes(q, k, v, q_pos, kv_pos, q), flops, "bfloat16")
    f32_lib = min(sdpa_yardsticks(torch, *f32[:3], mask))
    results["verify_attention"] = dict(
        source="src/repro_torch/kernels/csrc/verify_attention.cu",
        replaces="src/repro/kernels/block_attention.py:83",
        max_abs_err=worst, ms=kernel_ms, plain_ms=plain_ms, bound_ms=bms,
        bound_by=by, library_ms=min(repeat_ms, gqa_ms),
        fp32=fp32_row(fp32_ms, nbytes(*f32, f32[0]), flops, f32_lib,
                      "SDPA, the faster of repeated K/V and enable_gqa"),
        extra=f"SDPA repeated K/V {repeat_ms:.4f} ms, enable_gqa "
              f"{gqa_ms:.4f} ms",
        shape="bf16 q (8,8,32,128), k/v (8,256,8,128)")


def tree_case(torch, gen, b, h, kvh, hd, l, topo, dtype, *, stale=0):
    """A cache of ``l`` slots whose slots [length, length + kq) hold the
    block's tree nodes at logical positions length + depth, the prefix
    below, a few stale prefix slots (-1)."""
    dt = getattr(torch, dtype)
    kq = topo.num_nodes
    q = torch.randn((b, kq, h, hd), generator=gen, device="cuda").to(dt)
    k = torch.randn((b, l, kvh, hd), generator=gen, device="cuda").to(dt)
    v = torch.randn((b, l, kvh, hd), generator=gen, device="cuda").to(dt)
    length = torch.tensor([l - kq - 3 * i for i in range(b)], dtype=torch.int32,
                          device="cuda")
    depth = torch.as_tensor(topo.depths, dtype=torch.int32, device="cuda")
    q_pos = (length[:, None] + depth[None, :]).contiguous()
    slot = torch.arange(l, dtype=torch.int32, device="cuda")[None, :]
    node = slot - length[:, None]
    in_tree = (node >= 0) & (node < kq)
    kv_node = torch.where(in_tree, node, -1).int().contiguous()
    kv_pos = torch.where(slot < length[:, None], slot,
                         torch.where(in_tree, length[:, None]
                                     + depth[node.clamp(0, kq - 1)], -1)).int()
    if stale:
        idx = torch.randint(0, l - 64, (b, stale), generator=gen, device="cuda")
        kv_pos.scatter_(1, idx, -1)
    anc = torch.as_tensor(topo.anc_bits, dtype=torch.int32,
                          device="cuda")[None].repeat(b, 1)
    return q, k, v, q_pos, kv_pos.contiguous(), kv_node, anc


def check_tree_attention(torch, gen, results):
    from repro_torch.kernels.block_attention import (tree_verify_attention_cuda,
                                                     tree_verify_attention_plain,
                                                     verify_attention_cuda)
    from repro_torch.kernels.tree_mask import TreeTopology, default_tree

    chain = TreeTopology((-1,) + tuple(range(7)))
    chain32 = TreeTopology((-1,) + tuple(range(31)))
    cases = []   # (dtype, topology name, topology, H, L, window, meta, hd)
    for dtype in ("bfloat16", "float32"):
        for name, topo in (("tree(8,2)", default_tree(8, 2)),
                           ("tree(8,4)", default_tree(8, 4)),
                           ("chain(8)", chain)):
            for l in (256, 4096):
                cases.append((dtype, name, topo, 32, l, 0, 0, 128))
        cases.append((dtype, "tree(8,2) window+meta", default_tree(8, 2), 32,
                      256, 64, 4, 128))
        # 32 nodes: node 31's bit is the int32 sign bit; kq·G <= 64, so G = 2
        cases.append((dtype, "chain(32) bit 31", chain32, 16, 256, 0, 0, 128))
        cases.append((dtype, "tree(32,4) bit 31", default_tree(32, 4), 16,
                      4096, 0, 0, 128))
        # the split plan's edges, and the other head dims
        for l in (72, 300):
            cases.append((dtype, "tree(8,2)", default_tree(8, 2), 32, l, 0, 0,
                          128))
            cases.append((dtype, "chain(8)", chain, 32, l, 0, 0, 128))
        for hd in (32, 64):
            cases.append((dtype, "tree(8,4)", default_tree(8, 4), 32, 300, 0,
                          0, hd))
    worst = 0.0
    timed = {}
    for dtype, name, topo, h, l, window, meta, hd in cases:
        args = tree_case(torch, gen, 8, h, 8, hd, l, topo, dtype, stale=5)
        got = tree_verify_attention_cuda(*args, window=window, num_meta=meta)
        want = tree_verify_attention_plain(*args, window=window, num_meta=meta)
        torch.cuda.synchronize()
        check(not torch.isnan(got).any(), f"tree_verify_attention NaN ({name})")
        check(topo.num_nodes < 32 or int(args[-1][0, 31]) < 0,
              "the 32-node case does not set bit 31")
        err = (got.float() - want.float()).abs().max().item()
        tol = ATTN_TOL[dtype]
        ok = torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)
        extra = ""
        if name == "chain(8)":        # a chain's ancestor mask is causality
            chain_out = verify_attention_cuda(*args[:5], window=window,
                                              num_meta=meta)
            same = torch.equal(got, chain_out)
            extra = f", equal to verify_attention's bit for bit: {same}"
            ok = ok and same
        log(f"  tree_verify_attention {dtype} {name} H={h} hd={hd} L={l}: "
            f"max_abs_err={err:.3g}{extra} {'ok' if ok else 'FAIL'}")
        check(ok, f"tree_verify_attention {dtype} {name} L={l} differs from "
                  f"its plain version by {err}{extra}")
        worst = max(worst, err)
        if (name, l, window, hd) == ("tree(8,2)", 256, 0, 128):
            timed[dtype] = args
    log(f"  tree_verify_attention: max_abs_err over all {len(cases)} cases "
        f"{worst:.3g}")
    for dtype, args in timed.items():
        check_invariance(torch, f"tree_verify_attention {dtype}",
                         tree_verify_attention_cuda, args, queries=False)
        log(f"  tree_verify_attention {dtype}: B 1 == B 8 bit for bit ok")

    # time at the topk_tree path's shape: bf16, B=8, kq=8 (default_tree(8, 2),
    # --top-k 2), H=32, KV=8, L=256
    args = timed["bfloat16"]
    q, k, v, q_pos, kv_pos, kv_node, anc = args
    kernel_ms = time_ms(torch, lambda: tree_verify_attention_cuda(*args))
    plain_ms = time_ms(torch, lambda: tree_verify_attention_plain(*args))
    fp32_ms = time_ms(torch, lambda: tree_verify_attention_cuda(*timed["float32"]))
    # yardstick: scaled_dot_product_attention with the boolean tree mask
    # precomputed (outside the timed call)
    b, kq, h, hd = q.shape
    l = k.shape[1]
    qp, kp, kn = q_pos[:, :, None], kv_pos[:, None, :], kv_node[:, None, :]
    bit = (anc[:, :, None] >> kn.clamp(0, 31)) & 1
    mask = ((kp >= 0) & (kp <= qp) & ((kn < 0) | (bit != 0)))[:, None]
    repeat_ms, gqa_ms = sdpa_yardsticks(torch, q, k, v, mask)
    flops = 4 * b * kq * h * l * hd
    bms, by = bound(nbytes(q, k, v, q_pos, kv_pos, kv_node, anc, q), flops,
                    "bfloat16")
    f32 = timed["float32"]
    f32_lib = min(sdpa_yardsticks(torch, *f32[:3], mask))
    results["tree_verify_attention"] = dict(
        source="src/repro_torch/kernels/csrc/tree_verify_attention.cu",
        replaces="src/repro/kernels/block_attention.py:210",
        max_abs_err=worst, ms=kernel_ms, plain_ms=plain_ms, bound_ms=bms,
        bound_by=by, library_ms=min(repeat_ms, gqa_ms),
        fp32=fp32_row(fp32_ms, nbytes(*f32, f32[0]), flops, f32_lib,
                      "SDPA with the tree mask, the faster of repeated K/V "
                      "and enable_gqa"),
        extra=f"SDPA repeated K/V {repeat_ms:.4f} ms, enable_gqa "
              f"{gqa_ms:.4f} ms",
        shape="bf16 q (8,8,32,128) default_tree(8,2), k/v (8,256,8,128)")


def paged_case(torch, gen, b, kq, h, kvh, hd, P, ps, dtype, *, ctx,
               share=False, unmapped=0):
    """A pool of 1 + B·P pages under a shuffled table; row r holds
    positions 0..ctx[r]-1.  ``share``: row 1's first page is row 0's.
    ``unmapped``: the last pages of the last row point at trash page 0 with
    pos -1."""
    dt = getattr(torch, dtype)
    num_pages = 1 + b * P
    q = torch.randn((b, kq, h, hd), generator=gen, device="cuda").to(dt)
    kp = torch.randn((num_pages, ps, kvh, hd), generator=gen, device="cuda").to(dt)
    vp = torch.randn((num_pages, ps, kvh, hd), generator=gen, device="cuda").to(dt)
    tbl = (1 + torch.randperm(b * P, generator=gen, device="cuda")).int()
    tbl = tbl.reshape(b, P).contiguous()
    if share:
        tbl[1, 0] = tbl[0, 0]
    ctx = torch.tensor(ctx, dtype=torch.int32, device="cuda")
    slot = torch.arange(P * ps, dtype=torch.int32, device="cuda")[None, :]
    kv_pos = torch.where(slot < ctx[:, None], slot, -1).int()
    if unmapped:
        tbl[-1, P - unmapped:] = 0
        kv_pos[-1, (P - unmapped) * ps:] = -1
    q_pos = (ctx[:, None] - kq
             + torch.arange(kq, dtype=torch.int32, device="cuda")[None, :])
    return q, kp, vp, tbl, q_pos.int().contiguous(), kv_pos.contiguous()


def paged_gathered(torch, q, kp, vp, tbl, q_pos, kv_pos):
    """The dense (B, P·ps, KV, hd) view kp[tbl] the paged kernel reads
    through its table."""
    b, n_pages = tbl.shape
    _, ps, kvh, hd = kp.shape
    k = kp[tbl.long()].reshape(b, n_pages * ps, kvh, hd).contiguous()
    v = vp[tbl.long()].reshape(b, n_pages * ps, kvh, hd).contiguous()
    return q, k, v, q_pos, kv_pos


def check_paged_attention(torch, gen, results):
    from repro_torch.kernels.block_attention import verify_attention_cuda
    from repro_torch.kernels.paged_attention import (paged_verify_attention_cuda,
                                                     paged_verify_attention_plain)

    b, h, kvh, hd, P = 8, 32, 8, 128, 9
    cases = []   # (dtype, ps, kq, window, meta, kind)
    for dtype in ("bfloat16", "float32"):
        for ps in (8, 16):
            for kq in (1, 8):
                cases.append((dtype, ps, kq, 0, 0, "path"))
        cases.append((dtype, 16, 8, 0, 0, "shared page"))
        cases.append((dtype, 16, 8, 0, 0, "unmapped"))
        cases.append((dtype, 16, 8, 48, 4, "window+meta"))
    worst = 0.0
    timed = {}
    for dtype, ps, kq, window, meta, kind in cases:
        n = P * 16 // ps              # the same span of positions at any ps
        ctx = [n * ps - 3 * i for i in range(b)]
        if kind == "unmapped":
            ctx[-1] = (n - 3) * ps - 5
        args = paged_case(torch, gen, b, kq, h, kvh, hd, n, ps, dtype, ctx=ctx,
                          share=kind == "shared page",
                          unmapped=3 if kind == "unmapped" else 0)
        got = paged_verify_attention_cuda(*args, window=window, num_meta=meta)
        want = paged_verify_attention_plain(*args, window=window, num_meta=meta)
        torch.cuda.synchronize()
        check(not torch.isnan(got).any(), f"paged_verify_attention NaN ({kind})")
        err = (got.float() - want.float()).abs().max().item()
        tol = ATTN_TOL[dtype]
        ok = torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)
        # the same split body on the gathered view kp[tbl]: bit for bit
        gathered = verify_attention_cuda(*paged_gathered(torch, *args),
                                         window=window, num_meta=meta)
        same = torch.equal(got, gathered)
        log(f"  paged_verify_attention {dtype} ps={ps} kq={kq} {kind}: "
            f"max_abs_err={err:.3g}, equal to verify_attention on kp[tbl] "
            f"bit for bit: {same} {'ok' if ok and same else 'FAIL'}")
        check(ok and same, f"paged_verify_attention {dtype} ps={ps} kq={kq} "
                           f"{kind} differs from its plain version by {err} "
                           f"or from verify_attention on the gathered view")
        worst = max(worst, err)
        if (ps, kq, kind) == (16, 8, "path"):
            timed[dtype] = args
    log(f"  paged_verify_attention: max_abs_err over all {len(cases)} cases "
        f"{worst:.3g}")
    for dtype, args in timed.items():
        q, kp, vp, tbl, q_pos, kv_pos = args
        full = paged_verify_attention_cuda(*args)
        for r in range(q.shape[0]):              # the pool is shared
            row = paged_verify_attention_cuda(
                q[r:r + 1].contiguous(), kp, vp, tbl[r:r + 1].contiguous(),
                q_pos[r:r + 1].contiguous(), kv_pos[r:r + 1].contiguous())
            check(torch.equal(row, full[r:r + 1]),
                  f"paged_verify_attention {dtype}: batch row {r} alone "
                  f"differs from its row at B = 8")
        for i in range(q.shape[1]):
            one = paged_verify_attention_cuda(q[:, i:i + 1].contiguous(), kp,
                                              vp, tbl,
                                              q_pos[:, i:i + 1].contiguous(),
                                              kv_pos)
            check(torch.equal(one, full[:, i:i + 1]),
                  f"paged_verify_attention {dtype}: query {i} at kq = 1 "
                  f"differs from its row at kq = 8")
        log(f"  paged_verify_attention {dtype}: kq 1 == kq 8 and B 1 == B 8 "
            f"bit for bit ok")

    # time at the paged path's shape: bf16, B=8, kq=8, P=9 pages of 16
    # (L 144: 3 ranges of 48 keys), every page mapped
    q, kp, vp, tbl, q_pos, kv_pos = timed["bfloat16"]
    kernel_ms = time_ms(torch, lambda: paged_verify_attention_cuda(*timed["bfloat16"]))
    plain_ms = time_ms(torch, lambda: paged_verify_attention_plain(*timed["bfloat16"]))
    fp32_ms = time_ms(torch, lambda: paged_verify_attention_cuda(*timed["float32"]))
    # bytes: the pages this table maps (each read once), not the whole pool
    mapped = int(torch.unique(tbl).numel())
    page_bytes = kp[0].numel() * kp.element_size()
    bq, kq, hq, hdq = q.shape
    flops = 4 * bq * kq * hq * tbl.shape[1] * kp.shape[1] * hdq
    bms, by = bound(2 * mapped * page_bytes + nbytes(q, tbl, q_pos, kv_pos, q),
                    flops, "bfloat16")
    q32, kp32 = timed["float32"][0], timed["float32"][1]
    f32_bytes = (2 * mapped * kp32[0].numel() * kp32.element_size()
                 + nbytes(q32, tbl, q_pos, kv_pos, q32))
    results["paged_verify_attention"] = dict(
        source="src/repro_torch/kernels/csrc/paged_verify_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:87",
        max_abs_err=worst, ms=kernel_ms, plain_ms=plain_ms, bound_ms=bms,
        bound_by=by, library_ms=None,
        fp32=fp32_row(fp32_ms, f32_bytes, flops),
        shape=f"bf16 q (8,8,32,128), {mapped} mapped pages of (16,8,128)")


def check_split_kv(torch, gen, results, *, model, hd, h, kvh, kq, l, dtype,
                   timed):
    """The three split-KV kernels at one head_dim and shape (B 8, ``kq``
    queries, ``h`` heads over ``kvh`` KV heads, L ``l``; the paged kernel
    over ceil(L / 16) pages of 16, one page shared and one unmapped)
    against their plain versions, and bit for bit batch-invariant: kq 1 vs
    ``kq`` for the chain kernels, B 1 vs 8 for all three, the paged kernel
    equal to verify_attention on the gathered view.  The errors join each
    kernel's max_abs_err; with ``timed`` each call is timed beside its
    plain version, SDPA and the bound (``time_split_kv``)."""
    from repro_torch.kernels.block_attention import (tree_verify_attention_cuda,
                                                     tree_verify_attention_plain,
                                                     verify_attention_cuda,
                                                     verify_attention_plain)
    from repro_torch.kernels.paged_attention import (paged_verify_attention_cuda,
                                                     paged_verify_attention_plain)
    from repro_torch.kernels.tree_mask import default_tree

    b, ps = 8, 16
    P = -(-l // ps)
    tol = ATTN_TOL[dtype]
    tag = f"{dtype} hd {hd} {model}"
    cases = (
        ("verify_attention", verify_attention_cuda, verify_attention_plain,
         attention_case(torch, gen, b, kq, h, kvh, hd, l, dtype,
                        length=[l - kq - 3 * i for i in range(b)], stale=5)),
        ("tree_verify_attention", tree_verify_attention_cuda,
         tree_verify_attention_plain,
         tree_case(torch, gen, b, h, kvh, hd, l, default_tree(kq, 2), dtype,
                   stale=5 if l > 64 else 0)),
        ("paged_verify_attention", paged_verify_attention_cuda,
         paged_verify_attention_plain,
         paged_case(torch, gen, b, kq, h, kvh, hd, P, ps, dtype,
                    ctx=[P * ps - 3 * i for i in range(b)], share=True,
                    unmapped=1)))
    for name, fn, plain, args in cases:
        got = fn(*args)
        want = plain(*args)
        torch.cuda.synchronize()
        check(not torch.isnan(got).any(), f"{name} {tag} NaN")
        err = (got.float() - want.float()).abs().max().item()
        ok = torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)
        check(ok, f"{name} {tag} L {l} differs from its plain version by "
                  f"{err}")
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)
        if name == "paged_verify_attention":            # the pool is shared
            q, kp, vp, tbl, q_pos, kv_pos = args
            check(torch.equal(got, verify_attention_cuda(
                *paged_gathered(torch, *args))),
                  f"{name} {tag}: not verify_attention on the gathered view "
                  f"bit for bit")
            for r in range(b):
                row = fn(q[r:r + 1].contiguous(), kp, vp,
                         tbl[r:r + 1].contiguous(),
                         q_pos[r:r + 1].contiguous(),
                         kv_pos[r:r + 1].contiguous())
                check(torch.equal(row, got[r:r + 1]),
                      f"{name} {tag}: batch row {r} alone differs from its "
                      f"row at B = 8")
        else:
            check_invariance(torch, f"{name} {tag}", fn, args,
                             queries=name == "verify_attention")
        log(f"  {name} {tag} (B {b}, kq {kq}, {h}/{kvh} heads, L "
            f"{P * ps if name == 'paged_verify_attention' else l}): "
            f"max_abs_err={err:.3g}, invariant bit for bit ok")
        if timed:
            time_split_kv(torch, name, fn, plain, args, dtype, model)


def check_head_dim_16(torch, gen, results):
    """The three split-KV kernels at head_dim 16 (the trained policy-sweep
    model: 4 heads of 16, kq 8, L 300), bf16 and fp32 (``check_split_kv``);
    then verify_attention as the encoder-decoder's cross attention calls it
    (every query at position 0, the source's keys at 0 and a masked tail at
    -1), at paper-mt-base's heads (8 of 64) and the sweep model's (4 of 16).
    The errors join each kernel's max_abs_err; the times are printed
    (PERF.md §6)."""
    from repro_torch.kernels.block_attention import (verify_attention_cuda,
                                                     verify_attention_plain)

    b = 8
    for dtype in ("bfloat16", "float32"):
        check_split_kv(torch, gen, results, model="policy-sweep", hd=16, h=4,
                       kvh=4, kq=8, l=300, dtype=dtype, timed=True)

    # the cross attention call: q_pos 0, source keys at 0, masked tails
    tails = [0, 3, 5, 0, 7, 1, 0, 2]
    worst = 0.0
    for heads, hdim in ((8, 64), (4, 16)):
        for dtype in ("bfloat16", "float32"):
            tol = ATTN_TOL[dtype]
            dt = getattr(torch, dtype)
            for kq_ in (1, 8):
                for se in (24, 64):
                    q = torch.randn((b, kq_, heads, hdim), generator=gen,
                                    device="cuda").to(dt)
                    k = torch.randn((b, se, heads, hdim), generator=gen,
                                    device="cuda").to(dt)
                    v = torch.randn((b, se, heads, hdim), generator=gen,
                                    device="cuda").to(dt)
                    q_pos = torch.zeros((b, kq_), dtype=torch.int32,
                                        device="cuda")
                    slot = torch.arange(se, device="cuda")[None, :]
                    tail = torch.tensor(tails, device="cuda")[:, None]
                    kv_pos = torch.where(slot < se - tail, 0, -1).int()
                    got = verify_attention_cuda(q, k, v, q_pos, kv_pos)
                    want = verify_attention_plain(q, k, v, q_pos, kv_pos)
                    torch.cuda.synchronize()
                    err = (got.float() - want.float()).abs().max().item()
                    check(torch.allclose(got.float(), want.float(), rtol=tol,
                                         atol=tol),
                          f"cross attention {dtype} H {heads} hd {hdim} "
                          f"kq {kq_} Se {se} differs by {err}")
                    worst = max(worst, err)
                    if (heads, dtype, kq_, se) == (8, "bfloat16", 8, 64):
                        timed = (q, k, v, q_pos, kv_pos)
    results["verify_attention"]["max_abs_err"] = max(
        results["verify_attention"]["max_abs_err"], worst)
    q, k, v, q_pos, kv_pos = timed
    ms = time_ms(torch, lambda: verify_attention_cuda(*timed))
    plain_ms = time_ms(torch, lambda: verify_attention_plain(*timed))
    mask = (kv_pos[:, None, :] >= 0).expand(b, 8, -1)[:, None]
    repeat_ms, gqa_ms = sdpa_yardsticks(torch, q, k, v, mask)
    bms, by = bound(nbytes(q, k, v, q_pos, kv_pos, q),
                    4 * b * 8 * 8 * 64 * 64, "bfloat16")
    log(f"  cross attention (verify_attention, q_pos 0, masked tails): "
        f"max_abs_err={worst:.3g} over 16 cases ok; paper-mt-base's call "
        f"bf16 q (8,8,8,64), k/v (8,64,8,64): kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, SDPA {min(repeat_ms, gqa_ms):.4f} ms, bound "
        f"{bms:.5f} ms ({by})")


def check_head_dim_24(torch, gen, results):
    """The three split-KV kernels at head_dim 24 (computed at the width 32,
    lanes 24-31 zero, scale 1/√24), ``check_split_kv`` at quickstart's
    heads (B 8, kq 4, 4 heads over 2 KV heads) and the superres grid
    model's (4 over 4), L 60 and 200, bf16 and fp32, each timed at
    quickstart's shape, L 200.  Then fused_heads and fused_verify at those
    models' vocabularies, 32 and 16 padded to 256 lanes (-1e9 past the
    vocab), against their plain versions.  The errors join each kernel's
    max_abs_err; the times are printed (PERF.md §6)."""
    from repro_torch.kernels.fused_heads import fused_heads_topk_cuda
    from repro_torch.kernels.fused_verify import (fused_verify_cuda,
                                                  fused_verify_plain)

    b, kq = 8, 4
    for model, h, kvh in (("quickstart", 4, 2), ("superres", 4, 4)):
        for dtype in ("bfloat16", "float32"):
            for l in (60, 200):
                check_split_kv(torch, gen, results, model=model, hd=24, h=h,
                               kvh=kvh, kq=kq, l=l, dtype=dtype,
                               timed=model == "quickstart" and l == 200)

    # fused_heads / fused_verify at vocab 32 (quickstart, d 96) and 16
    # (superres, d 64), both padded to 256 lanes
    for model, d, vocab in (("quickstart", 96, 32), ("superres", 64, 16)):
        for dtype in ("bfloat16", "float32"):
            dt = getattr(torch, dtype)
            w = (torch.randn((d, 256), generator=gen, device="cuda") * 0.1).to(dt)
            o = torch.randn((b * (kq - 1), d), generator=gen,
                            device="cuda").to(dt)
            vals, ids = fused_heads_topk_cuda(o, w, vocab=vocab, top_t=1)
            torch.cuda.synchronize()
            ok, ties, wv = heads_ids_agree(torch, vals, ids, o, w, vocab, 1)
            err = (vals - wv).abs().max().item()
            tol = ATTN_TOL[dtype]
            ok = ok and torch.allclose(vals, wv, rtol=tol, atol=tol)
            check(ok and int(ids.max()) < vocab,
                  f"fused_heads {model} {dtype} vocab {vocab} differs from "
                  f"its plain version (err {err})")
            results["fused_heads"]["max_abs_err"] = max(
                results["fused_heads"]["max_abs_err"], err)
            logits = torch.randn((b, kq, 256), generator=gen, device="cuda")
            logits[..., vocab:] = -1e9                  # as project_vocab pads
            logits = logits.to(dt)
            greedy = torch.argmax(logits.float(), -1).int()
            props = torch.randint(0, vocab, greedy.shape, generator=gen,
                                  device="cuda", dtype=torch.int32)
            props[:, 1:3] = greedy[:, 0:2]
            for crit in ("exact", "topk", "distance"):
                got = fused_verify_cuda(logits, props, criterion=crit, top_k=2,
                                        epsilon=2.0)
                want = fused_verify_plain(logits, props, criterion=crit,
                                          top_k=2, epsilon=2.0)
                torch.cuda.synchronize()
                check(all(torch.equal(g, x) for g, x in zip(got, want)),
                      f"fused_verify {model} {dtype} vocab {vocab} {crit} "
                      f"differs from its plain version")
            heads_ms = time_ms(torch, lambda: fused_heads_topk_cuda(
                o, w, vocab=vocab, top_t=1))
            verify_ms = time_ms(torch, lambda: fused_verify_cuda(
                logits, props, criterion="exact"))
            log(f"  fused_heads {model} {dtype} ({b * (kq - 1)},{d})x({d},256) "
                f"vocab {vocab}: max_abs_err={err:.3g} near-ties={ties}, "
                f"kernel {heads_ms:.4f} ms; fused_verify ({b},{kq},256) bit for "
                f"bit under exact/topk/distance, kernel {verify_ms:.4f} ms ok")


# the families' attention heads: (model, H, KV, head_dim, the chain's kq,
# its cache lengths, the paged case's pages of 16, the L the trees and the
# timed calls run at); stablelm-12b's head_dim 160, starcoder2-7b's G 9 (72
# rows at kq 8, 288 under a 32-node tree: row tiles), llava-next-34b's G 7
# (56 rows at kq 8, 224 under a 32-node tree) behind its 2,880 patches
# (2880 + 64 + 64 + 8 = 3016 positions)
FAMILY_HEADS = (("stablelm-12b", 32, 8, 160, (1, 2, 8), (60, 256, 4096), 16,
                 256),
                ("starcoder2-7b", 36, 4, 128, (7, 8, 32), (256, 4096), 16, 256),
                ("olmoe-1b-7b / qwen2-moe-a2.7b", 16, 16, 128, (1, 2, 8),
                 (256, 4096), 16, 256),
                ("llava-next-34b", 56, 8, 128, (1, 2, 8), (256, 3016), 189,
                 3016))
# (model, d, vocab, lm_head lanes, T values, rows of o): the untied lm_heads
# of the families, pad lanes past the vocab as the path has them; llava's
# 56 rows are B 8 x 7 heads, 28 its B 4 serve's
FAMILY_VOCABS = (("nemotron-4-15b", 6144, 256000, 256000, (1, 4, 8), (56,)),
                 ("olmoe-1b-7b", 2048, 50304, 50432, (1, 8), (56,)),
                 ("qwen2-moe-a2.7b", 2048, 151936, 152064, (1, 8), (56,)),
                 ("hymba-1.5b", 1600, 32001, 32256, (1, 8), (56,)),
                 ("llava-next-34b", 7168, 64000, 64000, (1, 8), (56, 28)))
RING, WINDOW = 4352, 4096        # starcoder2-7b's dense ring (models/cache.py)
# hymba-1.5b's heads (25 over 5 KV heads of 64: G 5) and its windowed
# layers' ring: 1280 slots, the first 128 reserved for the meta tokens,
# a window of 1024 (models/cache.py)
HYMBA_HEADS = (25, 5, 64)
HYMBA_RING, HYMBA_WINDOW, HYMBA_META = 1280, 1024, 128


def ring_case(torch, gen, b, kq, h, kvh, hd, dtype):
    """A wrapped ring of RING slots: slot s holds the newest position p < top
    with p = s mod RING, the queries at top - kq .. top - 1 (top past two
    turns of the ring), so the window of WINDOW masks the ring's oldest
    slots."""
    dt = getattr(torch, dtype)
    q = torch.randn((b, kq, h, hd), generator=gen, device="cuda").to(dt)
    k = torch.randn((b, RING, kvh, hd), generator=gen, device="cuda").to(dt)
    v = torch.randn((b, RING, kvh, hd), generator=gen, device="cuda").to(dt)
    top = torch.tensor([2 * RING + 37 * i + 5 for i in range(b)],
                       dtype=torch.int32, device="cuda")
    slot = torch.arange(RING, dtype=torch.int32, device="cuda")[None, :]
    kv_pos = (top[:, None] - 1 - (top[:, None] - 1 - slot) % RING).int()
    q_pos = (top[:, None] - kq
             + torch.arange(kq, dtype=torch.int32, device="cuda")[None, :])
    return q, k, v, q_pos.int().contiguous(), kv_pos.contiguous()


def meta_ring_case(torch, gen, b, kq, h, kvh, hd, dtype):
    """hymba-1.5b's windowed-layer ring past its first turn: slots 0..127
    hold the meta positions 0..127, slot s >= 128 the newest position p <
    top with (p - 128) mod 1152 = s - 128, the queries at top - kq .. top -
    1 (top about 1,680: meta + a 1,536-token prompt + 16 new), so the
    window of 1024 masks the ring's oldest slots and the meta head stays
    visible."""
    dt = getattr(torch, dtype)
    ring = HYMBA_RING - HYMBA_META
    q = torch.randn((b, kq, h, hd), generator=gen, device="cuda").to(dt)
    k = torch.randn((b, HYMBA_RING, kvh, hd), generator=gen,
                    device="cuda").to(dt)
    v = torch.randn((b, HYMBA_RING, kvh, hd), generator=gen,
                    device="cuda").to(dt)
    top = torch.tensor([1680 - 7 * i for i in range(b)], dtype=torch.int32,
                       device="cuda")[:, None]
    slot = torch.arange(HYMBA_RING, dtype=torch.int32, device="cuda")[None, :]
    wrapped = top - 1 - (top - 1 - slot) % ring
    kv_pos = torch.where(slot < HYMBA_META, slot, wrapped).int()
    q_pos = top - kq + torch.arange(kq, dtype=torch.int32, device="cuda")[None]
    return q, k, v, q_pos.int().contiguous(), kv_pos.contiguous()


def check_hymba_heads(torch, gen, results):
    """verify_attention and paged_verify_attention at hymba-1.5b's heads
    (25 over 5 KV heads of 64: kq 8 is 40 query rows in one 48-row tile),
    bf16 and fp32, against their plain versions: the chain kernel at kq 1,
    2 and 8 over L 512 (64-token prompts after 128 meta tokens), and at kq
    8 over the windowed layers' wrapped ring of 1280 slots with the window
    of 1024 and 128 reserved meta slots; the paged kernel over 32 pages of
    16 (one shared, one unmapped) equal to verify_attention on the
    gathered view; each bit for bit batch-invariant (kq 1 and 2 against
    the block, B 1 against 8).  The errors join each kernel's max_abs_err;
    kq 8 at L 512, the ring and the pages are timed beside the plain
    version, SDPA and the bound."""
    import functools

    from repro_torch.kernels.block_attention import (row_plan,
                                                     verify_attention_cuda,
                                                     verify_attention_plain)
    from repro_torch.kernels.paged_attention import (paged_verify_attention_cuda,
                                                     paged_verify_attention_plain)

    b, l = 8, 512
    h, kvh, hd = HYMBA_HEADS
    meta = dict(window=HYMBA_WINDOW, num_meta=HYMBA_META)
    for dtype in ("bfloat16", "float32"):
        tol = ATTN_TOL[dtype]
        pre = f"{dtype} hymba-1.5b {h}/{kvh} heads of {hd}"

        def held(name, fn, plain, args, tag, **kw):
            got = fn(*args, **kw)
            want = plain(*args, **kw)
            torch.cuda.synchronize()
            check(not torch.isnan(got).any(), f"{name} {tag} NaN")
            err = (got.float() - want.float()).abs().max().item()
            check(torch.allclose(got.float(), want.float(), rtol=tol,
                                 atol=tol),
                  f"{name} {tag} differs from its plain version by {err}")
            results[name]["max_abs_err"] = max(results[name]["max_abs_err"],
                                               err)
            rows = args[0].shape[1] * h // kvh
            log(f"  {name} {tag} ({rows} rows, row_plan {row_plan(rows)}): "
                f"max_abs_err={err:.3g} ok")
            return got

        for kq in (1, 2, 8):
            args = attention_case(torch, gen, b, kq, h, kvh, hd, l, dtype,
                                  length=[l - kq - 3 * i for i in range(b)],
                                  stale=5)
            held("verify_attention", verify_attention_cuda,
                 verify_attention_plain, args, f"{pre} kq {kq} L {l}")
            if kq == 8:
                check_invariance(torch, f"verify_attention {pre} kq 8",
                                 verify_attention_cuda, args, queries=True)
                time_split_kv(torch, "verify_attention", verify_attention_cuda,
                              verify_attention_plain, args, dtype,
                              "hymba-1.5b")
        args = meta_ring_case(torch, gen, b, 8, h, kvh, hd, dtype)
        tag = (f"{pre} kq 8, ring {HYMBA_RING} (window {HYMBA_WINDOW}, "
               f"{HYMBA_META} meta slots)")
        held("verify_attention", verify_attention_cuda, verify_attention_plain,
             args, tag, **meta)
        check_invariance(torch, f"verify_attention {tag}",
                         functools.partial(verify_attention_cuda, **meta),
                         args, queries=True)
        time_split_kv(torch, "verify_attention", verify_attention_cuda,
                      verify_attention_plain, args, dtype,
                      "hymba-1.5b ring with meta slots", **meta)
        P, ps = l // 16, 16
        args = paged_case(torch, gen, b, 8, h, kvh, hd, P, ps, dtype,
                          ctx=[P * ps - 3 * i for i in range(b)], share=True,
                          unmapped=1)
        got = held("paged_verify_attention", paged_verify_attention_cuda,
                   paged_verify_attention_plain, args,
                   f"{pre} kq 8, {P} pages of {ps}, shared and unmapped")
        check(torch.equal(got, verify_attention_cuda(
            *paged_gathered(torch, *args))),
              f"paged_verify_attention {pre}: not verify_attention on the "
              f"gathered view bit for bit")
        q, kp, vp, tbl, q_pos, kv_pos = args
        for r in range(b):
            row = paged_verify_attention_cuda(
                q[r:r + 1].contiguous(), kp, vp, tbl[r:r + 1].contiguous(),
                q_pos[r:r + 1].contiguous(), kv_pos[r:r + 1].contiguous())
            check(torch.equal(row, got[r:r + 1]),
                  f"paged_verify_attention {pre}: batch row {r} alone "
                  f"differs from its row at B = 8")
        time_split_kv(torch, "paged_verify_attention",
                      paged_verify_attention_cuda,
                      paged_verify_attention_plain, args, dtype, "hymba-1.5b")
        log(f"  {pre}: kq 1 == kq 2 == the block and B 1 == B 8 bit for bit "
            f"(L {l} and the ring), the paged kernel == verify_attention on "
            f"kp[tbl], ok")


def check_family_heads(torch, gen, results):
    """The three split-KV kernels at the families' heads (FAMILY_HEADS: the
    MoE models' 16/16 heads of 128 run kq 8 as 8 rows of a 16-row tile),
    bf16 and fp32, against their plain versions: the chain kernel at each
    kq and L, at starcoder2's kq 8 with its window of 4096 over a wrapped
    ring of 4352 slots; the tree kernel with 8 and 32 nodes (at G 9: 72 and
    288 rows; at llava's G 7: 56 and 224); the paged kernel (16 pages of
    16, llava's 189, one shared, one unmapped) equal to verify_attention on
    the gathered view; each bit for bit batch-invariant (kq 1 and 2 against
    the block, B 1 against 8, whichever row tile holds the query).  The
    errors join each kernel's max_abs_err; the decode path's shape (kq 8 at
    the timed L, the tree of 8, the pages) is timed beside its plain
    version, SDPA and the bound."""
    import functools

    from repro_torch.kernels.block_attention import (row_plan,
                                                     tree_verify_attention_cuda,
                                                     tree_verify_attention_plain,
                                                     verify_attention_cuda,
                                                     verify_attention_plain)
    from repro_torch.kernels.paged_attention import (paged_verify_attention_cuda,
                                                     paged_verify_attention_plain)
    from repro_torch.kernels.tree_mask import default_tree

    b = 8

    def held(name, fn, plain, args, tag, **kw):
        got = fn(*args, **kw)
        want = plain(*args, **kw)
        torch.cuda.synchronize()
        check(not torch.isnan(got).any(), f"{name} {tag} NaN")
        err = (got.float() - want.float()).abs().max().item()
        tol = ATTN_TOL[dtype]
        check(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol),
              f"{name} {tag} differs from its plain version by {err}")
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)
        rows = args[0].shape[1] * (args[0].shape[2] // args[1].shape[2])
        log(f"  {name} {tag} ({rows} rows, {row_plan(rows)[0]} row tiles): "
            f"max_abs_err={err:.3g} ok")
        return got

    for model, h, kvh, hd, kqs, ls, P, timed_l in FAMILY_HEADS:
        for dtype in ("bfloat16", "float32"):
            pre = f"{dtype} {model} {h}/{kvh} heads of {hd}"
            timed = {}
            for kq in kqs:
                for l in ls:
                    args = attention_case(
                        torch, gen, b, kq, h, kvh, hd, l, dtype,
                        length=[max(0, l - kq - 3 * i) for i in range(b)],
                        stale=5)
                    held("verify_attention", verify_attention_cuda,
                         verify_attention_plain, args, f"{pre} kq {kq} L {l}")
                    if l == 256:
                        check_invariance(torch, f"verify_attention {pre} kq "
                                         f"{kq}", verify_attention_cuda, args,
                                         queries=True)
                    if l == timed_l and kq == 8:
                        timed["verify_attention"] = args
            if model == "starcoder2-7b":
                args = ring_case(torch, gen, b, 8, h, kvh, hd, dtype)
                fn = functools.partial(verify_attention_cuda, window=WINDOW)
                held("verify_attention", verify_attention_cuda,
                     verify_attention_plain, args,
                     f"{pre} kq 8 window {WINDOW}, ring {RING}", window=WINDOW)
                check_invariance(torch, f"verify_attention {pre} ring", fn,
                                 args, queries=True)
            for nodes in (8, 32):
                args = tree_case(torch, gen, b, h, kvh, hd, timed_l,
                                 default_tree(nodes, 2 if nodes == 8 else 4),
                                 dtype, stale=5)
                held("tree_verify_attention", tree_verify_attention_cuda,
                     tree_verify_attention_plain, args,
                     f"{pre} {nodes} nodes L {timed_l}")
                check_invariance(torch, f"tree_verify_attention {pre} "
                                 f"{nodes} nodes", tree_verify_attention_cuda,
                                 args, queries=False)
                if nodes == 8:
                    timed["tree_verify_attention"] = args
            ps = 16
            args = paged_case(torch, gen, b, 8, h, kvh, hd, P, ps, dtype,
                              ctx=[P * ps - 3 * i for i in range(b)],
                              share=True, unmapped=1)
            got = held("paged_verify_attention", paged_verify_attention_cuda,
                       paged_verify_attention_plain, args,
                       f"{pre} kq 8, {P} pages of {ps}, shared and unmapped")
            check(torch.equal(got, verify_attention_cuda(
                *paged_gathered(torch, *args))),
                  f"paged_verify_attention {pre}: not verify_attention on the "
                  f"gathered view bit for bit")
            q, kp, vp, tbl, q_pos, kv_pos = args
            for r in range(b):
                row = paged_verify_attention_cuda(
                    q[r:r + 1].contiguous(), kp, vp, tbl[r:r + 1].contiguous(),
                    q_pos[r:r + 1].contiguous(), kv_pos[r:r + 1].contiguous())
                check(torch.equal(row, got[r:r + 1]),
                      f"paged_verify_attention {pre}: batch row {r} alone "
                      f"differs from its row at B = 8")
            for i in range(q.shape[1]):
                one = paged_verify_attention_cuda(
                    q[:, i:i + 1].contiguous(), kp, vp, tbl,
                    q_pos[:, i:i + 1].contiguous(), kv_pos)
                check(torch.equal(one, got[:, i:i + 1]),
                      f"paged_verify_attention {pre}: query {i} at kq = 1 "
                      f"differs from its row at kq = 8")
            timed["paged_verify_attention"] = args
            log(f"  {pre}: kq 1 == kq 2 == the block and B 1 == B 8 bit for "
                f"bit, the paged kernel == verify_attention on kp[tbl], ok")
            for name, fn, plain in (
                    ("verify_attention", verify_attention_cuda,
                     verify_attention_plain),
                    ("tree_verify_attention", tree_verify_attention_cuda,
                     tree_verify_attention_plain),
                    ("paged_verify_attention", paged_verify_attention_cuda,
                     paged_verify_attention_plain)):
                time_split_kv(torch, name, fn, plain, timed[name], dtype,
                              model)


def check_family_vocab(torch, gen, results):
    """fused_heads at each of FAMILY_VOCABS' untied lm_heads, (56, d) x (d,
    lanes) in the row-major layout with the vocab passed (pad lanes past it
    never chosen), at its T values in bf16 and fp32, against its plain
    version, timed beside torch.mm then torch.topk and its bound; then
    fused_verify at (8, 8, vocab) under every criterion (ties and unaligned
    rows included) and at the path's padded (8, 8, lanes) with the pad
    lanes at -1e9, bit for bit against its plain version, timed."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.fused_heads import vocab_plan
    from repro_torch.kernels.fused_verify import verify_plan

    sms = _build.sm_count(torch.device("cuda"))
    for model, d, vocab, lanes, tops, rows in FAMILY_VOCABS:
        log(f"  {model}: vocab_plan({lanes}, {sms}) = "
            f"{vocab_plan(lanes, sms)}, verify_plan({vocab}, 8, 8, {sms}) = "
            f"{verify_plan(vocab, 8, 8, sms)}")
        for dtype in ("bfloat16", "float32"):
            check_family_vocab_case(torch, gen, results, model, rows, d, vocab,
                                    lanes, tops, dtype)


def check_family_vocab_case(torch, gen, results, model, rows, d, vocab, lanes,
                            tops, dtype):
    from repro_torch.kernels.fused_heads import fused_heads_topk_cuda
    from repro_torch.kernels.fused_verify import (fused_verify_cuda,
                                                  fused_verify_plain)

    dt = getattr(torch, dtype)
    w = (torch.randn((d, lanes), generator=gen, device="cuda") * 0.02).to(dt)
    for n in rows:
        o = torch.randn((n, d), generator=gen, device="cuda").to(dt)
        for top_t in tops:
            vals, ids = fused_heads_topk_cuda(o, w, vocab=vocab, top_t=top_t)
            torch.cuda.synchronize()
            ok, ties, wv = heads_ids_agree(torch, vals, ids, o, w, vocab,
                                           top_t)
            err = (vals - wv).abs().max().item()
            tol = ATTN_TOL[dtype]
            ok = ok and torch.allclose(vals, wv, rtol=tol, atol=tol)
            log(f"  fused_heads {dtype} T={top_t} {model} N {n}, lm_head "
                f"({d},{lanes}), vocab {vocab}: max_abs_err={err:.3g} "
                f"near-ties={ties} {'ok' if ok else 'FAIL'}")
            check(ok and int(ids.max()) < vocab,
                  f"fused_heads {dtype} T={top_t} N {n} at V {vocab} differs "
                  f"from its plain version (err {err})")
            results["fused_heads"]["max_abs_err"] = max(
                results["fused_heads"]["max_abs_err"], err)
        ms = time_ms(torch, lambda: fused_heads_topk_cuda(o, w, vocab=vocab,
                                                          top_t=1))
        two_ms = time_ms(torch, lambda: torch.topk(torch.mm(o, w), 1))
        log(f"  fused_heads {dtype} {model} ({n},{d})x({d},{lanes}) T=1: "
            f"kernel {ms:.4f} ms, torch.mm then torch.topk {two_ms:.4f} ms, "
            f"{heads_bounds(nbytes(o, w) + n * 8, n, d, lanes, dtype, ms)}")
        del o
    del w

    b, k = 8, 8
    logits = torch.randn((b, k, vocab), generator=gen, device="cuda").to(dt)
    ties = (torch.randint(0, 4, (b, k, vocab), generator=gen,
                          device="cuda").float() * 0.5).to(dt)
    odd = torch.randn((b, k, vocab - 3), generator=gen, device="cuda").to(dt)
    padded = torch.full((b, k, lanes), -1e9, device="cuda").to(dt)
    padded[..., :vocab] = logits
    for label, lg in (("random", logits), ("ties", ties),
                      (f"V {vocab - 3} unaligned", odd),
                      (f"{lanes} lanes, pads at -1e9", padded)):
        greedy = torch.argmax(lg.float(), -1).int()
        props = torch.randint(0, min(lg.shape[-1], vocab), greedy.shape,
                              generator=gen, device="cuda", dtype=torch.int32)
        props[:, 1:4] = greedy[:, 0:3]
        for crit, kw in (("exact", {}), ("topk", dict(top_k=3)),
                         ("topk", dict(top_k=8)),
                         ("distance", dict(epsilon=2.0))):
            got = fused_verify_cuda(lg, props, criterion=crit, **kw)
            want = fused_verify_plain(lg, props, criterion=crit, **kw)
            torch.cuda.synchronize()
            check(all(torch.equal(g, x) for g, x in zip(got, want)),
                  f"fused_verify {dtype} {label} {crit} {kw} at V "
                  f"{lg.shape[-1]} differs from its plain version")
        if label == "random":
            timed = (lg, props)
    lg, props = timed
    ms = time_ms(torch, lambda: fused_verify_cuda(lg, props, criterion="exact"))
    plain_ms = time_ms(torch, lambda: fused_verify_plain(lg, props,
                                                         criterion="exact"))
    two_ms = time_ms(torch, lambda: argmax_then_scan(torch, lg, props))
    bms, by = bound(nbytes(lg, props) + b * k * 9 + b * 8, b * k * vocab, dtype)
    log(f"  fused_verify {dtype} {model} ({b},{k},{vocab}): every criterion "
        f"bit for bit (random, ties, unaligned, padded to {lanes}) ok; kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, argmax then scan "
        f"{two_ms:.4f} ms, bound {bms:.4f} ms ({by})")


def time_split_kv(torch, name, fn, plain, args, dtype, model, *,
                  window: int = 0, num_meta: int = 0):
    """Kernel, plain version, SDPA (the chain and tree kernels) and bound of
    one split-KV call, printed for PERF.md's rows 1, 4 and 5; ``window``
    and ``num_meta`` go to both calls and into SDPA's mask."""
    kw = dict(window=window, num_meta=num_meta)
    ms = time_ms(torch, lambda: fn(*args, **kw))
    plain_ms = time_ms(torch, lambda: plain(*args, **kw))
    if name == "paged_verify_attention":
        q, kp, vp, tbl, q_pos, kv_pos = args
        k = v = None
        l = tbl.shape[1] * kp.shape[1]
        moved = nbytes(q, kp[tbl.long()], vp[tbl.long()], tbl, q_pos, kv_pos, q)
        lib = "n/a (no one call gathers pages)"
    else:
        q, k, v, q_pos, kv_pos = args[:5]
        l = k.shape[1]
        moved = nbytes(*args, q)
        qp, kp_ = q_pos[:, :, None], kv_pos[:, None, :]
        mask = (kp_ >= 0) & (kp_ <= qp)
        if window:
            mask = mask & ((qp - kp_ < window) | (kp_ < num_meta))
        if name == "tree_verify_attention":
            kn, anc = args[5][:, None, :], args[6]
            bit = (anc[:, :, None] >> kn.clamp(0, 31)) & 1
            mask = mask & ((kn < 0) | (bit != 0))
        repeat_ms, gqa_ms = sdpa_yardsticks(torch, q, k, v, mask[:, None])
        lib = f"{min(repeat_ms, gqa_ms):.4f} ms"
    b, kq, h, hd = q.shape
    bms, by = bound(moved, 4 * b * kq * h * l * hd, dtype)
    log(f"  {name} {dtype} hd {hd} {model} (B {b}, kq {kq}, L {l}): kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA {lib}, bound "
        f"{bms:.5f} ms ({by})")


def argmax_then_scan(torch, logits, props):
    """The two-call comparator of fused_verify (exact): torch.argmax over
    (B, k, V), then the compare and the prefix scan in PyTorch."""
    greedy = torch.argmax(logits, -1).int()
    acc = torch.ones_like(props, dtype=torch.bool)
    acc[:, 1:] = props[:, 1:] == greedy[:, :-1]
    khat = torch.cumprod(acc.int(), 1).sum(1).int()
    slot = torch.arange(props.shape[1], device=props.device)[None, :]
    toks = torch.where(slot < khat[:, None], props, 0)
    nxt = torch.gather(greedy, 1, (khat - 1).long()[:, None])[:, 0]
    return acc, khat, toks, nxt


def check_fused_verify(torch, gen, results):
    from repro_torch.kernels.fused_verify import (fused_verify_cuda,
                                                  fused_verify_plain)

    b, k, vocab, vp = 8, 8, 49155, 49408
    kw = dict(top_k=3, epsilon=2.0)

    def compare(label, logits, pr, crits=("exact", "topk", "distance"), **kw):
        """Each criterion's outputs, each equal to the plain version's."""
        outs = {}
        for crit in crits:
            outs[crit] = got = fused_verify_cuda(logits, pr, criterion=crit,
                                                 **kw)
            want = fused_verify_plain(logits, pr, criterion=crit, **kw)
            torch.cuda.synchronize()
            same = all(torch.equal(g, w) for g, w in zip(got, want))
            log(f"  fused_verify {label} {crit}: k̂={got[1].tolist()} "
                f"{'ok' if same else 'FAIL'}")
            check(same, f"fused_verify {label} {crit} differs from its plain "
                        f"version")
        return outs

    def proposals(logits, vocab):
        greedy = torch.argmax(logits.float(), -1).int()
        props = torch.randint(0, vocab, greedy.shape, generator=gen,
                              device="cuda", dtype=torch.int32)
        n = min(3, greedy.shape[1] - 1)
        props[:, 1:n + 1] = greedy[:, 0:n]           # accepted prefixes
        return greedy, props

    timed = {}
    for dtype in ("bfloat16", "float32"):
        logits = torch.randn((b, k, vp), generator=gen, device="cuda")
        logits[..., vocab:] = -1e9                   # as project_vocab pads
        logits = logits.to(getattr(torch, dtype))
        greedy, props = proposals(logits, vocab)
        all_acc = torch.cat([greedy[:, :1], greedy[:, :k - 1]], 1).contiguous()
        all_rej = ((greedy + vocab // 2) % vocab).roll(1, 1).contiguous()
        for name, pr in (("random", props), ("all-accept", all_acc),
                         ("all-reject", all_rej)):
            khat = compare(f"{dtype} {name}", logits, pr, **kw)["exact"][1]
            if name == "all-accept":
                check(bool((khat == k).all()), "all-accept k̂ != k")
            if name == "all-reject":
                check(bool((khat == 1).all()), "all-reject k̂ != 1")
        # a 1-slot block (--block-k 1) goes through the same kernel
        one = logits[:, :1].contiguous()
        outs = compare(f"{dtype} k=1", one, props[:, :1].contiguous(), **kw)
        check(all(bool((o[1] == 1).all()) for o in outs.values()),
              f"fused_verify {dtype} k=1: k̂ != 1")
        # logits quantised to four values: thousands of exact ties a row,
        # and the -1e9 pad lanes tie among themselves
        ties = (torch.randint(0, 4, (b, k, vp), generator=gen, device="cuda")
                .float() * 0.5)
        ties[..., vocab:] = -1e9
        ties = ties.to(getattr(torch, dtype))
        compare(f"{dtype} ties", ties, proposals(ties, vocab)[1], **kw)
        compare(f"{dtype} ties T8", ties, proposals(ties, vocab)[1],
                crits=("topk",), top_k=8)
        # V 49155 unpadded: rows start off 16-byte boundaries
        odd = logits[..., :vocab].contiguous()
        compare(f"{dtype} V {vocab} unaligned", odd, proposals(odd, vocab)[1],
                **kw)
        # one batch row, the largest block, T 8
        big = torch.randn((1, 32, vp), generator=gen, device="cuda").to(
            getattr(torch, dtype))
        compare(f"{dtype} B 1 k 32 T 8", big, proposals(big, vp)[1],
                crits=("topk",), top_k=8)
        timed[dtype] = (logits, props)
    logits, props = timed["bfloat16"]
    kernel_ms = time_ms(torch, lambda: fused_verify_cuda(logits, props,
                                                         criterion="exact"))
    plain_ms = time_ms(torch, lambda: fused_verify_plain(logits, props,
                                                         criterion="exact"))
    got = argmax_then_scan(torch, logits, props)
    want = fused_verify_plain(logits, props, criterion="exact")
    check(all(torch.equal(g, w) for g, w in zip(got, want)),
          "fused_verify's two-call comparator differs from its plain version")
    two_ms = time_ms(torch, lambda: argmax_then_scan(torch, logits, props))
    fp32_ms = time_ms(torch, lambda: fused_verify_cuda(*timed["float32"],
                                                       criterion="exact"))
    two32_ms = time_ms(torch, lambda: argmax_then_scan(torch, *timed["float32"]))
    bms, by = bound(nbytes(logits, props) + b * k * 9 + b * 8, b * k * vp,
                    "bfloat16")
    results["fused_verify"] = dict(
        source="src/repro_torch/kernels/csrc/fused_verify.cu",
        replaces="src/repro/kernels/fused_verify.py:109",
        max_abs_err=0.0, ms=kernel_ms, plain_ms=plain_ms, bound_ms=bms,
        bound_by=by, library_ms=None,
        fp32=fp32_row(fp32_ms, nbytes(*timed["float32"]) + b * k * 9 + b * 8,
                      b * k * vp, two32_ms,
                      "two calls: torch.argmax, then the compare and scan"),
        extra=f"two calls (argmax, then the compare and scan) "
              f"{two_ms:.4f} ms",
        shape="bf16 logits (8,8,49408), exact")


def heads_ids_agree(torch, vals, ids, o, w, vocab, top_t):
    """Kernel ids == plain ids, except where the plain version's own logit
    at the kernel's id is within HEADS_TIE_MARGIN * max|logit| of the plain
    version's value at that rank.  Returns (ok, ids that differ, the plain
    version's values)."""
    from repro_torch.kernels.fused_heads import heads_topk_plain

    wv, wi = heads_topk_plain(o, w, vocab=vocab, top_t=top_t)
    if torch.equal(ids, wi):
        return True, 0, wv
    logits = o.float() @ w.float()
    margin = HEADS_TIE_MARGIN * logits[:, :vocab].abs().max()
    at_kernel = torch.gather(logits, 1, ids.long())
    diff = ids != wi
    near = (at_kernel - wv).abs() <= margin
    return bool((near | ~diff).all()), int(diff.sum()), wv


def heads_bounds(byte_count, n, d, lanes, dtype, ms) -> str:
    """fused_heads' bound at (n, d) x (d, lanes) as text.  fp32 runs three
    TF32 products on the tensor cores (3 x 2 n d lanes operations at the
    TF32 rate); the CUDA-core bound of the first fp32 body (2 n d lanes at
    the fp32 rate) is printed beside it."""
    flops = 2.0 * n * d * lanes
    if dtype != "float32":
        bms, by = bound(byte_count, flops, dtype)
        return f"bound {bms:.4f} ms ({by})"
    bms, by = bound(byte_count, 3 * flops, "tf32")
    old_ms, old_by = bound(byte_count, flops, "float32")
    return (f"bound {bms:.4f} ms ({by}, 3xTF32; kernel {ms / bms:.2f}x), "
            f"CUDA-core bound {old_ms:.4f} ms ({old_by})")


def check_fused_heads(torch, gen, results):
    from repro_torch.kernels.fused_heads import (fused_heads_topk_cuda,
                                                 heads_topk_plain)

    n, d, vocab, vp = 56, 4096, 49155, 49408
    timed = {}
    worst = 0.0

    def compare(label, dtype, o, w, voc, top_t):
        vals, ids = fused_heads_topk_cuda(o, w, vocab=voc, top_t=top_t)
        torch.cuda.synchronize()
        ok, ties, wv = heads_ids_agree(torch, vals, ids, o, w, voc, top_t)
        err = (vals - wv).abs().max().item()
        tol = ATTN_TOL[dtype]
        vals_ok = torch.allclose(vals, wv, rtol=tol, atol=tol)
        log(f"  fused_heads {dtype} T={top_t} {label}: max_abs_err={err:.3g} "
            f"near-ties={ties} {'ok' if ok and vals_ok else 'FAIL'}")
        check(ok and vals_ok, f"fused_heads {dtype} T={top_t} {label} differs "
                              f"from its plain version (err {err})")
        return err

    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        o = torch.randn((n, d), generator=gen, device="cuda").to(dt)
        table = (torch.randn((vp, d), generator=gen, device="cuda") * 0.02).to(dt)
        w = table.t()                                  # the tied view, no copy
        for top_t in (1, 2, 4, 8):
            worst = max(worst, compare("tied (4096,49408)", dtype, o, w, vocab,
                                       top_t))
        timed[dtype] = (o, w)
        # pad lanes never win, even when they hold the largest logits
        huge = table.clone()
        huge[vocab:] = 1.0
        _, pad_ids = fused_heads_topk_cuda(o.abs(), huge.t(), vocab=vocab,
                                           top_t=4)
        check(int(pad_ids.max()) < vocab, "fused_heads selected a pad lane")
        log(f"  fused_heads {dtype} pad-never-wins: ok")
        del huge
        # rwkv6-1.6b: an untied, row-major lm_head (d 2048, Vp = V 65536)
        ro = torch.randn((n, 2048), generator=gen, device="cuda").to(dt)
        rw = (torch.randn((2048, 65536), generator=gen, device="cuda")
              * 0.02).to(dt)
        for top_t in (1, 4):
            worst = max(worst, compare("untied lm_head (2048,65536)", dtype,
                                       ro, rw, 65536, top_t))
        timed[dtype + " rwkv6"] = (ro, rw)
        # rows past one 64-row tile
        for rows in (1, 65, 200):
            ob = torch.randn((rows, d), generator=gen, device="cuda").to(dt)
            worst = max(worst, compare(f"N={rows}", dtype, ob, w, vocab, 4))

    def heads(args, voc):
        return lambda: fused_heads_topk_cuda(*args, vocab=voc, top_t=1)

    o, w = timed["bfloat16"]
    kernel_ms = time_ms(torch, heads(timed["bfloat16"], vocab))
    plain_ms = time_ms(torch, lambda: heads_topk_plain(o, w, vocab=vocab,
                                                       top_t=1))
    fp32_ms = time_ms(torch, heads(timed["float32"], vocab))
    ro, rw = timed["bfloat16 rwkv6"]
    rwkv_ms = time_ms(torch, heads(timed["bfloat16 rwkv6"], 65536))
    rwkv_fp32_ms = time_ms(torch, heads(timed["float32 rwkv6"], 65536))
    # a two-call comparator, not one PyTorch call (library_ms stays null):
    # the bf16 product (cuBLAS) writes the logits, then torch.topk reads them
    two_ms = time_ms(torch, lambda: torch.topk(torch.mm(o, w)[:, :vocab], 1))
    rwkv_two_ms = time_ms(torch, lambda: torch.topk(torch.mm(ro, rw), 1))
    o32, w32 = timed["float32"]
    ro32, rw32 = timed["float32 rwkv6"]
    # fp32 with TF32 off (main sets it): the CUDA-core product, then topk
    two32_ms = time_ms(torch, lambda: torch.topk(torch.mm(o32, w32)[:, :vocab],
                                                 1))
    rwkv_two32_ms = time_ms(torch, lambda: torch.topk(torch.mm(ro32, rw32), 1))
    rbms, _ = bound(nbytes(ro, rw) + n * 8, 2.0 * n * 2048 * 65536, "bfloat16")
    log(f"  fused_heads two calls (torch.mm in bf16, then torch.topk; not one "
        f"call, so not library_ms): granite {two_ms:.4f} ms, rwkv6 "
        f"{rwkv_two_ms:.4f} ms")
    for label, ms, two, (o_, w_) in (
            ("granite tied (4096,49408)", fp32_ms, two32_ms, (o32, w32)),
            ("rwkv6 row-major (2048,65536)", rwkv_fp32_ms, rwkv_two32_ms,
             (ro32, rw32))):
        bounds = heads_bounds(nbytes(o_, w_) + n * 8, n, *w_.shape,
                              "float32", ms)
        log(f"  fused_heads fp32 {label} T=1: kernel {ms:.4f} ms, torch.mm "
            f"(TF32 off) then torch.topk {two:.4f} ms, {bounds}")
    bms, by = bound(nbytes(o, w) + n * 8, 2.0 * n * d * vp, "bfloat16")
    results["fused_heads"] = dict(
        source="src/repro_torch/kernels/csrc/fused_heads.cu",
        replaces="src/repro/kernels/fused_heads.py:63",
        max_abs_err=worst, ms=kernel_ms, plain_ms=plain_ms, bound_ms=bms,
        bound_by=by, library_ms=None,
        fp32=fp32_row(fp32_ms, nbytes(o32, w32) + n * 8, 3 * 2.0 * n * d * vp,
                      two32_ms, "two calls: torch.mm in fp32 (TF32 off), "
                                "then torch.topk", peak="tf32"),
        extra=f"rwkv6's (2048,65536) row-major "
              f"lm_head: bf16 {rwkv_ms:.4f} ms (bound {rbms:.4f}), fp32 "
              f"{rwkv_fp32_ms:.4f} ms; two calls (mm + topk) {two_ms:.4f} / "
              f"{rwkv_two_ms:.4f} ms, fp32 {two32_ms:.4f} / "
              f"{rwkv_two32_ms:.4f} ms",
        shape="bf16 o (56,4096), tied table view (4096,49408), T=1")


# granite-3-8b's local shapes on the sharded path (phase 22): a rank's
# query / KV heads of 128 at model 2 and 4, and its row block of the tied
# table (Vp 49408 over model; the last block holds the 253 pad lanes)
MESH_HEADS = ((2, 16, 4), (4, 8, 2))
MESH_VOCAB, MESH_VP = 49155, 49408


def check_mesh_shapes(torch, gen, results):
    """The decode kernels at the local shapes of phase 22's ranks, bf16 and
    fp32, against their plain versions: the three split-KV kernels at 16/4
    and 8/2 heads of 128 (B 8, kq 8, L 256: the ring of 64 + 64 + 8
    positions; the paged kernel over 16 pages), bit for bit batch-invariant
    and timed at model 2; fused_heads on each rank's (Vp / M, 4096) row
    block of the tied table (the kernel's transpose view of it, vocab cut
    at the block's real lanes) at T 1, 2 and 4, and the blocks' top-T
    merged as ``comm.merge_top_t`` merges them equal to one launch over the
    whole table; timed at model 2's first block."""
    from repro_torch.kernels.fused_heads import (fused_heads_topk_cuda,
                                                 heads_topk_plain)

    for m, h, kvh in MESH_HEADS:
        for dtype in ("bfloat16", "float32"):
            check_split_kv(torch, gen, results, model=f"granite model {m}",
                           hd=128, h=h, kvh=kvh, kq=8, l=256, dtype=dtype,
                           timed=m == 2)
    n, d = 56, 4096
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        table = (torch.randn((MESH_VP, d), generator=gen, device="cuda")
                 * 0.02).to(dt)
        o = torch.randn((n, d), generator=gen, device="cuda").to(dt)
        for m, _, _ in MESH_HEADS:
            vl = MESH_VP // m
            for top_t in (1, 2, 4):
                vals, ids = [], []
                for i in range(m):
                    block = table[i * vl:(i + 1) * vl].contiguous()
                    real = min(MESH_VOCAB - i * vl, vl)
                    kv, ki = fused_heads_topk_cuda(o, block.t(), vocab=real,
                                                   top_t=top_t)
                    torch.cuda.synchronize()
                    ok, ties, pv = heads_ids_agree(torch, kv, ki, o, block.t(),
                                                   real, top_t)
                    err = (kv - pv).abs().max().item()
                    tol = ATTN_TOL[dtype]
                    check(ok and torch.allclose(kv, pv, rtol=tol, atol=tol),
                          f"fused_heads {dtype} block {i} of {m} T={top_t} "
                          f"differs from its plain version (err {err})")
                    results["fused_heads"]["max_abs_err"] = max(
                        results["fused_heads"]["max_abs_err"], err)
                    vals.append(kv)
                    ids.append(ki.long() + i * vl)
                v, i_ = torch.cat(vals, 1), torch.cat(ids, 1)
                by_id = torch.argsort(i_, dim=1, stable=True)
                v, i_ = v.gather(1, by_id), i_.gather(1, by_id)
                top = torch.argsort(v, dim=1, descending=True,
                                    stable=True)[:, :top_t]
                _, whole = fused_heads_topk_cuda(o, table.t(),
                                                 vocab=MESH_VOCAB, top_t=top_t)
                check(torch.equal(i_.gather(1, top).int(), whole),
                      f"fused_heads {dtype}: the {m} blocks' merged top-"
                      f"{top_t} differs from one launch over the table")
            log(f"  fused_heads {dtype} on the {m} ({vl}, {d}) row blocks of "
                f"the tied table, T 1/2/4: each == its plain version, merged "
                f"== one launch over (4096, {MESH_VP}) ok")
        vl = MESH_VP // 2
        block = table[:vl].contiguous()
        ms = time_ms(torch, lambda: fused_heads_topk_cuda(o, block.t(),
                                                          vocab=vl, top_t=1))
        plain_ms = time_ms(torch, lambda: heads_topk_plain(o, block.t(),
                                                           vocab=vl, top_t=1))
        two_ms = time_ms(torch, lambda: torch.topk(torch.mm(o, block.t()), 1))
        bounds = heads_bounds(nbytes(o, block) + n * 8, n, d, vl, dtype, ms)
        log(f"  fused_heads {dtype} granite model 2 block ({n}, {d}) x ({d}, "
            f"{vl}) T=1: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"torch.mm then torch.topk {two_ms:.4f} ms, {bounds}")
    check_mesh_family_shapes(torch, gen, results)


# phase 22's families at ``model`` 2: the MoE models' 8/8 heads of 128 a
# rank, olmoe-1b-7b's (2048, 50432 / 2) block of its untied lm_head at
# vocab 50304, rwkv6-1.6b's scan at 16 of its 32 heads (8 at model 4)
MESH_MOE_HEADS = (8, 8, 128)
MESH_OLMOE = (2048, 50304, 50432)
MESH_SCAN = (8, 512, 16, 64)


def check_mesh_family_shapes(torch, gen, results):
    """The decode kernels at the local shapes of phase 22's families,
    bf16 and fp32, against their plain versions: the three split-KV
    kernels at the MoE models' 8/8 heads of 128 a rank (B 8, kq 8, L 256;
    paged over 16 pages), bit for bit batch-invariant and timed beside
    SDPA; fused_heads on each of olmoe-1b-7b's two (2048, 25216) column
    blocks of its untied lm_head (the row-major layout, vocab cut at the
    block's real lanes) at T 1, 2 and 4, the blocks' top-T merged equal to
    one launch over the whole lm_head, timed at the first block beside
    torch.mm then torch.topk; rwkv6_scan at a rank's 16 heads (B 8, S 512,
    D 64) and 8 heads (model 4), timed at 16 beside its plain version and
    the bound."""
    from repro_torch.kernels.fused_heads import (fused_heads_topk_cuda,
                                                 heads_topk_plain)
    from repro_torch.kernels.rwkv6_scan import (rwkv6_scan_cuda,
                                                rwkv6_scan_plain)

    h, kvh, hd = MESH_MOE_HEADS
    for dtype in ("bfloat16", "float32"):
        check_split_kv(torch, gen, results, model="MoE model 2", hd=hd, h=h,
                       kvh=kvh, kq=8, l=256, dtype=dtype, timed=True)
    d, vocab, lanes = MESH_OLMOE
    n, vl = 56, lanes // 2
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        w = (torch.randn((d, lanes), generator=gen, device="cuda")
             * 0.02).to(dt)
        o = torch.randn((n, d), generator=gen, device="cuda").to(dt)
        blocks = [w[:, i * vl:(i + 1) * vl].contiguous() for i in range(2)]
        for top_t in (1, 2, 4):
            vals, ids = [], []
            for i, block in enumerate(blocks):
                real = min(vocab - i * vl, vl)
                kv, ki = fused_heads_topk_cuda(o, block, vocab=real,
                                               top_t=top_t)
                torch.cuda.synchronize()
                ok, _, pv = heads_ids_agree(torch, kv, ki, o, block, real,
                                            top_t)
                err = (kv - pv).abs().max().item()
                tol = ATTN_TOL[dtype]
                check(ok and torch.allclose(kv, pv, rtol=tol, atol=tol),
                      f"fused_heads {dtype} olmoe block {i} T={top_t} "
                      f"differs from its plain version (err {err})")
                results["fused_heads"]["max_abs_err"] = max(
                    results["fused_heads"]["max_abs_err"], err)
                vals.append(kv)
                ids.append(ki.long() + i * vl)
            v, i_ = torch.cat(vals, 1), torch.cat(ids, 1)
            by_id = torch.argsort(i_, dim=1, stable=True)
            v, i_ = v.gather(1, by_id), i_.gather(1, by_id)
            top = torch.argsort(v, dim=1, descending=True,
                                stable=True)[:, :top_t]
            _, whole = fused_heads_topk_cuda(o, w, vocab=vocab, top_t=top_t)
            check(torch.equal(i_.gather(1, top).int(), whole),
                  f"fused_heads {dtype}: olmoe's two blocks' merged top-"
                  f"{top_t} differs from one launch over the lm_head")
        block = blocks[0]
        ms = time_ms(torch, lambda: fused_heads_topk_cuda(o, block, vocab=vl,
                                                          top_t=1))
        plain_ms = time_ms(torch, lambda: heads_topk_plain(o, block,
                                                           vocab=vl, top_t=1))
        two_ms = time_ms(torch, lambda: torch.topk(torch.mm(o, block), 1))
        bounds = heads_bounds(nbytes(o, block) + n * 8, n, d, vl, dtype, ms)
        log(f"  fused_heads {dtype} olmoe model 2 block ({n}, {d}) x ({d}, "
            f"{vl}), T 1/2/4 each == its plain version, merged == one launch "
            f"over ({d}, {lanes}) ok; T=1: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, torch.mm then torch.topk {two_ms:.4f} ms, "
            f"{bounds}")
        del w, o, blocks, block
    b, s_, h, d = MESH_SCAN
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        for heads in (h, h // 2):
            r, k, v = (torch.randn((b, s_, heads, d), generator=gen,
                                   device="cuda").to(dt) for _ in range(3))
            logw = -torch.exp(torch.randn((b, s_, heads, d), generator=gen,
                                          device="cuda") * 0.5 - 1.0)
            u = torch.randn((heads, d), generator=gen, device="cuda") * 0.1
            got = rwkv6_scan_cuda(r, k, v, logw, u)
            want = rwkv6_scan_plain(r, k, v, logw, u)
            torch.cuda.synchronize()
            err = 0.0
            for g, w_ in zip(got, want):              # y, the final state
                ok = bool(torch.isfinite(g).all()) and torch.allclose(
                    g, w_, rtol=SCAN_TOL,
                    atol=SCAN_TOL * float(w_.abs().max()))
                check(ok, f"rwkv6_scan {dtype} at {heads} heads differs from "
                          f"its plain version")
                err = max(err, (g - w_).abs().max().item())
            results["rwkv6_scan"]["max_abs_err"] = max(
                results["rwkv6_scan"]["max_abs_err"], err)
            line = (f"  rwkv6_scan {dtype} a rank's B={b} S={s_} H={heads} "
                    f"D={d}: max_abs_err={err:.3g} ok")
            if heads == h:
                ms = time_ms(torch, lambda: rwkv6_scan_cuda(r, k, v, logw, u))
                plain_ms = time_ms(torch, lambda: rwkv6_scan_plain(
                    r, k, v, logw, u), runs=5, warmup=1)
                out_bytes = (b * s_ * heads * d + b * heads * d * d) * 4
                bms, by = bound(nbytes(r, k, v, logw, u) + out_bytes,
                                4.0 * b * s_ * heads * d * d, "float32")
                line += (f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                         f"library none, bound {bms:.5f} ms ({by})")
            log(line)


# phase 23's inputs (ROADMAP §1 item 8c(ii)) at a rank's local shapes on
# the card, ``model`` 2: paper-mt-base's 8 heads of 64 (4 / 4 a rank), its
# decoder cache of 1 + 64 + 8 positions (L 80) and cross call over Se 64;
# llava-next-34b's 56 / 8 heads of 128 (28 / 4), L 3016; each model's
# vocab block of its untied lm_head: (d, lanes, vocab, rows a launch);
# fused_verify on a data rank's rows of phase 10
MESH_MT_HEADS = ((2, 4, 4),)
MESH_LLAVA_HEADS = ((2, 28, 4),)
MESH_HEAD_BLOCKS = (("paper-mt-base", 512, 32000, 32000, 56),
                    ("llava-next-34b", 7168, 64000, 64000, 28))


def heads_block_checks(torch, gen, results, label, d, vocab, lanes, n, m):
    """fused_heads on each of ``m`` column blocks of a (d, lanes) untied
    lm_head (row-major, vocab cut at each block's real lanes), bf16 and
    fp32, T 1, 2 and 4, each against its plain version, the blocks' top-T
    merged as ``comm.merge_top_t`` merges them equal to one launch over
    the whole lm_head; the first block timed at T 1 beside its plain
    version, torch.mm then torch.topk, and the bound."""
    from repro_torch.kernels.fused_heads import (fused_heads_topk_cuda,
                                                 heads_topk_plain)

    vl = lanes // m
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        w = (torch.randn((d, lanes), generator=gen, device="cuda")
             * 0.02).to(dt)
        o = torch.randn((n, d), generator=gen, device="cuda").to(dt)
        blocks = [w[:, i * vl:(i + 1) * vl].contiguous() for i in range(m)]
        for top_t in (1, 2, 4):
            vals, ids = [], []
            for i, block in enumerate(blocks):
                real = min(vocab - i * vl, vl)
                kv, ki = fused_heads_topk_cuda(o, block, vocab=real,
                                               top_t=top_t)
                torch.cuda.synchronize()
                ok, _, pv = heads_ids_agree(torch, kv, ki, o, block, real,
                                            top_t)
                err = (kv - pv).abs().max().item()
                tol = ATTN_TOL[dtype]
                check(ok and torch.allclose(kv, pv, rtol=tol, atol=tol),
                      f"fused_heads {dtype} {label} block {i} of {m} "
                      f"T={top_t} differs from its plain version (err {err})")
                results["fused_heads"]["max_abs_err"] = max(
                    results["fused_heads"]["max_abs_err"], err)
                vals.append(kv)
                ids.append(ki.long() + i * vl)
            v, i_ = torch.cat(vals, 1), torch.cat(ids, 1)
            by_id = torch.argsort(i_, dim=1, stable=True)
            v, i_ = v.gather(1, by_id), i_.gather(1, by_id)
            top = torch.argsort(v, dim=1, descending=True,
                                stable=True)[:, :top_t]
            _, whole = fused_heads_topk_cuda(o, w, vocab=vocab, top_t=top_t)
            check(torch.equal(i_.gather(1, top).int(), whole),
                  f"fused_heads {dtype}: {label}'s {m} blocks' merged top-"
                  f"{top_t} differs from one launch over the lm_head")
        block = blocks[0]
        ms = time_ms(torch, lambda: fused_heads_topk_cuda(o, block, vocab=vl,
                                                          top_t=1))
        plain_ms = time_ms(torch, lambda: heads_topk_plain(o, block,
                                                           vocab=vl, top_t=1))
        two_ms = time_ms(torch, lambda: torch.topk(torch.mm(o, block), 1))
        bounds = heads_bounds(nbytes(o, block) + n * 8, n, d, vl, dtype, ms)
        log(f"  fused_heads {dtype} {label} model {m} block ({n}, {d}) x "
            f"({d}, {vl}), T 1/2/4 each == its plain version, merged == one "
            f"launch over ({d}, {lanes}) ok; T=1: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, torch.mm then torch.topk {two_ms:.4f} ms, "
            f"{bounds}")
        del w, o, blocks, block


def check_input_shapes(torch, gen, results):
    """The decode kernels at the local shapes of phase 22's inputs (the
    encoder-decoder, llava's patch prefix, the draft and locality models
    run at shapes phases 3's earlier checks hold), bf16 and fp32, against
    their plain versions: the three split-KV kernels at paper-mt-base's
    4 / 4 heads of 64 a rank (B 8, kq 8, L 80: its decoder's 1 + 64 + 8
    positions; paged over 5 pages) and at llava's 28 / 4 heads of 128 (L
    3016; paged over 189 pages), bit for bit batch-invariant, timed beside
    SDPA; verify_attention as
    the cross attention calls it at a rank's 4 heads of 64 over Se 64
    (every query at position 0, masked tails), timed; fused_heads on each
    rank's block of paper-mt-base's (512, 32000) and llava's (7168,
    64000) untied lm_heads (``heads_block_checks``); fused_verify on a
    data rank's 4 rows of phase 10's (8, 8, 32000) logits, timed."""
    from repro_torch.kernels.block_attention import (verify_attention_cuda,
                                                     verify_attention_plain)
    from repro_torch.kernels.fused_verify import (fused_verify_cuda,
                                                  fused_verify_plain)

    for name, heads, hd, l in (("paper-mt-base", MESH_MT_HEADS, 64, 80),
                               ("llava", MESH_LLAVA_HEADS, 128, 3016)):
        for m, h, kvh in heads:
            for dtype in ("bfloat16", "float32"):
                check_split_kv(torch, gen, results, model=f"{name} model {m}",
                               hd=hd, h=h, kvh=kvh, kq=8, l=l, dtype=dtype,
                               timed=m == 2)
    b, se, h, hd = 8, 64, 4, 64
    tails = [0, 3, 5, 0, 7, 1, 0, 2]
    worst = 0.0
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        for kq_ in (1, 8):
            q = torch.randn((b, kq_, h, hd), generator=gen, device="cuda").to(dt)
            k = torch.randn((b, se, h, hd), generator=gen, device="cuda").to(dt)
            v = torch.randn((b, se, h, hd), generator=gen, device="cuda").to(dt)
            q_pos = torch.zeros((b, kq_), dtype=torch.int32, device="cuda")
            slot = torch.arange(se, device="cuda")[None, :]
            tail = torch.tensor(tails, device="cuda")[:, None]
            kv_pos = torch.where(slot < se - tail, 0, -1).int()
            args = (q, k, v, q_pos, kv_pos)
            got = verify_attention_cuda(*args)
            want = verify_attention_plain(*args)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            check(torch.allclose(got.float(), want.float(),
                                 rtol=ATTN_TOL[dtype], atol=ATTN_TOL[dtype]),
                  f"cross attention {dtype} a rank's {h} heads kq {kq_} "
                  f"differs by {err}")
            worst = max(worst, err)
        ms = time_ms(torch, lambda: verify_attention_cuda(*args))
        plain_ms = time_ms(torch, lambda: verify_attention_plain(*args))
        mask = (kv_pos[:, None, :] >= 0).expand(b, kq_, -1)[:, None]
        repeat_ms, gqa_ms = sdpa_yardsticks(torch, q, k, v, mask)
        bms, by = bound(nbytes(*args, q), 4 * b * kq_ * h * se * hd, dtype)
        log(f"  cross attention {dtype} paper-mt-base model 2 (a rank's "
            f"{h} heads of {hd}, q ({b},{kq_},{h},{hd}), Se {se}, masked "
            f"tails): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA "
            f"{min(repeat_ms, gqa_ms):.4f} ms, bound {bms:.5f} ms ({by})")
    results["verify_attention"]["max_abs_err"] = max(
        results["verify_attention"]["max_abs_err"], worst)
    log(f"  cross attention at a rank's heads: max_abs_err={worst:.3g} over "
        f"4 cases ok")
    for label, d, vocab, lanes, n in MESH_HEAD_BLOCKS:
        heads_block_checks(torch, gen, results, label, d, vocab, lanes, n, 2)
    b, k, vocab = 4, 8, 32000
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        logits = torch.randn((b, k, vocab), generator=gen, device="cuda").to(dt)
        greedy = torch.argmax(logits.float(), -1).int()
        props = torch.randint(0, vocab, greedy.shape, generator=gen,
                              device="cuda", dtype=torch.int32)
        props[:, 1:4] = greedy[:, 0:3]                # accepted prefixes
        for crit in ("exact", "topk", "distance"):
            got = fused_verify_cuda(logits, props, criterion=crit, top_k=2,
                                    epsilon=2.0)
            want = fused_verify_plain(logits, props, criterion=crit, top_k=2,
                                      epsilon=2.0)
            torch.cuda.synchronize()
            check(all(torch.equal(g, w) for g, w in zip(got, want)),
                  f"fused_verify {dtype} a data rank's ({b}, {k}, {vocab}) "
                  f"{crit} differs from its plain version")
        ms = time_ms(torch, lambda: fused_verify_cuda(logits, props,
                                                      criterion="exact"))
        plain_ms = time_ms(torch, lambda: fused_verify_plain(
            logits, props, criterion="exact"))
        two_ms = time_ms(torch, lambda: argmax_then_scan(torch, logits, props))
        bms, by = bound(nbytes(logits, props) + b * k * 9 + b * k,
                        b * k * vocab, dtype)
        log(f"  fused_verify {dtype} paper-mt-base a data rank's ({b}, {k}, "
            f"{vocab}) exact / topk / distance bit for bit ok; exact: kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, torch.argmax then the "
            f"scan {two_ms:.4f} ms, bound {bms:.5f} ms ({by})")


def check_mt_heads_verify(torch, gen):
    """fused_heads and fused_verify at the shapes phases 10-10c give them:
    paper-mt-base's untied row-major lm_head (512, 32000) and (8, 8, 32000)
    p_1 logits, bf16 and fp32; the trained fixture's (64, 256) lm_head
    (vocab 48, pad lanes -1e9) and (1, 8, 256) logits, fp32 as phase 10c
    runs it.  A chain drafts B x 7 heads at T 1, a tree B x 4 depths at
    T 4 (default_tree(8, 4)); verification as DecodeConfig(top_k=2,
    epsilon=2.0) asks."""
    from repro_torch.kernels.fused_heads import (fused_heads_topk_cuda,
                                                 heads_topk_plain)
    from repro_torch.kernels.fused_verify import (fused_verify_cuda,
                                                  fused_verify_plain)

    kw = dict(top_k=2, epsilon=2.0)
    cases = [("paper-mt-base", "bfloat16", 8, 512, 32000, 32000),
             ("paper-mt-base", "float32", 8, 512, 32000, 32000),
             ("fixture", "float32", 1, 64, 48, 256)]
    for name, dtype, b, d, vocab, vp in cases:
        dt = getattr(torch, dtype)
        w = (torch.randn((d, vp), generator=gen, device="cuda") * 0.02).to(dt)
        for rows, top_t in ((b * 7, 1), (b * 4, 4)):
            o = torch.randn((rows, d), generator=gen, device="cuda").to(dt)
            vals, ids = fused_heads_topk_cuda(o, w, vocab=vocab, top_t=top_t)
            torch.cuda.synchronize()
            ok, ties, wv = heads_ids_agree(torch, vals, ids, o, w, vocab, top_t)
            err = (vals - wv).abs().max().item()
            tol = ATTN_TOL[dtype]
            ok = ok and torch.allclose(vals, wv, rtol=tol, atol=tol)
            log(f"  fused_heads {name} {dtype} ({rows},{d})x({d},{vp}) "
                f"T={top_t}: max_abs_err={err:.3g} near-ties={ties} "
                f"{'ok' if ok else 'FAIL'}")
            check(ok, f"fused_heads {name} {dtype} N={rows} T={top_t} differs "
                      f"from its plain version (err {err})")
        logits = torch.randn((b, 8, vp), generator=gen, device="cuda")
        ties = (torch.randint(0, 4, (b, 8, vp), generator=gen, device="cuda")
                .float() * 0.5)
        for lg in (logits, ties):
            lg[..., vocab:] = -1e9                    # as project_vocab pads
        logits, ties = logits.to(dt), ties.to(dt)
        greedy = torch.argmax(logits.float(), -1).int()
        props = torch.randint(0, vocab, greedy.shape, generator=gen,
                              device="cuda", dtype=torch.int32)
        props[:, 1:4] = greedy[:, 0:3]                # accepted prefixes
        all_acc = torch.cat([greedy[:, :1], greedy[:, :7]], 1).contiguous()
        all_rej = ((greedy + vocab // 2) % vocab).roll(1, 1).contiguous()
        for label, lg, pr in (("random", logits, props),
                              ("all-accept", logits, all_acc),
                              ("all-reject", logits, all_rej),
                              ("ties", ties, props)):
            for crit in ("exact", "topk", "distance"):
                got = fused_verify_cuda(lg, pr, criterion=crit, **kw)
                want = fused_verify_plain(lg, pr, criterion=crit, **kw)
                torch.cuda.synchronize()
                same = all(torch.equal(g, w) for g, w in zip(got, want))
                log(f"  fused_verify {name} {dtype} ({b},8,{vp}) {label} "
                    f"{crit}: k̂={got[1].tolist()} {'ok' if same else 'FAIL'}")
                check(same, f"fused_verify {name} {dtype} {label} {crit} "
                            f"differs from its plain version")
                if crit == "exact" and label in ("all-accept", "all-reject"):
                    want_k = 8 if label == "all-accept" else 1
                    check(bool((got[1] == want_k).all()),
                          f"fused_verify {name} {label}: k̂ != {want_k}")
        if name == "paper-mt-base" and dtype == "bfloat16":
            o = torch.randn((b * 7, d), generator=gen, device="cuda").to(dt)
            heads_ms = time_ms(torch, lambda: fused_heads_topk_cuda(
                o, w, vocab=vocab, top_t=1))
            heads_plain = time_ms(torch, lambda: heads_topk_plain(
                o, w, vocab=vocab, top_t=1))
            verify_ms = time_ms(torch, lambda: fused_verify_cuda(
                logits, props, criterion="exact"))
            verify_plain = time_ms(torch, lambda: fused_verify_plain(
                logits, props, criterion="exact"))
            heads_bound, _ = bound(nbytes(o, w) + b * 7 * 8,
                                   2.0 * b * 7 * d * vp, dtype)
            verify_bound, _ = bound(nbytes(logits, props) + b * 8 * 9 + b * 8,
                                    b * 8 * vp, dtype)
            log(f"  paper-mt-base bf16: fused_heads ({b * 7},{d})x({d},{vp}) "
                f"T=1 kernel {heads_ms:.4f} ms, plain {heads_plain:.4f} ms, "
                f"bound {heads_bound:.4f} ms; fused_verify ({b},8,{vp}) exact "
                f"kernel {verify_ms:.4f} ms, plain {verify_plain:.4f} ms, "
                f"bound {verify_bound:.4f} ms")


def check_rwkv6_scan(torch, gen, results):
    from repro_torch.kernels.rwkv6_scan import (rwkv6_scan_cuda,
                                                rwkv6_scan_plain)

    cases = []   # (dtype, B, S, H, D, kind)
    for dtype in ("bfloat16", "float32"):
        cases += [(dtype, 8, 512, 32, 64, "path"),
                  (dtype, 8, 37, 32, 64, "ragged S"),
                  (dtype, 8, 1, 32, 64, "S 1"),
                  (dtype, 8, 16, 32, 64, "S 16"),
                  (dtype, 8, 17, 32, 64, "S 17"),
                  (dtype, 2, 64, 8, 16, "D 16"),
                  (dtype, 2, 64, 8, 32, "D 32"),
                  (dtype, 2, 64, 8, 128, "D 128"),
                  (dtype, 1, 48, 4, 64, "strong decay"),
                  (dtype, 2, 64, 8, 64, "logw -20"),
                  (dtype, 2, 64, 8, 64, "mixed decay")]
    worst = 0.0
    timed = {}
    for dtype, b, s, h, d, kind in cases:
        dt = getattr(torch, dtype)
        r, k, v = (torch.randn((b, s, h, d), generator=gen,
                               device="cuda").to(dt) for _ in range(3))
        if kind == "strong decay":               # w = e^-8: near-total decay
            logw = torch.full((b, s, h, d), -8.0, device="cuda")
        elif kind == "logw -20":                 # past the reference's range
            logw = torch.full((b, s, h, d), -20.0, device="cuda")
        elif kind == "mixed decay":              # w = 1 beside w = e^-20
            logw = torch.zeros((b, s, h, d), device="cuda")
            logw[..., 1::2] = -20.0
        else:
            logw = -torch.exp(torch.randn((b, s, h, d), generator=gen,
                                          device="cuda") * 0.5 - 1.0)
        u = torch.randn((h, d), generator=gen, device="cuda") * 0.1
        got = rwkv6_scan_cuda(r, k, v, logw, u)
        want = rwkv6_scan_plain(r, k, v, logw, u)
        torch.cuda.synchronize()
        ok, err = True, 0.0
        for g, w in zip(got, want):                  # y, then the final state
            ok = ok and bool(torch.isfinite(g).all()) and torch.allclose(
                g, w, rtol=SCAN_TOL, atol=SCAN_TOL * float(w.abs().max()))
            err = max(err, (g - w).abs().max().item())
        log(f"  rwkv6_scan {dtype} B={b} S={s} H={h} D={d} {kind}: "
            f"max_abs_err={err:.3g} (max|y| {float(want[0].abs().max()):.3g}) "
            f"{'ok' if ok else 'FAIL'}")
        check(ok, f"rwkv6_scan {dtype} S={s} D={d} {kind} differs from its "
                  f"plain version by {err}")
        worst = max(worst, err)
        if kind == "path":
            timed[dtype] = (r, k, v, logw, u)
        for chunk in CHECKPOINT_CHUNKS:               # the training forward
            y1, s1, ck = rwkv6_scan_cuda(r, k, v, logw, u, chunk=chunk)
            check(torch.equal(y1, got[0]) and torch.equal(s1, got[1]),
                  f"rwkv6_scan {dtype} S={s} D={d} {kind}: the forward with "
                  f"checkpoints every {chunk} differs from the forward without")
            check(ck.shape == (b, h, -(-s // chunk), d, d)
                  and torch.equal(ck[:, :, 0], torch.zeros_like(ck[:, :, 0])),
                  f"rwkv6_scan {dtype} S={s} chunk {chunk}: checkpoints "
                  f"{tuple(ck.shape)}")
    log(f"  rwkv6_scan: max_abs_err over all {len(cases)} cases {worst:.3g}; "
        f"with checkpoints every {CHECKPOINT_CHUNKS} steps y and the final "
        f"state bit for bit those without, in every case")

    # time at the rwkv6 serve path's prefill: bf16, B=8, S=512, H=32, D=64
    fp32_ms = time_ms(torch, lambda: rwkv6_scan_cuda(*timed["float32"]))
    f32_bytes = nbytes(*timed["float32"])
    timed = timed["bfloat16"]
    kernel_ms = time_ms(torch, lambda: rwkv6_scan_cuda(*timed))
    plain_ms = time_ms(torch, lambda: rwkv6_scan_plain(*timed), runs=5,
                       warmup=1)
    b, s, h, d = timed[0].shape
    out_bytes = (b * s * h * d + b * h * d * d) * 4      # y and the state, f32
    bms, by = bound(nbytes(*timed) + out_bytes, 4.0 * b * s * h * d * d,
                    "float32")
    results["rwkv6_scan"] = dict(
        source="src/repro_torch/kernels/csrc/rwkv6_scan.cu",
        replaces="src/repro/kernels/rwkv6_scan.py:100",
        max_abs_err=worst, ms=kernel_ms, plain_ms=plain_ms, bound_ms=bms,
        bound_by=by, library_ms=None,
        fp32=fp32_row(fp32_ms, f32_bytes + out_bytes, 4.0 * b * s * h * d * d),
        shape="bf16 r/k/v (8,512,32,64), logw f32, u (32,64)")
    check_rwkv6_scan_bwd(torch, gen, results)


CHECKPOINT_CHUNKS = (16, 32)      # the training forward's checkpoint spacings


def scan_bwd_case(torch, gen, dtype, b, s, h, d, kind, chunk, with_dstate):
    """The reverse scan's inputs: the forward's, the plain forward's
    checkpoints of every ``chunk`` steps, dy and (``with_dstate``) dstate."""
    from repro_torch.kernels.ref import rwkv6_scan as plain

    dt = getattr(torch, dtype)
    r, k, v = (torch.randn((b, s, h, d), generator=gen, device="cuda").to(dt)
               for _ in range(3))
    if kind in ("-8", "-20"):
        logw = torch.full((b, s, h, d), float(kind), device="cuda")
    elif kind == "0 beside -20":
        logw = torch.zeros((b, s, h, d), device="cuda")
        logw[..., 1::2] = -20.0
    else:
        logw = -torch.exp(torch.randn((b, s, h, d), generator=gen,
                                      device="cuda") * 0.5 - 1.0)
    u = torch.randn((h, d), generator=gen, device="cuda") * 0.1
    dy = torch.randn((b, s, h, d), generator=gen, device="cuda")
    ds = (torch.randn((b, h, d, d), generator=gen, device="cuda")
          if with_dstate else None)
    _, _, ck = plain(r, k, v, logw, u, chunk=chunk)
    return r, k, v, logw, u, ck, dy, ds


def check_rwkv6_scan_bwd(torch, gen, results):
    """The reverse scan (csrc/rwkv6_scan_bwd.cu) against its plain version
    from the same checkpoints: S 1, 16, 17, 37 and 512, D 16, 32, 64 and
    128, logw -8, -20 and 0 beside -20, r/k/v f32 and bf16, with and
    without dstate, chunks of 16 and 32; each output within SCAN_TOL of its
    own max |value|.  Timed at rwkv6-1.6b's training shape (fp32, B 4, S
    512, H 32, D 64, chunk 16) beside the plain version and the bound."""
    from repro_torch.kernels.ref import rwkv6_scan_bwd as plain_bwd
    from repro_torch.kernels.rwkv6_scan import (TRAIN_CHUNK,
                                                rwkv6_scan_bwd_cuda)

    cases = []   # (dtype, B, S, H, D, logw, chunk, dstate)
    for dtype in ("float32", "bfloat16"):
        cases += [(dtype, 2, 1, 4, 64, "mild", 16, False),
                  (dtype, 2, 16, 4, 64, "mild", 16, True),
                  (dtype, 2, 17, 4, 64, "-8", 32, True),
                  (dtype, 2, 37, 4, 64, "0 beside -20", 16, False),
                  (dtype, 2, 37, 4, 16, "mild", 32, True),
                  (dtype, 2, 37, 4, 32, "-20", 16, True),
                  (dtype, 1, 40, 2, 128, "mild", 16, True),
                  (dtype, 1, 40, 2, 128, "0 beside -20", 32, False),
                  (dtype, 4, 512, 32, 64, "mild", 16, False)]
    worst = 0.0
    for dtype, b, s, h, d, kind, chunk, with_ds in cases:
        ins = scan_bwd_case(torch, gen, dtype, b, s, h, d, kind, chunk, with_ds)
        got = rwkv6_scan_bwd_cuda(*ins, chunk=chunk)
        want = plain_bwd(*ins, chunk=chunk)
        torch.cuda.synchronize()
        ok, err = True, 0.0
        for g, w in zip(got, want):            # dr, dk, dv, dlogw, du
            ok = ok and bool(torch.isfinite(g).all()) and bool(
                ((g - w).abs() <= SCAN_TOL * float(w.abs().max())).all())
            err = max(err, (g - w).abs().max().item())
        log(f"  rwkv6_scan_bwd {dtype} B={b} S={s} H={h} D={d} logw {kind} "
            f"chunk {chunk}{' dstate' if with_ds else ''}: max_abs_err="
            f"{err:.3g} (max|dr| {float(want[0].abs().max()):.3g}) "
            f"{'ok' if ok else 'FAIL'}")
        check(ok, f"rwkv6_scan_bwd {dtype} S={s} D={d} logw {kind} chunk "
                  f"{chunk} differs from its plain version by {err}")
        worst = max(worst, err)
    log(f"  rwkv6_scan_bwd: max_abs_err over all {len(cases)} cases {worst:.3g}")

    # rwkv6-1.6b's training shape: fp32, B 4, S 512, H 32, D 64
    b, s, h, d, chunk = 4, 512, 32, 64, TRAIN_CHUNK
    ins = scan_bwd_case(torch, gen, "float32", b, s, h, d, "mild", chunk, False)
    kernel_ms = time_ms(torch, lambda: rwkv6_scan_bwd_cuda(*ins, chunk=chunk))
    plain_ms = time_ms(torch, lambda: plain_bwd(*ins, chunk=chunk), runs=3,
                       warmup=1)
    out_bytes = 4 * b * s * h * d * 4 + h * d * 4   # dr, dk, dv, dlogw, du
    flops = 12.0 * b * s * h * d * d
    in_bytes = nbytes(*ins[:7])
    bms, by = bound(in_bytes + out_bytes, flops, "float32")
    log(f"  rwkv6_scan_bwd @ fp32 (4,512,32,64) chunk {chunk}: kernel "
        f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.4f} ms "
        f"({by}: {(in_bytes + out_bytes) / 1e6:.1f} MB, {flops / 1e9:.2f} "
        f"GFLOP), checkpoints {nbytes(ins[5]) / 2 ** 20:.1f} MiB a layer")
    # the call's kernels one by one (the reverse scan, dv's zeroing at D
    # 128, the wrapper's sum of du over B), from a profiled call, L2 warm
    _, busy_ms, count, busy = profiled_busy(
        torch, lambda: rwkv6_scan_bwd_cuda(*ins, chunk=chunk))
    if busy_ms is None:
        log("  rwkv6_scan_bwd kernels one by one: not measured (no profiler trace)")
    else:
        names = {}
        for k in busy:                  # the kernel's own name, unmangled
            m = re.search(r"(\w+)[<(]", k)
            names[k] = m.group(1) if m else k
        log(f"  rwkv6_scan_bwd kernels one by one ({count} in the call, "
            f"{busy_ms:.4f} ms busy): "
            + ", ".join(f"{names[k]} {t:.4f} ms" for k, t in
                        sorted(busy.items(), key=lambda kv: -kv[1])))
    results["rwkv6_scan_bwd"] = dict(
        source="src/repro_torch/kernels/csrc/rwkv6_scan_bwd.cu",
        replaces="src/repro/models/rwkv6.py:90",
        max_abs_err=worst, ms=kernel_ms, plain_ms=plain_ms, bound_ms=bms,
        bound_by=by, library_ms=None,
        fp32=fp32_row(kernel_ms, in_bytes + out_bytes, flops),
        shape="fp32 r/k/v/logw/dy (4,512,32,64), u (32,64), checkpoints "
              "every 16 steps")


# ---------------------------------------------------------------------------
# phases 4-6: the decode path at full width
# ---------------------------------------------------------------------------


def p1_logits_after(torch, M, params, cfg, prefix, patches=None):
    """p_1's logits (V,) in fp32 after ``prefix`` (1-d token tensor), by one
    full forward of the prefix (behind ``patches`` (P, d), a vision_text
    row's patch embeddings, in chunks of KV_CHUNK keys)."""
    batch = {"tokens": prefix[None]}
    if patches is not None:
        batch["patch_embeds"] = patches[None]
    h = M.embed_inputs(params, cfg, batch)
    hidden, _ = M.forward_hidden(params, cfg, h, moe_full_capacity=True,
                                 kv_chunk=KV_CHUNK if patches is not None
                                 else 0)
    return M.base_logits(params, cfg, hidden[:, -1])[0, :cfg.vocab_size].float()


def top2_gap(torch, logits) -> float:
    """The top-2 gap of ``logits`` (V,), as a fraction of max|logit|."""
    top2 = torch.topk(logits, 2).values
    return float((top2[0] - top2[1]) / logits.abs().max())


def near_tie(torch, M, params, cfg, prefix, patches=None) -> float:
    """Greedy's top-2 p_1 logit gap after ``prefix``, as a fraction of
    max|logit|."""
    return top2_gap(torch, p1_logits_after(torch, M, params, cfg, prefix,
                                           patches))


def bf16_ulp(x: float) -> float:
    """Spacing of bf16 values (8 significant bits) at magnitude ``x``."""
    import math
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def divergence_at(torch, logits, bpd_tok, greedy_tok):
    """Where BPD's and greedy's tokens first differ, from the full forward's
    p_1 ``logits`` there: the top-2 gap, and the rank and gap below the top
    of each side's token, the gaps in bf16 ulps of max|logit|."""
    ulp = bf16_ulp(float(logits.abs().max()))
    top2 = torch.topk(logits, 2).values
    out = {"top2_ulps": float(top2[0] - top2[1]) / ulp}
    for side, tok in (("bpd", bpd_tok), ("greedy", greedy_tok)):
        out[f"{side}_rank"] = int((logits > logits[tok]).sum()) + 1
        out[f"{side}_ulps"] = float(top2[0] - logits[tok]) / ulp
    return out


def causal_logits_after(torch, M, params, cfg, batch=None):
    """``logits_after(row, prefix)`` of the decoder-only model: p_1's
    logits after the 1-d token ``prefix`` (behind the row's patches when
    ``batch`` carries them)."""
    patches = (batch or {}).get("patch_embeds")
    return lambda r, prefix: p1_logits_after(
        torch, M, params, cfg, prefix,
        None if patches is None else patches[r])


class Routes:
    """While entered, the router logits of every MoE layer that runs
    (``models.moe.ROUTER_TRACE``), kept on the device with their positions:
    the evidence for a router near-tie (``router_tie``)."""

    def __init__(self, torch):
        self.torch, self.recs = torch, []

    def __enter__(self):
        from repro_torch.models import moe

        moe.ROUTER_TRACE = lambda layer, pos, logits: self.recs.append(
            (layer, pos.clone(), logits))
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe

        moe.ROUTER_TRACE = None

    def row(self, r):
        """{(position, layer): logits (E,)} of batch row ``r``, each from
        the last forward over the position (numpy, on the host)."""
        out = {}
        for layer, pos, logits in self.recs:
            pos, logits = pos[r].tolist(), logits[r].float().cpu().numpy()
            for j, q in enumerate(pos):
                out[(q, layer)] = logits[j]
        return out

    def by_position(self):
        """{(position, layer): (n, E)} of every row's logits (numpy)."""
        import numpy as np

        parts = {}
        for layer, pos, logits in self.recs:
            flat = logits.reshape(-1, logits.shape[-1]).float().cpu().numpy()
            for q, lg in zip(pos.reshape(-1).tolist(), flat):
                parts.setdefault((q, layer), []).append(lg)
        return {key: np.stack(v) for key, v in parts.items()}


ROUTER_TIES = []       # every router near-tie admitted in this run
# (arch, run) -> a one-device run of phases 16-18 (``family_paths``' paths,
# ``phase_engine_fp32``'s engine, ``family_serve``'s bf16 serve) that phase
# 22 holds its sharded runs of the same model, seed and prompts against
ONE_DEVICE = {}


def routes_for(torch, cfg):
    """A ``Routes`` recorder for an MoE model, else a context that records
    nothing (and gives None)."""
    import contextlib

    return Routes(torch) if cfg.mlp_type == "moe" else contextlib.nullcontext()


def router_tie(cfg, greedy_row, other, end: int, label: str) -> bool:
    """The router extension of the near-tie rule.  ``greedy_row``:
    greedy's routing of one row (``Routes.row``); ``other``: the run that
    left it (``Routes.by_position``), where each (position, layer) is
    matched to the computation closest to greedy's (within ROUTER_MATCH of
    max|logit|: stale drafts, tree siblings and other requests lie far
    away).  At the first (position, layer) below ``end`` whose chosen
    experts differ, both sides' relative K-th / (K+1)-th router-probability
    gap must be below ROUTER_TIE_MARGIN; the evidence is printed and
    counted in ROUTER_TIES.  Returns whether the divergence is admitted."""
    import numpy as np

    k = cfg.num_experts_per_tok

    def top(lg):
        return set(np.argsort(-lg, kind="stable")[:k].tolist())

    def gap(lg):
        srt = np.sort(lg.astype(np.float64))[::-1]
        return float(-np.expm1(-(srt[k - 1] - srt[k])))

    for q in range(end):
        for layer in range(cfg.num_layers):
            g = greedy_row[(q, layer)]
            cands = other.get((q, layer))
            if cands is None:
                log(f"    {label}: the run never computed position {q}")
                return False
            dist = np.abs(cands - g).max(axis=1)
            j = int(dist.argmin())
            near = float(dist[j]) <= ROUTER_MATCH * float(np.abs(g).max())
            o = cands[j]
            if near and top(g) == top(o):
                continue
            gaps = (gap(g), gap(o))
            ok = near and max(gaps) < ROUTER_TIE_MARGIN
            log(f"    {label}: first routing difference at position {q}, "
                f"layer {layer}: greedy's experts {sorted(top(g))}, the "
                f"run's {sorted(top(o))} (its closest computation "
                f"{float(dist[j]):.3g} away, max|router logit| "
                f"{float(np.abs(g).max()):.3g}); K-th / (K+1)-th router gaps "
                f"{gaps[0]:.3g} / {gaps[1]:.3g}: "
                f"{'a router near-tie' if ok else 'NOT a router near-tie'}")
            if ok:
                ROUTER_TIES.append((label, q, layer, max(gaps)))
            return ok
    log(f"    {label}: no routing difference before position {end}")
    return False


def compare_rows(torch, logits_after, bpd, greedy, text_len, prompt_len, *,
                 routes=None, cfg=None, label=""):
    """BPD rows must equal greedy's, except a row that diverges at a
    position where greedy's top-2 gap is below TIE_MARGIN
    (``logits_after(row, prefix)``: p_1's logits after a row's prefix), or,
    for an MoE model with ``routes`` (greedy's and BPD's ``Routes``), one
    whose first routing difference is a router near-tie (``router_tie``)."""
    diverged = []
    other = routes[1].by_position() if routes else None
    for r in range(bpd.shape[0]):
        n = int(text_len[r])
        a, g = bpd[r, :n], greedy[r, :n]
        if torch.equal(a, g):
            continue
        p = int((a != g).nonzero()[0])
        gap = top2_gap(torch, logits_after(r, g[:p]))
        log(f"    row {r} diverges at position {p} (new token {p - prompt_len}): "
            f"greedy top-2 gap {gap:.3g} of max|logit|")
        ok = gap < TIE_MARGIN or (routes is not None and router_tie(
            cfg, routes[0].row(r), other, p, f"{label} row {r}"))
        check(ok, f"row {r}: BPD differs from greedy at position {p} with no "
                  f"near-tie (gap {gap})")
        diverged.append(r)
    return diverged


def report_divergences(torch, logits_after, bpd, greedy, prompt_len, end):
    """bf16: each row's first BPD/greedy divergence, reported and counted
    as a near-tie when BPD's token lies within BF16_TIE_ULPS of the full
    forward's top logit (its rank is printed, but several logits can tie
    within one ulp).  Reported, never failed."""
    rows = []
    for r in range(bpd.shape[0]):
        a, g = bpd[r, :end], greedy[r, :end]
        if torch.equal(a, g):
            continue
        p = int((a != g).nonzero()[0])
        d = divergence_at(torch, logits_after(r, g[:p]), int(a[p]), int(g[p]))
        d["tie"] = d["bpd_ulps"] <= BF16_TIE_ULPS
        log(f"    row {r} diverges at new token {p - prompt_len}: full-forward "
            f"top-2 gap {d['top2_ulps']:.3g} ulp; BPD's token rank "
            f"{d['bpd_rank']} ({d['bpd_ulps']:.3g} ulp below the top), "
            f"greedy's rank {d['greedy_rank']} ({d['greedy_ulps']:.3g} ulp)"
            f"{'' if d['tie'] else '  NOT A NEAR-TIE'}")
        rows.append(d)
    return rows


def phase_decode(torch, results):
    import numpy as np

    from repro_torch.config import DecodeConfig, get_config
    from repro_torch.core import ModelBundle
    from repro_torch.core import decode as D
    from repro_torch.data.synthetic import MarkovLM
    from repro_torch.kernels import _build
    from repro_torch.launch import serve
    from repro_torch.kernels.tree_mask import default_tree
    from repro_torch.models import model as M

    full = cfg = get_config("granite-3-8b").replace(dtype="float32")
    t0 = time.perf_counter()
    params = M.init(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    log(f"[decode] granite-3-8b fp32: {n_params / 1e9:.3f} B parameters, "
        f"init {time.perf_counter() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.1f} GiB allocated")
    task = MarkovLM(vocab=256, temperature=0.2, seed=0)
    prompt_len, max_new, block_k = 64, 64, cfg.bpd_k
    prompts = torch.as_tensor(task.sample(np.random.default_rng(1), 8,
                                          prompt_len), device="cuda")
    batch = {"tokens": prompts}
    dec = DecodeConfig(max_new_tokens=max_new, block_k=block_k)
    layers = cfg.num_layers

    _build.reset_launches()
    t0 = time.perf_counter()
    g_toks, g_stats = D.greedy_decode(params, cfg, dec, batch)
    torch.cuda.synchronize()
    g_wall = time.perf_counter() - t0
    g_launch = dict(_build.LAUNCHES)
    _build.reset_launches()
    t0 = time.perf_counter()
    b_toks, b_stats = D.bpd_decode(params, cfg, dec, batch)
    torch.cuda.synchronize()
    b_wall = time.perf_counter() - t0
    b_launch = dict(_build.LAUNCHES)
    log(f"[decode] greedy: {g_stats['iterations']} steps, {g_wall:.2f}s, "
        f"launches {g_launch}")
    log(f"[decode] bpd: k̂={b_stats['mean_accepted']:.4f} iterations="
        f"{b_stats['iterations']} invocations={b_stats['invocations']}, "
        f"{b_wall:.2f}s, launches {b_launch}")
    check(g_launch["verify_attention"] == layers * g_stats["iterations"],
          f"greedy: verify_attention launched {g_launch['verify_attention']} "
          f"times for {g_stats['iterations']} forwards of {layers} layers")
    check(b_launch["verify_attention"] == layers * b_stats["iterations"],
          f"bpd: verify_attention launched {b_launch['verify_attention']} "
          f"times for {b_stats['iterations']} forwards of {layers} layers")
    check(b_launch["fused_verify"] == b_stats["iterations"],
          "bpd: fused_verify not launched once per iteration")
    check(b_launch["fused_heads"] == b_stats["iterations"] + 1,
          "bpd: fused_heads not launched once per iteration + prefill")
    check(bool((b_stats["generated"] == max_new).all()), "bpd: short rows")
    after = causal_logits_after(torch, M, params, cfg)
    diverged = compare_rows(torch, after, b_toks, g_toks,
                            b_stats["text_len"], prompt_len)
    log(f"[decode] fp32 BPD tokens == greedy tokens in "
        f"{8 - len(diverged)}/8 rows (others at near-ties)")
    phase4 = {"prompts": prompts.cpu(), "greedy": g_toks.cpu(),
              "khat": b_stats["mean_accepted"],
              "iterations": b_stats["iterations"]}

    # ---- phases 4b-5c, 14, 15a-15d: fp32 at cut depth -----------------------
    full_params = params
    cfg = full.replace(num_layers=FAMILY_FP32_LAYERS["granite-3-8b"])
    params = M.init(cfg, seed=0, device="cuda")
    layers = cfg.num_layers
    _build.reset_launches()
    g_toks, g_stats = D.greedy_decode(params, cfg, dec, batch)
    check(_build.LAUNCHES["verify_attention"] == layers * g_stats["iterations"],
          f"greedy at {layers} layers: launches {dict(_build.LAUNCHES)}")
    log(f"[decode] phases 4b-5c, 14, 15a-15d at {layers} of {full.num_layers} "
        f"layers (seed 0): greedy {g_stats['iterations']} steps, the tokens "
        f"they are held to")

    # ---- phase 4b: the paged cache and tree verification, fp32 -------------
    for label, kw, bpd in (
            ("greedy paged", dict(cache_backend="paged"), False),
            ("bpd exact paged", dict(cache_backend="paged"), True),
            ("bpd topk_tree dense", dict(policy="topk_tree", top_k=2), True),
            ("bpd topk_tree paged", dict(policy="topk_tree", top_k=2,
                                         cache_backend="paged"), True)):
        pdec = dec.replace(**kw)
        _build.reset_launches()
        t0 = time.perf_counter()
        run = D.bpd_decode if bpd else D.greedy_decode
        toks, stats = run(params, cfg, pdec, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launch = dict(_build.LAUNCHES)
        iters = stats["iterations"]
        if pdec.policy == "topk_tree":
            attn = "tree_verify_attention"
        elif pdec.cache_backend == "paged":
            attn = "paged_verify_attention"
        else:
            attn = "verify_attention"
        want = {name: 0 for name in launch}
        want[attn] = layers * iters
        if bpd:
            want.update(fused_verify=iters, fused_heads=iters + 1)
        log(f"[paths] {label}: k̂={stats['mean_accepted']:.4f} iterations="
            f"{iters} invocations={stats['invocations']}, {wall:.2f}s, "
            f"launches {launch}")
        check(launch == want, f"{label}: launches {launch}, expected {want}")
        check(bool((stats["generated"] == max_new).all()), f"{label}: short rows")
        after = causal_logits_after(torch, M, params, cfg)
        diverged = compare_rows(torch, after, toks, g_toks,
                                stats["text_len"], prompt_len)
        log(f"[paths] {label}: tokens == greedy tokens in "
            f"{8 - len(diverged)}/8 rows (others at near-ties)")
        if label == "bpd exact paged":
            results["paged_verify_attention"]["launches"] = launch[attn]

    # ---- phase 5: multi-token accepts on the card -------------------------
    cont = g_toks[:, prompt_len:prompt_len + block_k].contiguous()
    for corrupt in (None, 3):
        state, prefix = D.bpd_prefill_causal_lm(params, cfg, dec, batch,
                                                max_new=max_new)
        props = cont.clone()
        if corrupt is not None:
            props[:, corrupt] = (props[:, corrupt] + 1) % cfg.vocab_size
        check(torch.equal(state.proposals[:, 0], cont[:, 0]),
              "prefill's verified slot 0 != greedy's first token")
        state = state._replace(proposals=props)
        with torch.no_grad():
            state = D.bpd_iteration(params, cfg, dec, D.causal_lm_backend(cfg),
                                    state, prefix_offset=prefix,
                                    max_new=max_new)
        khat = (state.text_len - prompt_len).tolist()
        want = block_k if corrupt is None else corrupt
        log(f"[accepts] proposals = greedy continuation"
            f"{'' if corrupt is None else f' with slot {corrupt} corrupted'}: "
            f"k̂ per row {khat}")
        for r, kh in enumerate(khat):
            if kh != want:
                gap = near_tie(torch, M, params, cfg,
                               g_toks[r, :prompt_len + kh])
                check(kh < want and gap < TIE_MARGIN,
                      f"row {r}: k̂={kh}, expected {want} (gap {gap})")
        n = prompt_len + min(khat)
        check(torch.equal(state.tokens[:, :n], g_toks[:, :n]),
              "committed tokens differ from greedy's")

    # ---- phase 5b: hand-made tree proposals ---------------------------------
    fanout = 2
    topo = default_tree(block_k, fanout)
    chain = [int(n) for n in topo.path_matrix[block_k - 1]]   # node 1's chain
    for backend in ("dense", "paged"):
        tdec = dec.replace(policy="topk_tree", top_k=fanout,
                           cache_backend=backend)
        for case, want in (("node 1 wrong, node 2 right", 2),
                           ("node 1's chain right", block_k - fanout + 1)):
            nodes = torch.empty_like(cont)
            for n in range(block_k):
                d = int(topo.depths[n])
                if n in chain:
                    nodes[:, n] = cont[:, d]
                else:                    # a sibling of node 1: a wrong token
                    nodes[:, n] = (cont[:, 1] + int(topo.ranks[n])) % cfg.vocab_size
            if want == 2:
                nodes[:, 1] = (cont[:, 1] + fanout) % cfg.vocab_size
                nodes[:, 2] = cont[:, 1]
            state, prefix = D.bpd_prefill_causal_lm(params, cfg, tdec, batch,
                                                    max_new=max_new)
            state = state._replace(proposals=nodes)
            with torch.no_grad():
                state = D.bpd_iteration(params, cfg, tdec,
                                        D.causal_lm_backend(cfg), state,
                                        prefix_offset=prefix, max_new=max_new)
            khat = (state.text_len - prompt_len).tolist()
            log(f"[tree] {backend} cache, {case}: k̂ per row {khat} "
                f"(expected {want})")
            for r, kh in enumerate(khat):
                if kh != want:
                    gap = near_tie(torch, M, params, cfg,
                                   g_toks[r, :prompt_len + kh])
                    check(kh < want and gap < TIE_MARGIN,
                          f"tree row {r}: k̂={kh}, expected {want} (gap {gap})")
            with torch.no_grad():            # the next block on the compacted cache
                state = D.bpd_iteration(params, cfg, tdec,
                                        D.causal_lm_backend(cfg), state,
                                        prefix_offset=prefix, max_new=max_new)
            after = causal_logits_after(torch, M, params, cfg)
            diverged = compare_rows(torch, after, state.tokens, g_toks,
                                    state.text_len, prompt_len)
            log(f"[tree] {backend} cache, {case}, second iteration: k̂ per row "
                f"{(state.text_len - prompt_len - torch.tensor(khat, device='cuda')).tolist()}; "
                f"tokens == greedy tokens in {8 - len(diverged)}/8 rows")

    # ---- phase 5c: the fp32 engine ------------------------------------------
    greedy_rows = phase_engine_fp32(torch, M, D, params, cfg, dec, prompts,
                                    g_toks)

    # ---- phase 14: kv_chunk on the fp32 weights ----------------------------
    phase_kv_chunk(torch, params, cfg, dec, batch, g_toks, prompt_len)

    # ---- phase 15a, 15b, 15d: draft_model on the fp32 weights --------------
    t15 = time.perf_counter()
    phase_draft_self(torch, M, D, params, cfg, dec, batch, g_toks, prompt_len)
    bundle = phase_draft_small(torch, M, D, params, cfg, dec, batch, g_toks,
                               prompt_len)
    phase_draft_engine(torch, D, params, cfg, dec, prompts, greedy_rows,
                       bundle, "15d draft_model + exact, paged")
    del bundle
    phase_draft_engine(torch, D, params, cfg, dec, prompts, greedy_rows,
                       ModelBundle(params, cfg),
                       "15d self-draft, paged, steps_per_sync 4",
                       steps_per_sync=4, alone=True)
    log(f"[draft] 15a, 15b fp32, 15d {time.perf_counter() - t15:.1f}s")

    # ---- phase 6: bf16 serve, phase 4's weights at full depth ---------------
    del state, params
    gc.collect()
    params, cfg, layers = full_params, full, full.num_layers
    # in place (frees the fp32 copy), the fp32-read leaves kept in fp32
    M.cast_for_compute(params, cfg.replace(dtype="bfloat16"))
    torch.cuda.empty_cache()
    log(f"[serve] weights cast for bf16: "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.1f} GiB allocated")
    _build.reset_launches()
    out = serve.main(["--arch", "granite-3-8b", "--full-config", "--batch",
                      "8", "--prompt-len", str(prompt_len), "--max-new",
                      str(max_new), "--block-k", str(block_k), "--seed", "0"],
                     params=params)
    launches = dict(_build.LAUNCHES)
    scfg, sdec, sbatch = out["cfg"], out["dec"], out["batch"]
    check(torch.equal(sbatch["tokens"], prompts), "serve prompts differ")
    s_toks, s_stats = out["tokens"], out["stats"]
    chain_path = ("verify_attention", "fused_verify", "fused_heads")
    check(all(launches[name] > 0 for name in chain_path),
          f"serve: a kernel was never launched: {launches}")
    check(launches["verify_attention"] == 2 * layers * s_stats["iterations"],
          f"serve: verify_attention launches {launches}")
    gb_toks, gb_stats = D.greedy_decode(params, scfg, sdec, sbatch)
    n = prompt_len + max_new
    same = (s_toks[:, prompt_len:n] == gb_toks[:, prompt_len:n])
    agree = float(same.float().mean())
    rows_equal = int(same.all(dim=1).sum())
    generated = int(s_stats["generated"].sum())
    static_tps = generated / out["wall_s"]
    log(f"[serve] bf16: {static_tps:.1f} tokens/s, "
        f"k̂={s_stats['mean_accepted']:.4f}, iterations="
        f"{s_stats['iterations']}, invocations="
        f"{s_stats['invocations']}, wall {out['wall_s'] * 1e3:.1f} ms; "
        f"BPD vs greedy agreement {agree:.4f} of tokens, {rows_equal}/8 rows "
        f"identical (reported, not required in bf16)")
    after = causal_logits_after(torch, M, params, scfg)
    div = report_divergences(torch, after, s_toks, gb_toks, prompt_len, n)
    log(f"[serve] bf16 first divergences: {len(div)} rows, "
        f"{sum(d['tie'] for d in div)} at near-ties (BPD's token <= "
        f"{BF16_TIE_ULPS} ulp below the top); BPD's token ranks "
        f"{[d['bpd_rank'] for d in div]}, ulps below the top "
        f"{[round(d['bpd_ulps'], 3) for d in div]}")
    for name in chain_path:
        results[name]["launches"] = launches[name]
    phase4["bf16"] = {"tokens": s_toks.cpu(), "tps": static_tps,
                      "iterations": s_stats["iterations"]}
    profile_iteration(torch, D, params, scfg, sdec, sbatch, "exact dense")

    # ---- phase 6b: bf16 serve, topk_tree on the paged cache ----------------
    _build.reset_launches()
    out = serve.main(["--arch", "granite-3-8b", "--full-config", "--batch",
                      "8", "--prompt-len", str(prompt_len), "--max-new",
                      str(max_new), "--block-k", str(block_k), "--seed", "0",
                      "--policy", "topk_tree", "--cache-backend", "paged"],
                     params=params)
    launches = dict(_build.LAUNCHES)
    tcfg, tdec, tbatch = out["cfg"], out["dec"], out["batch"]
    t_toks, t_stats = out["tokens"], out["stats"]
    iters = t_stats["iterations"]
    want = {name: 0 for name in launches}
    want.update(tree_verify_attention=2 * layers * iters,
                fused_verify=2 * iters, fused_heads=2 * (iters + 1))
    check(launches == want, f"serve topk_tree paged: launches {launches}, "
                            f"expected {want}")
    results["tree_verify_attention"]["launches"] = launches["tree_verify_attention"]
    gt_toks, _ = D.greedy_decode(params, tcfg, tdec, tbatch)
    same = (t_toks[:, prompt_len:n] == gt_toks[:, prompt_len:n])
    generated = int(t_stats["generated"].sum())
    log(f"[serve] bf16 topk_tree paged: {generated / out['wall_s']:.1f} "
        f"tokens/s, k̂={t_stats['mean_accepted']:.4f}, iterations={iters}, "
        f"invocations="
        f"{t_stats['invocations']}, wall {out['wall_s'] * 1e3:.1f} ms; "
        f"BPD vs greedy agreement {float(same.float().mean()):.4f} of tokens, "
        f"{int(same.all(dim=1).sum())}/8 rows identical (reported, not "
        f"required in bf16)")
    after = causal_logits_after(torch, M, params, tcfg)
    div = report_divergences(torch, after, t_toks, gt_toks, prompt_len, n)
    log(f"[serve] bf16 topk_tree paged first divergences: {len(div)} rows, "
        f"{sum(d['tie'] for d in div)} at near-ties; BPD's token ranks "
        f"{[d['bpd_rank'] for d in div]}, ulps below the top "
        f"{[round(d['bpd_ulps'], 3) for d in div]}")
    profile_iteration(torch, D, params, tcfg, tdec, tbatch, "topk_tree paged")

    # ---- phase 6c: the bf16 engine and the HTTP server ---------------------
    phase4["engine_bf16"] = phase_engine_bf16(torch, params, scfg, sdec,
                                              prompts, static_tps)

    # ---- phase 15b bf16: draft_model on the cast weights -------------------
    phase_draft_bf16(torch, D, params, scfg, sdec, sbatch, static_tps)
    return phase4


# ---------------------------------------------------------------------------
# phases 5c and 6c: the continuous-batching engine
# ---------------------------------------------------------------------------

ENGINE_GROUPS = {"exact": 4, "topk_tree": 4}
ENGINE_BUDGETS = (64, 16, 40, 56, 24, 48, 32, 64, 16, 64, 32, 48, 56, 24, 40, 16)


def engine_plan():
    """The engine phases' 16 requests: (rid, prompt row, prompt length,
    budget, arrival, policy).  Phase 4's 8 prompts at 64 tokens arrive at
    0; the first 32 tokens of prompts 0-3 and the first 48 of prompts 4-7
    arrive later in virtual time, each in its source prompt's group, so
    their pages can be copy-on-write hits of the source's prefix pages."""
    plan = [(i, i, 64, ENGINE_BUDGETS[i], 0.0) for i in range(8)]
    plan += [(8 + j, j, 32, ENGINE_BUDGETS[8 + j], 2.0 * (j + 1))
             for j in range(4)]
    plan += [(12 + j, 4 + j, 48, ENGINE_BUDGETS[12 + j], 2.0 * (j + 5))
             for j in range(4)]
    return [(rid, row, plen, budget, t, ("exact", "topk_tree")[row % 2])
            for rid, row, plen, budget, t in plan]


def engine_requests(serving, prompts):
    host = prompts.cpu().numpy()
    return [serving.Request(rid=rid, prompt=host[row, :plen], max_new=budget,
                            arrival=t, policy=policy)
            for rid, row, plen, budget, t, policy in engine_plan()]


def profiled_busy(torch, fn):
    """Run ``fn`` once under torch.profiler: (its result, the kernels' summed
    device ms, kernel count, {name: ms}); the times are None when the
    profiler sees no device activity or is unavailable (a measurement, not
    the path: ``fn`` runs either way)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    try:
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.__enter__()
    except (RuntimeError, AttributeError) as exc:
        log(f"[profile] torch.profiler unavailable ({exc}); not measured")
        return fn(), None, 0, {}
    out = fn()
    torch.cuda.synchronize()
    try:
        prof.__exit__(None, None, None)
        kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    except (RuntimeError, AttributeError) as exc:
        log(f"[profile] torch.profiler failed ({exc}); not measured")
        return out, None, 0, {}
    busy = {}
    for e in kernels:
        busy[e.name] = busy.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    return out, (sum(busy.values()) if kernels else None), len(kernels), busy


def quantile(values, q: float) -> float:
    """The ``q`` quantile of ``values`` (nearest rank)."""
    v = sorted(values)
    return float(v[min(len(v) - 1, int(round(q * (len(v) - 1))))])


def drive_engine(torch, serving, engine, reqs, label, *, profile_step=6,
                 ttft=False):
    """Serve ``reqs`` through ``engine`` with a virtual clock (one scheduler
    step per second of arrival time).  Scheduler step ``profile_step`` is
    timed alone (host wall, synced) and the next one profiled (device
    busy), so the sample's idle share is 1 - busy / wall (None: no
    sample).  ``ttft``: the committed tokens are polled after each step
    (``poll_progress``), and each request's time to first token is the host
    wall from the start of the step its arrival made it visible to the
    step that committed its first token (``sample["ttft"]``).  The sample
    also holds the scheduler steps and the collectives issued
    (``sharding.comm.CALLS``).  Returns (the finished requests, host wall
    s, harvest reads, the sample)."""
    from repro_torch.sharding import comm

    sched = serving.Scheduler(engine)
    for r in reqs:
        sched.submit(r)
    now, done, pulls, sample = 0.0, [], 0, {}
    seen, first = {}, {}
    calls = sum(comm.CALLS.values())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while not sched.drained():
        step = int(now)
        start = time.perf_counter()
        for r in reqs:
            if r.arrival <= now:
                seen.setdefault(r.rid, start)
        if step == profile_step:
            torch.cuda.synchronize()
            ts = time.perf_counter()
            got = sched.step(now=now)
            torch.cuda.synchronize()
            sample["wall_ms"] = (time.perf_counter() - ts) * 1e3
        elif profile_step is not None and step == profile_step + 1:
            got, busy, n_kernels, names = profiled_busy(
                torch, lambda: sched.step(now=now))
            sample.update(busy_ms=busy, kernels=n_kernels, names=names)
        else:
            got = sched.step(now=now)
        if ttft:
            fresh = [req.rid for req, _ in engine.poll_progress()]
            at = time.perf_counter()
            for rid in fresh + [f.rid for f in got]:
                first.setdefault(rid, at)
        pulls += len({f.policy for f in got})
        done += got
        now += 1.0
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    sample.update(steps=int(now), collectives=sum(comm.CALLS.values()) - calls)
    if ttft:
        sample["ttft"] = [first[r.rid] - seen[r.rid] for r in reqs]
    groups = {g.name: g for g in engine.groups}
    # k̂ per group: accepted tokens per request iteration (invocations less
    # the admission prefill)
    khat = {name: sum(f.generated for f in done if f.policy == name)
            / max(sum(f.invocations - 1 for f in done if f.policy == name), 1)
            for name in groups}
    tokens = sum(f.generated for f in done)
    busy = sample.get("busy_ms")
    log(f"[engine] {label}: {len(done)} requests, {tokens} tokens in "
        f"{wall:.2f}s ({tokens / wall:.1f} tokens/s); k̂ per group "
        f"{ {n: round(k, 4) for n, k in khat.items()} }; group steps "
        f"{ {n: g.num_forwards // engine.ecfg.steps_per_sync for n, g in groups.items()} }"
        f", iterations {engine.num_steps}, forwards {engine.num_forwards}, "
        f"prefills { {n: g.num_prefills for n, g in groups.items()} }, host "
        f"reads {engine.num_host_syncs} ({pulls} harvest); "
        + ("no sampled scheduler step" if profile_step is None else
           f"sampled scheduler step: host wall {sample['wall_ms']:.2f} ms, "
           + ("device busy not measured" if busy is None else
              f"{sample['kernels']} kernels busy {busy:.2f} ms, idle share "
              f"{1 - busy / sample['wall_ms']:.3f}")))
    return done, wall, pulls, sample


def check_engine_launches(engine, launches, label, *, paged):
    """Each kernel launched exactly as the engine's own accounting implies:
    its group's attention kernel once per layer and forward dispatched
    (masked no-op forwards of a window included), fused_verify once per
    forward, fused_heads once per forward and per prefill forward."""
    layers = engine.cfg.num_layers
    fwd = {g.name: g.num_forwards for g in engine.groups}
    pre = {g.name: g.num_prefills for g in engine.groups}
    want = {name: 0 for name in launches}
    chain = "paged_verify_attention" if paged else "verify_attention"
    want[chain] = layers * fwd["exact"]
    want["tree_verify_attention"] = layers * fwd["topk_tree"]
    want["fused_verify"] = sum(fwd.values())
    want["fused_heads"] = sum(fwd.values()) + sum(pre.values())
    check(launches == want, f"{label}: launches {launches}, expected {want}")
    log(f"[engine] {label}: launches {launches} (exact)")


def compare_engine(torch, after, done, greedy_rows, plan, label, *,
                   routes=None, cfg=None):
    """Each request's tokens equal greedy's truncated to its budget, except
    a request that leaves greedy where greedy's top-2 gap is below
    TIE_MARGIN (reported), or (an MoE model, ``routes`` = ({(row, plen):
    (greedy's Routes, its batch row)}, the engine's Routes)) whose first
    routing difference is a router near-tie.  ``greedy_rows[(row, plen)]``
    is greedy's row (prompt + 64 new tokens)."""
    other = routes[1].by_position() if routes else None
    by_rid = {f.rid: f for f in done}
    check(sorted(by_rid) == [p[0] for p in plan], f"{label}: requests lost")
    diverged = []
    for rid, row, plen, budget, _, _ in plan:
        f = by_rid[rid]
        g = greedy_rows[(row, plen)]
        want = g[plen:plen + budget].tolist()
        got = f.tokens.tolist()
        check(f.generated == budget == len(got),
              f"{label}: request {rid} generated {f.generated} of {budget}")
        if got == want:
            continue
        p = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
        gap = top2_gap(torch, after(rid, g[:plen + p]))
        log(f"    request {rid} (prompt row {row}, {plen} tokens) diverges at "
            f"new token {p}: greedy top-2 gap {gap:.3g} of max|logit|")
        ok = gap < TIE_MARGIN
        if not ok and routes is not None:
            rec, r = routes[0][(row, plen)]
            ok = router_tie(cfg, rec.row(r), other, plen + p,
                            f"{label} request {rid}")
        check(ok, f"{label}: request {rid} differs from greedy at new token "
                  f"{p} with no near-tie ({gap})")
        diverged.append(rid)
    log(f"[engine] {label}: tokens == greedy tokens in "
        f"{len(plan) - len(diverged)}/{len(plan)} requests (others at "
        f"near-ties)")
    return diverged


def phase_engine_fp32(torch, M, D, params, cfg, dec, prompts, g_toks, *,
                      disaggregated=True, greedy_routes=None):
    """Phase 5c: the fp32 engine, twice — unified on the managed page pool
    (page size 16, one iteration per host read), then (``disaggregated``)
    disaggregated (prefill batches of 4) on the dense slab with windows of
    4.  Returns greedy's row for each (prompt row, prompt length) of the
    plan.  An MoE model's routings are recorded (``greedy_routes``: those
    of the greedy decode that gave ``g_toks``) for the router near-tie
    rule."""
    from repro_torch import serving
    from repro_torch.kernels import _build

    plan = engine_plan()
    greedy_rows = {(row, 64): g_toks[row] for row in range(8)}
    g_routes = {(row, 64): (greedy_routes, row) for row in range(8)}
    for plen, rows in ((32, range(0, 4)), (48, range(4, 8))):
        with routes_for(torch, cfg) as rec:
            gt, _ = D.greedy_decode(
                params, cfg, dec,
                {"tokens": prompts[list(rows), :plen].contiguous()})
        for i, row in enumerate(rows):
            greedy_rows[(row, plen)] = gt[i]
            g_routes[(row, plen)] = (rec, i)
    after = causal_logits_after(torch, M, params, cfg)
    edec = dec.replace(top_k=2, page_size=16)
    runs = (("unified, paged, steps_per_sync 1",
             edec.replace(cache_backend="paged"), dict(steps_per_sync=1)),
            ("disaggregated (prefill_slots 4), dense, steps_per_sync 4",
             edec.replace(cache_backend="dense"),
             dict(prefill_slots=4, steps_per_sync=4)))[:2 if disaggregated
                                                         else 1]
    seen = {name: 0 for name in _build.KERNELS}
    for label, rdec, kw in runs:
        ecfg = serving.EngineConfig(num_slots=8, max_prompt_len=64,
                                    max_new_cap=64, **kw)
        engine = serving.ContinuousBatchingEngine(params, cfg, rdec, ecfg,
                                                  policies=ENGINE_GROUPS)
        _build.reset_launches()
        with routes_for(torch, cfg) as rec:
            done, wall, pulls, _ = drive_engine(
                torch, serving, engine, engine_requests(serving, prompts),
                label)
        launches = dict(_build.LAUNCHES)
        paged = rdec.cache_backend == "paged"
        check_engine_launches(engine, launches, label, paged=paged)
        for name, n in launches.items():
            seen[name] += n
        counts = engine.compile_counts()
        check(counts and all(v == 1 for v in counts.values()),
              f"{label}: builds {counts}")
        steps = engine.num_forwards // ecfg.steps_per_sync
        check(engine.num_host_syncs == steps + pulls,
              f"{label}: {engine.num_host_syncs} host reads for {steps} group "
              f"steps and {pulls} harvests")
        if paged:
            hits = sum(g.pages.cow_hits for g in engine.groups)
            log(f"[engine] {label}: copy-on-write prefix pages "
                f"{ {g.name: g.pages.cow_hits for g in engine.groups} }")
            check(hits > 0, f"{label}: no copy-on-write prefix hit")
        if kw["steps_per_sync"] > 1:
            log(f"[engine] {label}: {engine.num_forwards - engine.num_steps} "
                f"of {engine.num_forwards} forwards were masked no-ops "
                f"(windows after a harvestable row)")
        compare_engine(torch, after, done, greedy_rows, plan, label,
                       routes=(g_routes, rec) if rec is not None else None,
                       cfg=cfg)
        if paged:
            ONE_DEVICE[(cfg.name, "engine unified paged")] = {
                "records": [engine_record(f) for f in done],
                "launches": launches, "wall": wall,
                "counters": {"iterations": engine.num_steps,
                             "forwards": engine.num_forwards,
                             "prefill_batches": engine.num_prefill_batches,
                             "cow": {g.name: g.pages.cow_hits
                                     for g in engine.groups}}}
    for name in ("verify_attention", "paged_verify_attention",
                 "tree_verify_attention", "fused_verify", "fused_heads"):
        check(seen[name] > 0 or name == "verify_attention"
              and not disaggregated, f"engine: {name} never launched")
    return greedy_rows


def phase_engine_bf16(torch, params, cfg, dec, prompts, static_tps):
    """Phase 6c: the bf16 engine on the managed page pool (tokens/s and
    TTFT beside the static serve's, one scheduler step profiled), then the
    HTTP server on 127.0.0.1 answering 8 concurrent streamed requests from
    a client in this process: each stream must be byte-identical to its
    finish record.  Returns the engine run's tokens, tokens/s, TTFTs and
    host ms a scheduler step, for phase 22."""
    import asyncio
    import http.client
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch import serving

    edec = dec.replace(top_k=2, page_size=16, cache_backend="paged")
    ecfg = serving.EngineConfig(num_slots=8, max_prompt_len=64, max_new_cap=64)
    engine = serving.ContinuousBatchingEngine(params, cfg, edec, ecfg,
                                              policies=ENGINE_GROUPS)
    done, wall, _, sample = drive_engine(
        torch, serving, engine, engine_requests(serving, prompts),
        "bf16 unified, paged", ttft=True)
    tokens = sum(f.generated for f in done)
    ttft = sample["ttft"]
    log(f"[engine] bf16: {tokens / wall:.1f} tokens/s through the engine "
        f"(16 requests, budgets 16-64) beside {static_tps:.1f} tokens/s of "
        f"phase 6's static serve (8 x 64); TTFT p50 "
        f"{quantile(ttft, 0.5) * 1e3:.1f} ms, p99 "
        f"{quantile(ttft, 0.99) * 1e3:.1f} ms (host wall from the step of "
        f"arrival, committed tokens polled each step); "
        f"{wall / sample['steps'] * 1e3:.1f} host ms a scheduler step (the "
        f"poll after each step inside the window, as in the tokens/s)")
    run = {"tokens": {f.rid: f.tokens.tolist() for f in done},
           "tps": tokens / wall, "ttft": ttft,
           "step_ms": wall / sample["steps"] * 1e3}
    names = sample.get("names") or {}
    attn_ms = sum(ms for n, ms in names.items() if "attention_kernel" in n)
    for n, ms in sorted(names.items(), key=lambda kv: -kv[1])[:6]:
        log(f"    {ms:8.3f} ms  {n[:90]}")
    if names:
        log(f"[engine] bf16 sampled step: attention kernels {attn_ms:.3f} ms "
            f"of the busy time")
    direct = {f.rid: f.tokens.tolist() for f in done}

    # ---- the HTTP server: 8 concurrent streamed requests -------------------
    engine = serving.ContinuousBatchingEngine(params, cfg, edec, ecfg,
                                              policies=ENGINE_GROUPS)
    frontend = serving.Frontend(serving.Scheduler(engine), max_queue=16)
    srv = serving.HTTPServer(frontend, host="127.0.0.1", port=0)
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()
    asyncio.run_coroutine_threadsafe(srv.start(), loop).result(timeout=300)
    host = prompts.cpu().numpy()
    plan = [p for p in engine_plan() if p[0] < 8]

    def client(p):
        rid, row, plen, budget, _, policy = p
        body = json.dumps({"prompt": host[row, :plen].tolist(),
                           "max_new": budget, "policy": policy})
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=600)
        t0 = time.perf_counter()
        conn.request("POST", "/v1/generate", body=body)
        resp = conn.getresponse()
        check(resp.status == 200, f"http: status {resp.status}")
        toks, done_ev, ttft, event = [], None, None, None
        while True:
            line = resp.readline()
            if not line:
                break
            line = line.decode().rstrip("\n")
            if line.startswith("event: "):
                event = line[7:]
            elif line.startswith("data: "):
                data = json.loads(line[6:])
                if event == "token":
                    if ttft is None:
                        ttft = time.perf_counter() - t0
                    toks.extend(data["tokens"])
                elif event == "done":
                    done_ev = data
        conn.close()
        return rid, toks, done_ev, ttft

    try:
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=8) as ex:
            streams = list(ex.map(client, plan))
        http_wall = time.perf_counter() - t0
    finally:
        asyncio.run_coroutine_threadsafe(srv.stop(), loop).result(timeout=300)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(timeout=30)
    records = {f.rid: f for f in frontend.scheduler.finished}
    ttfts, same, total = [], 0, 0
    for (rid, toks, done_ev, ttft), p in zip(streams, plan):
        check(done_ev is not None, f"http: stream {rid} has no done event")
        f = records[done_ev["rid"]]
        check(toks == f.tokens.tolist() == done_ev["tokens"],
              f"http: stream of request {rid} differs from its finish record")
        check(len(toks) == p[3], f"http: request {rid} streamed {len(toks)} "
                                 f"of {p[3]} tokens")
        ttfts.append(ttft)
        want = direct[rid]
        same += sum(a == b for a, b in zip(toks, want))
        total += len(want)
    log(f"[http] 8 concurrent streamed requests in {http_wall:.2f}s: every "
        f"stream byte-identical to its finish record; TTFT p50 "
        f"{quantile(ttfts, 0.5) * 1e3:.1f} ms, p99 "
        f"{quantile(ttfts, 0.99) * 1e3:.1f} ms; agreement with "
        f"the direct engine run {same / total:.4f} of tokens (reported, not "
        f"required in bf16); builds {engine.compile_counts()}")
    return run


def profile_iteration(torch, D, params, cfg, dec, batch, label, *,
                      seq2seq=False, policy=None, aux_params=None,
                      kv_chunk=0):
    """One bf16 BPD iteration under torch.profiler: host wall time against
    the kernels' summed device time (the device's idle share), and the
    hand-written kernels' launches.  ``seq2seq``: an encoder-decoder,
    ``batch`` holding the sources; ``policy`` / ``aux_params``: a bound
    policy and its session's auxiliary parameters (draft_model);
    ``kv_chunk``: the prefill's chunk of keys."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import _build

    if seq2seq:
        state, be = D.bpd_prefill_seq2seq(params, cfg, dec, batch)
        prefix = 0
    else:
        state, prefix = D.bpd_prefill_causal_lm(params, cfg, dec, batch,
                                                max_new=dec.max_new_tokens,
                                                policy=policy,
                                                aux_params=aux_params,
                                                kv_chunk=kv_chunk)
        be = D.causal_lm_backend(cfg)

    def step(s):
        with torch.no_grad():
            return D.bpd_iteration(params, cfg, dec, be, s,
                                   prefix_offset=prefix,
                                   max_new=dec.max_new_tokens, policy=policy,
                                   aux_params=aux_params)

    state = step(state)                           # warm-up
    torch.cuda.synchronize()
    before = dict(_build.LAUNCHES)
    t0 = time.perf_counter()
    state = step(state)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launched = {n: c - before[n] for n, c in _build.LAUNCHES.items()
                if c != before[n]}
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            state = step(state)
            torch.cuda.synchronize()
        kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        # the Mamba scan's steps (models/mamba.py: one addcmul a step)
        scan = sum(1 for e in prof.events() if e.name == "aten::addcmul")
    except (RuntimeError, AttributeError) as exc:    # a measurement, not the path
        log(f"[profile] torch.profiler unavailable ({exc}); not measured")
        return
    busy = {}
    for e in kernels:
        busy[e.name] = busy.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy_ms = sum(busy.values())
    if not kernels:
        log(f"[profile] one bf16 BPD iteration ({label}): wall {wall_ms:.2f} ms; the "
            f"profiler saw no kernels, device time not measured")
        return
    attn_ms = sum(ms for name, ms in busy.items() if "attention_kernel" in name)
    # fused_heads: its product-and-fold kernel (heads_tc_kernel, both
    # dtypes), fp32's split of o into TF32 parts and the merge of the
    # blocks' partials
    heads_ms = sum(ms for name, ms in busy.items()
                   if any(k in name for k in ("heads_tc_kernel",
                                              "split_o_kernel",
                                              "merge_topk_kernel")))
    log(f"[profile] one bf16 BPD iteration ({label}): wall {wall_ms:.2f} ms, "
        f"{len(kernels)} kernels busy {busy_ms:.2f} ms, of which attention "
        f"kernels {attn_ms:.3f} ms, fused_heads {heads_ms:.3f} ms; device "
        f"idle share {1 - busy_ms / wall_ms:.3f}; hand-written kernels "
        f"launched {launched}"
        f"{f'; Mamba scan steps (addcmul launches) {scan}' if scan else ''}")
    for name, ms in sorted(busy.items(), key=lambda kv: -kv[1])[:8]:
        log(f"    {ms:8.3f} ms  {name[:90]}")


# ---------------------------------------------------------------------------
# phases 8-9: rwkv6-1.6b, the RWKV-6 family, at full width
# ---------------------------------------------------------------------------


def phase_rwkv(torch, results):
    import numpy as np

    from repro_torch.config import DecodeConfig, get_config
    from repro_torch.core import decode as D
    from repro_torch.data.synthetic import MarkovLM
    from repro_torch.kernels import _build
    from repro_torch.launch import serve
    from repro_torch.models import model as M

    cfg = get_config("rwkv6-1.6b").replace(dtype="float32")
    t0 = time.perf_counter()
    params = M.init(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    log(f"[rwkv] rwkv6-1.6b fp32: {n_params / 1e9:.3f} B parameters, init "
        f"{time.perf_counter() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.1f} GiB allocated")
    task = MarkovLM(vocab=256, temperature=0.2, seed=0)
    prompt_len, max_new, block_k = 512, 64, cfg.bpd_k
    prompts = torch.as_tensor(task.sample(np.random.default_rng(1), 8,
                                          prompt_len), device="cuda")
    batch = {"tokens": prompts}
    dec = DecodeConfig(max_new_tokens=max_new, block_k=block_k)
    layers = cfg.num_layers

    # ---- phase 8: fp32 greedy and BPD exact ---------------------------------
    runs = {}
    for label, run in (("greedy", D.greedy_decode), ("bpd exact", D.bpd_decode)):
        _build.reset_launches()
        t0 = time.perf_counter()
        toks, stats = run(params, cfg, dec, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launch = dict(_build.LAUNCHES)
        iters = stats["iterations"]
        want = {name: 0 for name in launch}
        want["rwkv6_scan"] = layers                       # one prefill
        if run is D.bpd_decode:
            want.update(fused_verify=iters, fused_heads=iters + 1)
        log(f"[rwkv] {label}: k̂={stats['mean_accepted']:.4f} iterations="
            f"{iters} invocations={stats['invocations']}, {wall:.2f}s, "
            f"launches {launch}")
        check(launch == want, f"rwkv {label}: launches {launch}, expected {want}")
        check(_build.CHECKPOINTED_SCANS == 0,
              f"rwkv {label}: {_build.CHECKPOINTED_SCANS} scans wrote checkpoints")
        check(bool((stats["generated"] == max_new).all()), f"rwkv {label}: short rows")
        runs[label] = (toks, stats)
    g_toks = runs["greedy"][0]
    b_toks, b_stats = runs["bpd exact"]
    after = causal_logits_after(torch, M, params, cfg)
    diverged = compare_rows(torch, after, b_toks, g_toks,
                            b_stats["text_len"], prompt_len)
    log(f"[rwkv] fp32 BPD tokens == greedy tokens in {8 - len(diverged)}/8 "
        f"rows (others at near-ties)")

    # ---- phase 8b: multi-token accepts roll the recurrent state back --------
    rollback_check(torch, M, D, params, cfg, dec, batch, g_toks, prompt_len,
                   "rwkv")

    # ---- phase 9: bf16 serve ------------------------------------------------
    _build.reset_launches()
    out = serve.main(["--arch", "rwkv6-1.6b", "--full-config", "--batch", "8",
                      "--prompt-len", str(prompt_len), "--max-new",
                      str(max_new), "--block-k", str(block_k), "--seed", "0"],
                     params=params)
    launches = dict(_build.LAUNCHES)
    scfg, sdec, sbatch = out["cfg"], out["dec"], out["batch"]
    check(torch.equal(sbatch["tokens"], prompts), "rwkv serve prompts differ")
    log(f"[rwkv serve] weights cast for bf16: "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.1f} GiB allocated; "
        f"{sum(p.numel() for p in params.parameters() if p.dtype == torch.float32)} "
        f"parameters kept fp32")
    s_toks, s_stats = out["tokens"], out["stats"]
    iters = s_stats["iterations"]
    want = {name: 0 for name in launches}           # warm-up + timed run
    want.update(rwkv6_scan=2 * layers, fused_verify=2 * iters,
                fused_heads=2 * (iters + 1))
    check(launches == want, f"rwkv serve: launches {launches}, expected {want}")
    check(_build.CHECKPOINTED_SCANS == 0,
          f"rwkv serve: {_build.CHECKPOINTED_SCANS} scans wrote checkpoints")
    results["rwkv6_scan"]["launches"] = launches["rwkv6_scan"]
    gb_toks, _ = D.greedy_decode(params, scfg, sdec, sbatch)
    n = prompt_len + max_new
    same = (s_toks[:, prompt_len:n] == gb_toks[:, prompt_len:n])
    generated = int(s_stats["generated"].sum())
    log(f"[rwkv serve] bf16: {generated / out['wall_s']:.1f} tokens/s, "
        f"k̂={s_stats['mean_accepted']:.4f}, iterations={iters}, invocations="
        f"{s_stats['invocations']}, wall {out['wall_s'] * 1e3:.1f} ms; BPD vs "
        f"greedy agreement {float(same.float().mean()):.4f} of tokens, "
        f"{int(same.all(dim=1).sum())}/8 rows identical (reported, not "
        f"required in bf16)")
    after = causal_logits_after(torch, M, params, scfg)
    div = report_divergences(torch, after, s_toks, gb_toks, prompt_len, n)
    log(f"[rwkv serve] bf16 first divergences: {len(div)} rows, "
        f"{sum(d['tie'] for d in div)} at near-ties; BPD's token ranks "
        f"{[d['bpd_rank'] for d in div]}, ulps below the top "
        f"{[round(d['bpd_ulps'], 3) for d in div]}")
    profile_iteration(torch, D, params, scfg, sdec, sbatch, "rwkv6 exact")


# ---------------------------------------------------------------------------
# phases 10-10c: the paper's encoder-decoder MT model
# ---------------------------------------------------------------------------


def mt_logits_after(torch, S, params, cfg, src):
    """``logits_after(row, prefix)`` of an encoder-decoder: p_1's logits
    (V,) in fp32 after BOS + the output ``prefix``, by encoding source row
    ``row`` of ``src`` and one full decoder forward."""
    def after(r, prefix):
        enc = S.encode(params, cfg, src[r:r + 1])
        bos = torch.zeros((1,), dtype=torch.int32, device=src.device)
        tgt = torch.cat([bos, prefix.to(torch.int32)])[None]
        hidden, _ = S.forward_hidden(params, cfg, tgt, enc)
        return S.base_logits(params, cfg, hidden[:, -1])[0, :cfg.vocab_size].float()
    return after


def mt_launches(iters, layers, policy, greedy=False):
    """The kernels one seq2seq decode of ``iters`` iterations launches: self
    and cross attention once per layer and forward (a tree's self attention
    on tree_verify_attention), fused_verify once per iteration, fused_heads
    once per iteration and prefill when the heads draft."""
    want = dict(verify_attention=2 * layers * iters, fused_verify=iters,
                fused_heads=0 if greedy or policy == "input_copy" else iters + 1)
    if policy == "topk_tree":
        want.update(verify_attention=layers * iters,
                    tree_verify_attention=layers * iters)
    return want


def phase_mt(torch, results):
    import numpy as np

    from repro_torch.config import DecodeConfig, get_config
    from repro_torch.core import decode as D
    from repro_torch.data.synthetic import MarkovLM
    from repro_torch.kernels import _build
    from repro_torch.models import model as M
    from repro_torch.models import seq2seq as S

    cfg = get_config("paper-mt-base").replace(dtype="float32")
    t0 = time.perf_counter()
    params = M.init(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    log(f"[mt] paper-mt-base fp32: {n_params / 1e6:.1f} M parameters, init "
        f"{time.perf_counter() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")
    task = MarkovLM(vocab=255, temperature=0.2, seed=0)
    src_len, max_new, block_k = 64, 64, cfg.bpd_k
    # token 0 is BOS, kept out of the sources
    src = torch.as_tensor(task.sample(np.random.default_rng(1), 8, src_len) + 1,
                          dtype=torch.int32, device="cuda")
    batch = {"src": src}
    dec = DecodeConfig(max_new_tokens=max_new, block_k=block_k, top_k=2)
    layers = cfg.num_layers
    after = mt_logits_after(torch, S, params, cfg, src)

    # ---- phase 10: fp32 greedy, then BPD under four policies ---------------
    runs = {}
    for label in ("greedy", "exact", "adaptive", "input_copy", "topk_tree"):
        greedy = label == "greedy"
        _build.reset_launches()
        t0 = time.perf_counter()
        if greedy:
            toks, stats = D.greedy_decode_seq2seq(params, cfg, dec, batch)
        else:
            toks, stats = D.bpd_decode_seq2seq(params, cfg,
                                               dec.replace(policy=label), batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launch = dict(_build.LAUNCHES)
        iters = stats["iterations"]
        want = {name: 0 for name in launch}
        want.update(mt_launches(iters, layers, label, greedy))
        log(f"[mt] {label}: k̂={stats['mean_accepted']:.4f} iterations={iters} "
            f"invocations={stats['invocations']}, {wall:.2f}s, launches {launch}")
        check(launch == want, f"mt {label}: launches {launch}, expected {want}")
        check(bool((stats["generated"] == max_new).all()), f"mt {label}: short rows")
        runs[label] = (toks, stats)
    ONE_DEVICE[(cfg.name, "src")] = src.cpu()      # phase 23's sources
    g_toks = runs["greedy"][0]
    check(runs["greedy"][1]["iterations"] == max_new, "mt greedy: not one "
                                                      "token an iteration")
    for label in ("exact", "adaptive", "input_copy", "topk_tree"):
        toks, stats = runs[label]
        diverged = compare_rows(torch, after, toks, g_toks, stats["generated"], 0)
        log(f"[mt] fp32 {label}: tokens == greedy tokens in "
            f"{8 - len(diverged)}/8 rows (others at near-ties)")

    # hand-made accepts: greedy's continuation (k̂ 8), slot 3 corrupted (3),
    # then a second iteration on the committed cache
    cont = g_toks[:, :block_k].contiguous()
    for corrupt in (None, 3):
        state, be = D.bpd_prefill_seq2seq(params, cfg, dec, batch)
        check(torch.equal(state.proposals[:, 0], cont[:, 0]),
              "mt prefill's verified slot 0 != greedy's first token")
        props = cont.clone()
        if corrupt is not None:
            props[:, corrupt] = (props[:, corrupt] + 1) % cfg.vocab_size
        state = state._replace(proposals=props)
        with torch.no_grad():
            state = D.bpd_iteration(params, cfg, dec, be, state,
                                    prefix_offset=0, max_new=max_new)
        khat = (state.text_len - 1).tolist()
        want = block_k if corrupt is None else corrupt
        log(f"[mt accepts] proposals = greedy continuation"
            f"{'' if corrupt is None else f' with slot {corrupt} corrupted'}: "
            f"k̂ per row {khat}")
        for r, kh in enumerate(khat):
            if kh != want:
                gap = top2_gap(torch, after(r, g_toks[r, :kh]))
                check(kh < want and gap < TIE_MARGIN,
                      f"mt row {r}: k̂={kh}, expected {want} (gap {gap})")
        with torch.no_grad():
            state = D.bpd_iteration(params, cfg, dec, be, state,
                                    prefix_offset=0, max_new=max_new)
        diverged = compare_rows(torch, after, state.tokens[:, 1:], g_toks,
                                state.text_len - 1, 0)
        log(f"[mt accepts] second iteration: k̂ per row "
            f"{(state.text_len - 1 - torch.tensor(khat, device='cuda')).tolist()}; "
            f"tokens == greedy tokens in {8 - len(diverged)}/8 rows")
    del state, be

    # ---- phase 10b: the weights cast for bf16, exact and input_copy ---------
    bcfg = cfg.replace(dtype="bfloat16")
    M.cast_for_compute(params, bcfg)
    torch.cuda.empty_cache()
    after = mt_logits_after(torch, S, params, bcfg, src)
    gb_toks, _ = D.greedy_decode_seq2seq(params, bcfg, dec, batch)
    for policy in ("exact", "input_copy"):
        pdec = dec.replace(policy=policy)
        D.bpd_decode_seq2seq(params, bcfg, pdec, batch)          # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks, stats = D.bpd_decode_seq2seq(params, bcfg, pdec, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        same = toks[:, :max_new] == gb_toks[:, :max_new]
        generated = int(stats["generated"].sum())
        log(f"[mt bf16] {policy}: {generated / wall:.1f} tokens/s, "
            f"k̂={stats['mean_accepted']:.4f}, iterations={stats['iterations']}, "
            f"wall {wall * 1e3:.1f} ms; BPD vs greedy agreement "
            f"{float(same.float().mean()):.4f} of tokens, "
            f"{int(same.all(dim=1).sum())}/8 rows identical (reported, not "
            f"required in bf16)")
        div = report_divergences(torch, after, toks, gb_toks, 0, max_new)
        log(f"[mt bf16] {policy} first divergences: {len(div)} rows, "
            f"{sum(d['tie'] for d in div)} at near-ties; BPD's token ranks "
            f"{[d['bpd_rank'] for d in div]}, ulps below the top "
            f"{[round(d['bpd_ulps'], 3) for d in div]}")
        profile_iteration(torch, D, params, bcfg, pdec, batch,
                          f"paper-mt-base {policy}", seq2seq=True)


def fixture_config(path: Path):
    """A fixture's ``config.json`` as the port's ``ModelConfig``."""
    from repro_torch.config import ModelConfig

    with open(path / "config.json") as f:
        fields = json.load(f)
    fields["global_attn_layers"] = tuple(fields["global_attn_layers"])
    return ModelConfig(**fields)


def match_reference(torch, after, rows, want_rows, label) -> int:
    """Each row of ``rows`` (lists of tokens) equals ``want_rows``' except
    a row that first leaves it where p_1's top-2 gap after the reference's
    prefix is below TIE_MARGIN (``after(row, prefix)``), which is reported.
    Returns the number of equal rows."""
    equal = 0
    for r, (got, want) in enumerate(zip(rows, want_rows)):
        if got == want:
            equal += 1
            continue
        p = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
        prefix = torch.tensor(want[:p], dtype=torch.int32, device="cuda")
        gap = top2_gap(torch, after(r, prefix))
        log(f"    {label} row {r}: leaves the reference's tokens at {p}, "
            f"p_1's top-2 gap there {gap:.3g} of max|logit|")
        check(gap < TIE_MARGIN, f"{label} row {r} differs from the reference "
                                f"with no near-tie ({gap})")
    return equal


def match_rows(torch, after, rows, want_rows, label) -> int:
    """``match_reference`` on the rows' tokens; a row whose tokens equal
    the reference's must equal it in its counts too (equal tokens leave no
    room for a tie to excuse other counts).  Returns the equal rows."""
    equal = match_reference(torch, after, [r["tokens"] for r in rows],
                            [w["tokens"] for w in want_rows], label)
    for r, (row, want) in enumerate(zip(rows, want_rows)):
        if row["tokens"] == want["tokens"]:
            check(row == want, f"{label} row {r}: the reference's tokens in "
                               f"{row['iterations']} iterations, "
                               f"{row['generated']} generated; reference "
                               f"{want['iterations']}, {want['generated']}")
    return equal


FIXTURE = ROOT / "tests" / "data" / "policy_sweep"
FIXTURE_POLICIES = ("exact", "topk", "distance", "adaptive", "input_copy",
                    "topk_tree")


def phase_fixture(torch):
    """Phase 10c: the trained policy-sweep model on the card, fp32, each
    source row decoded alone at B 1 as the reference did; tokens,
    iterations and generated counts equal to ``reference.json``'s.  A row
    may leave them only where its tokens first differ at a near-tie of
    p_1, which is reported; with equal tokens the counts must be equal."""
    import numpy as np

    from repro_torch import bridge
    from repro_torch.config import DecodeConfig
    from repro_torch.core import decode as D
    from repro_torch.models import seq2seq as S

    cfg = fixture_config(FIXTURE)
    with open(FIXTURE / "reference.json") as f:
        ref = json.load(f)
    params = bridge.load_checkpoint(str(FIXTURE / "checkpoint"), cfg,
                                    device="cuda")
    src = torch.as_tensor(np.load(FIXTURE / "src.npy"), device="cuda")
    n_rows, se = src.shape
    log(f"[fixture] {cfg.name}: {sum(p.numel() for p in params.parameters())} "
        f"parameters (head_dim {cfg.resolved_head_dim}), {n_rows} rows of {se}")
    after = mt_logits_after(torch, S, params, cfg, src)
    decoded = {}
    t0 = time.perf_counter()
    for policy in FIXTURE_POLICIES:
        dec = DecodeConfig(max_new_tokens=se, block_k=8, policy=policy,
                           top_k=2, epsilon=2.0)
        rows = []
        for r in range(n_rows):
            toks, stats = D.bpd_decode_seq2seq(params, cfg, dec,
                                               {"src": src[r:r + 1]})
            rows.append({"tokens": toks[0, :se].tolist(),
                         "iterations": stats["iterations"],
                         "generated": int(stats["generated"][0])})
        decoded[policy] = rows
        equal = match_rows(torch, after, rows, ref[policy]["rows"],
                           f"fixture {policy}")
        khat = float(np.mean([r["generated"] / max(r["iterations"], 1)
                              for r in rows]))
        log(f"[fixture] {policy}: k̂ {khat:.4f} (reference.json "
            f"{ref[policy]['mean_khat']:.4f}); {equal}/{n_rows} rows equal to "
            f"the reference's (others at reported near-ties)")
    for policy in ("adaptive", "input_copy", "topk_tree"):
        match_reference(torch, after,
                        [r["tokens"] for r in decoded[policy]],
                        [r["tokens"] for r in decoded["exact"]],
                        f"fixture {policy} vs exact")
    log(f"[fixture] lossless policies emit exact's tokens; "
        f"{time.perf_counter() - t0:.1f}s")
    return [r["tokens"] for r in decoded["exact"]]


# ---------------------------------------------------------------------------
# phases 12-14: trained weights (quickstart, locality) and kv_chunk
# ---------------------------------------------------------------------------


QUICKSTART = ROOT / "tests" / "data" / "quickstart"
LOCALITY = ROOT / "tests" / "data" / "locality"
LOCALITY_ROWS = {"locality": ("locality", "locality"),   # row -> (arm, policy)
                 "locality_exact": ("locality", "exact"),
                 "locality_raster": ("raster", "exact")}
QUICKSTART_STEPS = 300
KV_CHUNK, KV_PROMPT, KV_NEW = 512, 2048, 16
KV_SHORT_CHUNK = 24  # phase 4's 64-token prompts in chunks of 24, 24 and 16
KV_TOL = 1e-4        # of max|hidden|: fp32 softmax sums in another order, 40 layers


def phase_quickstart(torch, card):
    """Phase 12: examples/quickstart.py's model (head_dim 24) on the card.
    12a: the pinned fixture (tests/data/quickstart), fp32, its 8 prompts as
    one batch, greedy and BPD exact: tokens equal to reference.json under
    the near-tie rule, and with equal tokens equal iterations, generated
    counts and k̂.  12b: the port trains quickstart's recipe on the card
    (fp32, 300 steps) and decodes the same prompts: BPD emits greedy's
    tokens, k̂ > 1.5, fewer invocations than greedy's."""
    import numpy as np

    from repro_torch import bridge
    from repro_torch.config import DecodeConfig, TrainConfig
    from repro_torch.core import decode as D
    from repro_torch.data.synthetic import MarkovLM
    from repro_torch.kernels import _build
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.optim import optimizer_init

    t0 = time.perf_counter()
    cfg = fixture_config(QUICKSTART)
    with open(QUICKSTART / "reference.json") as f:
        ref = json.load(f)
    params = bridge.load_checkpoint(str(QUICKSTART / "checkpoint"), cfg,
                                    device="cuda")
    prompts = torch.as_tensor(np.load(QUICKSTART / "prompts.npy"),
                              device="cuda")
    plen = prompts.shape[1]
    max_new = len(ref["bpd"]["tokens"][0]) - plen
    dec = DecodeConfig(max_new_tokens=max_new, block_k=cfg.bpd_k,
                       criterion="exact")
    batch = {"tokens": prompts}
    log(f"[quickstart] {cfg.name}: {sum(p.numel() for p in params.parameters())}"
        f" parameters, head_dim {cfg.resolved_head_dim}, {prompts.shape[0]} "
        f"prompts of {plen}, {max_new} new tokens")
    after = causal_logits_after(torch, M, params, cfg)
    for label, run in (("bpd", D.bpd_decode), ("greedy", D.greedy_decode)):
        _build.reset_launches()
        toks, stats = run(params, cfg, dec, batch)
        torch.cuda.synchronize()
        launch = dict(_build.LAUNCHES)
        want = ref[label]
        rows = toks[:, :plen + max_new].tolist()
        equal = match_reference(torch, after, rows, want["tokens"],
                                f"quickstart {label}")
        if equal == len(rows):
            check(stats["iterations"] == want["iterations"]
                  and stats["generated"].tolist() == want["generated"]
                  and abs(stats["mean_accepted"] - want["mean_accepted"]) < 1e-6,
                  f"quickstart {label}: reference.json's tokens in "
                  f"{stats['iterations']} iterations, reference "
                  f"{want['iterations']}")
        check(launch["verify_attention"] == cfg.num_layers * stats["iterations"],
              f"quickstart {label}: verify_attention launches {launch}")
        log(f"[quickstart] 12a fixture {label}: k̂ {stats['mean_accepted']:.4f} "
            f"in {stats['iterations']} iterations (reference.json "
            f"{want['mean_accepted']:.4f} in {want['iterations']}); "
            f"{equal}/{len(rows)} rows equal to the reference's (others at "
            f"reported near-ties); launches {launch}")

    # 12b: quickstart's recipe trained by the port on the card
    tc = TrainConfig(global_batch=16, seq_len=48, lr=3e-3, warmup_steps=30,
                     head_loss="mean")
    task = MarkovLM(vocab=cfg.vocab_size, temperature=0.12, seed=3)
    params = M.init(cfg, seed=0, device="cuda")
    opt = optimizer_init(params, tc)
    step = steps.make_train_step(cfg, tc)
    data = task.batches(batch=tc.global_batch, seq_len=tc.seq_len, seed=1)
    gen = torch.Generator().manual_seed(1)
    t1 = time.perf_counter()
    losses = []
    for _ in range(QUICKSTART_STEPS):
        b = {k: torch.as_tensor(v, device="cuda") for k, v in next(data).items()}
        params, opt, metrics = step(params, opt, b, gen)
        losses.append(metrics["loss"])
    losses = [float(x) for x in losses]
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t1
    bt, bs = D.bpd_decode(params, cfg, dec, batch)
    gt, gs = D.greedy_decode(params, cfg, dec, batch)
    torch.cuda.synchronize()
    after = causal_logits_after(torch, M, params, cfg)
    diverged = compare_rows(torch, after, bt, gt, bs["text_len"], plen)
    log(f"[quickstart] 12b trained on the card: {QUICKSTART_STEPS} steps in "
        f"{train_s:.1f}s ({train_s / QUICKSTART_STEPS * 1e3:.1f} ms a step), "
        f"loss {np.mean(losses[:10]):.4f} -> {np.mean(losses[-10:]):.4f} "
        f"(first / last 10); BPD k̂ {bs['mean_accepted']:.4f}, invocations "
        f"{bs['invocations']} vs greedy {gs['invocations']}; BPD == greedy in "
        f"{8 - len(diverged)}/8 rows (others at near-ties); {card}")
    check(bs["mean_accepted"] > 1.5,
          f"quickstart trained on the card: k̂ {bs['mean_accepted']} <= 1.5")
    check(bs["invocations"] < gs["invocations"],
          "quickstart trained on the card: BPD needs no fewer invocations")
    log(f"[quickstart] phase 12 {time.perf_counter() - t0:.1f}s")


def decode_field_rows(torch, D, params, cfg, dec, stream, start):
    """Each row decoded alone from its coarse prompt (B 1), as the
    reference's ``policy_sweep._decode_field``: [{tokens, iterations,
    generated}] and the decoded streams."""
    n = stream.shape[1]
    rows = []
    for r in range(stream.shape[0]):
        prompt = torch.as_tensor(stream[r:r + 1, :start], device="cuda")
        toks, stats = D.bpd_decode(params, cfg, dec, {"tokens": prompt})
        rows.append({"tokens": toks[0, :n].tolist(),
                     "iterations": stats["iterations"],
                     "generated": int(stats["generated"].sum())})
    return rows


def field_summary(field, rows, grids):
    """iterations per token, k̂ and MAE of decoded rows, as
    ``_decode_field`` computes them."""
    import numpy as np

    iters = sum(r["iterations"] for r in rows)
    gen = sum(r["generated"] for r in rows)
    toks = np.asarray([r["tokens"] for r in rows])
    mae = float(np.abs(field.to_grid(toks).astype(int)
                       - grids.astype(int)).mean())
    return {"iters_per_token": iters / max(gen, 1),
            "mean_khat": gen / max(iters, 1), "mae": mae}


def phase_locality(torch, card):
    """Phase 13: the locality image policy on the pinned fixture
    (tests/data/locality: 8 x 8 fields, stride 2, 16 levels; the lattice
    and raster arms).  13a, fp32: each of the 8 evaluation rows decoded
    alone under locality, locality_exact and locality_raster; tokens,
    iterations and generated counts equal to reference.json under the
    near-tie rule, and with all rows equal the MAE, iterations per token
    and k̂ too; locality emits locality_exact's tokens and takes fewer
    iterations than locality_raster.  13b: the lattice model cast for
    bf16, locality and exact: k̂ and iterations recorded, not gated.  13c:
    the fp32 lattice model served by the engine with a locality and an
    exact group of 2 slots, the 8 prompts under each: every request equal
    to its static decode of 13a."""
    import numpy as np

    from repro_torch import bridge, serving
    from repro_torch.config import DecodeConfig
    from repro_torch.core import decode as D
    from repro_torch.data.synthetic import OrdinalField
    from repro_torch.models import model as M

    t0 = time.perf_counter()
    with open(LOCALITY / "reference.json") as f:
        ref = json.load(f)
    grids = np.load(LOCALITY / "grids.npy")
    arms = {}
    for arm in ("locality", "raster"):
        cfg = fixture_config(LOCALITY / arm)
        params = bridge.load_checkpoint(str(LOCALITY / arm / "checkpoint"),
                                        cfg, device="cuda")
        field = OrdinalField(levels=cfg.vocab_size, height=grids.shape[1],
                             width=grids.shape[2], n_waves=2, stride=2,
                             order=arm, bilinear=True)
        check(np.array_equal(field.sample_grid(np.random.default_rng(42),
                                               grids.shape[0]), grids),
              f"locality: the port's OrdinalField ({arm}) does not draw "
              f"grids.npy")
        arms[arm] = (cfg, params, field)
    field = arms["locality"][2]
    h, w = grids.shape[1:]
    start, n = field.coarse_len, h * w
    dec = DecodeConfig(max_new_tokens=n - start, block_k=arms["locality"][0].bpd_k,
                       image_height=h, image_width=w, locality_stride=2)
    log(f"[locality] {grids.shape[0]} fields of {h} x {w}, coarse prompts of "
        f"{start}, {n - start} new tokens, head_dim "
        f"{arms['locality'][0].resolved_head_dim}")
    decoded = {}
    for name, (arm, policy) in LOCALITY_ROWS.items():
        cfg, params, fld = arms[arm]
        stream = fld.serialize(grids)
        rows = decode_field_rows(torch, D, params, cfg,
                                 dec.replace(policy=policy), stream, start)
        decoded[name] = rows
        want = ref[name]
        after = causal_logits_after(torch, M, params, cfg)
        equal = match_rows(torch, after, rows, want["rows"], name)
        summary = field_summary(fld, rows, grids)
        if equal == len(rows):
            check(all(abs(summary[k] - want[k]) < 1e-9 for k in summary),
                  f"{name}: {summary} against reference.json's")
        log(f"[locality] 13a {name}: iterations/token "
            f"{summary['iters_per_token']:.4f}, k̂ {summary['mean_khat']:.4f}, "
            f"MAE {summary['mae']:.4f} (reference.json "
            f"{want['iters_per_token']:.4f}, {want['mean_khat']:.4f}, "
            f"{want['mae']:.4f}); {equal}/{len(rows)} rows equal")
    cfg, params, _ = arms["locality"]
    after = causal_logits_after(torch, M, params, cfg)
    match_reference(torch, after, [r["tokens"] for r in decoded["locality"]],
                    [r["tokens"] for r in decoded["locality_exact"]],
                    "locality vs locality_exact")
    its = {k: sum(r["iterations"] for r in v) for k, v in decoded.items()}
    check(its["locality"] < its["locality_raster"],
          f"locality took {its['locality']} iterations, raster "
          f"{its['locality_raster']}")
    log(f"[locality] 13a: locality emits locality_exact's tokens; iterations "
        f"locality {its['locality']} < raster {its['locality_raster']} "
        f"(exact on the lattice model {its['locality_exact']})")

    # 13b: bf16, recorded
    stream = field.serialize(grids)
    bcfg = cfg.replace(dtype="bfloat16")
    bparams = M.cast_for_compute(
        bridge.load_checkpoint(str(LOCALITY / "locality" / "checkpoint"), cfg,
                               device="cuda"), bcfg)
    for policy in ("locality", "exact"):
        rows = decode_field_rows(torch, D, bparams, bcfg,
                                 dec.replace(policy=policy), stream, start)
        s = field_summary(field, rows, grids)
        agree = sum(r["tokens"] == f["tokens"] for r, f in
                    zip(rows, decoded["locality" if policy == "locality"
                                      else "locality_exact"]))
        log(f"[locality] 13b bf16 {policy}: k̂ {s['mean_khat']:.4f}, "
            f"iterations {sum(r['iterations'] for r in rows)}, MAE "
            f"{s['mae']:.4f}; {agree}/{len(rows)} rows equal to fp32's "
            f"(recorded, not gated)")

    # 13c: the engine with a locality and an exact group
    engine = serving.ContinuousBatchingEngine(
        params, cfg, dec, serving.EngineConfig(num_slots=4, max_prompt_len=start,
                                               max_new_cap=n - start),
        policies={"locality": 2, "exact": 2})
    sched = serving.Scheduler(engine)
    plan = {}
    for r in range(grids.shape[0]):
        for j, policy in enumerate(("locality", "exact")):
            rid = 2 * r + j
            plan[rid] = (r, "locality" if j == 0 else "locality_exact")
            sched.submit(serving.Request(rid=rid, prompt=stream[r, :start],
                                         max_new=n - start, policy=policy))
    done = sched.run()
    ONE_DEVICE[("locality", "rows")] = [r["tokens"] for r in
                                        decoded["locality"]]
    check(sorted(f.rid for f in done) == sorted(plan), "engine lost requests")
    got, want = [], []
    for f in sorted(done, key=lambda f: f.rid):
        r, name = plan[f.rid]
        got.append(stream[r, :start].tolist() + f.tokens.tolist())
        want.append(decoded[name][r]["tokens"])
    equal = match_reference(torch, after, got, want, "engine")
    log(f"[locality] 13c engine (locality 2 + exact 2 slots, 16 requests): "
        f"{equal}/16 requests equal to their static decodes (others at "
        f"reported near-ties); builds {engine.compile_counts()}")
    check(all(v == 1 for v in engine.compile_counts().values()),
          f"engine built a serving function twice: {engine.compile_counts()}")
    log(f"[locality] phase 13 {time.perf_counter() - t0:.1f}s; {card}")


def phase_kv_chunk(torch, params, cfg, dec, batch, g_toks, prompt_len):
    """Phase 14: kv_chunk on granite-3-8b at full width, fp32 (phase 4b's
    cut weights).  A 2048-token MarkovLM prompt prefilled with
    kv_chunk 512 and without: final hidden states within KV_TOL of
    max|hidden|, each prefill's peak memory above the weights printed,
    and greedy's 16 new tokens equal (near-tie rule); then BPD exact
    through DecodeSession(kv_chunk=512) on that prompt emits the unchunked
    greedy's tokens, and through DecodeSession(kv_chunk=24) on phase 4's
    batch (64-token prompts, three chunks) that model's greedy tokens (both
    under the near-tie rule)."""
    import numpy as np

    from repro_torch import serving
    from repro_torch.core import decode as D
    from repro_torch.data.synthetic import MarkovLM
    from repro_torch.models import model as M

    t0 = time.perf_counter()
    task = MarkovLM(vocab=256, temperature=0.2, seed=0)
    long = torch.as_tensor(task.sample(np.random.default_rng(14), 1, KV_PROMPT),
                           device="cuda")
    h = M.embed_inputs(params, cfg, {"tokens": long})
    pos = torch.arange(KV_PROMPT, dtype=torch.int32, device="cuda")
    hidden, peak = {}, {}
    for chunk in (0, KV_CHUNK):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            hidden[chunk], _ = M.forward_hidden(params, cfg, h, positions=pos,
                                                kv_chunk=chunk)
        torch.cuda.synchronize()
        peak[chunk] = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    scale = float(hidden[0].abs().max())
    err = float((hidden[KV_CHUNK] - hidden[0]).abs().max())
    log(f"[kv_chunk] prefill of {KV_PROMPT} tokens: max|h| {scale:.4g}, "
        f"kv_chunk {KV_CHUNK} vs none max abs diff {err:.3g} "
        f"({err / scale:.3g} of max|h|, tolerance {KV_TOL}); peak above the "
        f"weights: none {peak[0]:.1f} MiB, kv_chunk {KV_CHUNK} "
        f"{peak[KV_CHUNK]:.1f} MiB")
    check(err <= KV_TOL * scale, f"kv_chunk prefill differs by {err}")
    del hidden, h
    gdec = dec.replace(max_new_tokens=KV_NEW)
    toks = {chunk: D.greedy_decode(params, cfg, gdec, {"tokens": long},
                                   kv_chunk=chunk)[0]
            for chunk in (0, KV_CHUNK)}
    after = causal_logits_after(torch, M, params, cfg)
    match_reference(torch, after, toks[KV_CHUNK][:, :KV_PROMPT + KV_NEW].tolist(),
                    toks[0][:, :KV_PROMPT + KV_NEW].tolist(), "kv_chunk greedy")
    log(f"[kv_chunk] greedy {KV_NEW} new tokens after the {KV_PROMPT}-token "
        f"prompt: kv_chunk {KV_CHUNK} == none")
    sess = serving.DecodeSession(params, cfg, gdec, kv_chunk=KV_CHUNK)
    l_toks, l_stats = sess.decode({"tokens": long})
    torch.cuda.synchronize()
    diverged = compare_rows(torch, after, l_toks, toks[0],
                            l_stats["text_len"], KV_PROMPT)
    log(f"[kv_chunk] DecodeSession(kv_chunk={KV_CHUNK}).decode of the "
        f"{KV_PROMPT}-token prompt: k̂ {l_stats['mean_accepted']:.4f} in "
        f"{l_stats['iterations']} iterations; tokens == unchunked greedy's: "
        f"{not diverged} (else at a near-tie)")
    sess = serving.DecodeSession(params, cfg, dec, kv_chunk=KV_SHORT_CHUNK)
    b_toks, b_stats = sess.decode(batch)
    torch.cuda.synchronize()
    diverged = compare_rows(torch, after, b_toks, g_toks, b_stats["text_len"],
                            prompt_len)
    log(f"[kv_chunk] DecodeSession(kv_chunk={KV_SHORT_CHUNK}).decode of "
        f"phase 4's batch: k̂ {b_stats['mean_accepted']:.4f} in "
        f"{b_stats['iterations']} iterations; tokens == greedy's in "
        f"{8 - len(diverged)}/8 rows (others at near-ties); "
        f"{time.perf_counter() - t0:.1f}s")


# ---------------------------------------------------------------------------
# phase 15: the draft_model policy (a second model drafts the block)
# ---------------------------------------------------------------------------


DRAFT_SEED = 7
DRAFT_FIXTURE = ROOT / "tests" / "data" / "draft_model"
DRAFT_FIXTURE_ROWS = {"draft_model": "gold", "ss_draft_model": "ss"}


def small_draft(torch, cfg, dtype="float32"):
    """15b's draft: granite-3-8b's smoke geometry (2 layers, d 256, 8 / 2
    heads of 32) at the full vocabulary, no heads, random from seed 7."""
    from repro_torch.config import get_config
    from repro_torch.core import ModelBundle
    from repro_torch.models import model as M

    dcfg = get_config("granite-3-8b", smoke=True).replace(
        dtype=dtype, bpd_enabled=False, vocab_size=cfg.vocab_size)
    return ModelBundle(M.init(dcfg, seed=DRAFT_SEED, device="cuda"), dcfg)


def draft_launches(cfg, dcfg, iters, steps, *, paged=False):
    """The kernels a draft_model decode of ``iters`` iterations launches:
    the verifier's attention once per layer and iteration, the draft's
    ``verify_attention`` once per draft layer and sequential draft forward
    (``steps`` a drafting, every iteration and the first draft after the
    prefill), fused_verify once per iteration, fused_heads never (no head
    drafts)."""
    want = dict(verify_attention=dcfg.num_layers * steps * (iters + 1),
                fused_verify=iters)
    primary = "paged_verify_attention" if paged else "verify_attention"
    want[primary] = want.get(primary, 0) + cfg.num_layers * iters
    return want


def check_launches(launches, want, label):
    full = {name: 0 for name in launches}
    full.update(want)
    check(launches == full, f"{label}: launches {launches}, expected {full}")


def phase_draft_self(torch, M, D, params, cfg, dec, batch, g_toks, prompt_len):
    """15a: granite-3-8b drafting for itself at full width, fp32 (the
    reference's test_good_draft_model_cuts_iterations at full size): every
    block verifies whole, so 64 new tokens take 8 iterations, except where
    a near-tie of p_1 lets the kq-1/2 draft forwards and the kq-8 verify
    forward pick different tokens (reported: the split-KV body is bit for
    bit the same at any kq, the cuBLAS products need not be).  Iterations
    are stepped here to see each row's k̂."""
    from repro_torch import serving
    from repro_torch.core import ModelBundle
    from repro_torch.kernels import _build

    max_new, block_k = dec.max_new_tokens, dec.block_k
    sess = serving.DecodeSession(params, cfg, dec, policy="draft_model",
                                 bundles={"draft": ModelBundle(params, cfg)})
    steps = sess.policy.drafter.draft_steps_per_iter(block_k)
    be = D.causal_lm_backend(cfg)
    _build.reset_launches()
    t0 = time.perf_counter()
    with torch.no_grad():
        state, prefix = D.bpd_prefill_causal_lm(
            params, cfg, dec, batch, max_new=max_new, policy=sess.policy,
            aux_params=sess.aux_params)
        splits = []
        while not bool(state.finished.all()) and state.iters < max_new:
            before = state.text_len.clone()
            live = ~state.finished
            state = D.bpd_iteration(params, cfg, dec, be, state,
                                    prefix_offset=prefix, max_new=max_new,
                                    policy=sess.policy,
                                    aux_params=sess.aux_params)
            khat = state.text_len - before
            room = torch.clamp(max_new - (before - prompt_len), max=block_k)
            for r in torch.nonzero(live & (khat < room)).flatten().tolist():
                splits.append((r, int(state.text_len[r])))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    iters = state.iters
    khat = float(state.generated.sum()) / iters / state.generated.shape[0]
    log(f"[draft] 15a self-draft fp32: k̂ {khat:.4f} in {iters} iterations "
        f"(draft_steps_per_iter {steps}), {wall:.2f}s, launches {launches}")
    check(steps == block_k - 1, f"15a: {steps} draft forwards an iteration")
    check_launches(launches, draft_launches(cfg, cfg, iters, steps), "15a")
    after = causal_logits_after(torch, M, params, cfg)
    for r, pos in splits:
        gap = top2_gap(torch, after(r, g_toks[r, :pos]))
        log(f"    row {r}: block split before position {pos} (new token "
            f"{pos - prompt_len}), greedy top-2 gap {gap:.3g} of max|logit|")
        check(gap < TIE_MARGIN, f"15a row {r}: the self-draft's block split "
                                f"at {pos} with no near-tie ({gap})")
    check(iters == -(-max_new // block_k) or splits,
          f"15a: {iters} iterations with no split block")
    diverged = compare_rows(torch, after, state.tokens, g_toks,
                            state.text_len, prompt_len)
    log(f"[draft] 15a: tokens == greedy tokens in {8 - len(diverged)}/8 rows "
        f"(others at near-ties); {len(splits)} blocks split at near-ties")


def phase_draft_small(torch, M, D, params, cfg, dec, batch, g_toks,
                      prompt_len, *, label="15b", kv_chunk=0):
    """15b fp32: the small random draft (``small_draft``) at the primary's
    full width (granite's; 19a llava's behind its patches, the prefill in
    chunks of ``kv_chunk`` keys): lossless against greedy, k̂ about 1,
    launches exact.  Returns the draft bundle (15d serves with it)."""
    from repro_torch import serving
    from repro_torch.kernels import _build

    bundle = small_draft(torch, cfg)
    sess = serving.DecodeSession(params, cfg, dec, policy="draft_model",
                                 bundles={"draft": bundle}, kv_chunk=kv_chunk)
    steps = sess.policy.drafter.draft_steps_per_iter(dec.block_k)
    _build.reset_launches()
    t0 = time.perf_counter()
    toks, stats = sess.decode(batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    log(f"[draft] {label} small draft fp32 ({bundle.cfg.num_layers} layers, "
        f"d {bundle.cfg.d_model}, vocab {bundle.cfg.vocab_size}): k̂ "
        f"{stats['mean_accepted']:.4f} in {stats['iterations']} iterations, "
        f"{wall:.2f}s, launches {launches}")
    check_launches(launches, draft_launches(cfg, bundle.cfg,
                                            stats["iterations"], steps),
                   label)
    after = causal_logits_after(torch, M, params, cfg, batch)
    diverged = compare_rows(torch, after, toks, g_toks, stats["text_len"],
                            prompt_len)
    rows = toks.shape[0]
    log(f"[draft] {label}: tokens == greedy tokens in {rows - len(diverged)}/"
        f"{rows} rows (others at near-ties)")
    return bundle


def phase_draft_bf16(torch, D, params, cfg, dec, batch, static_tps):
    """15b bf16: the small draft cast for bf16 beside the cast granite,
    through DecodeSession: tokens/s beside phase 6's exact serve, k̂,
    iterations, and one iteration profiled."""
    from repro_torch import serving
    from repro_torch.kernels import _build

    bundle = small_draft(torch, cfg, dtype="bfloat16")
    sess = serving.DecodeSession(params, cfg, dec, policy="draft_model",
                                 bundles={"draft": bundle})
    sess.decode(batch)                                       # warm-up
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    toks, stats = sess.decode(batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    steps = sess.policy.drafter.draft_steps_per_iter(dec.block_k)
    check_launches(launches, draft_launches(cfg, bundle.cfg,
                                            stats["iterations"], steps),
                   "15b bf16")
    tps = int(stats["generated"].sum()) / wall
    log(f"[draft] 15b bf16: {tps:.1f} tokens/s beside {static_tps:.1f} of "
        f"phase 6's exact serve; k̂ {stats['mean_accepted']:.4f} in "
        f"{stats['iterations']} iterations, wall {wall * 1e3:.1f} ms; "
        f"launches {launches}")
    profile_iteration(torch, D, params, cfg, dec, batch,
                      "draft_model, small draft", policy=sess.policy,
                      aux_params=sess.aux_params)


def phase_draft_engine(torch, D, params, cfg, dec, prompts, greedy_rows,
                       bundle, label, *, steps_per_sync=1, alone=False):
    """15d: the fp32 engine on the managed page pool with a draft_model and
    an exact group of 4 slots each drafting with ``bundle``: 5c's 16
    requests (the topk_tree ones in the draft_model group), each greedy's
    under the near-tie rule, every serving function built once, launches
    exactly as the groups' forwards and prefills imply.

    With ``alone`` (a self-draft, in windows of ``steps_per_sync``
    iterations, so a row that finishes mid-window re-drafts in place while
    frozen): a self-draft accepts whole blocks only while each row's draft
    cache holds its committed stream through the scatter on attach, the
    reset on evict and the frozen re-drafts, so each draft_model request's
    tokens and invocations must equal a run-to-completion
    ``DecodeSession.decode`` of that request alone with the same draft,
    except where greedy's continuation holds a near-tie (reported)."""
    from repro_torch import serving
    from repro_torch.kernels import _build
    from repro_torch.models import model as M

    plan = [p[:5] + ({"topk_tree": "draft_model"}.get(p[5], p[5]),)
            for p in engine_plan()]
    host = prompts.cpu().numpy()
    reqs = [serving.Request(rid=rid, prompt=host[row, :plen], max_new=budget,
                            arrival=t, policy=policy)
            for rid, row, plen, budget, t, policy in plan]
    bundles = {"draft": bundle}
    edec = dec.replace(page_size=16, cache_backend="paged")
    ecfg = serving.EngineConfig(num_slots=8, max_prompt_len=64,
                                max_new_cap=64, steps_per_sync=steps_per_sync)
    engine = serving.ContinuousBatchingEngine(
        params, cfg, edec, ecfg, policies={"draft_model": 4, "exact": 4},
        bundles=bundles)
    _build.reset_launches()
    done, wall, pulls, _ = drive_engine(torch, serving, engine, reqs, label)
    launches = dict(_build.LAUNCHES)
    g = {grp.name: grp for grp in engine.groups}
    steps = engine.session.bound_policy("draft_model").drafter \
        .draft_steps_per_iter(dec.block_k)
    drafts = g["draft_model"].num_forwards + g["draft_model"].num_prefills
    want = dict(
        paged_verify_attention=cfg.num_layers * sum(
            grp.num_forwards for grp in engine.groups),
        verify_attention=bundle.cfg.num_layers * steps * drafts,
        fused_verify=sum(grp.num_forwards for grp in engine.groups),
        fused_heads=g["exact"].num_forwards + g["exact"].num_prefills)
    check_launches(launches, want, label)
    log(f"[draft] {label}: launches {launches} (exact)")
    counts = engine.compile_counts()
    check(counts and all(v == 1 for v in counts.values()),
          f"{label}: builds {counts}")
    after = causal_logits_after(torch, M, params, cfg)
    compare_engine(torch, after, done, greedy_rows, plan, label)
    if not alone:
        return

    sess = serving.DecodeSession(params, cfg, dec, policy="draft_model",
                                 bundles=bundles)
    by_rid = {f.rid: f for f in done}
    t0 = time.perf_counter()
    split, khat = [], []
    for rid, row, plen, budget, _, policy in plan:
        if policy != "draft_model":
            continue
        f = by_rid[rid]
        toks, stats = sess.decode(
            {"tokens": prompts[row:row + 1, :plen].contiguous()},
            max_new_rows=torch.tensor([budget], device="cuda"))
        want = (toks[0, plen:plen + budget].tolist(), stats["invocations"])
        khat.append(f.generated / max(f.invocations - 1, 1))
        if (f.tokens.tolist(), f.invocations) == want:
            continue
        g_row = greedy_rows[(row, plen)]
        gap = min(top2_gap(torch, after(rid, g_row[:plen + i]))
                  for i in range(budget))
        log(f"    request {rid}: {f.invocations} invocations in the engine, "
            f"{want[1]} alone; tokens equal {f.tokens.tolist() == want[0]}; "
            f"greedy's least top-2 gap over its {budget} tokens {gap:.3g}")
        check(gap < TIE_MARGIN, f"{label}: request {rid} differs from its "
                                f"run-to-completion decode with no near-tie")
        split.append(rid)
    n = len(khat)
    check(sum(khat) / n > 2.0, f"{label}: the self-draft's k̂ {khat}")
    log(f"[draft] {label}: {n - len(split)}/{n} draft_model requests equal "
        f"their run-to-completion decode alone in tokens and invocations "
        f"(others at reported near-ties); k̂ per request "
        f"{[round(k, 4) for k in khat]}; {time.perf_counter() - t0:.1f}s")


def phase_draft_fixture(torch, exact_rows):
    """15c: the pinned distilled students (tests/data/draft_model) drafting
    for the trained sweep teacher, fp32, each source row alone as the
    reference decoded it: rows equal to reference.json under the near-tie
    rule (equal tokens with equal counts), the tokens 10c's exact tokens,
    draft_steps_per_iter 7 and draft_steps_saved 1, launches exact."""
    import numpy as np

    from repro_torch import bridge, serving
    from repro_torch.config import DecodeConfig
    from repro_torch.core import ModelBundle
    from repro_torch.kernels import _build
    from repro_torch.models import seq2seq as S

    cfg = fixture_config(FIXTURE)
    params = bridge.load_checkpoint(str(FIXTURE / "checkpoint"), cfg,
                                    device="cuda")
    dcfg = fixture_config(DRAFT_FIXTURE)
    with open(DRAFT_FIXTURE / "reference.json") as f:
        ref = json.load(f)
    with open(FIXTURE / "reference.json") as f:
        exact_khat = json.load(f)["exact"]["mean_khat"]
    src = torch.as_tensor(np.load(FIXTURE / "src.npy"), device="cuda")
    n_rows, se = src.shape
    after = mt_logits_after(torch, S, params, cfg, src)
    dec = DecodeConfig(max_new_tokens=se, block_k=8, policy="draft_model")
    t0 = time.perf_counter()
    for row, student in DRAFT_FIXTURE_ROWS.items():
        dparams = bridge.load_checkpoint(str(DRAFT_FIXTURE / student), dcfg,
                                         device="cuda")
        sess = serving.DecodeSession(params, cfg, dec, bundles={
            "draft": ModelBundle(dparams, dcfg)})
        steps = sess.policy.drafter.draft_steps_per_iter(8)
        check((float(steps), float(8 - steps)) == (7.0, 1.0),
              f"15c {row}: draft_steps_per_iter {steps}")
        rows = []
        for r in range(n_rows):
            _build.reset_launches()
            toks, stats = sess.decode_seq2seq({"src": src[r:r + 1]})
            launches = dict(_build.LAUNCHES)
            iters = stats["iterations"]
            want = draft_launches(cfg, dcfg, iters, steps)
            want["verify_attention"] += cfg.num_layers * iters   # cross attention
            check_launches(launches, want, f"15c {row} row {r}")
            rows.append({"tokens": toks[0, :se].tolist(), "iterations": iters,
                         "generated": int(stats["generated"][0])})
        equal = match_rows(torch, after, rows, ref[row]["rows"], f"15c {row}")
        match_reference(torch, after, [r["tokens"] for r in rows], exact_rows,
                        f"15c {row} vs exact")
        khat = float(np.mean([r["generated"] / max(r["iterations"], 1)
                              for r in rows]))
        log(f"[draft] 15c {row} ({student} student): k̂ {khat:.4f} "
            f"(reference.json {ref[row]['mean_khat']:.4f}, exact "
            f"{exact_khat:.4f}); {equal}/{n_rows} rows equal to the "
            f"reference's (others at reported near-ties); draft steps per "
            f"iteration {steps}, saved {8 - steps}; tokens == 10c's exact")
    log(f"[draft] 15c {time.perf_counter() - t0:.1f}s")


def phase_draft_launcher(torch):
    """15e: ``repro_torch.launch.serve --arch granite-3-8b --policy
    draft_model`` with the smoke primary and the smoke draft, as the
    reference's launcher serves them, then ``--engine --policies
    exact=2,draft_model=2``: both run to completion and report k̂."""
    from repro_torch.launch import serve

    base = ["--arch", "granite-3-8b", "--batch", "4", "--prompt-len", "16",
            "--max-new", "32"]
    out = serve.main(base + ["--policy", "draft_model"])
    stats = out["stats"]
    check(bool((stats["generated"] == 32).all()), "15e: short rows")
    log(f"[draft] 15e launcher static: k̂ {stats['mean_accepted']:.4f} in "
        f"{stats['iterations']} iterations, {out['wall_s'] * 1e3:.1f} ms")
    out = serve.main(base + ["--engine", "--policies",
                             "exact=2,draft_model=2"])
    fin = out["finished"]
    check(len(fin) == 8 and all(f.generated > 0 for f in fin),
          "15e: the engine did not serve every request")
    khat = {p: sum(f.generated for f in fin if f.policy == p)
            / max(sum(f.invocations - 1 for f in fin if f.policy == p), 1)
            for p in ("exact", "draft_model")}
    log(f"[draft] 15e launcher --engine exact=2,draft_model=2: {len(fin)} "
        f"requests, k̂ per group { {p: round(k, 4) for p, k in khat.items()} }")


# ---------------------------------------------------------------------------
# phase 16: the dense text families at full width
# ---------------------------------------------------------------------------


FAMILY_MEM_GIB = 76.0   # the fp32 decodes' peak at full depth stays below it
WINDOW_PROMPT = 4608    # starcoder2-7b's window + 512: the ring wraps
WINDOW_CHUNK = 512
# the fp32 decodes of phases 4b-5c, 14, 15 and 16-18 run at a twentieth to
# an eighth of the depth (cut from a quarter to pay for phase 22's sharded
# engine, and stablelm-12b's, starcoder2-7b's and nemotron-4-15b's from 4
# layers to 2 for its sharded families), so that the script stays within
# 75% of its time limit; phase 4 and each bf16 serve run at full depth.
# rwkv6-1.6b's entry is phase 22's sharded fp32 depth (phase 8 decodes it
# whole)
FAMILY_FP32_LAYERS = {"granite-3-8b": 4, "stablelm-12b": 2,
                      "starcoder2-7b": 2, "nemotron-4-15b": 2,
                      "olmoe-1b-7b": 2, "qwen2-moe-a2.7b": 3,
                      "hymba-1.5b": 4, "rwkv6-1.6b": 4}


def attention_launches(cfg, dec) -> dict:
    """{kernel: launches per forward} of the attention layers of ``cfg``
    under ``dec``: the tree kernel in every layer under topk_tree; on the
    paged cache the paged kernel in the global layers and the dense chain
    kernel in the windowed ones (windowed layers keep a dense ring,
    models/cache.py: starcoder2-7b's every layer, hymba-1.5b's 29 of 32);
    else the dense chain kernel in every layer."""
    layers = cfg.num_layers
    if dec.policy == "topk_tree":
        return {"tree_verify_attention": layers}
    if dec.cache_backend != "paged":
        return {"verify_attention": layers}
    windowed = sum(1 for i in range(layers) if cfg.sliding_window
                   and i not in cfg.global_attn_layers)
    out = {"verify_attention": windowed,
           "paged_verify_attention": layers - windowed}
    return {k: n for k, n in out.items() if n}


def family_paths(torch, M, D, params, cfg, dec, batch, prompt_len, paths,
                 label, *, kv_chunk=0):
    """greedy_decode, then each BPD path of ``paths`` ((name, decode
    overrides)), fp32: each must emit greedy's tokens (near-tie rule, for
    an MoE model with its router extension), its attention kernel launched
    once per layer and forward, fused_verify once per iteration,
    fused_heads once per iteration and prefill.  The chain paths prefill in
    chunks of ``kv_chunk`` keys (a tree's prefill cannot, as in the
    reference).  Returns greedy's tokens and, for an MoE model, greedy's
    ``Routes`` (else None)."""
    from repro_torch.kernels import _build

    g_toks = g_routes = None
    for name, kw in (("greedy", {}),) + tuple(paths):
        pdec = dec.replace(**kw)
        _build.reset_launches()
        t0 = time.perf_counter()
        run = D.greedy_decode if name == "greedy" else D.bpd_decode
        chunk = 0 if pdec.policy == "topk_tree" else kv_chunk
        with routes_for(torch, cfg) as rec:
            toks, stats = run(params, cfg, pdec, batch, kv_chunk=chunk)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launch = dict(_build.LAUNCHES)
        iters = stats["iterations"]
        want = {k: 0 for k in launch}
        for kernel, n in attention_launches(cfg, pdec).items():
            want[kernel] = n * iters
        if name != "greedy":
            want.update(fused_verify=iters, fused_heads=iters + 1)
        log(f"[families] {label} {name}: k̂={stats['mean_accepted']:.4f} "
            f"iterations={iters} invocations={stats['invocations']}, "
            f"{wall:.2f}s, launches {launch}")
        check(launch == want, f"{label} {name}: launches {launch}, expected "
                              f"{want}")
        check(bool((stats["generated"] == dec.max_new_tokens).all()),
              f"{label} {name}: short rows")
        ONE_DEVICE[(cfg.name, name)] = {
            "tokens": toks.cpu(), "generated": stats["generated"].cpu(),
            "text_len": stats["text_len"].cpu(), "iterations": iters,
            "launches": launch, "wall": wall, "routes": rec}
        if g_toks is None:
            g_toks, g_routes = toks, rec
            continue
        diverged = compare_rows(
            torch, causal_logits_after(torch, M, params, cfg, batch), toks,
            g_toks, stats["text_len"], prompt_len, cfg=cfg,
            label=f"{label} {name}",
            routes=(g_routes, rec) if rec is not None else None)
        rows = toks.shape[0]
        log(f"[families] {label} {name}: tokens == greedy tokens in "
            f"{rows - len(diverged)}/{rows} rows (others at near-ties)")
    return g_toks, g_routes


def family_serve(torch, D, M, params, cfg, prompts, label):
    """The weights cast for bf16 in place and served statically by
    repro_torch.launch.serve --arch ... --full-config (phase 4's prompts,
    64 new tokens, block_k 8): tokens/s, k̂, iterations, launches, the
    serve's peak memory, agreement with bf16 greedy and each row's first
    divergence from it (reported, as phase 6); one iteration profiled."""
    from repro_torch.kernels import _build
    from repro_torch.launch import serve

    M.cast_for_compute(params, cfg.replace(dtype="bfloat16"))
    torch.cuda.empty_cache()
    log(f"[families] {label} cast for bf16: "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.1f} GiB allocated")
    torch.cuda.reset_peak_memory_stats()
    prompt_len, max_new = prompts.shape[1], 64
    _build.reset_launches()
    out = serve.main(["--arch", cfg.name, "--full-config", "--batch", "8",
                      "--prompt-len", str(prompt_len), "--max-new",
                      str(max_new), "--block-k", str(cfg.bpd_k), "--seed",
                      "0"], params=params)
    launches = dict(_build.LAUNCHES)
    scfg, sdec, sbatch = out["cfg"], out["dec"], out["batch"]
    check(torch.equal(sbatch["tokens"], prompts), f"{label}: serve prompts "
                                                  f"differ")
    s_toks, s_stats = out["tokens"], out["stats"]
    attn = attention_launches(scfg, sdec)
    check(all(launches[k] == 2 * n * s_stats["iterations"]
              for k, n in attn.items())
          and launches["fused_verify"] == 2 * s_stats["iterations"],
          f"{label} serve: launches {launches}")
    generated = int(s_stats["generated"].sum())
    ONE_DEVICE[(cfg.name, "bf16 serve")] = {
        "tokens": s_toks.cpu(), "tps": generated / out["wall_s"],
        "khat": s_stats["mean_accepted"], "iterations": s_stats["iterations"],
        "peak": torch.cuda.max_memory_allocated()}
    gb_toks, _ = D.greedy_decode(params, scfg, sdec, sbatch)
    n = prompt_len + max_new
    same = s_toks[:, prompt_len:n] == gb_toks[:, prompt_len:n]
    log(f"[families] {label} bf16 serve: {generated / out['wall_s']:.1f} "
        f"tokens/s, k̂={s_stats['mean_accepted']:.4f}, iterations="
        f"{s_stats['iterations']}, wall {out['wall_s'] * 1e3:.1f} ms, "
        f"launches {launches}, peak "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; BPD vs bf16 "
        f"greedy agreement {float(same.float().mean()):.4f} of tokens, "
        f"{int(same.all(dim=1).sum())}/8 rows identical (reported)")
    div = report_divergences(torch, causal_logits_after(torch, M, params,
                                                        scfg),
                             s_toks, gb_toks, prompt_len, n)
    log(f"[families] {label} bf16 first divergences: {len(div)} rows, "
        f"{sum(d['tie'] for d in div)} at near-ties; BPD's token ranks "
        f"{[d['bpd_rank'] for d in div]}, ulps below the top "
        f"{[round(d['bpd_ulps'], 3) for d in div]}")
    profile_iteration(torch, D, params, scfg, sdec, sbatch,
                      f"{label} exact dense")


def window_check(torch, M, D, params, cfg, dec, *, prompt_len, kv_chunk,
                 label):
    """A windowed model past its ring: 2 MarkovLM prompts of ``prompt_len``
    tokens prefilled through DecodeSession(kv_chunk=``kv_chunk``), then
    ``dec.max_new_tokens`` new tokens under greedy and under BPD exact,
    equal (near-tie rule); and an independent check: forward_hidden over
    the meta tokens (if any) + prompt + greedy's tokens (the window on the
    full path, every meta position visible) gives greedy's token as p_1's
    argmax at every generated position (near-tie rule), positions that wrap
    the ring of the cached decode (starcoder2-7b: 4,608 tokens over 4,352
    slots; hymba-1.5b: 128 meta + 1,536 tokens over 1,280 slots, the first
    128 reserved)."""
    import numpy as np

    from repro_torch import serving
    from repro_torch.data.synthetic import MarkovLM
    from repro_torch.models import cache as C

    t0 = time.perf_counter()
    task = MarkovLM(vocab=256, temperature=0.2, seed=0)
    long = torch.as_tensor(task.sample(np.random.default_rng(16), 2,
                                       prompt_len), device="cuda")
    meta, max_new = cfg.num_meta_tokens, dec.max_new_tokens
    windowed = next(i for i in range(cfg.num_layers)
                    if i not in cfg.global_attn_layers)
    ring = C.attn_buf_len(cfg, windowed, meta + prompt_len + max_new,
                          dec.block_k)
    sess = serving.DecodeSession(params, cfg, dec, kv_chunk=kv_chunk)
    g_toks, g_stats = sess.greedy({"tokens": long})
    b_toks, b_stats = sess.decode({"tokens": long})
    torch.cuda.synchronize()
    after = causal_logits_after(torch, M, params, cfg)
    diverged = compare_rows(torch, after, b_toks, g_toks, b_stats["text_len"],
                            prompt_len)
    log(f"[window] {label} window {cfg.sliding_window}, ring {ring} slots "
        f"({meta} reserved for meta tokens): 2 prompts of {prompt_len} "
        f"through DecodeSession(kv_chunk={kv_chunk}); greedy "
        f"{g_stats['iterations']} steps, BPD exact k̂ "
        f"{b_stats['mean_accepted']:.4f} in {b_stats['iterations']} "
        f"iterations; tokens equal in {2 - len(diverged)}/2 rows (others at "
        f"near-ties)")
    end = prompt_len + max_new
    seq = g_toks[:, :end]
    pos = torch.arange(meta + end, dtype=torch.int32, device="cuda")
    with torch.no_grad():
        h = M.embed_inputs(params, cfg, {"tokens": seq})
        hidden, _ = M.forward_hidden(params, cfg, h, positions=pos,
                                     kv_chunk=kv_chunk)
        logits = M.base_logits(params, cfg,
                               hidden[:, meta + prompt_len - 1:meta + end - 1])
    logits = logits[..., :cfg.vocab_size].float()
    full = logits.argmax(-1)
    want = seq[:, prompt_len:end]
    off = (full != want).nonzero().tolist()
    for r, j in off:
        gap = top2_gap(torch, logits[r, j])
        log(f"    row {r}, new token {j}: the full forward's argmax "
            f"{int(full[r, j])} != greedy's {int(want[r, j])}, top-2 gap "
            f"{gap:.3g} of max|logit|")
        check(gap < TIE_MARGIN, f"{label} window: the full forward and "
                                f"the cached greedy differ at row {r}, new "
                                f"token {j} with no near-tie ({gap})")
    check(meta + end > ring, f"{label}: the window check does not wrap the "
                             f"ring")
    log(f"[window] {label}: the full forward over {meta + end} positions "
        f"(window {cfg.sliding_window}, kv_chunk {kv_chunk}) gives greedy's "
        f"token at {2 * max_new - len(off)}/{2 * max_new} generated "
        f"positions (others at near-ties); {time.perf_counter() - t0:.1f}s")


def phase_families(torch, results):
    """Phase 16: stablelm-12b, starcoder2-7b and nemotron-4-15b at full
    width from seed 0, fp32, phase 4's 8 prompts of 64, 64 new tokens,
    block_k 8: the decode paths each model is served on (launches exact,
    greedy's tokens), 16a stablelm-12b's fp32 engine (5c's 16 requests,
    unified on the managed page pool), 16b starcoder2-7b's window past its
    ring, then each cast for bf16 and served (--full-config); each model's
    parameters and peak memory printed."""
    import numpy as np

    from repro_torch.config import DecodeConfig, get_config
    from repro_torch.core import decode as D
    from repro_torch.data.synthetic import MarkovLM
    from repro_torch.models import model as M

    task = MarkovLM(vocab=256, temperature=0.2, seed=0)
    prompts = torch.as_tensor(task.sample(np.random.default_rng(1), 8, 64),
                              device="cuda")
    batch = {"tokens": prompts}
    chain_tree = (("bpd exact dense", {}),
                  ("bpd exact paged", dict(cache_backend="paged")),
                  ("bpd topk_tree dense", dict(policy="topk_tree", top_k=2)),
                  ("bpd topk_tree paged", dict(policy="topk_tree", top_k=2,
                                               cache_backend="paged")))
    for name, paths in (("stablelm-12b", chain_tree),
                        ("starcoder2-7b", chain_tree),
                        ("nemotron-4-15b", chain_tree[::3])):
        t0 = time.perf_counter()
        full = get_config(name).replace(dtype="float32")
        cfg = full.replace(num_layers=FAMILY_FP32_LAYERS[name])
        torch.cuda.reset_peak_memory_stats()
        params = M.init(cfg, seed=0, device="cuda")
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in params.parameters())
        log(f"[families] {name} fp32 decodes at {cfg.num_layers} of "
            f"{full.num_layers} layers: {n_params / 1e9:.3f} B parameters, "
            f"{cfg.num_layers} layers, d {cfg.d_model}, {cfg.num_heads}/"
            f"{cfg.num_kv_heads} heads of {cfg.resolved_head_dim}, vocab "
            f"{cfg.vocab_size}, window {cfg.sliding_window}; init "
            f"{time.perf_counter() - t0:.1f}s, "
            f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")
        if cfg.sliding_window:
            log(f"[families] {name}: every layer windowed at "
                f"{cfg.sliding_window}, so the paged backend keeps each "
                f"layer's dense ring: its paged paths launch "
                f"verify_attention / tree_verify_attention")
        dec = DecodeConfig(max_new_tokens=64, block_k=cfg.bpd_k)
        g_toks, _ = family_paths(torch, M, D, params, cfg, dec, batch, 64,
                                 paths, name)
        if name == "stablelm-12b":
            phase_engine_fp32(torch, M, D, params, cfg, dec, prompts, g_toks,
                              disaggregated=False)
        if name == "starcoder2-7b":
            window_check(torch, M, D, params, cfg, dec,
                         prompt_len=WINDOW_PROMPT, kv_chunk=WINDOW_CHUNK,
                         label="starcoder2-7b")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"[families] {name} fp32 peak {peak:.2f} GiB at {cfg.num_layers} "
            f"layers; {time.perf_counter() - t0:.1f}s")
        check(peak < FAMILY_MEM_GIB, f"{name}: the fp32 decodes peak at "
                                     f"{peak:.2f} GiB, over {FAMILY_MEM_GIB} "
                                     f"GiB")
        del params
        gc.collect()
        torch.cuda.empty_cache()
        params = M.init(full, seed=0, device="cuda")    # the serve: full depth
        family_serve(torch, D, M, params, full, prompts, name)
        log(f"[families] {name} {time.perf_counter() - t0:.1f}s")
        del params
        gc.collect()
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 17: the MoE family (olmoe-1b-7b, qwen2-moe-a2.7b)
# ---------------------------------------------------------------------------


MOE_TRAIN_LAYERS = 8    # 17c: olmoe-1b-7b fine-tuned at full width


def phase_moe(torch, results):
    """Phase 17: olmoe-1b-7b and qwen2-moe-a2.7b at full width from seed
    0, the fp32 decodes at an eighth of the depth (FAMILY_FP32_LAYERS: 2 of
    16 and 3 of 24 layers), phase 4's 8 prompts of 64, 64 new tokens,
    block_k 8,
    every decode forward routing at full capacity: 17a olmoe's greedy,
    exact and topk_tree on both caches and its fp32 engine (5c's 16
    requests, unified on the managed page pool); 17b qwen2-moe's greedy,
    exact dense and topk_tree paged; each greedy's tokens under the
    near-tie rule with its router extension, launches exact, the fp32 peak
    under FAMILY_MEM_GIB; then each at full depth from seed 0, cast for
    bf16 and served (--full-config); 17c training (``phase_moe_train``)."""
    import numpy as np

    from repro_torch.config import DecodeConfig, get_config
    from repro_torch.core import decode as D
    from repro_torch.data.synthetic import MarkovLM
    from repro_torch.models import model as M

    task = MarkovLM(vocab=256, temperature=0.2, seed=0)
    prompts = torch.as_tensor(task.sample(np.random.default_rng(1), 8, 64),
                              device="cuda")
    batch = {"tokens": prompts}
    chain_tree = (("bpd exact dense", {}),
                  ("bpd exact paged", dict(cache_backend="paged")),
                  ("bpd topk_tree dense", dict(policy="topk_tree", top_k=2)),
                  ("bpd topk_tree paged", dict(policy="topk_tree", top_k=2,
                                               cache_backend="paged")))
    for name, paths in (("olmoe-1b-7b", chain_tree),
                        ("qwen2-moe-a2.7b", chain_tree[::3])):
        t0 = time.perf_counter()
        full = get_config(name).replace(dtype="float32")
        cfg = full.replace(num_layers=FAMILY_FP32_LAYERS[name])
        torch.cuda.reset_peak_memory_stats()
        params = M.init(cfg, seed=0, device="cuda")
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in params.parameters())
        log(f"[moe] {name} fp32 decodes at {cfg.num_layers} of "
            f"{full.num_layers} layers: {n_params / 1e9:.3f} B parameters, "
            f"{cfg.num_layers} layers, d {cfg.d_model}, {cfg.num_heads}/"
            f"{cfg.num_kv_heads} heads of {cfg.resolved_head_dim}, "
            f"{cfg.num_experts} experts ({cfg.padded_num_experts} stored) "
            f"of width {cfg.d_ff}, top-{cfg.num_experts_per_tok}, shared "
            f"width {cfg.shared_expert_d_ff}, vocab {cfg.vocab_size}; init "
            f"{time.perf_counter() - t0:.1f}s, "
            f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")
        dec = DecodeConfig(max_new_tokens=64, block_k=cfg.bpd_k)
        ties0 = len(ROUTER_TIES)
        g_toks, g_routes = family_paths(torch, M, D, params, cfg, dec, batch,
                                        64, paths, name)
        if name == "olmoe-1b-7b":
            phase_engine_fp32(torch, M, D, params, cfg, dec, prompts, g_toks,
                              disaggregated=False, greedy_routes=g_routes)
        del g_routes
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"[moe] {name} fp32 peak {peak:.2f} GiB; router near-ties "
            f"admitted {len(ROUTER_TIES) - ties0}; "
            f"{time.perf_counter() - t0:.1f}s")
        check(peak < FAMILY_MEM_GIB, f"{name}: the fp32 decodes peak at "
                                     f"{peak:.2f} GiB, over {FAMILY_MEM_GIB} "
                                     f"GiB")
        del params
        gc.collect()
        torch.cuda.empty_cache()
        params = M.init(full, seed=0, device="cuda")    # the serve: full depth
        family_serve(torch, D, M, params, full, prompts, name)
        log(f"[moe] {name} {time.perf_counter() - t0:.1f}s")
        del params
        gc.collect()
        torch.cuda.empty_cache()
    log(f"[moe] router near-ties admitted in this run: {len(ROUTER_TIES)} "
        f"{ROUTER_TIES} (margin {ROUTER_TIE_MARGIN} of p_K)")
    phase_moe_train(torch, card_line())


def phase_moe_train(torch, card):
    """17c: one make_train_step card vs CPU at a narrow olmoe geometry
    where capacity drops assignments (``card_vs_cpu``); then olmoe-1b-7b
    fine-tuned at full width, its depth cut to MOE_TRAIN_LAYERS so that
    parameters, gradients and AdamW moments (16 bytes a parameter) fit,
    TRAIN_STEPS steps of B 4 x S 256: the loss falls, the router's aux and
    z terms and the dropped share per step, step ms, tokens/s, peak."""
    from repro_torch.config import TrainConfig, get_config
    from repro_torch.data.pipeline import prefetch
    from repro_torch.data.synthetic import MarkovLM
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model as M
    from repro_torch.optim import optimizer_init
    from repro_torch.utils.tree import tree_size

    full = get_config("olmoe-1b-7b")
    narrow = full.replace(num_layers=2, d_model=1024, num_heads=8,
                          num_kv_heads=8, num_experts=16,
                          num_experts_per_tok=4, d_ff=512, vocab_size=4096,
                          dtype="float32")
    card_vs_cpu(torch, narrow, {"fine-tuned": (
        TrainConfig(lr=1e-4, warmup_steps=1), 2, False)},
        "17c olmoe narrow (d 1024, 16 experts top-4, capacity "
        f"{narrow.capacity_factor})")

    cfg = full.replace(num_layers=MOE_TRAIN_LAYERS, dtype="float32")
    params = M.init(cfg, seed=0, device="cuda")
    n, n_full = tree_size(params), tree_size(M.init(full, device="meta"))
    log(f"[train] 17c olmoe-1b-7b fp32 fine-tuned, depth cut from "
        f"{full.num_layers} to {cfg.num_layers} layers: full depth's "
        f"parameters, gradients and AdamW moments ({n_full / 1e9:.3f} B x 16 "
        f"bytes = {n_full * 16 / 2 ** 30:.1f} GiB) do not fit in 80 GB; at "
        f"{cfg.num_layers} layers {n / 1e9:.3f} B parameters, "
        f"{n * 16 / 2 ** 30:.1f} GiB for them")
    tc = TrainConfig(head_loss="random", lr=TRAIN_LR, warmup_steps=1,
                     schedule="constant")
    opt = optimizer_init(params, tc)
    gen = torch.Generator().manual_seed(1)
    batches = prefetch(MarkovLM(vocab=256, temperature=0.2, seed=0).batches(
        batch=4, seq_len=256, seed=2), device="cuda")
    torch.cuda.reset_peak_memory_stats()
    step = make_train_step(cfg, tc)
    params, opt, losses, ms, m = run_steps(
        torch, step, params, opt, batches, gen, TRAIN_STEPS,
        "17c olmoe fine-tuned",
        keep=("moe_aux_loss", "moe_z_loss", "moe_dropped_frac"))
    batches.close()
    step_report(torch, f"17c olmoe-1b-7b fine-tuned, {cfg.num_layers} layers, "
                f"B 4 x S 256", ms, 4 * 256, card)
    check_loss_falls(losses, "17c olmoe fine-tuned")
    check(0 < float(m["moe_dropped_frac"]) < 1, f"17c: dropped share "
                                                f"{float(m['moe_dropped_frac'])}")
    del params, opt, step
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 18: the Hymba hybrid family (hymba-1.5b)
# ---------------------------------------------------------------------------


HYMBA_WINDOW_PROMPT = 1536   # 18b: + 128 meta + 16 new = 1,680 > 1,280 slots
HYMBA_TRAIN_LAYERS = 8       # 18e: hymba-1.5b fine-tuned at full width
HYMBA_TRAIN_STEPS = 10


def topk_within(torch, M, params, cfg, toks, prompt_len, n, top_k, label):
    """topk acceptance keeps any proposal inside p_1's top-``top_k``, so its
    tokens may leave greedy's: each generated token must rank within
    ``top_k`` of p_1 by a full forward over its row's prefix (one batched
    forward), or sit where the top_k-th / (top_k+1)-th gap is below
    TIE_MARGIN.  Returns how many tokens are not p_1's argmax."""
    seq = toks[:, :prompt_len + n]
    with torch.no_grad():
        h = M.embed_inputs(params, cfg, {"tokens": seq})
        hidden, _ = M.forward_hidden(params, cfg, h)
        meta = cfg.num_meta_tokens
        logits = M.base_logits(params, cfg, hidden[:, meta + prompt_len - 1:
                                                   meta + prompt_len + n - 1])
    logits = logits[..., :cfg.vocab_size].float()
    tok = seq[:, prompt_len:].long()
    mine = logits.gather(-1, tok[..., None])[..., 0]
    rank = (logits > mine[..., None]).sum(-1) + 1
    top = torch.topk(logits, top_k + 1).values
    gap = (top[..., top_k - 1] - top[..., top_k]) / logits.abs().amax(-1)
    bad = (rank > top_k) & (gap >= TIE_MARGIN)
    check(not bool(bad.any()), f"{label}: {int(bad.sum())} tokens outside "
                               f"p_1's top-{top_k} with no near-tie")
    return int((rank > 1).sum())


def rollback_check(torch, M, D, params, cfg, dec, batch, g_toks, prompt_len,
                   label, *, kv_chunk=0, corrupts=(None, 3)):
    """8b / 18c / 19a: from the prefill (in chunks of ``kv_chunk`` keys),
    one BPD iteration with greedy's continuation as the proposals (k̂ = 8),
    then with slot 3 corrupted (k̂ = 3) (``corrupts``), each followed by a
    second iteration on the committed state (RWKV-6's, the Mamba heads'
    beside attention, or llava's KV cache behind its patch prefix), which
    must give greedy's tokens."""
    block_k = dec.block_k
    cont = g_toks[:, prompt_len:prompt_len + block_k].contiguous()
    be = D.causal_lm_backend(cfg)
    patches = batch.get("patch_embeds")
    for corrupt in corrupts:
        state, prefix = D.bpd_prefill_causal_lm(params, cfg, dec, batch,
                                                max_new=dec.max_new_tokens,
                                                kv_chunk=kv_chunk)
        check(prefix == M.prefix_len(cfg, batch), f"{label} prefix {prefix}")
        check(torch.equal(state.proposals[:, 0], cont[:, 0]),
              f"{label} prefill's verified slot 0 != greedy's first token")
        props = cont.clone()
        if corrupt is not None:
            props[:, corrupt] = (props[:, corrupt] + 1) % cfg.vocab_size
        state = state._replace(proposals=props)
        with torch.no_grad():
            state = D.bpd_iteration(params, cfg, dec, be, state,
                                    prefix_offset=prefix,
                                    max_new=dec.max_new_tokens)
        khat = (state.text_len - prompt_len).tolist()
        want = block_k if corrupt is None else corrupt
        log(f"[{label} accepts] proposals = greedy continuation"
            f"{'' if corrupt is None else f' with slot {corrupt} corrupted'}: "
            f"k̂ per row {khat}")
        for r, kh in enumerate(khat):
            if kh != want:
                gap = near_tie(torch, M, params, cfg,
                               g_toks[r, :prompt_len + kh],
                               None if patches is None else patches[r])
                check(kh < want and gap < TIE_MARGIN,
                      f"{label} row {r}: k̂={kh}, expected {want} (gap {gap})")
        with torch.no_grad():           # the next block on the committed state
            state = D.bpd_iteration(params, cfg, dec, be, state,
                                    prefix_offset=prefix,
                                    max_new=dec.max_new_tokens)
        diverged = compare_rows(torch, causal_logits_after(torch, M, params,
                                                           cfg, batch),
                                state.tokens, g_toks, state.text_len,
                                prompt_len)
        second = (state.text_len - prompt_len
                  - torch.tensor(khat, device="cuda")).tolist()
        log(f"[{label} accepts] second iteration on the committed state: k̂ "
            f"per row {second}; tokens == greedy tokens in "
            f"{len(khat) - len(diverged)}/{len(khat)} rows")


def hymba_prefill_profile(torch, D, params, cfg, dec, batch):
    """18d: one bf16 prefill (128 meta + the prompt) under torch.profiler:
    its host wall, the kernels' busy time and the Mamba scan's steps
    (one addcmul launch a step and layer)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def prefill():
        return D.bpd_prefill_causal_lm(params, cfg, dec, batch,
                                       max_new=dec.max_new_tokens)

    prefill()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prefill()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            prefill()
            torch.cuda.synchronize()
        events = prof.events()
    except (RuntimeError, AttributeError) as exc:    # a measurement, not the path
        log(f"[profile] torch.profiler unavailable ({exc}); not measured")
        return
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    scan = sum(1 for e in events if e.name == "aten::addcmul")
    positions = cfg.num_meta_tokens + batch["tokens"].shape[1]
    log(f"[profile] one bf16 hymba-1.5b prefill of {positions} positions "
        f"(B {batch['tokens'].shape[0]}): wall {wall_ms:.2f} ms, "
        f"{len(kernels)} kernels busy {busy:.2f} ms, idle share "
        f"{1 - busy / wall_ms:.3f}; Mamba scan steps (addcmul launches) "
        f"{scan} ({positions} x {cfg.num_layers} layers)")


def phase_hymba(torch, results):
    """Phase 18: hymba-1.5b (32 layers of attention beside Mamba heads,
    d 1600, 25/5 heads of 64, windows of 1024 outside layers 0, 15 and 31,
    128 meta tokens, untied lm_head at vocab 32001) at full width from seed
    0, the fp32 decodes at an eighth of the depth (FAMILY_FP32_LAYERS: 4 of
    32 layers, layer 0 the only global one), phase 4's 8 prompts of 64, 64
    new tokens, block_k 8.  18a greedy, BPD exact, topk (T 2) and adaptive
    on the dense cache and exact on the paged cache (the global layer
    paged, the 3 windowed on their dense rings: 3 verify_attention + 1
    paged_verify_attention a forward), launches exact; exact and adaptive
    emit greedy's tokens (near-tie rule), topk's tokens lie within p_1's
    top-2; the fp32 peak.  18b the window: 2 prompts of 1,536 tokens, 16
    new, greedy and BPD exact equal, and a full forward over meta + prompt
    + greedy's tokens giving greedy's token past the wrapped ring.  18c
    hand-made accepts roll the Mamba state back (``rollback_check``).  18d
    the full depth from seed 0 cast for bf16 (A_log, D and the norm scales
    stay fp32) and served (--full-config): tokens/s, k̂, one iteration and
    one prefill profiled with the scan's launches.  18e training
    (``phase_hymba_train``)."""
    import numpy as np

    from repro_torch.config import DecodeConfig, get_config
    from repro_torch.core import decode as D
    from repro_torch.data.synthetic import MarkovLM
    from repro_torch.kernels import _build
    from repro_torch.models import model as M

    name = "hymba-1.5b"
    t0 = time.perf_counter()
    full = get_config(name).replace(dtype="float32")
    cfg = full.replace(num_layers=FAMILY_FP32_LAYERS[name])
    torch.cuda.reset_peak_memory_stats()
    params = M.init(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    log(f"[hymba] {name} fp32 decodes at {cfg.num_layers} of "
        f"{full.num_layers} layers: {n_params / 1e9:.3f} B parameters, "
        f"{cfg.num_layers} layers, d {cfg.d_model}, {cfg.num_heads}/"
        f"{cfg.num_kv_heads} heads of {cfg.resolved_head_dim}, Mamba d_inner "
        f"{cfg.ssm_expand * cfg.d_model} x state {cfg.ssm_state_dim}, window "
        f"{cfg.sliding_window} outside layers {cfg.global_attn_layers}, "
        f"{cfg.num_meta_tokens} meta tokens, vocab {cfg.vocab_size}; init "
        f"{time.perf_counter() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")
    task = MarkovLM(vocab=256, temperature=0.2, seed=0)
    prompts = torch.as_tensor(task.sample(np.random.default_rng(1), 8, 64),
                              device="cuda")
    batch = {"tokens": prompts}
    dec = DecodeConfig(max_new_tokens=64, block_k=cfg.bpd_k)

    # ---- 18a: greedy and BPD, dense and paged -------------------------------
    paths = (("bpd exact dense", {}),
             ("bpd adaptive dense", dict(policy="adaptive")),
             ("bpd exact paged", dict(cache_backend="paged")))
    g_toks, _ = family_paths(torch, M, D, params, cfg, dec, batch, 64, paths,
                             name)
    tdec = dec.replace(policy="topk", top_k=2)
    _build.reset_launches()
    t_toks, t_stats = D.bpd_decode(params, cfg, tdec, batch)
    torch.cuda.synchronize()
    launch = dict(_build.LAUNCHES)
    iters = t_stats["iterations"]
    want = {k: 0 for k in launch}
    want.update(verify_attention=cfg.num_layers * iters, fused_verify=iters,
                fused_heads=iters + 1)
    check(launch == want, f"{name} bpd topk: launches {launch}, expected "
                          f"{want}")
    check(bool((t_stats["generated"] == dec.max_new_tokens).all()),
          f"{name} bpd topk: short rows")
    off = topk_within(torch, M, params, cfg, t_toks, 64, dec.max_new_tokens,
                      2, f"{name} bpd topk")
    same = int((t_toks[:, 64:128] == g_toks[:, 64:128]).all(dim=1).sum())
    log(f"[families] {name} bpd topk (T 2) dense: k̂="
        f"{t_stats['mean_accepted']:.4f} iterations={iters}, launches "
        f"{launch}; every token within p_1's top-2 ({off} not its argmax), "
        f"{same}/8 rows equal to greedy's")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[hymba] {name} fp32 decodes peak {peak:.2f} GiB; "
        f"{time.perf_counter() - t0:.1f}s")
    check(peak < FAMILY_MEM_GIB, f"{name}: the fp32 decodes peak at "
                                 f"{peak:.2f} GiB")

    # ---- 18b: the window past the ring, 18c: rollback ----------------------
    window_check(torch, M, D, params, cfg, dec.replace(max_new_tokens=16),
                 prompt_len=HYMBA_WINDOW_PROMPT, kv_chunk=0, label=name)
    rollback_check(torch, M, D, params, cfg, dec, batch, g_toks, 64, "hymba")

    # ---- 18d: bf16 serve at full depth --------------------------------------
    del params
    gc.collect()
    torch.cuda.empty_cache()
    params = M.init(full, seed=0, device="cuda")
    family_serve(torch, D, M, params, full, prompts, name)
    kept = sorted({k.split(".")[-1] for k, v in params.state_dict().items()
                   if v.dtype == torch.float32})
    check(kept == ["A_log", "D", "scale"], f"{name} bf16 cast kept {kept} "
                                           f"in fp32")
    hymba_prefill_profile(torch, D, params, full.replace(dtype="bfloat16"),
                          dec, batch)
    log(f"[hymba] {name} {time.perf_counter() - t0:.1f}s")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    phase_hymba_train(torch, card_line())


def phase_hymba_train(torch, card):
    """18e: one make_train_step card vs CPU at a narrow hymba geometry (d
    256, 2 layers, layer 1 windowed at 32, 8 meta tokens; ``card_vs_cpu``),
    then hymba-1.5b fine-tuned at full width, its depth cut to
    HYMBA_TRAIN_LAYERS (layer 0 the only global one left), HYMBA_TRAIN_STEPS
    steps of B 4 x S 256 (after the 128 meta tokens): the loss falls, step
    ms, tokens/s, peak.  The Mamba backward is autograd through the scan's
    loop."""
    from repro_torch.config import TrainConfig, get_config
    from repro_torch.data.pipeline import prefetch
    from repro_torch.data.synthetic import MarkovLM
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model as M
    from repro_torch.optim import optimizer_init
    from repro_torch.utils.tree import tree_size

    full = get_config("hymba-1.5b")
    narrow = full.replace(num_layers=2, d_model=256, num_heads=4,
                          num_kv_heads=2, head_dim=64, d_ff=512,
                          vocab_size=4096, sliding_window=32,
                          global_attn_layers=(0,), num_meta_tokens=8,
                          dtype="float32")
    card_vs_cpu(torch, narrow, {"fine-tuned": (
        TrainConfig(lr=1e-4, warmup_steps=1), 2, False)},
        "18e hymba narrow (d 256, layer 1 windowed at 32, 8 meta tokens)")

    cfg = full.replace(num_layers=HYMBA_TRAIN_LAYERS, dtype="float32")
    params = M.init(cfg, seed=0, device="cuda")
    n, n_full = tree_size(params), tree_size(M.init(full, device="meta"))
    log(f"[train] 18e hymba-1.5b fp32 fine-tuned, depth cut from "
        f"{full.num_layers} to {cfg.num_layers} layers (global layers "
        f"{tuple(i for i in cfg.global_attn_layers if i < cfg.num_layers)}: "
        f"only layer 0 stays global): full depth's parameters, gradients and "
        f"AdamW moments ({n_full / 1e9:.3f} B x 16 bytes = "
        f"{n_full * 16 / 2 ** 30:.1f} GiB) beside the scan's saved states "
        f"leave too little of 80 GB; at {cfg.num_layers} layers "
        f"{n / 1e9:.3f} B parameters, {n * 16 / 2 ** 30:.1f} GiB for them")
    tc = TrainConfig(head_loss="random", lr=TRAIN_LR, warmup_steps=1,
                     schedule="constant")
    opt = optimizer_init(params, tc)
    gen = torch.Generator().manual_seed(1)
    batches = prefetch(MarkovLM(vocab=256, temperature=0.2, seed=0).batches(
        batch=4, seq_len=256, seed=2), device="cuda")
    torch.cuda.reset_peak_memory_stats()
    step = make_train_step(cfg, tc)
    params, opt, losses, ms, _ = run_steps(
        torch, step, params, opt, batches, gen, HYMBA_TRAIN_STEPS,
        "18e hymba fine-tuned")
    batches.close()
    step_report(torch, f"18e hymba-1.5b fine-tuned, {cfg.num_layers} layers, "
                f"B 4 x S 256 (+ {cfg.num_meta_tokens} meta)", ms, 4 * 256,
                card)
    check_loss_falls(losses, "18e hymba fine-tuned")
    del params, opt, step
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 19: llava-next-34b, the vision_text backbone behind 2,880 patches
# ---------------------------------------------------------------------------


LLAVA_FP32_LAYERS = 4      # 19a: 4 of 60 layers in fp32
LLAVA_BATCH = 4            # 19b: 2.76 GiB of bf16 KV at 3,016 positions a row
LLAVA_PARAMS = 36_737_948_672   # the reference's init, by jax.eval_shape
LLAVA_SERVE_CHUNK = 256    # 19b: at 512 keys the prefill's fp32 chunk scores
                           # did not fit beside 71.2 GiB of weights and KV
LLAVA_SERVE_NEW = 32       # 19b's new tokens (19a decodes 64)


def llava_batch(torch, cfg, prompts):
    """LLAVA_BATCH rows: the stub frontend's 2,880 patch embeddings
    (``stub_frontend_inputs`` from seed 0, as ``input_specs`` shapes them)
    before the first of phase 4's MarkovLM prompts of 64 tokens."""
    import numpy as np

    from repro_torch.data.pipeline import stub_frontend_inputs

    stub = stub_frontend_inputs(cfg, np.random.default_rng(0), LLAVA_BATCH, 64)
    return {"patch_embeds": torch.as_tensor(stub["patch_embeds"],
                                            device="cuda"),
            "tokens": prompts[:LLAVA_BATCH].contiguous()}


def phase_llava(torch, results):
    """Phase 19: llava-next-34b (60 layers, d 7168, 56/8 heads of 128,
    untied lm_head at vocab 64000) behind the full 2,880-patch prefix.
    19a fp32 at full width, depth cut to LLAVA_FP32_LAYERS (full depth is
    137 GiB in fp32), B 4 x 64-token prompts, 64 new tokens, block_k 8,
    the chain prefills in chunks of KV_CHUNK keys: greedy, BPD exact on
    both caches and topk_tree paged, each greedy's tokens (near-tie rule,
    each row's logits behind its own patches), launches exact;
    ``draft_model`` with a small text draft (the pairing the reference
    runs) greedy's tokens; one iteration with greedy's continuation as the
    proposals gives k̂ = 8 at the patch offset.  19b (``phase_llava_serve``)
    bf16 at full depth."""
    import numpy as np

    from repro_torch.config import DecodeConfig, get_config
    from repro_torch.core import decode as D
    from repro_torch.data.synthetic import MarkovLM
    from repro_torch.models import model as M

    name = "llava-next-34b"
    t0 = time.perf_counter()
    log(f"[llava] earlier phases freed: "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")
    full = get_config(name)
    cfg = full.replace(num_layers=LLAVA_FP32_LAYERS, dtype="float32")
    torch.cuda.reset_peak_memory_stats()
    params = M.init(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    prompts = torch.as_tensor(MarkovLM(vocab=256, temperature=0.2, seed=0)
                              .sample(np.random.default_rng(1), 8, 64),
                              device="cuda")
    batch = llava_batch(torch, cfg, prompts)
    ONE_DEVICE[(name, "prompts")] = prompts.cpu()      # phase 22's batch
    log(f"[llava] 19a {name} fp32 at {cfg.num_layers} of {full.num_layers} "
        f"layers (full depth's 36.74 B parameters take 137 GiB in fp32): "
        f"{n_params / 1e9:.3f} B parameters, d {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.resolved_head_dim}, "
        f"vocab {cfg.vocab_size}; batch {tuple(batch['patch_embeds'].shape)} "
        f"patches + {tuple(batch['tokens'].shape)} tokens; "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")
    dec = DecodeConfig(max_new_tokens=64, block_k=cfg.bpd_k)
    paths = (("bpd exact dense", {}),
             ("bpd exact paged", dict(cache_backend="paged")),
             ("bpd topk_tree paged", dict(policy="topk_tree", top_k=2,
                                          cache_backend="paged")))
    g_toks, _ = family_paths(torch, M, D, params, cfg, dec, batch, 64, paths,
                             name, kv_chunk=KV_CHUNK)

    phase_draft_small(torch, M, D, params, cfg, dec, batch, g_toks, 64,
                      label="19a llava, a patch-prefixed primary",
                      kv_chunk=KV_CHUNK)
    rollback_check(torch, M, D, params, cfg, dec, batch, g_toks, 64, "llava",
                   kv_chunk=KV_CHUNK, corrupts=(None,))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[llava] 19a fp32 peak {peak:.2f} GiB; "
        f"{time.perf_counter() - t0:.1f}s")
    check(peak < FAMILY_MEM_GIB, f"{name}: the fp32 decodes peak at "
                                 f"{peak:.2f} GiB")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    phase_llava_serve(torch, full, batch)
    log(f"[llava] {name} {time.perf_counter() - t0:.1f}s")


def phase_llava_serve(torch, full, batch):
    """19b: llava-next-34b at full depth, its parameters drawn in bf16 on
    the card (never an fp32 init cast down: that is 137 GiB), all 36.74 B
    of them, before any workspace; BPD exact on the dense cache through
    DecodeSession(kv_chunk=LLAVA_SERVE_CHUNK) behind the 2,880 patches:
    tokens/s, k̂, iterations, launches exact; bf16 greedy, each row's first
    divergence from BPD a near-tie of at most BF16_TIE_ULPS; one iteration
    profiled; the peak memory; then repro_torch.launch.serve --full-config
    with the reference's 4 zero patches on the same weights."""
    from repro_torch import serving
    from repro_torch.config import DecodeConfig
    from repro_torch.core import decode as D
    from repro_torch.kernels import _build
    from repro_torch.launch import serve
    from repro_torch.models import model as M

    cfg = full.replace(param_dtype="bfloat16")
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = M.init(cfg, seed=0, device="cuda")
    M.cast_for_compute(params, cfg)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    log(f"[llava] 19b {cfg.name} bf16 at full depth ({cfg.num_layers} layers): "
        f"{n_params:,} parameters, init {time.perf_counter() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")
    check(n_params == LLAVA_PARAMS, f"llava-next-34b: {n_params} parameters, "
                                    f"the reference's init has {LLAVA_PARAMS}")
    dec = DecodeConfig(max_new_tokens=LLAVA_SERVE_NEW, block_k=cfg.bpd_k)
    sess = serving.DecodeSession(params, cfg, dec, kv_chunk=LLAVA_SERVE_CHUNK)
    _build.reset_launches()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    toks, stats = sess.decode(batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = dict(_build.LAUNCHES)
    iters = stats["iterations"]
    check_launches(launches, dict(verify_attention=cfg.num_layers * iters,
                                  fused_verify=iters, fused_heads=iters + 1),
                   "19b bf16 exact dense")
    generated = int(stats["generated"].sum())
    log(f"[llava] 19b bf16 BPD exact dense, B {LLAVA_BATCH} behind "
        f"{batch['patch_embeds'].shape[1]} patches: {generated / wall:.1f} "
        f"tokens/s ({generated} tokens, host wall {wall * 1e3:.1f} ms with "
        f"the prefill), k̂={stats['mean_accepted']:.4f}, iterations={iters}, "
        f"launches {launches}")
    g_toks, _ = sess.greedy(batch)
    torch.cuda.synchronize()
    end = 64 + dec.max_new_tokens
    same = toks[:, 64:end] == g_toks[:, 64:end]
    div = report_divergences(torch, causal_logits_after(torch, M, params, cfg,
                                                        batch),
                             toks, g_toks, 64, end)
    log(f"[llava] 19b BPD vs bf16 greedy: agreement "
        f"{float(same.float().mean()):.4f} of tokens, "
        f"{int(same.all(dim=1).sum())}/{LLAVA_BATCH} rows identical; first "
        f"divergences at {[round(d['bpd_ulps'], 3) for d in div]} ulps below "
        f"the top")
    check(all(d["tie"] for d in div), f"19b: a bf16 divergence beyond "
                                      f"{BF16_TIE_ULPS} ulps")
    profile_iteration(torch, D, params, cfg, dec, batch,
                      "llava-next-34b exact dense, 2,880 patches",
                      kv_chunk=LLAVA_SERVE_CHUNK)
    rows = batch["patch_embeds"].shape[1] + end + dec.block_k
    kv = (cfg.num_layers * 2 * cfg.num_kv_heads * cfg.resolved_head_dim * 2
          * LLAVA_BATCH * rows)
    log(f"[llava] 19b peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} "
        f"GiB allocated (weights {n_params * 2 / 2 ** 30:.2f} GiB, dense KV "
        f"{kv / 2 ** 30:.2f} GiB for {LLAVA_BATCH} rows of {rows} positions)")
    del sess
    _build.reset_launches()
    out = serve.main(["--arch", cfg.name, "--full-config", "--batch",
                      str(LLAVA_BATCH), "--prompt-len", "64", "--max-new", "16",
                      "--kv-chunk", str(LLAVA_SERVE_CHUNK), "--seed", "0"],
                     params=params)
    launches = dict(_build.LAUNCHES)
    pe = out["batch"]["patch_embeds"]
    check(tuple(pe.shape) == (LLAVA_BATCH, 4, cfg.d_model)
          and not bool(pe.any()), f"19b launcher: patches {tuple(pe.shape)}")
    s_stats = out["stats"]
    check(launches["verify_attention"]
          == 2 * cfg.num_layers * s_stats["iterations"],
          f"19b launcher: launches {launches}")
    log(f"[llava] 19b launcher (--full-config, the reference's 4 zero "
        f"patches, 16 new tokens): "
        f"{int(s_stats['generated'].sum()) / out['wall_s']:.1f} tokens/s, "
        f"k̂={s_stats['mean_accepted']:.4f}, iterations "
        f"{s_stats['iterations']}, launches {launches}")
    del params, out
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 20: hubert-xlarge, encoder-only masked-prediction training
# ---------------------------------------------------------------------------


HUBERT_STEPS = 13     # 20b: 2 warm-up, 10 timed, 1 profiled
HUBERT_B, HUBERT_S = 8, 512


def phase_hubert(torch, card):
    """Phase 20: 20a one make_train_step card vs CPU at a narrow
    encoder-only geometry (d 320, 4 heads of 80, 2 layers, vocab 504;
    ``card_vs_cpu`` on MaskedFrames).  20b hubert-xlarge at full width and
    depth (48 layers, d 1280, 16 heads of 80: attention in plain PyTorch,
    no hand-written kernel) in fp32, AdamW on MaskedFrames batches of
    HUBERT_B x HUBERT_S: step ms, training frames/s, peak, one step
    profiled; every loss finite.  Then repro_torch.launch.train on the
    smoke config for 2 steps."""
    from repro_torch.config import TrainConfig, get_config
    from repro_torch.data.pipeline import prefetch
    from repro_torch.data.synthetic import MaskedFrames
    from repro_torch.launch import train
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model as M
    from repro_torch.optim import optimizer_init
    from repro_torch.utils.tree import tree_size

    t0 = time.perf_counter()
    full = get_config("hubert-xlarge").replace(dtype="float32")
    narrow = full.replace(num_layers=2, d_model=320, num_heads=4,
                          num_kv_heads=4, d_ff=1280, max_seq_len=64)
    card_vs_cpu(torch, narrow, {"masked prediction": (
        TrainConfig(lr=1e-4, warmup_steps=1), None, False)},
        "20a hubert narrow (d 320, 4 heads of 80)")

    params = M.init(full, seed=0, device="cuda")
    n = tree_size(params)
    log(f"[train] 20b hubert-xlarge fp32 at full width and depth "
        f"({full.num_layers} layers, d {full.d_model}, {full.num_heads} heads "
        f"of {full.resolved_head_dim}, codebook {full.vocab_size}): "
        f"{n / 1e9:.3f} B parameters, {n * 16 / 2 ** 30:.1f} GiB with "
        f"gradients and AdamW moments")
    tc = TrainConfig(lr=1e-4, warmup_steps=1, schedule="constant")
    opt = optimizer_init(params, tc)
    frames = MaskedFrames(full.d_model, codebook=min(full.vocab_size, 504),
                          seed=0)
    batches = prefetch(frames.batches(batch=HUBERT_B, seq_len=HUBERT_S, seed=1),
                       device="cuda")
    torch.cuda.reset_peak_memory_stats()
    step = make_train_step(full, tc)
    params, opt, losses, ms, _ = run_steps(
        torch, step, params, opt, batches, torch.Generator().manual_seed(1),
        HUBERT_STEPS, "20b hubert-xlarge")
    batches.close()
    step_report(torch, f"20b hubert-xlarge, {full.num_layers} layers, B "
                f"{HUBERT_B} x S {HUBERT_S} frames", ms, HUBERT_B * HUBERT_S,
                card)
    check(all(x == x and abs(x) < float("inf") for x in losses),
          f"20b: losses {losses}")
    del params, opt, step
    gc.collect()
    torch.cuda.empty_cache()
    out = train.main(["--arch", "hubert-xlarge", "--steps", "2", "--batch",
                      "2", "--seq", "64", "--log-every", "1"])
    loss = float(out["metrics"]["loss"])
    check(loss == loss, f"20 launcher: loss {loss}")
    log(f"[train] 20 repro_torch.launch.train --arch hubert-xlarge (smoke "
        f"config, 2 steps on the card): loss {loss:.4f}; phase 20 "
        f"{time.perf_counter() - t0:.1f}s")


# ---------------------------------------------------------------------------
# phase 21: RWKV-6 training (the scan's backward) and the serving twins
# ---------------------------------------------------------------------------


RWKV_TRAIN_STEPS = 13   # 21b: 2 warm-up, 10 timed, 1 profiled
# 21a: u's gradient (the sum over every position of r k (dy . v), terms that
# largely cancel) moves by 7.4e-5 of its max when the scan's y moves by a
# relative 1e-7 and by 3.3e-4 at 1e-6 (tools/rwkv6_grad_noise.py, on the
# CPU); the card's chunked TF32-split scan leaves y about 6e-7 of its max
# from the plain recurrence.  So u's gradient is held at atol 1e-3 of its
# max, every other leaf at TRAIN_TOL.
RWKV_U_GRAD_ATOL = {"/tm/u": 1e-3}
RWKV_TRAIN_B, RWKV_TRAIN_S = 4, 512
RWKV_QUICKSTART = {"khat": 2.8235, "invocations": 18, "greedy": 49}  # the
# reference's CPU run of the quickstart recipe on rwkv6's smoke geometry


def example(name):
    """``examples/<name>.py`` as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check_scan_launches(label, steps, layers):
    """Every scan of a training run wrote checkpoints and had its backward:
    ``steps`` x ``layers`` of each, and nothing else launched."""
    from repro_torch.kernels import _build

    launch = dict(_build.LAUNCHES)
    want = {name: 0 for name in launch}
    want.update(rwkv6_scan=steps * layers, rwkv6_scan_bwd=steps * layers)
    check(launch == want and _build.CHECKPOINTED_SCANS == steps * layers,
          f"{label}: launches {launch}, {_build.CHECKPOINTED_SCANS} with "
          f"checkpoints; expected {want}, all with checkpoints")
    return launch


def phase_rwkv_train(torch, results, card):
    """Phase 21: 21a one make_train_step card vs CPU at a narrow rwkv6
    geometry (d 256, 4 heads of 64, 2 layers, d_ff 512, vocab 1024;
    ``card_vs_cpu``, u's gradient at RWKV_U_GRAD_ATOL), frozen with
    scheduled sampling and self targets, then fine-tuned; 21b rwkv6-1.6b at full width and depth in fp32, fine-tuned,
    AdamW, MarkovLM B 4 x S 512, 2 warm-up steps, 10 timed and one
    profiled: the loss falls, each step launches the scan with checkpoints
    and its backward once a layer; 21c the quickstart recipe on rwkv6's
    smoke geometry at vocab 32 and k 4 (300 steps): BPD exact emits
    greedy's tokens at k̂ > 1.5 in fewer invocations; 21d the example
    twins: serve_bpd_torch.py for granite-3-8b and rwkv6-1.6b (static) and
    granite-3-8b --continuous, each row or request greedy's tokens with
    exact launches, and translate_bpd_torch.py --quick."""
    import numpy as np

    from repro_torch.config import DecodeConfig, TrainConfig, get_config
    from repro_torch.core import decode as D
    from repro_torch.data.pipeline import prefetch
    from repro_torch.data.synthetic import MarkovLM
    from repro_torch.kernels import _build
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model as M
    from repro_torch.optim import optimizer_init
    from repro_torch.utils.tree import tree_size

    full = get_config("rwkv6-1.6b").replace(dtype="float32")

    # ---- 21a: a narrow step, card vs CPU -----------------------------------
    t0 = time.perf_counter()
    narrow = full.replace(num_layers=2, d_model=256, rwkv_head_dim=64,
                          d_ff=512, vocab_size=1024)
    _build.reset_launches()
    card_vs_cpu(torch, narrow, {
        "frozen, scheduled sampling (self targets)": (
            TrainConfig(freeze_base=True, scheduled_sampling=True,
                        ss_self_targets=True, lr=1e-4, warmup_steps=1), 3, True),
        "fine-tuned": (TrainConfig(lr=1e-4, warmup_steps=1), 2, False)},
        "21a rwkv6 narrow (d 256, 4 heads of 64)", grad_atol=RWKV_U_GRAD_ATOL)
    bwd = _build.LAUNCHES["rwkv6_scan_bwd"]
    check(bwd == _build.CHECKPOINTED_SCANS == narrow.num_layers,
          f"21a: {bwd} backward launches and {_build.CHECKPOINTED_SCANS} "
          f"checkpointed scans on the card, expected {narrow.num_layers} "
          f"(the fine-tuned step; the frozen one differentiates no scan)")
    log(f"[train] 21a: the fine-tuned card step launched the scan with "
        f"checkpoints and its backward {bwd} times each; "
        f"{time.perf_counter() - t0:.1f}s")

    # ---- 21b: rwkv6-1.6b at full width and depth ---------------------------
    t1 = time.perf_counter()
    params = M.init(full, seed=0, device="cuda")
    n = tree_size(params)
    log(f"[train] 21b rwkv6-1.6b fp32 fine-tuned at full width and depth "
        f"({full.num_layers} layers, d {full.d_model}, "
        f"{full.d_model // full.rwkv_head_dim} heads of {full.rwkv_head_dim}, "
        f"vocab {full.vocab_size}): {n / 1e9:.3f} B parameters, "
        f"{n * 16 / 2 ** 30:.1f} GiB with gradients and AdamW moments")
    tc = TrainConfig(head_loss="random", lr=TRAIN_LR, warmup_steps=1,
                     schedule="constant")
    opt = optimizer_init(params, tc)
    batches = prefetch(MarkovLM(vocab=256, temperature=0.2, seed=0).batches(
        batch=RWKV_TRAIN_B, seq_len=RWKV_TRAIN_S, seed=2), device="cuda")
    torch.cuda.reset_peak_memory_stats()
    step = make_train_step(full, tc)
    prof = {}
    _build.reset_launches()
    params, opt, losses, ms, _ = run_steps(
        torch, step, params, opt, batches, torch.Generator().manual_seed(1),
        RWKV_TRAIN_STEPS, "21b rwkv6-1.6b", profile=prof)
    batches.close()
    launch = check_scan_launches("21b", RWKV_TRAIN_STEPS,
                                 full.num_layers)
    results["rwkv6_scan_bwd"]["launches"] = launch["rwkv6_scan_bwd"]
    tokens = RWKV_TRAIN_B * RWKV_TRAIN_S
    step_report(torch, f"21b rwkv6-1.6b fine-tuned, {full.num_layers} layers, "
                f"B {RWKV_TRAIN_B} x S {RWKV_TRAIN_S}", ms, tokens, card)
    check(all(x == x and abs(x) < float("inf") for x in losses),
          f"21b: losses {losses}")
    check_loss_falls(losses, "21b rwkv6-1.6b")
    if prof.get("busy_ms"):
        busy = prof["busy"]
        total = prof["busy_ms"]
        fwd = sum(t for k, t in busy.items() if "rwkv6_scan_kernel" in k)
        bwd_ms = sum(t for k, t in busy.items() if "rwkv6_scan_bwd" in k)
        gemm = sum(t for k, t in busy.items() if "gemm" in k or "nvjet" in k)
        log(f"[train] 21b one step's device time {total:.1f} ms: the scan "
            f"{fwd:.2f} ms ({fwd / total:.3f}), its backward {bwd_ms:.2f} ms "
            f"({bwd_ms / total:.3f}), cuBLAS products {gemm:.1f} ms "
            f"({gemm / total:.3f}); launches per step: "
            f"{launch['rwkv6_scan'] // RWKV_TRAIN_STEPS} + "
            f"{launch['rwkv6_scan_bwd'] // RWKV_TRAIN_STEPS}")
    else:
        log("[train] 21b kernel shares: not measured (no profiler trace)")
    del params, opt, step
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[train] 21b {time.perf_counter() - t1:.1f}s")

    # ---- 21c: the quickstart recipe on rwkv6's smoke geometry --------------
    t2 = time.perf_counter()
    cfg = get_config("rwkv6-1.6b", smoke=True).replace(
        vocab_size=32, bpd_k=4, dtype="float32")
    qtc = TrainConfig(global_batch=16, seq_len=48, lr=3e-3, warmup_steps=30,
                      head_loss="mean")
    task = MarkovLM(vocab=cfg.vocab_size, temperature=0.12, seed=3)
    params = M.init(cfg, seed=0, device="cuda")
    opt = optimizer_init(params, qtc)
    step = make_train_step(cfg, qtc)
    data = task.batches(batch=qtc.global_batch, seq_len=qtc.seq_len, seed=1)
    gen = torch.Generator().manual_seed(1)
    _build.reset_launches()
    qlosses = []
    for _ in range(QUICKSTART_STEPS):
        b = {k: torch.as_tensor(v, device="cuda") for k, v in next(data).items()}
        params, opt, m = step(params, opt, b, gen)
        qlosses.append(m["loss"])
    qlosses = [float(x) for x in qlosses]
    check_scan_launches("21c training", QUICKSTART_STEPS, cfg.num_layers)
    prompts = torch.as_tensor(task.sample(np.random.default_rng(9), 8, 12),
                              device="cuda")
    dec = DecodeConfig(max_new_tokens=48, block_k=4, criterion="exact")
    batch = {"tokens": prompts}
    bt, bs = D.bpd_decode(params, cfg, dec, batch)
    gt, gs = D.greedy_decode(params, cfg, dec, batch)
    with torch.no_grad():
        after = causal_logits_after(torch, M, params, cfg)
        diverged = compare_rows(torch, after, bt, gt, bs["text_len"], 12)
    ref = RWKV_QUICKSTART
    log(f"[train] 21c quickstart recipe on rwkv6 (smoke geometry, vocab 32, "
        f"k 4, {QUICKSTART_STEPS} steps on the card): loss "
        f"{np.mean(qlosses[:10]):.4f} -> {np.mean(qlosses[-10:]):.4f}; BPD "
        f"k̂ {bs['mean_accepted']:.4f} in {bs['invocations']} invocations vs "
        f"greedy's {gs['invocations']} (the reference on the CPU, other "
        f"draws: {ref['khat']} in {ref['invocations']} vs {ref['greedy']}); "
        f"BPD == greedy in {8 - len(diverged)}/8 rows (others at near-ties); "
        f"{time.perf_counter() - t2:.1f}s; {card}")
    check(bs["mean_accepted"] > 1.5, f"21c: k̂ {bs['mean_accepted']} <= 1.5")
    check(bs["invocations"] < gs["invocations"],
          "21c: BPD needs no fewer invocations than greedy")
    del params, opt, step

    # ---- 21d: the example twins --------------------------------------------
    t3 = time.perf_counter()
    serve_twin = example("serve_bpd_torch")
    for arch in ("granite-3-8b", "rwkv6-1.6b"):
        scfg = get_config(arch, smoke=True).replace(dtype="float32")
        _build.reset_launches()
        params, stask = serve_twin.train(scfg, 150, torch.device("cuda"))
        if scfg.block_type == "rwkv6":
            check_scan_launches(f"21d {arch} training", 150,
                                scfg.num_layers)
        _build.reset_launches()
        out = serve_twin.serve_static(params, scfg, stask,
                                      np.random.default_rng(7), batch=4,
                                      max_new=24, dev=torch.device("cuda"))
        launch = dict(_build.LAUNCHES)
        state, it = out["state"], out["iterations"]
        want = {name: 0 for name in launch}
        want.update(fused_verify=it, fused_heads=it + 1)
        if scfg.block_type == "rwkv6":
            want["rwkv6_scan"] = scfg.num_layers
        else:
            want["verify_attention"] = scfg.num_layers * it
        check(launch == want and _build.CHECKPOINTED_SCANS == 0,
              f"21d {arch}: launches {launch}, expected {want}")
        gt, _ = D.greedy_decode(params, scfg, out["dec"], out["batch"])
        with torch.no_grad():
            diverged = compare_rows(torch, causal_logits_after(
                torch, M, params, scfg), state.tokens, gt, state.text_len,
                serve_twin.PROMPT_LEN)
        check(bool((state.generated == 24).all()), f"21d {arch}: short rows")
        log(f"[twins] 21d serve_bpd_torch {arch}: {int(state.generated.sum())} "
            f"tokens in {it} serve steps, {out['wall_s'] * 1e3:.1f} ms; rows "
            f"== greedy_decode's in {4 - len(diverged)}/4 (others at "
            f"near-ties); launches {launch} (exact)")
        if arch == "granite-3-8b":
            _build.reset_launches()
            cont = serve_twin.serve_continuous(
                params, scfg, stask, np.random.default_rng(7), batch=4,
                max_new=24, dev=torch.device("cuda"))
            launch = dict(_build.LAUNCHES)
            engine = cont["engine"]
            fwd = sum(g.num_forwards for g in engine.groups)
            pre = sum(g.num_prefills for g in engine.groups)
            want = {name: 0 for name in launch}
            want.update(verify_attention=scfg.num_layers * fwd,
                        fused_verify=fwd, fused_heads=fwd + pre)
            check(launch == want, f"21d continuous: launches {launch}, "
                                  f"expected {want}")
            done = {f.rid: f for f in cont["finished"]}
            check(sorted(done) == [r.rid for r in cont["requests"]],
                  "21d continuous: requests lost")
            ties = 0
            for req in cont["requests"]:
                prompt = torch.as_tensor(req.prompt, device="cuda")
                g, _ = D.greedy_decode(
                    params, scfg, cont["dec"].replace(max_new_tokens=req.max_new),
                    {"tokens": prompt[None]})
                want_t = g[0, len(req.prompt):len(req.prompt) + req.max_new]
                got_t = [int(x) for x in done[req.rid].tokens]
                if got_t == want_t.tolist():
                    continue
                p = next(i for i, (a, b) in enumerate(zip(got_t, want_t.tolist()))
                         if a != b)
                with torch.no_grad():
                    gap = near_tie(torch, M, params, scfg,
                                   g[0, :len(req.prompt) + p])
                check(gap < TIE_MARGIN, f"21d continuous: request {req.rid} "
                                        f"differs from greedy at new token {p} "
                                        f"with no near-tie ({gap})")
                ties += 1
            log(f"[twins] 21d serve_bpd_torch granite-3-8b --continuous: "
                f"{len(done)} requests through 4 slots in {cont['steps']} "
                f"engine steps, {len(done) - ties}/{len(done)} equal to their "
                f"greedy_decode alone (others at near-ties); launches {launch} "
                f"(exact: {fwd} forwards, {pre} prefills)")
        del params
    from repro_torch.models import seq2seq as S

    trans = example("translate_bpd_torch").main(["--quick", "--device", "cuda"])
    gt, _ = D.greedy_decode_seq2seq(trans["params"], trans["cfg"], trans["dec"],
                                    trans["batch"])
    n = trans["dec"].max_new_tokens
    with torch.no_grad():
        diverged = compare_rows(torch, mt_logits_after(
            torch, S, trans["params"], trans["cfg"], trans["batch"]["src"]),
            trans["tokens"][:, :n], gt[:, :n],
            torch.full((gt.shape[0],), n), 0)
    trace_khat = len(trans["trace_tokens"]) / trans["trace_steps"]
    log(f"[twins] 21d translate_bpd_torch --quick: trace {trace_khat:.4f} "
        f"tokens a step ({trans['trace_steps']} steps), batch k̂ "
        f"{trans['stats']['mean_accepted']:.4f} (the slowest row's: the "
        f"reference's own --quick run on the CPU gives 1.00), BPD == greedy "
        f"in {gt.shape[0] - len(diverged)}/{gt.shape[0]} rows (others at "
        f"near-ties); {time.perf_counter() - t3:.1f}s; phase 21d {card}")
    check(trace_khat > 1, f"21d translate: the trace accepted {trace_khat} "
                          f"tokens a step")


# ---------------------------------------------------------------------------
# phase 11: training (the paper's §6 loss, AdamW, checkpoints, the launcher)
# ---------------------------------------------------------------------------


TRAIN_TOL = {"rtol": 1e-4, "atol_of_max": 1e-5}   # card vs CPU, fp32, per leaf
TRAIN_STEPS = 20                                   # per run of 11b and 11c
TRAIN_LR = 3e-5      # 11b / 11c, constant: in trials on the card, higher
                     # rates made these 20-step runs diverge


def leaf_checksums(torch, params, names):
    """One int64 per leaf: the sum of its fp32 words as integers, so any
    changed bit of a leaf changes it (almost surely)."""
    leaves = dict(_named(params))
    return torch.stack([leaves[n].detach().view(torch.int32).sum(dtype=torch.int64)
                        for n in names]).cpu()


def _named(params):
    from repro_torch.utils.tree import flatten_with_names
    return flatten_with_names(params)


def run_steps(torch, step, params, opt, batches, gen, n, label, *,
              keep=(), profile=None):
    """``n`` training steps, each synced and timed on the host clock, the
    last one also under torch.profiler (device busy against the median
    step, the top kernels); returns (params, opt, losses, per-step ms of
    the first n - 1, last metrics).  The metrics named in ``keep`` are
    printed step by step; ``profile``, a dict, receives the profiled
    step's device busy ms and {kernel name: ms}."""
    losses, ms, kept = [], [], []
    for _ in range(n - 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, next(batches), gen)
        losses.append(float(m["loss"]))            # waits for the step
        ms.append((time.perf_counter() - t0) * 1e3)
        kept.append([float(m[k]) for k in keep])
    batch = next(batches)
    torch.cuda.synchronize()
    (params, opt, m), busy_ms, count, busy = profiled_busy(
        torch, lambda: step(params, opt, batch, gen))
    if profile is not None:
        profile.update(busy_ms=busy_ms, busy=busy)
    losses.append(float(m["loss"]))
    kept.append([float(m[k]) for k in keep])
    if keep:
        log(f"[train] {label}: {' / '.join(keep)} per step "
            f"{[[round(x, 4) for x in row] for row in kept]}")
    log(f"[train] {label}: losses {[round(x, 4) for x in losses]}")
    if busy_ms is not None:
        steady = median_after_warmup(ms)
        gemm = sum(t for k, t in busy.items() if "gemm" in k or "nvjet" in k)
        log(f"[train] {label}: one step profiled: {count} kernels, device busy "
            f"{busy_ms:.1f} ms against the median step's {steady:.1f} ms (idle "
            f"share {1 - busy_ms / steady:.3f}); cuBLAS products {gemm:.1f} ms")
        for name, t in sorted(busy.items(), key=lambda kv: -kv[1])[:6]:
            log(f"    {t:8.3f} ms  {name[:90]}")
    return params, opt, losses, ms, m


def median_after_warmup(ms):
    steady = sorted(ms[2:])
    return steady[len(steady) // 2]


def step_report(torch, label, ms, tokens, card):
    """Step ms (median after 2 warm-up steps), tokens/s and peak memory."""
    med = median_after_warmup(ms)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[train] {label}: step {med:.1f} ms (median of {len(ms) - 2} after 2 "
        f"warm-up; first {ms[0]:.1f} ms), {tokens / med * 1e3:,.0f} training "
        f"tokens/s ({tokens} a step), peak {peak:.2f} GiB allocated; {card}")


def check_loss_falls(losses, label):
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    check(last < first, f"{label}: loss did not fall (first 5 mean {first:.4f}, "
                        f"last 5 mean {last:.4f})")
    log(f"[train] {label}: loss falls, first 5 mean {first:.4f} -> last 5 "
        f"mean {last:.4f}")


def leaf_within(name, got, want, label, arel=None):
    """``got`` within TRAIN_TOL of ``want`` (the atol a fraction of
    ``want``'s max |value|, ``arel`` where given); returns the worst share
    of the tolerance."""
    rtol = TRAIN_TOL["rtol"]
    arel = TRAIN_TOL["atol_of_max"] if arel is None else arel
    err = (got - want).abs()
    tol = arel * float(want.abs().max()) + rtol * want.abs()
    over = err > tol
    check(not bool(over.any()), f"{label}: {name} differs by up to "
                                f"{float(err.max()):.3g} at {int(over.sum())} elements")
    return float((err / tol.clamp(min=1e-30)).max())


def phase_train_card_vs_cpu(torch, card):
    """11a: one make_train_step on the card and on the CPU from the same
    fp32 weights and batch at granite's attention width (``card_vs_cpu``),
    frozen with scheduled sampling and self targets, then fine-tuned."""
    from repro_torch.config import TrainConfig, get_config

    cfg = get_config("granite-3-8b").replace(
        num_layers=2, d_ff=1024, bpd_hidden=1024, vocab_size=4096,
        dtype="float32")
    runs = {
        "frozen, scheduled sampling (self targets)": (
            TrainConfig(freeze_base=True, scheduled_sampling=True,
                        ss_self_targets=True, lr=1e-4, warmup_steps=1), 3, True),
        "fine-tuned": (TrainConfig(lr=1e-4, warmup_steps=1), 2, False),
    }
    card_vs_cpu(torch, cfg, runs, "11a")
    log(f"[train] 11a passed; {card}")


def card_vs_cpu(torch, cfg, runs, tag, grad_atol=None):
    """One make_train_step of ``cfg`` on the card and on the CPU from the
    same fp32 weights (seed 0) and batch (B 2 x S 64 MarkovLM, MaskedFrames
    for an audio encoder), for each of
    ``runs`` ({label: (TrainConfig, head index, frozen)}), head index and
    swap mask injected: the loss, the gradient norm, an MoE model's three
    metrics and every gradient agree within TRAIN_TOL, and every leaf the
    card updated equals the CPU's optimizer applied to the card's
    gradients.  Against the CPU's own step an AdamW element may differ more
    where |g| is near eps: g/(|g| + eps) amplifies the gradients' fp32
    difference there (and a gradient within its tolerance of zero can take
    either sign); such elements are counted.  An MoE model's routings are
    recorded on both sides: each layer's kept and dropped assignments must
    be equal.  ``grad_atol`` ({leaf name suffix: atol as a fraction of the
    leaf's max}) holds the gradients of those leaves to another atol."""
    import copy

    import numpy as np

    from repro_torch.data.synthetic import MarkovLM, MaskedFrames
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model as M
    from repro_torch.optim import freeze_mask, optimizer_init, optimizer_update

    if cfg.modality == "audio":
        data = MaskedFrames(cfg.d_model, codebook=min(cfg.vocab_size, 504),
                            seed=0).sample(np.random.default_rng(2), 2, 64)
    else:
        data = {"tokens": MarkovLM(vocab=256, temperature=0.2, seed=0).sample(
            np.random.default_rng(2), 2, 64)}
    swap = torch.as_tensor(np.random.default_rng(3).random((2, 64)) < 0.5)
    rtol, arel = TRAIN_TOL["rtol"], TRAIN_TOL["atol_of_max"]
    moe_keys = ("moe_aux_loss", "moe_z_loss", "moe_dropped_frac")
    for label, (tc, head, frozen) in runs.items():
        t0 = time.perf_counter()
        cpu = M.init(cfg, seed=0, device="cpu")
        dev = copy.deepcopy(cpu).to("cuda")
        mask = freeze_mask(cpu, train_only_heads=True) if frozen else None
        out = {}
        for side, params in (("cpu", cpu), ("cuda", dev)):
            step = make_train_step(cfg, tc, mask)
            batch = {k: torch.as_tensor(v, device=side)
                     for k, v in data.items()}
            with routes_for(torch, cfg) as rec:
                _, _, m = step(params, optimizer_init(params, tc, mask), batch,
                               None, head_idx=head, swap=swap)
            grads = {n: p.grad.cpu() for n, p in _named(params) if p.grad is not None}
            out[side] = (float(m["loss"]), float(m["grad_norm"]), grads,
                         {k: float(m[k]) for k in moe_keys if k in m}, rec)
        (l_cpu, n_cpu, g_cpu, x_cpu, r_cpu), (l_card, n_card, g_card, x_card,
                                              r_card) = out["cpu"], out["cuda"]
        log(f"[train] {tag} {label}: loss card {l_card:.6f} / cpu {l_cpu:.6f}, "
            f"grad norm {n_card:.6f} / {n_cpu:.6f}, head {head}")
        check(abs(l_card - l_cpu) <= rtol * abs(l_cpu),
              f"{tag} {label}: loss {l_card} on the card, {l_cpu} on the CPU")
        check(abs(n_card - n_cpu) <= rtol * abs(n_cpu),
              f"{tag} {label}: grad norm {n_card} on the card, {n_cpu} on the "
              f"CPU")
        for k, want in x_cpu.items():
            log(f"[train] {tag} {label}: {k} card {x_card[k]:.6f} / cpu "
                f"{want:.6f}")
            check(abs(x_card[k] - want) <= rtol * abs(want) + 1e-7,
                  f"{tag} {label}: {k} {x_card[k]} on the card, {want} on "
                  f"the CPU")
        if r_cpu is not None:
            check_same_dispatch(torch, cfg, r_cpu, r_card, f"{tag} {label}")
        check(sorted(g_card) == sorted(g_cpu), f"{tag} {label}: other leaves "
                                               f"got gradients on the card")
        def arel_of(n):
            return next((a for sfx, a in (grad_atol or {}).items()
                         if n.endswith(sfx)), None)

        worst = max((leaf_within(f"grad {n}", g_card[n], g, f"{tag} {label}",
                                 arel_of(n)), n)
                    for n, g in g_cpu.items())
        for sfx, a in (grad_atol or {}).items():
            errs = [float(((g_card[n] - g).abs().max()) / g.abs().max())
                    for n, g in g_cpu.items() if n.endswith(sfx)]
            if errs:
                log(f"[train] {tag} {label}: gradients of *{sfx} held at atol "
                    f"{a} of their max (not {TRAIN_TOL['atol_of_max']}): "
                    f"worst |card - cpu| {max(errs):.3g} of the max")
        replay = M.init(cfg, seed=0, device="cpu")     # the step's start
        optimizer_update(g_card, optimizer_init(replay, tc, mask), replay, tc,
                         mask=mask)
        amplified = 0
        cpu_leaves, replay_leaves = dict(_named(cpu)), dict(_named(replay))
        for n, p in _named(dev):
            got = p.detach().cpu()
            worst = max(worst, (leaf_within(n, got, replay_leaves[n].detach(),
                                            f"{tag} {label} (update)"), n))
            want = cpu_leaves[n].detach()
            amplified += int(((got - want).abs() > arel * float(want.abs().max())
                              + rtol * want.abs()).sum())
        log(f"[train] {tag} {label}: {len(g_cpu)} gradients agree with the "
            f"CPU's and {len(replay_leaves)} updated leaves with the CPU's "
            f"update of the card's gradients (rtol {rtol}, atol {arel} of each "
            f"leaf's max; worst {worst[1]} at {worst[0]:.3f} of its "
            f"tolerance); {amplified} elements beyond it from the CPU's own "
            f"step (AdamW near eps); {time.perf_counter() - t0:.1f}s")
        del cpu, dev, replay, out
        gc.collect()
        torch.cuda.empty_cache()


def check_same_dispatch(torch, cfg, cpu_routes, card_routes, label):
    """The capacity-bounded dispatch of every MoE layer of one training
    forward, from each side's router logits: the same experts chosen and
    the same assignments kept (``moe.assignment_ranks`` < capacity)."""
    from repro_torch.models import moe

    fwd = list(zip(cpu_routes.recs, card_routes.recs))
    check(len(cpu_routes.recs) == len(card_routes.recs) > 0,
          f"{label}: {len(cpu_routes.recs)} MoE layers ran on the CPU, "
          f"{len(card_routes.recs)} on the card")
    dropped = []
    for (layer, _, lc), (_, _, lg) in fwd:
        keeps = []
        for logits in (lc, lg.cpu()):
            b, s, _ = logits.shape
            ids = moe.top_experts(torch.softmax(logits, -1),
                                  cfg.num_experts_per_tok)
            flat = ids.reshape(b, -1)
            keeps.append((flat, moe.assignment_ranks(flat)
                          < moe.capacity(cfg, s)))
        (ic, kc), (ig, kg) = keeps
        check(torch.equal(ic, ig) and torch.equal(kc, kg),
              f"{label}: layer {layer} routes or keeps other assignments on "
              f"the card ({int((ic != ig).sum())} ids, {int((kc != kg).sum())} "
              f"kept flags differ)")
        dropped.append(int((~kc).sum()))
    check(sum(dropped) > 0, f"{label}: capacity dropped no assignment")
    log(f"[train] {label}: every MoE layer chose the same experts and kept "
        f"the same assignments on both sides; dropped per layer {dropped} of "
        f"{kc.numel()}")


def phase_train_frozen(torch, phase4, card):
    """11b: the paper's frozen-base setting on granite-3-8b at full width
    and depth: only the heads train; the base stays bit for bit, so greedy
    is phase 4's and BPD (exact) emits it; k̂ before and after."""
    import numpy as np

    from repro_torch.config import DecodeConfig, TrainConfig, get_config
    from repro_torch.core import decode as D
    from repro_torch.data.pipeline import prefetch
    from repro_torch.data.synthetic import MarkovLM
    from repro_torch.kernels import _build
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model as M
    from repro_torch.optim import freeze_mask, optimizer_init
    from repro_torch.utils.tree import tree_size

    cfg = get_config("granite-3-8b").replace(dtype="float32")
    params = M.init(cfg, seed=0, device="cuda")         # phase 4's weights
    mask = freeze_mask(params, train_only_heads=True)
    heads = sum(p.numel() for n, p in _named(params) if mask[n] > 0)
    log(f"[train] 11b granite-3-8b fp32, frozen base: {tree_size(params) / 1e9:.3f} "
        f"B parameters, {heads / 1e9:.3f} B in the heads")
    base = [n for n, _ in _named(params) if mask[n] == 0]
    before = leaf_checksums(torch, params, base)
    prompts = phase4["prompts"].to("cuda")
    dec = DecodeConfig(max_new_tokens=64, block_k=cfg.bpd_k)
    layers = cfg.num_layers

    def bpd(label):
        _build.reset_launches()
        toks, stats = D.bpd_decode(params, cfg, dec, {"tokens": prompts})
        launches = dict(_build.LAUNCHES)
        iters = stats["iterations"]
        check(launches["verify_attention"] == layers * iters
              and launches["fused_verify"] == iters
              and launches["fused_heads"] == iters + 1,
              f"11b bpd {label}: launches {launches} for {iters} iterations")
        log(f"[train] 11b BPD exact {label}: k̂={stats['mean_accepted']:.4f} "
            f"iterations={iters}, launches {launches}")
        return toks, stats

    log(f"[train] 11b BPD exact before training: k̂={phase4['khat']:.4f} "
        f"iterations={phase4['iterations']} (phase 4's run on these weights)")
    tc = TrainConfig(freeze_base=True, head_loss="random", lr=TRAIN_LR,
                     warmup_steps=1, schedule="constant")
    opt = optimizer_init(params, tc, mask)
    gen = torch.Generator().manual_seed(0)
    batches = prefetch(MarkovLM(vocab=256, temperature=0.2, seed=0).batches(
        batch=4, seq_len=256, seed=1), device="cuda")
    torch.cuda.reset_peak_memory_stats()
    step = make_train_step(cfg, tc, mask)
    params, opt, losses, ms, m = run_steps(torch, step, params, opt, batches,
                                           gen, TRAIN_STEPS, "11b frozen")
    step_report(torch, "11b frozen, B 4 x S 256", ms, 4 * 256, card)
    log(f"[train] 11b grad norm (last step) {float(m['grad_norm']):.4f}")
    check_loss_falls(losses, "11b frozen")
    check(torch.equal(leaf_checksums(torch, params, base), before),
          "11b: a base parameter changed under the frozen base")
    log(f"[train] 11b: all {len(base)} base leaves bit for bit unchanged")

    g_toks, _ = D.greedy_decode(params, cfg, dec, {"tokens": prompts})
    check(torch.equal(g_toks.cpu(), phase4["greedy"]),
          "11b: greedy tokens after frozen training differ from phase 4's")
    log("[train] 11b: greedy tokens equal phase 4's in 8/8 rows")
    after = causal_logits_after(torch, M, params, cfg)
    b_toks, b_stats = bpd("after training")
    diverged = compare_rows(torch, after, b_toks, g_toks, b_stats["text_len"], 64)
    log(f"[train] 11b: BPD exact on the trained heads == greedy in "
        f"{8 - len(diverged)}/8 rows (others at near-ties)")

    tc_ss = tc.replace(scheduled_sampling=True, ss_self_targets=True)
    torch.cuda.reset_peak_memory_stats()
    step = make_train_step(cfg, tc_ss, mask)
    params, opt, losses, ms, m = run_steps(torch, step, params, opt, batches,
                                           gen, TRAIN_STEPS, "11b frozen, ss_self_targets")
    batches.close()
    step_report(torch, "11b frozen + scheduled sampling (self targets)", ms,
                4 * 256, card)
    check(torch.equal(leaf_checksums(torch, params, base), before),
          "11b: a base parameter changed under scheduled sampling")
    b_toks, b_stats = bpd("after ss_self_targets")
    diverged = compare_rows(torch, after, b_toks, g_toks, b_stats["text_len"], 64)
    log(f"[train] 11b: BPD exact after ss_self_targets == greedy in "
        f"{8 - len(diverged)}/8 rows (k̂ reported, not gated)")


def phase_train_finetune(torch, card):
    """11c: the fine-tuned base at granite's full width, 4 of 40 layers."""
    from repro_torch.config import TrainConfig, get_config
    from repro_torch.data.pipeline import prefetch
    from repro_torch.data.synthetic import MarkovLM
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model as M
    from repro_torch.optim import optimizer_init
    from repro_torch.utils.tree import tree_size

    full = get_config("granite-3-8b")
    cfg = full.replace(num_layers=4, dtype="float32")
    params = M.init(cfg, seed=0, device="cuda")
    n = tree_size(params)
    n_full = tree_size(M.init(full, device="meta"))
    log(f"[train] 11c granite-3-8b fp32 fine-tuned, depth cut from 40 to 4 "
        f"layers: full depth's parameters, gradients and AdamW moments "
        f"({n_full / 1e9:.3f} B x 16 bytes = {n_full * 16 / 2 ** 30:.1f} GiB) "
        f"do not fit in 80 GB; at 4 layers {n / 1e9:.3f} B parameters, "
        f"{n * 16 / 2 ** 30:.1f} GiB for them")
    watch = ["embed/table", "blocks/0/attn/wq", "blocks/3/mlp/w2/w"]
    before = leaf_checksums(torch, params, watch)
    tc = TrainConfig(head_loss="random", lr=TRAIN_LR, warmup_steps=1,
                     schedule="constant")
    opt = optimizer_init(params, tc)
    gen = torch.Generator().manual_seed(1)
    batches = prefetch(MarkovLM(vocab=256, temperature=0.2, seed=0).batches(
        batch=4, seq_len=256, seed=2), device="cuda")
    torch.cuda.reset_peak_memory_stats()
    step = make_train_step(cfg, tc)
    params, opt, losses, ms, m = run_steps(torch, step, params, opt, batches,
                                           gen, TRAIN_STEPS, "11c fine-tuned")
    batches.close()
    step_report(torch, "11c fine-tuned, 4 layers, B 4 x S 256", ms, 4 * 256, card)
    check_loss_falls(losses, "11c fine-tuned")
    moved = leaf_checksums(torch, params, watch) != before
    check(bool(moved.all()), f"11c: leaves that did not move: "
                             f"{[w for w, mv in zip(watch, moved) if not mv]}")
    log(f"[train] 11c: {watch} moved")


def phase_train_launcher(torch, card):
    """11d: paper-mt-base at full size through the entry point, checkpoint
    restored bit for bit and decoded, then a resumed run."""
    import tempfile

    import numpy as np

    from repro_torch.checkpoint import latest_step, restore
    from repro_torch.config import DecodeConfig, TrainConfig
    from repro_torch.core import decode as D
    from repro_torch.data.pipeline import prefetch
    from repro_torch.data.synthetic import PhraseMT
    from repro_torch.launch import train as train_launch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import optimizer_init

    steps, more = 20, 10
    with tempfile.TemporaryDirectory() as ckpt_dir:
        argv = ["--arch", "paper-mt-base", "--full-config", "--batch", "8",
                "--seq", "64", "--lr", "3e-4", "--log-every", "5",
                "--ckpt-dir", ckpt_dir]
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = train_launch.main(argv + ["--steps", str(steps)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        cfg, params = out["cfg"], out["params"]
        log(f"[train] 11d paper-mt-base: {steps} steps through "
            f"repro_torch.launch.train in {wall:.1f}s (init and checkpoint "
            f"included), peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} "
            f"GiB allocated; {card}")
        check(latest_step(ckpt_dir) == steps, "11d: no final checkpoint")
        restored, extra = restore(ckpt_dir, params)
        check(extra == {"arch": "paper-mt-base"}, f"11d: extra {extra}")
        same = [torch.equal(a, b) for (_, a), (_, b) in zip(_named(restored),
                                                            _named(params))]
        check(all(same) and len(same) == len(_named(params)),
              "11d: a restored parameter differs from the trained one")
        log(f"[train] 11d: {len(same)} restored leaves equal the trained ones "
            f"bit for bit")
        task = PhraseMT(vocab=cfg.vocab_size, expand=2, seed=1)
        src = torch.as_tensor(task.make_pair(np.random.default_rng(5), 8, 32)[0],
                              device="cuda")
        dec = DecodeConfig(max_new_tokens=64, block_k=cfg.bpd_k)
        a, sa = D.bpd_decode_seq2seq(params, cfg, dec, {"src": src})
        b, sb = D.bpd_decode_seq2seq(restored, cfg, dec, {"src": src})
        check(torch.equal(a, b) and sa["iterations"] == sb["iterations"],
              "11d: the restored weights decode other tokens")
        log(f"[train] 11d: bpd_decode_seq2seq on the restored weights == on "
            f"the trained ones (8 sources x 32, 64 new tokens, k̂="
            f"{sa['mean_accepted']:.4f}, {sa['iterations']} iterations)")
        again = train_launch.main(argv + ["--steps", str(steps + more)])
        check(again["start"] == steps and latest_step(ckpt_dir) == steps + more,
              f"11d: the second run started at {again['start']}")
        log(f"[train] 11d: a second run resumed at step {again['start']} and "
            f"saved step {latest_step(ckpt_dir)}")
    # the launcher's step, timed and profiled outside it on the trained weights
    tc = TrainConfig(global_batch=8, seq_len=64, lr=3e-4, steps=steps,
                     warmup_steps=10)
    batches = prefetch(train_launch.data_for(cfg, 8, 64, 1), device="cuda")
    torch.cuda.reset_peak_memory_stats()
    params, _, _, ms, _ = run_steps(torch, make_train_step(cfg, tc), params,
                                    optimizer_init(params, tc), batches,
                                    torch.Generator().manual_seed(2), 8,
                                    "11d paper-mt-base")
    batches.close()
    step_report(torch, "11d paper-mt-base, B 8 x (32 + 64)", ms, 8 * 64, card)


def phase_train(torch, phase4):
    card = card_line()
    t0 = time.perf_counter()
    phase_train_card_vs_cpu(torch, card)
    phase_train_frozen(torch, phase4, card)
    gc.collect()
    torch.cuda.empty_cache()
    phase_train_finetune(torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    phase_train_launcher(torch, card)
    log(f"[train] phase 11 {time.perf_counter() - t0:.1f}s")


# ---------------------------------------------------------------------------
# phase 22: sharded serving on ("data", "model") and ("pod", "data",
# "model") meshes of processes: the static serve, the engine, the HTTP server
# ---------------------------------------------------------------------------


# granite-3-8b's fp32 depth on the mesh: 2 of 40 layers, cut from the 10
# of its other fp32 paths to keep the script within 900 s (and from 4 to 2
# to pay for the sharded families)
MESH_FP32_LAYERS = 2
MESH_RANKS_S = 900         # the four ranks' time limit, their start included
MESH_BUDGETS = (64, 16, 40, 56, 24, 48, 32, 8)
MESH_PATHS = {            # label -> (DecodeConfig keywords, BPD?, budgets?)
    "greedy": ({}, False, False),
    "exact dense": ({}, True, False),
    "exact paged": ({"cache_backend": "paged"}, True, False),
    "topk_tree dense": ({"policy": "topk_tree", "top_k": 2}, True, False),
    "exact budgets": ({}, True, True),
}
MESH_RUNS = {(1, 2): tuple(MESH_PATHS), (2, 2): ("exact dense",)}
# the (1, 2) paths split between the pair of ranks 0, 1 and the pair of
# ranks 2, 3, which run them side by side on the card (ranks 0, 1 then
# serve the engine over (1, 2), whose collectives make it 4x the (2, 1)
# engine of ranks 2, 3: so these take the third path)
MESH_PAIR_PATHS = (("greedy", "exact dense"),
                   ("exact paged", "topk_tree dense", "exact budgets"))
GLOO_DTYPES = ("float32", "bfloat16", "float16", "int32", "int64")
# the engine on the mesh, phase 5c's plan and groups: label -> (DecodeConfig
# keywords, EngineConfig keywords); the unified runs over (1, 2) on ranks 0,
# 1 beside (2, 1) on ranks 2, 3, the disaggregated one over the pod mesh
# (2, 1, 2) of all four (each pod prefills 2 of a batch of 4 and hands them
# to every rank over ``pod``)
MESH_ENGINE_RUNS = {
    "unified dense": ({"cache_backend": "dense"}, {}),
    "unified paged": ({"cache_backend": "paged"}, {}),
    "disaggregated dense, windows of 4": (
        {"cache_backend": "dense"}, {"prefill_slots": 4, "steps_per_sync": 4}),
}
MESH_ENGINE_PAIRS = ("unified dense", "unified paged")
ENGINE_KERNELS = ("verify_attention", "tree_verify_attention",
                  "paged_verify_attention", "fused_heads", "fused_verify")
# the MoE, RWKV-6 and Hymba families (ROADMAP §1 item 8c(i)) in fp32 at
# FAMILY_FP32_LAYERS, seed 0, over the (1, 2) pair of ranks 2, 3: arch ->
# MESH_PATHS labels; olmoe-1b-7b's exact dense also over (1, 4) (16 of its
# 64 experts a rank) and its phase 17 engine run over the pair
MESH_FAMILY_PATHS = {
    "olmoe-1b-7b": ("greedy", "exact dense", "exact paged",
                    "topk_tree dense"),
    "qwen2-moe-a2.7b": ("greedy", "exact dense"),
    "rwkv6-1.6b": ("greedy", "exact dense"),
    "hymba-1.5b": ("greedy", "exact dense"),
}
# the one-device run of phases 16-18 (``family_paths``) each label is held
# against (rwkv6-1.6b's are decoded beside the ranks' start)
ONE_DEVICE_PATH = {"greedy": "greedy", "exact dense": "bpd exact dense",
                   "exact paged": "bpd exact paged",
                   "topk_tree dense": "bpd topk_tree dense"}


def mesh_decode(torch, D, params, cfg, dec, batch, label, mesh=None):
    """One of MESH_PATHS on the card (sharded over ``mesh`` when given):
    {tokens, generated, text_len, iterations, launches, wall}, the launches
    counted from 0 and checked against the forwards the run made, as phase
    4b counts them (on every rank: each launches its own kernels; an
    RWKV-6 model its scan once a layer in the prefill).  An MoE model's
    routings are kept too (``Routes.by_position``, under "routes")."""
    from repro_torch.kernels import _build

    kw, bpd, budgets = MESH_PATHS[label]
    pdec = dec.replace(**kw)
    rows = list(MESH_BUDGETS) if budgets else None
    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with routes_for(torch, cfg) as rec:
        if bpd:
            toks, st = D.bpd_decode(params, cfg, pdec, batch,
                                    max_new_rows=rows, mesh=mesh)
        else:
            toks, st = D.greedy_decode(params, cfg, pdec, batch, mesh=mesh)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    iters = st["iterations"]
    want = {name: 0 for name in launches}
    if cfg.block_type == "rwkv6":
        want["rwkv6_scan"] = cfg.num_layers
    else:
        for kernel, n in attention_launches(cfg, pdec).items():
            want[kernel] = n * iters
    if bpd:
        want.update(fused_verify=iters, fused_heads=iters + 1)
    check(launches == want, f"{label}: launches {launches}, expected {want}")
    budget = torch.as_tensor(rows if rows else [dec.max_new_tokens] * len(toks))
    check(bool((st["generated"].cpu() == budget).all()),
          f"{label}: generated {st['generated'].tolist()}")
    return {"tokens": toks, "generated": st["generated"],
            "text_len": st["text_len"], "iterations": iters,
            "launches": launches, "wall": wall,
            "routes": None if rec is None else rec.by_position()}


def nonzero(launches: dict) -> dict:
    return {name: n for name, n in launches.items() if n}


def collectives(torch, mesh) -> dict:
    """Which dtypes the process group's all_reduce and all_gather_into_tensor
    take on CUDA tensors over the ``model`` axis (the sharded path sums in
    fp32 or int64 and gathers in each tensor's own dtype), and the ms of one
    fp32 all_reduce of 4 KiB and of a layer's (8, 8, 4096) sum (1 MiB), and
    of p_1's (8, 8, 49408) logits (12.6 MB) gathered both ways: as the
    all_reduce of a zero-filled full buffer and as all_gather_into_tensor of
    each rank's lanes; each the mean of 20 after 3."""
    import torch.distributed as dist

    from repro_torch.sharding import comm

    out = {}
    group = mesh.groups["model"]
    m = mesh.shape["model"]
    for name in GLOO_DTYPES:
        x = torch.ones(4, dtype=getattr(torch, name), device=mesh.device)
        try:
            dist.all_reduce(x, group=group)
            out[name] = float(x[0]) == m
        except (RuntimeError, ValueError) as exc:
            out[name] = f"refused: {str(exc).splitlines()[0][:80]}"
        x = torch.full((4,), mesh.coords["model"] + 1,
                       dtype=getattr(torch, name), device=mesh.device)
        y = torch.empty(4 * m, dtype=x.dtype, device=mesh.device)
        try:
            comm.all_gather_into_tensor(y, x, group=group)
            out[f"gather {name}"] = y.cpu().tolist() == [
                float(i // 4 + 1) for i in range(4 * m)]
        except (RuntimeError, ValueError) as exc:
            out[f"gather {name}"] = f"refused: {str(exc).splitlines()[0][:80]}"

    def timed(fn):
        for i in range(23):
            if i == 3:
                torch.cuda.synchronize(mesh.device)
                t0 = time.perf_counter()
            fn()
        torch.cuda.synchronize(mesh.device)
        return round((time.perf_counter() - t0) / 20 * 1e3, 3)

    for label, n in (("4 KiB", 1024), ("1 MiB", 8 * 8 * 4096),
                     ("12.6 MB", 8 * 8 * 49408)):
        x = torch.zeros(n, device=mesh.device)
        out[f"{label} ms"] = timed(lambda: dist.all_reduce(x, group=group))
    lanes = torch.zeros(8 * 8 * 49408 // m, device=mesh.device)
    full = torch.zeros(8 * 8 * 49408, device=mesh.device)
    out["12.6 MB gather ms"] = timed(
        lambda: comm.all_gather_into_tensor(full, lanes, group=group))
    return out


def rebind(params, mesh):
    """``params``, a rank's blocks, under another mesh of the same
    ``model`` axis: a rank's blocks depend on its ``model`` coordinate
    alone, so the (1, 2) pairs' blocks are the (2, 2) and (2, 1, 2) ranks'
    (rank r at model coordinate r % 2 on all three)."""
    from repro_torch.models import model as M

    for node in params.modules():
        if isinstance(node, M.ParamTree):
            node.mesh = mesh
    return params


def mesh_weights(torch, mesh):
    """granite-3-8b's blocks of this rank at MESH_FP32_LAYERS in fp32, drawn
    from seed 0 (``model.init(mesh=)``), and the config."""
    from repro_torch.config import get_config
    from repro_torch.models import model as M

    cfg = get_config("granite-3-8b").replace(dtype="float32",
                                             num_layers=MESH_FP32_LAYERS)
    return M.init(cfg, seed=0, mesh=mesh), cfg


def quiet_unless_first(mesh):
    import contextlib
    import io

    return (contextlib.redirect_stdout(io.StringIO()) if mesh.index
            else contextlib.nullcontext())


def mesh_rank_runs(torch, mesh, job, paths, params, cfg):
    """One mesh's static share of a phase 22 rank: ``paths`` on this rank's
    blocks ``params``.  Only the mesh's rank 0 prints."""
    from repro_torch.config import DecodeConfig
    from repro_torch.core import decode as D

    dev = mesh.device
    out = {"device": f"{dev} ({torch.cuda.get_device_name(dev)})",
           "backend": mesh.backend, "coords": dict(mesh.coords), "runs": {},
           "collectives": collectives(torch, mesh)}
    batch = {"tokens": torch.as_tensor(job["prompts"], device=dev)}
    dec = DecodeConfig(max_new_tokens=job["max_new"], block_k=job["block_k"])
    with quiet_unless_first(mesh):
        for label in paths:
            out["runs"][label] = mesh_decode(torch, D, params, cfg, dec, batch,
                                             label, mesh)
    return out


def engine_record(f) -> tuple:
    return (f.rid, f.tokens.tolist(), f.generated, f.invocations, f.policy)


def engine_run(torch, params, cfg, dec, prompts, label, mesh=None, *,
               ttft=False):
    """One of MESH_ENGINE_RUNS (``dec`` the base DecodeConfig) through the
    engine on phase 5c's plan and virtual clock: on one device, or sharded
    over ``mesh`` (rank 0 schedules, the others replay its plans).  Returns
    {records, launches, wall, counters, ``drive_engine``'s sample,
    handoff}."""
    from repro_torch import serving
    from repro_torch.kernels import _build

    dkw, ekw = MESH_ENGINE_RUNS[label]
    edec = dec.replace(top_k=2, page_size=16, **dkw)
    ecfg = serving.EngineConfig(num_slots=8, max_prompt_len=64,
                                max_new_cap=64, **ekw)
    engine = serving.ContinuousBatchingEngine(params, cfg, edec, ecfg,
                                              mesh=mesh,
                                              policies=ENGINE_GROUPS)
    where = "one device" if mesh is None else f"mesh {mesh.shape}"
    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sample = {}
    if mesh is None or mesh.index == 0:
        done, _, _, sample = drive_engine(
            torch, serving, engine, engine_requests(serving, prompts),
            f"{label}, {where}", profile_step=None, ttft=ttft)
        engine.release_followers()
    else:
        done = engine.follow()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    sess = engine.session
    return {"records": [engine_record(f) for f in done],
            "launches": {n: _build.LAUNCHES[n] for n in ENGINE_KERNELS},
            "wall": wall, "sample": sample,
            "counters": {"iterations": engine.num_steps,
                         "forwards": engine.num_forwards,
                         "prefill_batches": engine.num_prefill_batches,
                         "plans": engine.num_plans,
                         "cow": {g.name: g.pages.cow_hits
                                 for g in engine.groups if g.pages}},
            "handoff": (sess.handoffs, sess.handoff_bytes,
                        sess.handoff_seconds)}


def mesh_rank_bf16(torch, mesh, job):
    """A phase 22 rank's bf16 runs over (1, 2): granite-3-8b's blocks at
    full depth (phase 4's draw, phase 6's cast); BPD exact dense timed, each
    first divergence from phase 6's tokens (``job["bf16"]``) a near-tie of
    at most BF16_TIE_ULPS (by the sharded full forward); then the unified
    paged engine on phase 6c's plan, TTFT polled, each request's first
    divergence from phase 6c's (``job["engine_bf16"]``) a near-tie too."""
    from repro_torch.config import DecodeConfig, get_config
    from repro_torch.core import decode as D
    from repro_torch.models import model as M
    from repro_torch.sharding import comm

    dev = mesh.device
    full = get_config("granite-3-8b").replace(dtype="float32")
    batch = {"tokens": torch.as_tensor(job["prompts"], device=dev)}
    dec = DecodeConfig(max_new_tokens=job["max_new"], block_k=job["block_k"])
    torch.cuda.reset_peak_memory_stats(dev)
    params = M.init(full, seed=0, mesh=mesh)        # phase 4's draw, then
    bcfg = full.replace(dtype="bfloat16")           # phase 6's cast
    M.cast_for_compute(params, bcfg)
    torch.cuda.empty_cache()
    with quiet_unless_first(mesh):
        run = mesh_decode(torch, D, params, bcfg, dec, batch, "exact dense",
                          mesh)
        prompt_len = batch["tokens"].shape[1]
        after = causal_logits_after(torch, M, params, bcfg)
        div = report_divergences(torch, after, run["tokens"],
                                 torch.as_tensor(job["bf16"], device=dev),
                                 prompt_len, prompt_len + job["max_new"])
        check(all(d["tie"] for d in div),
              f"22: a sharded bf16 divergence beyond {BF16_TIE_ULPS} ulps")
        calls = sum(comm.CALLS.values())
        eng = engine_run(torch, params, bcfg, dec, batch["tokens"],
                         "unified paged", mesh, ttft=True)
        eng["collectives_all"] = sum(comm.CALLS.values()) - calls
        want = job["engine_bf16"]["tokens"]
        host = batch["tokens"].cpu()
        plan = {p[0]: p for p in engine_plan()}
        eng["divergences"] = []
        for rid, toks, *_ in eng["records"]:
            ref = want[rid]
            if toks == ref:
                continue
            i = next(i for i, (a, b) in enumerate(zip(toks, ref)) if a != b)
            _, row, plen, *_ = plan[rid]
            prefix = torch.cat([host[row, :plen],
                                torch.as_tensor(ref[:i], dtype=host.dtype)])
            d = divergence_at(torch, after(0, prefix.to(dev)), toks[i], ref[i])
            d.update(rid=rid, at=i, tie=d["bpd_ulps"] <= BF16_TIE_ULPS)
            eng["divergences"].append(d)
        check(all(d["tie"] for d in eng["divergences"]),
              f"22: a sharded bf16 engine divergence from phase 6c beyond "
              f"{BF16_TIE_ULPS} ulps: {eng['divergences']}")
    run.update(divergences=div, peak=torch.cuda.max_memory_allocated(dev),
               engine=eng)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return run


def family_weights(torch, arch, mesh=None):
    """``arch`` at full width and FAMILY_FP32_LAYERS in fp32, from seed 0:
    this rank's blocks over ``mesh`` (``model.init(mesh=)``), or the whole
    weights on the card; and the config."""
    from repro_torch.config import get_config
    from repro_torch.models import model as M

    cfg = get_config(arch).replace(dtype="float32",
                                   num_layers=FAMILY_FP32_LAYERS[arch])
    if mesh is None:
        return M.init(cfg, seed=0, device="cuda"), cfg
    return M.init(cfg, seed=0, mesh=mesh), cfg


def forward_expert_ids(torch, M, params, cfg, batch) -> dict:
    """{layer: (B, S, K) expert ids} of one full-capacity forward of
    ``batch``: what every rank of a mesh must route alike."""
    from repro_torch.models import moe

    with Routes(torch) as rec:
        M.forward_hidden(params, cfg, M.embed_inputs(params, cfg, batch),
                         moe_full_capacity=True)
    return {layer: moe.top_experts(torch.softmax(lg, -1),
                                   cfg.num_experts_per_tok).cpu()
            for layer, _, lg in rec.recs}


def mesh_family_runs(torch, mesh, job, families) -> dict:
    """A phase 22 rank's fp32 family runs over ``mesh``: for each arch of
    ``families`` ({arch: MESH_PATHS labels}) its paths on this rank's
    blocks (``family_weights``), with an MoE model's routings and the
    expert ids of a full forward of the prompts.  Only the mesh's rank 0
    prints."""
    from repro_torch.config import DecodeConfig
    from repro_torch.core import decode as D
    from repro_torch.models import model as M

    batch = {"tokens": torch.as_tensor(job["prompts"], device=mesh.device)}
    dec = DecodeConfig(max_new_tokens=job["max_new"], block_k=job["block_k"])
    out = {}
    with quiet_unless_first(mesh):
        for arch, paths in families.items():
            params, cfg = family_weights(torch, arch, mesh)
            runs = {label: mesh_decode(torch, D, params, cfg, dec, batch,
                                       label, mesh) for label in paths}
            if cfg.mlp_type == "moe":
                runs["expert ids"] = forward_expert_ids(torch, M, params, cfg,
                                                        batch)
            out[arch] = runs
            del params
            gc.collect()
            torch.cuda.empty_cache()
    return out


def mesh_rank_family_bf16(torch, mesh, job):
    """olmoe-1b-7b's bf16 serve over (1, 2) on ranks 2, 3: this rank's
    blocks at full depth (phase 17's draw from seed 0, then its bf16 cast),
    BPD exact dense timed; the collectives it issued, the rank's peak after
    the cast, and each row's first divergence from phase 17's one-device
    serve (``job["olmoe_bf16"]``), by the sharded full forward."""
    from repro_torch.config import DecodeConfig, get_config
    from repro_torch.core import decode as D
    from repro_torch.models import model as M
    from repro_torch.sharding import comm

    dev = mesh.device
    full = get_config("olmoe-1b-7b").replace(dtype="float32")
    batch = {"tokens": torch.as_tensor(job["prompts"], device=dev)}
    dec = DecodeConfig(max_new_tokens=job["max_new"], block_k=job["block_k"])
    params = M.init(full, seed=0, mesh=mesh)
    bcfg = full.replace(dtype="bfloat16")
    M.cast_for_compute(params, bcfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    with quiet_unless_first(mesh):
        calls = sum(comm.CALLS.values())
        run = mesh_decode(torch, D, params, bcfg, dec, batch, "exact dense",
                          mesh)
        run["collectives"] = sum(comm.CALLS.values()) - calls
        run["peak"] = torch.cuda.max_memory_allocated(dev)
        prompt_len = batch["tokens"].shape[1]
        run["divergences"] = report_divergences(
            torch, causal_logits_after(torch, M, params, bcfg), run["tokens"],
            torch.as_tensor(job["olmoe_bf16"], device=dev), prompt_len,
            prompt_len + job["max_new"])
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return run


def phase22_rank(mesh22, job):
    """One of phase 22's four ranks.  Every rank makes every mesh first, in
    one order: the (1, 2) pairs of ranks 0, 1 and 2, 3, the (2, 1) mesh of
    ranks 2, 3, the (1, 4) mesh and the pod mesh (2, 1, 2) of all four.
    Then: each pair's MESH_PAIR_PATHS side by side on the pair's fp32
    blocks, and the unified engine (MESH_ENGINE_PAIRS) over (1, 2) on
    ranks 0, 1 beside (2, 1) on ranks 2, 3 (whole fp32 weights of their
    own), after which ranks 2, 3 serve olmoe-1b-7b's phase 17 engine run
    over their pair; then, on the pairs' blocks, the (2, 2) mesh's BPD
    exact dense, olmoe's exact dense over (1, 4) and the disaggregated
    engine over the pod mesh; then ranks 0 and 1 the granite bf16 runs
    beside ranks 2 and 3's family runs (MESH_FAMILY_PATHS) and olmoe's
    bf16 serve, and all four meet at the last barrier.  Returns {(1, 2):
    ..., (2, 2): ..., "engine": {shape: {label: run}}, "families": {mesh:
    {arch: runs}}[, "bf16": ...][, "olmoe bf16": ...]}."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False     # fp32 means fp32
    torch.backends.cudnn.allow_tf32 = False
    side = mesh22.index // 2
    dev = mesh22.device
    pairs = [make_mesh(1, 2, device=dev, ranks=r) for r in ((0, 1), (2, 3))]
    m21 = make_mesh(2, 1, device=dev, ranks=(2, 3))
    m14 = make_mesh(1, 4, device=dev)
    pod = make_mesh(1, 2, pod=2, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    params, cfg = mesh_weights(torch, pairs[side])
    out = {(1, 2): mesh_rank_runs(torch, pairs[side], job,
                                  MESH_PAIR_PATHS[side], params, cfg),
           "engine": {}}
    prompts = torch.as_tensor(job["prompts"], device=dev)
    from repro_torch.config import DecodeConfig

    dec = DecodeConfig(max_new_tokens=job["max_new"], block_k=job["block_k"])
    if side == 0:
        shape, mesh, blocks = (1, 2), pairs[0], params
    else:
        shape, mesh = (2, 1), m21
        blocks, _ = mesh_weights(torch, m21)
    with quiet_unless_first(mesh):
        out["engine"][shape] = {
            label: engine_run(torch, blocks, cfg, dec, prompts, label, mesh)
            for label in MESH_ENGINE_PAIRS}
    del blocks
    if side == 1:                   # olmoe's engine over the pair (2, 3)
        olmoe, ocfg = family_weights(torch, "olmoe-1b-7b", pairs[1])
        with quiet_unless_first(pairs[1]):
            out["engine"]["olmoe (1, 2)"] = {"unified paged": engine_run(
                torch, olmoe, ocfg, dec, prompts, "unified paged", pairs[1])}
        del olmoe
    out[(2, 2)] = mesh_rank_runs(torch, mesh22, job, MESH_RUNS[(2, 2)],
                                 rebind(params, mesh22), cfg)
    out["families"] = {(1, 4): mesh_family_runs(
        torch, m14, job, {"olmoe-1b-7b": ("exact dense",)})}
    label = "disaggregated dense, windows of 4"
    with quiet_unless_first(pod):
        out["engine"][(2, 1, 2)] = {label: engine_run(
            torch, rebind(params, pod), cfg, dec, prompts, label, pod)}
    out["fp32_peak"] = torch.cuda.max_memory_allocated(dev)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    if side == 0:
        out["bf16"] = mesh_rank_bf16(torch, pairs[0], job)
    else:
        out["families"][(1, 2)] = mesh_family_runs(torch, pairs[1], job,
                                                   MESH_FAMILY_PATHS)
        out["olmoe bf16"] = mesh_rank_family_bf16(torch, pairs[1], job)
    out["inputs"] = phase23_rank(torch, side, pairs, m21, mesh22, pod, job)
    dist.barrier(group=mesh22.groups["world"])
    return out


# ---------------------------------------------------------------------------
# phase 23 (in phase 22's spawn): the inputs on a mesh (ROADMAP §1 item
# 8c(ii)): the encoder-decoder, llava's patch prefix, draft_model, locality
# ---------------------------------------------------------------------------


# paper-mt-base at full width and depth, phase 10's sources and paths
# (MESH_MT_PATHS over (1, 2), exact over (2, 2)), MESH_MT_NEW new tokens;
# draft_model on granite at MESH_FP32_LAYERS: MESH_DRAFT_STATIC_NEW new
# tokens of phase 4's prompts static (two blocks of 8 at least, so the
# draft's cache is read back across iterations), and the first
# MESH_DRAFT_REQUESTS of phase 15d's plan (budgets cut to MESH_DRAFT_NEW)
# through an engine of a draft_model and an exact group of 2 slots each;
# 13c's locality engine on the first MESH_LOC_FIELDS fields (3: a field of
# each group admitted after an eviction).  Each is cut so that phase 23
# costs the script about half a minute
MESH_MT_PATHS = ("exact", "topk_tree", "input_copy")
MESH_MT_22_PATHS = ("exact",)
MESH_MT_NEW = 32
MESH_LLAVA_PATHS = ("bpd exact dense", "bpd exact paged")
MESH_DRAFT_STATIC_NEW = 16
MESH_DRAFT_NEW, MESH_DRAFT_REQUESTS = 8, 8
MESH_LOC_FIELDS = 3
DRAFT_GROUPS = {"draft_model": 2, "exact": 2}


def run_launches(torch, fn):
    """(``fn()``, its wall seconds, the kernels it launched)."""
    from repro_torch.kernels import _build

    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, dict(_build.LAUNCHES)


def decode_record(toks, st, wall, launches) -> dict:
    return {"tokens": toks.cpu(), "generated": st["generated"].cpu(),
            "text_len": st["text_len"].cpu(), "iterations": st["iterations"],
            "launches": launches, "wall": wall}


def mt_mesh_runs(torch, mesh, job, paths) -> dict:
    """paper-mt-base fp32 at full width and depth from seed 0, this rank's
    blocks (``model.init(mesh=)``) or on one device without ``mesh``: each
    of ``paths`` (phase 10's policies) on phase 10's sources (a rank's rows
    of them), MESH_MT_NEW new tokens."""
    from repro_torch.config import DecodeConfig, get_config
    from repro_torch.core import decode as D
    from repro_torch.models import model as M

    cfg = get_config("paper-mt-base").replace(dtype="float32")
    dev = "cuda" if mesh is None else mesh.device
    params = M.init(cfg, seed=0, device=dev, mesh=mesh)
    batch = {"src": torch.as_tensor(job["mt_src"], device=dev)}
    dec = DecodeConfig(max_new_tokens=MESH_MT_NEW, block_k=cfg.bpd_k, top_k=2)
    out = {}
    for label in paths:
        (toks, st), wall, launches = run_launches(
            torch, lambda: D.bpd_decode_seq2seq(
                params, cfg, dec.replace(policy=label), batch, mesh=mesh))
        out[label] = decode_record(toks, st, wall, launches)
    return out


def mt_mesh_bf16(torch, mesh, job) -> dict:
    """paper-mt-base cast for bf16 (phase 10b's cast) over ``mesh`` or on
    one device, BPD exact on phase 10's sources, MESH_MT_NEW new tokens,
    timed without a warm-up (each process has run bf16 serves before):
    tokens/s, k̂, iterations and the collectives it issued."""
    from repro_torch.config import DecodeConfig, get_config
    from repro_torch.core import decode as D
    from repro_torch.models import model as M
    from repro_torch.sharding import comm

    cfg = get_config("paper-mt-base").replace(dtype="float32")
    dev = "cuda" if mesh is None else mesh.device
    params = M.init(cfg, seed=0, device=dev, mesh=mesh)
    bcfg = cfg.replace(dtype="bfloat16")
    M.cast_for_compute(params, bcfg)
    batch = {"src": torch.as_tensor(job["mt_src"], device=dev)}
    dec = DecodeConfig(max_new_tokens=MESH_MT_NEW, block_k=cfg.bpd_k,
                       policy="exact")
    calls = sum(comm.CALLS.values())
    (toks, st), wall, launches = run_launches(
        torch, lambda: D.bpd_decode_seq2seq(params, bcfg, dec, batch,
                                            mesh=mesh))
    rec = decode_record(toks, st, wall, launches)
    rec.update(collectives=sum(comm.CALLS.values()) - calls,
               khat=st["mean_accepted"])
    return rec


def llava_mesh_runs(torch, mesh, job) -> dict:
    """llava-next-34b fp32 at LLAVA_FP32_LAYERS over ``mesh`` (28 / 4 heads
    a rank at ``model`` 2), this rank's blocks from seed 0, behind phase
    19a's 2,880 stub patches (its batch, 64 new tokens, block_k 8, the
    chain prefills in chunks of KV_CHUNK keys): MESH_LLAVA_PATHS."""
    from repro_torch.config import DecodeConfig, get_config
    from repro_torch.core import decode as D
    from repro_torch.models import model as M

    cfg = get_config("llava-next-34b").replace(num_layers=LLAVA_FP32_LAYERS,
                                               dtype="float32")
    params = M.init(cfg, seed=0, mesh=mesh)
    batch = llava_batch(torch, cfg, torch.as_tensor(job["llava_prompts"],
                                                    device=mesh.device))
    dec = DecodeConfig(max_new_tokens=64, block_k=cfg.bpd_k)
    out = {}
    for label, kw in (("bpd exact dense", {}),
                      ("bpd exact paged", {"cache_backend": "paged"})):
        (toks, st), wall, launches = run_launches(
            torch, lambda: D.bpd_decode(params, cfg, dec.replace(**kw), batch,
                                        kv_chunk=KV_CHUNK, mesh=mesh))
        out[label] = decode_record(toks, st, wall, launches)
    out["peak"] = torch.cuda.max_memory_allocated(mesh.device)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def draft_static(torch, params, cfg, dec, batch, bundle, mesh=None) -> dict:
    """draft_model with ``bundle`` through a DecodeSession (sharded over
    ``mesh`` when given: the bundle cut by the primary's rules, a
    self-draft's the primary's own blocks): the decode record, the draft
    forwards an iteration and the draft cache's KV heads."""
    from repro_torch import serving

    sess = serving.DecodeSession(params, cfg, dec.replace(
        policy="draft_model", max_new_tokens=MESH_DRAFT_STATIC_NEW),
        mesh=mesh,
        bundles={"draft": bundle})
    (toks, st), wall, launches = run_launches(torch,
                                              lambda: sess.decode(batch))
    rec = decode_record(toks, st, wall, launches)
    drafter = sess.policy.drafter
    rec.update(steps=drafter.draft_steps_per_iter(dec.block_k),
               draft_kv_heads=drafter.cache_cfg.num_kv_heads,
               draft_kv_whole=bundle.cfg.num_kv_heads,
               self_draft=sess.aux_params["draft"] is sess.params)
    return rec


def draft_plan():
    """The first MESH_DRAFT_REQUESTS of phase 15d's plan (its topk_tree
    requests in the draft_model group), budgets cut to MESH_DRAFT_NEW."""
    return [(rid, row, plen, min(budget, MESH_DRAFT_NEW), t,
             {"topk_tree": "draft_model"}.get(policy, policy))
            for rid, row, plen, budget, t, policy
            in engine_plan()[:MESH_DRAFT_REQUESTS]]


def draft_engine_run(torch, params, cfg, dec, prompts, bundle, label,
                     mesh=None, **ekw) -> dict:
    """``draft_plan``'s requests through the engine on the managed page
    pool with a draft_model and an exact group of 2 slots (15d's groups,
    cut), drafting with ``bundle``: on one device, or sharded over
    ``mesh`` (rank 0 schedules on the virtual clock, the others replay its
    plans).  Returns {records, launches, wall, counters}."""
    from repro_torch import serving
    from repro_torch.kernels import _build

    host = prompts.cpu().numpy()
    reqs = [serving.Request(rid=rid, prompt=host[row, :plen], max_new=budget,
                            arrival=t, policy=policy)
            for rid, row, plen, budget, t, policy in draft_plan()]
    edec = dec.replace(page_size=16, cache_backend="paged")
    ecfg = serving.EngineConfig(num_slots=sum(DRAFT_GROUPS.values()),
                                max_prompt_len=64, max_new_cap=MESH_DRAFT_NEW,
                                **ekw)
    engine = serving.ContinuousBatchingEngine(
        params, cfg, edec, ecfg, mesh=mesh, policies=DRAFT_GROUPS,
        bundles={"draft": bundle})
    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if mesh is None or mesh.index == 0:
        done, _, _, _ = drive_engine(torch, serving, engine, reqs, label,
                                     profile_step=None)
        engine.release_followers()
    else:
        done = engine.follow()
    torch.cuda.synchronize()
    return {"records": sorted(engine_record(f) for f in done),
            "launches": {n: _build.LAUNCHES[n] for n in ENGINE_KERNELS},
            "wall": time.perf_counter() - t0,
            "counters": {"iterations": engine.num_steps,
                         "forwards": engine.num_forwards,
                         "prefill_batches": engine.num_prefill_batches}}


def locality_engine_run(torch, mesh=None, *, static=False) -> dict:
    """Phase 13c's engine (the lattice fixture, a locality and an exact
    group of 2 slots, each field's coarse prompt under each policy) on the
    first MESH_LOC_FIELDS fields, on the card or over ``mesh``: rank 0 runs
    the scheduler, the others replay its plans; with ``static`` then the
    fields as one static batch.  A
    rank whose block of the vocab projection holds no real lane (vocab 16
    in the first of 64-lane blocks) launches no fused_heads: ``real``
    records its real lanes."""
    import numpy as np

    from repro_torch import bridge, serving
    from repro_torch.config import DecodeConfig
    from repro_torch.data.synthetic import OrdinalField
    from repro_torch.kernels import _build
    from repro_torch.models import model as M

    cfg = fixture_config(LOCALITY / "locality")
    dev = "cuda" if mesh is None else mesh.device
    params = bridge.load_checkpoint(str(LOCALITY / "locality" / "checkpoint"),
                                    cfg, device=dev, mesh=mesh)
    grids = np.load(LOCALITY / "grids.npy")
    field = OrdinalField(levels=cfg.vocab_size, height=grids.shape[1],
                         width=grids.shape[2], n_waves=2, stride=2,
                         order="locality", bilinear=True)
    stream = field.serialize(grids)[:MESH_LOC_FIELDS]
    h, w = grids.shape[1:]
    start, n = field.coarse_len, h * w
    dec = DecodeConfig(max_new_tokens=n - start, block_k=cfg.bpd_k,
                       image_height=h, image_width=w, locality_stride=2)
    engine = serving.ContinuousBatchingEngine(
        params, cfg, dec, serving.EngineConfig(num_slots=4,
                                               max_prompt_len=start,
                                               max_new_cap=n - start),
        mesh=mesh, policies={"locality": 2, "exact": 2})
    _build.reset_launches()
    t0 = time.perf_counter()
    if mesh is None or mesh.index == 0:
        sched = serving.Scheduler(engine)
        for r in range(len(stream)):
            for j, policy in enumerate(("locality", "exact")):
                sched.submit(serving.Request(rid=2 * r + j,
                                             prompt=stream[r, :start],
                                             max_new=n - start, policy=policy))
        done = sched.run()
        engine.release_followers()
    else:
        done = engine.follow()
    torch.cuda.synchronize()
    _, lo = M.vocab_lanes(params, cfg)
    lanes = M.vocab_matrix(params, cfg).shape[1]
    out = {"records": sorted(engine_record(f) for f in done),
           "launches": {k: _build.LAUNCHES[k] for k in ENGINE_KERNELS},
           "counters": {"iterations": engine.num_steps,
                        "forwards": engine.num_forwards},
           "wall": time.perf_counter() - t0,
           "real": max(0, min(cfg.vocab_size - lo, lanes))}
    if static:                     # the fields as one batch of prompts
        toks, _ = serving.DecodeSession(params, cfg, dec.replace(
            policy="locality"), mesh=mesh).decode(
            {"tokens": torch.as_tensor(stream[:, :start], device=dev)})
        out["static"] = toks[:, :n].cpu().tolist()
    return out


def phase23_rank(torch, side, pairs, m21, mesh22, pod, job) -> dict:
    """Phase 23's share of a phase 22 rank: ranks 2, 3 (whose phase 22
    share ends about 35 s sooner) run granite's draft engine unified and
    the locality engine over their (1, 2) pair, then the locality engine
    over (2, 1) with the fields as one static batch, while ranks 0, 1
    finish phase 22; then, every rank's phase 22 memory freed, ranks 0, 1
    run paper-mt-base fp32 (MESH_MT_PATHS) and bf16 exact and granite's
    draft_model static (self and small draft) beside ranks 2, 3's llava;
    then all four run paper-mt-base exact over (2, 2) and the draft engine
    disaggregated over the pod mesh (2, 1, 2).  Only a mesh's rank 0
    prints."""
    import torch.distributed as dist

    from repro_torch.config import DecodeConfig

    t0 = time.perf_counter()
    out, parts = {}, {}

    def run(key, fn):
        t = time.perf_counter()
        out[key] = fn()
        parts[key] = round(time.perf_counter() - t, 1)

    dec = DecodeConfig(max_new_tokens=job["max_new"], block_k=job["block_k"])
    prompts = torch.as_tensor(job["prompts"], device=mesh22.device)
    mesh = pairs[side]
    if side == 1:
        with quiet_unless_first(mesh):
            params, cfg = mesh_weights(torch, mesh)
            run("draft engine (1, 2)", lambda: draft_engine_run(
                torch, params, cfg, dec, prompts, small_draft(torch, cfg),
                "draft unified", mesh))
            del params
            run("locality (1, 2)", lambda: locality_engine_run(torch, mesh))
        with quiet_unless_first(m21):
            run("locality (2, 1)", lambda: locality_engine_run(
                torch, m21, static=True))
    gc.collect()
    torch.cuda.empty_cache()
    # llava's 21 GiB a rank only once every rank's phase 22 work (side
    # 0's bf16 granite at full depth) has freed its memory on the card
    dist.barrier(group=mesh22.groups["world"])
    with quiet_unless_first(mesh):
        if side == 0:
            run("mt (1, 2)", lambda: mt_mesh_runs(torch, mesh, job,
                                                  MESH_MT_PATHS))
            run("mt bf16 (1, 2)", lambda: mt_mesh_bf16(torch, mesh, job))
            params, cfg = mesh_weights(torch, mesh)
            batch = {"tokens": prompts}
            for name, bundle in (("self", self_bundle(params, cfg)),
                                 ("small", small_draft(torch, cfg))):
                run(f"draft {name} (1, 2)", lambda: {"run": draft_static(
                    torch, params, cfg, dec, batch, bundle, mesh)})
            del params, bundle
        else:
            torch.cuda.reset_peak_memory_stats(mesh22.device)
            run("llava (1, 2)", lambda: llava_mesh_runs(torch, mesh, job))
    with quiet_unless_first(mesh22):
        run("mt (2, 2)", lambda: mt_mesh_runs(torch, mesh22, job,
                                              MESH_MT_22_PATHS))
    with quiet_unless_first(pod):
        params, cfg = mesh_weights(torch, pod)
        run("draft engine (2, 1, 2)", lambda: draft_engine_run(
            torch, params, cfg, dec, prompts, small_draft(torch, cfg),
            "draft disaggregated", pod, prefill_slots=2))
        del params
    out["seconds"], out["parts"] = time.perf_counter() - t0, parts
    return out


def self_bundle(params, cfg):
    """A self-draft's bundle: the primary's own tree and config."""
    from repro_torch.core import ModelBundle

    return ModelBundle(params, cfg)


def repeats(toks, prompt_len: int, end: int) -> list:
    """Each row's count of new tokens equal to the token before them: where
    a random-weight model repeats itself, heads that copy the hidden state
    propose right, and the row with the fewest sets the iterations (and so
    k̂) of the batch."""
    new = toks[:, prompt_len - 1:end]
    return (new[:, 1:] == new[:, :-1]).sum(dim=1).tolist()


class Positions:
    """A run's routings as ``Routes.by_position`` gave them on a rank: what
    ``router_tie`` reads of the run that left the one-device run."""

    def __init__(self, table):
        self.table = table

    def by_position(self):
        return self.table


def compare_mesh_run(torch, after, got, want, label, prompt_len, *,
                     cfg=None) -> bool:
    """A sharded fp32 run against the single-device one: tokens equal
    except at rows that diverge at a near-tie (``compare_rows``; for an MoE
    model ``cfg`` with its router extension, from both runs' routings), and
    with every row equal the counters equal too.  Returns whether every
    row was equal."""
    routes = None
    if got.get("routes") is not None and want.get("routes") is not None:
        routes = (want["routes"], Positions(got["routes"]))
    diverged = compare_rows(torch, after,
                            torch.as_tensor(got["tokens"]).cuda(),
                            want["tokens"].cuda(), want["text_len"],
                            prompt_len, routes=routes, cfg=cfg, label=label)
    if diverged:
        log(f"[mesh] {label}: rows {diverged} diverge at near-ties; "
            f"iterations {got['iterations']} vs {want['iterations']}")
        return False
    for key in ("generated", "text_len"):
        check(torch.equal(torch.as_tensor(got[key]), want[key]),
              f"{label}: {key} {got[key]} vs {want[key].tolist()}")
    check(got["iterations"] == want["iterations"],
          f"{label}: iterations {got['iterations']} vs {want['iterations']}")
    return True


def http_demo(torch):
    """The launcher's HTTP demo over a ``model`` mesh of two ranks sharing
    the card, at its default smoke config: one streamed request whose SSE
    tokens equal the done payload (the launcher checks), and that payload
    equal to rank 0's finish record and the other rank's.  Returns the
    seconds it took."""
    from repro_torch.launch import serve

    t0 = time.perf_counter()
    out = serve.main(["--arch", "granite-3-8b", "--mesh-model", "2", "--http",
                      "--http-demo", "--port", "0"])
    done = out["demo"]
    records = [[engine_record(f) for f in r["finished"]] for r in out["ranks"]]
    check(len(records[0]) == 1 and records[1] == records[0],
          f"22 http: finish records differ between ranks: {records}")
    rid, toks, generated, invocations, _ = records[0][0]
    check(done["tokens"] == toks and done["generated"] == generated
          and done["invocations"] == invocations,
          f"22 http: the stream's done payload {done} differs from its "
          f"finish record {records[0][0]}")
    wall = time.perf_counter() - t0
    log(f"[mesh] http --mesh-model 2 --http-demo: {generated} tokens "
        f"streamed over SSE equal to the finish record of rank 0 and of rank "
        f"1 ({invocations} invocations); {wall:.1f}s with its two ranks' "
        f"start")
    return wall


def compare_engine_runs(got, want, label):
    """A sharded engine run's finish records equal the single-device
    engine's, record for record (tokens, generated, invocations, policy),
    and its iterations and forwards too."""
    check(got["records"] == want["records"],
          f"22 {label}: records differ from the single-device engine's")
    for key in ("iterations", "forwards", "prefill_batches", "cow"):
        check(got["counters"][key] == want["counters"][key],
              f"22 {label}: {key} {got['counters'][key]} vs "
              f"{want['counters'][key]}")


def phase_mesh(torch, phase4, card):
    """Phase 22: granite-3-8b at full width sharded over meshes of ranks
    that share the one card (gloo), against the single-device port on the
    same seed, prompts and depth: the static serve, the engine
    unified and disaggregated, the bf16 engine beside phase 6c, and the
    launcher's HTTP demo over a ``model`` mesh (``phase22_rank``: one spawn
    of four ranks; the demo spawns two more beside them)."""
    from repro_torch.config import DecodeConfig, get_config
    from repro_torch.core import decode as D
    from repro_torch.launch.mesh import choose_backend, spawn
    from repro_torch.models import model as M

    import threading

    t0 = time.perf_counter()
    prompts = phase4["prompts"]
    prompt_len, max_new, block_k = prompts.shape[1], 64, 8
    backend, why = choose_backend(4, "cuda")
    check(backend == "gloo", f"ranks on one card: backend {backend}")
    # the ranks start (about 10 s to reach the card) while this process
    # runs the single-device references and the HTTP demo
    spawned = {}
    job = {"prompts": prompts.numpy(), "max_new": max_new,
           "block_k": block_k, "bf16": phase4["bf16"]["tokens"].numpy(),
           "engine_bf16": {"tokens": phase4["engine_bf16"]["tokens"]},
           "olmoe_bf16": ONE_DEVICE[("olmoe-1b-7b", "bf16 serve")][
               "tokens"].numpy(),
           "mt_src": ONE_DEVICE[("paper-mt-base", "src")].numpy(),
           "llava_prompts": ONE_DEVICE[("llava-next-34b", "prompts")].numpy()}

    def ranks_run():
        try:
            spawned["ranks"] = spawn(phase22_rank, 2, 2, device="cuda",
                                     timeout=MESH_RANKS_S, args=(job,))
        except BaseException as exc:           # raised below, in this thread
            spawned["error"] = exc

    worker = threading.Thread(target=ranks_run, name="phase22-ranks")
    worker.start()
    batch = {"tokens": prompts.to("cuda")}
    dec = DecodeConfig(max_new_tokens=max_new, block_k=block_k)
    cfg = get_config("granite-3-8b").replace(dtype="float32",
                                             num_layers=MESH_FP32_LAYERS)
    params = M.init(cfg, seed=0, device="cuda")
    after = causal_logits_after(torch, M, params, cfg)
    singles = {}
    for label in MESH_PATHS:
        r = mesh_decode(torch, D, params, cfg, dec, batch, label)
        singles[label] = {k: (v.cpu() if hasattr(v, "cpu") else v)
                          for k, v in r.items()}
    engines = {label: engine_run(torch, params, cfg, dec, batch["tokens"],
                                 label) for label in MESH_ENGINE_RUNS}
    # phase 23's one-device references, at the ranks' sizes
    small = small_draft(torch, cfg)
    refs23 = {
        "draft self": draft_static(torch, params, cfg, dec, batch,
                                   self_bundle(params, cfg)),
        "draft small": draft_static(torch, params, cfg, dec, batch, small),
        "draft engine": draft_engine_run(torch, params, cfg, dec,
                                         batch["tokens"], small,
                                         "draft one device"),
        "mt": mt_mesh_runs(torch, None, job, MESH_MT_PATHS),
        "mt bf16": mt_mesh_bf16(torch, None, job),
        "locality": locality_engine_run(torch)}
    del small
    # the families' one-device runs: phases 16-18's, and rwkv6-1.6b's here
    rwkv, rcfg = family_weights(torch, "rwkv6-1.6b")
    for label in MESH_FAMILY_PATHS["rwkv6-1.6b"]:
        r = mesh_decode(torch, D, rwkv, rcfg, dec, batch, label)
        ONE_DEVICE[("rwkv6-1.6b", ONE_DEVICE_PATH[label])] = {
            k: (v.cpu() if hasattr(v, "cpu") else v) for k, v in r.items()}
    del rwkv
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[mesh] single-device references at {MESH_FP32_LAYERS} of 40 layers "
        f"and rwkv6-1.6b's at {FAMILY_FP32_LAYERS['rwkv6-1.6b']} of 24 in "
        f"{time.perf_counter() - t0:.1f}s, beside the ranks' start")
    http_s = http_demo(torch)
    worker.join(timeout=MESH_RANKS_S + 30)
    check(not worker.is_alive(), "phase 22: the ranks outlived their limit")
    if "error" in spawned:
        raise spawned["error"]
    ranks = spawned["ranks"]
    log(f"[mesh] 4 ranks, backend {backend} ({why}): "
        f"{time.perf_counter() - t0:.1f}s with their start")
    equal = 0
    for shape in MESH_RUNS:
        group = [(i, r[shape]) for i, r in enumerate(ranks) if shape in r]
        for i, r in group:
            log(f"    {shape} rank {i} at {r['coords']} on {r['device']}, "
                f"{r['backend']}: "
                + "; ".join(f"{label} launches {nonzero(run['launches'])}, "
                            f"{run['wall']:.2f}s"
                            for label, run in r["runs"].items())
                + f"; collectives on CUDA tensors: {r['collectives']}")
        for label in MESH_RUNS[shape]:
            want = singles[label]
            holders = [(i, r) for i, r in group if label in r["runs"]]
            check(len(holders) == shape[0] * shape[1],
                  f"22: {shape} {label} ran on {len(holders)} ranks")
            for i, r in holders:
                equal += compare_mesh_run(torch, after, r["runs"][label], want,
                                          f"{shape} rank {i} {label}",
                                          prompt_len)
            got = holders[0][1]["runs"][label]
            log(f"[mesh] {shape} {label}: k̂="
                f"{float(want['generated'].sum()) / want['iterations'] / 8:.4f}"
                f", iterations {got['iterations']} (single device "
                f"{want['iterations']}), tokens checked on ranks "
                f"{[i for i, _ in holders]}; "
                f"{got['wall']:.2f}s (single device {want['wall']:.2f}s)")
    log(f"[mesh] fp32 peak a rank: "
        f"{[round(r['fp32_peak'] / 2 ** 30, 2) for r in ranks]} GiB")
    pair = {**ranks[2][(1, 2)]["runs"], **ranks[0][(1, 2)]["runs"]}
    greedy = torch.as_tensor(pair["greedy"]["tokens"]).cuda()
    for label in MESH_RUNS[(1, 2)][1:]:
        diverged = compare_rows(torch, after, torch.as_tensor(
            pair[label]["tokens"]).cuda(), greedy, pair[label]["text_len"],
            prompt_len)
        log(f"[mesh] (1, 2) sharded BPD {label} == sharded greedy's tokens in "
            f"{8 - len(diverged)}/8 rows (others at near-ties)")

    # ---- the engine: fp32 records and launches against one device --------
    t_engine = 0.0
    for shape, idx in (((1, 2), (0, 1)), ((2, 1), (2, 3)),
                       ((2, 1, 2), (0, 1, 2, 3))):
        for label, want in engines.items():
            runs = [(i, ranks[i]["engine"][shape][label]) for i in idx
                    if label in ranks[i]["engine"].get(shape, {})]
            if not runs:
                continue
            check(len(runs) == len(idx), f"22 engine {shape} {label}: ran on "
                                         f"{len(runs)} ranks")
            for i, got in runs:
                compare_engine_runs(got, want, f"engine {shape} {label} rank "
                                               f"{i}")
                if len(shape) == 2:
                    check(got["launches"] == want["launches"],
                          f"22 engine {shape} {label} rank {i}: launches "
                          f"{got['launches']} vs one device's "
                          f"{want['launches']}")
            lead = runs[0][1]
            t_engine = max(t_engine, lead["wall"])
            n, nbytes, secs = lead["handoff"]
            steps = lead["sample"]["steps"]
            hand = ("" if not n else
                    f"; pod handoff {n} gathers, {nbytes / n / 2 ** 20:.2f} "
                    f"MiB and {secs / n * 1e3:.1f} ms a gather "
                    f"({nbytes / steps / 2 ** 20:.3f} MiB a scheduler step)")
            log(f"[mesh] engine {shape} {label}: 16 records equal to one "
                f"device's on ranks {list(idx)}, iterations "
                f"{lead['counters']['iterations']}, forwards "
                f"{lead['counters']['forwards']}, CoW {lead['counters']['cow']}"
                f"; launches a rank {[nonzero(g['launches']) for _, g in runs]}"
                f" ({'equal to' if len(shape) == 2 else 'beside'} one "
                f"device's {nonzero(want['launches'])}); {lead['wall']:.2f}s "
                f"(one device {want['wall']:.2f}s), {steps} scheduler steps, "
                f"{lead['counters']['plans']} plans, "
                f"{lead['sample']['collectives'] / steps:.1f} collectives a "
                f"scheduler step on rank 0{hand}")

    # ---- bf16 over (1, 2): the static serve and the engine -----------------
    runs = [r["bf16"] for r in ranks if "bf16" in r]
    check(len(runs) == 2, f"22: the bf16 serve ran on {len(runs)} ranks")
    for i, b in enumerate(runs):
        check(torch.equal(torch.as_tensor(b["tokens"]),
                          torch.as_tensor(runs[0]["tokens"])),
              f"22 bf16: rank {i}'s tokens differ from rank 0's")
        check(b["engine"]["records"] == runs[0]["engine"]["records"],
              f"22 bf16 engine: rank {i}'s records differ from rank 0's")
        log(f"    (1, 2) rank {i} bf16 full depth: peak "
            f"{b['peak'] / 2 ** 30:.2f} GiB, launches "
            f"{nonzero(b['launches'])}, wall {b['wall']:.2f}s")
    b = runs[0]
    gen = int(b["generated"].sum())
    end = prompt_len + max_new
    log(f"[mesh] bf16 granite-3-8b, 40 layers, sharded over (1, 2): "
        f"{gen / b['wall']:.1f} tokens/s (two ranks sharing one card, gloo), "
        f"beside phase 6's single-device {phase4['bf16']['tps']:.1f} "
        f"tokens/s; k̂={gen / b['iterations'] / 8:.4f}, iterations "
        f"{b['iterations']} (phase 6: {phase4['bf16']['iterations']}); "
        f"repeated new tokens a row {repeats(torch.as_tensor(b['tokens']), prompt_len, end)}"
        f" (phase 6: {repeats(phase4['bf16']['tokens'], prompt_len, end)}); "
        f"first divergences from phase 6's tokens: {len(b['divergences'])} "
        f"rows, all within {BF16_TIE_ULPS} bf16 ulps of the top logit; {card}")
    e, one = b["engine"], phase4["engine_bf16"]
    tokens = sum(rec[2] for rec in e["records"])
    sample, ttft = e["sample"], e["sample"]["ttft"]
    log(f"[mesh] bf16 engine over (1, 2), unified paged, phase 6c's 16 "
        f"requests: {tokens / e['wall']:.1f} tokens/s beside phase 6c's "
        f"{one['tps']:.1f}; TTFT p50 {quantile(ttft, 0.5) * 1e3:.1f} / p99 "
        f"{quantile(ttft, 0.99) * 1e3:.1f} ms beside "
        f"{quantile(one['ttft'], 0.5) * 1e3:.1f} / "
        f"{quantile(one['ttft'], 0.99) * 1e3:.1f}; "
        f"{e['wall'] / sample['steps'] * 1e3:.1f} host ms a scheduler step "
        f"beside {one['step_ms']:.1f}; {sample['collectives'] / sample['steps']:.1f}"
        f" collectives a scheduler step on rank 0 ({e['counters']['plans']} "
        f"plans over {sample['steps']} steps); launches a rank "
        f"{nonzero(e['launches'])}; {len(e['divergences'])} of 16 requests "
        f"leave phase 6c's tokens, each first at a near-tie "
        f"({[(d['rid'], d['at'], round(d['bpd_ulps'], 3)) for d in e['divergences']]}"
        f": request, new token, ulps below the top); {card}")
    equal += compare_mesh_families(torch, ranks, prompt_len, card)
    equal += compare_inputs(torch, ranks, refs23, after, card)
    log(f"[mesh] fp32 sharded runs with every row equal to the single-device "
        f"port's: {equal}; the longest fp32 engine run on the ranks "
        f"{t_engine:.1f}s, the bf16 engine {e['wall']:.1f}s, the HTTP demo "
        f"{http_s:.1f}s (beside the ranks); phase 22 "
        f"{time.perf_counter() - t0:.1f}s")


def lazy_after(make):
    """``logits_after(row, prefix)`` whose model ``make()`` builds on the
    first call: only a row that leaves the one-device run reads it."""
    held = {}

    def after(r, prefix):
        if "fn" not in held:
            held["fn"] = make()
        return held["fn"](r, prefix)

    return after


def compare_decodes(torch, ranks, key, idx, labels, want_of, after,
                    prompt_len, name) -> int:
    """Phase 23's static runs ``key`` of ranks ``idx`` against one device's
    (``want_of(label)``): tokens under the near-tie rule, and with every
    row equal the counters and each rank's launches equal.  Returns the
    runs with every row equal."""
    equal = 0
    for label in labels:
        want = want_of(label)
        same = True
        for i in idx:
            got = ranks[i]["inputs"][key][label]
            ok = compare_mesh_run(torch, after, got, want,
                                  f"{name} {key} rank {i} {label}",
                                  prompt_len)
            if ok:
                check(nonzero(got["launches"]) == nonzero(want["launches"]),
                      f"23 {name} {key} rank {i} {label}: launches "
                      f"{nonzero(got['launches'])} vs one device's "
                      f"{nonzero(want['launches'])}")
            same = same and ok
            equal += ok
        lead = ranks[idx[0]]["inputs"][key][label]
        b = lead["generated"].shape[0]
        log(f"[inputs] {name} {key} {label}: "
            f"{'tokens, counters and launches equal to' if same else 'near-tie divergences from'}"
            f" one device's on ranks {list(idx)}; k̂="
            f"{float(lead['generated'].sum()) / lead['iterations'] / b:.4f}, "
            f"iterations {lead['iterations']} (one device "
            f"{want['iterations']}), launches a rank "
            f"{nonzero(lead['launches'])}; {lead['wall']:.2f}s (one device "
            f"{want['wall']:.2f}s)")
    return equal


def compare_engine_records(ranks, key, idx, want, label, *, launches=True):
    """Phase 23's engine runs against one device's: records (tokens,
    generated, invocations, policy), iterations and forwards equal on
    every rank, and each rank's launches where ``launches``."""
    for i in idx:
        got = ranks[i]["inputs"][key]
        check(got["records"] == want["records"],
              f"23 {label} rank {i}: records differ from one device's")
        for k in ("iterations", "forwards"):
            check(got["counters"][k] == want["counters"][k],
                  f"23 {label} rank {i}: {k} {got['counters'][k]} vs "
                  f"{want['counters'][k]}")
        if launches:
            want_l = dict(want["launches"])
            if got.get("real") == 0:      # a block of pad lanes alone
                want_l["fused_heads"] = 0
            check(got["launches"] == want_l,
                  f"23 {label} rank {i}: launches {got['launches']} vs "
                  f"{want_l}")
    lead = ranks[idx[0]]["inputs"][key]
    pads = [i for i in idx if ranks[i]["inputs"][key].get("real") == 0]
    log(f"[inputs] {label}: {len(want['records'])} records and counters "
        f"equal to one device's on ranks {list(idx)} (iterations "
        f"{lead['counters']['iterations']}, forwards "
        f"{lead['counters']['forwards']}); launches a rank "
        f"{[nonzero(ranks[i]['inputs'][key]['launches']) for i in idx]}"
        f"{' (equal' if launches else ''}"
        f"{f'; no fused_heads on ranks {pads}, whose vocab block holds pad lanes only' if launches and pads else ''}"
        f"{')' if launches else ''} beside one device's "
        f"{nonzero(want['launches'])}; {lead['wall']:.2f}s")


def compare_inputs(torch, ranks, one, after_granite, card) -> int:
    """Phase 23 against the one-device runs ``one`` (computed beside the
    ranks' start): paper-mt-base over (1, 2) and (2, 2), granite's
    draft_model static and its engine (unified over (1, 2), disaggregated
    over (2, 1, 2)), the locality engine over (1, 2) and (2, 1); llava over
    (1, 2) against 19a's, the locality fields as one static batch over (2,
    1) against 13a's rows; paper-mt-base bf16 over (1, 2) beside one
    device's.  Returns the sharded fp32 runs with every row equal."""
    from repro_torch import bridge
    from repro_torch.config import get_config
    from repro_torch.models import model as M
    from repro_torch.models import seq2seq as S

    equal = 0
    mcfg = get_config("paper-mt-base").replace(dtype="float32")
    src = ONE_DEVICE[(mcfg.name, "src")].cuda()
    after = lazy_after(lambda: mt_logits_after(
        torch, S, M.init(mcfg, seed=0, device="cuda"), mcfg, src))
    for key, idx, paths in (("mt (1, 2)", (0, 1), MESH_MT_PATHS),
                            ("mt (2, 2)", (0, 1, 2, 3), MESH_MT_22_PATHS)):
        equal += compare_decodes(torch, ranks, key, idx, paths,
                                 lambda label: one["mt"][label],
                                 after, 0, "paper-mt-base")
    b, w = ranks[0]["inputs"]["mt bf16 (1, 2)"], one["mt bf16"]
    same = sum(bool(torch.equal(torch.as_tensor(b["tokens"])[r],
                                w["tokens"][r])) for r in range(8))
    log(f"[inputs] bf16 paper-mt-base exact over (1, 2), {MESH_MT_NEW} new "
        f"tokens: {int(b['generated'].sum()) / b['wall']:.1f} tokens/s beside "
        f"one device's {int(w['generated'].sum()) / w['wall']:.1f}; "
        f"k̂={b['khat']:.4f} in {b['iterations']} iterations (one device "
        f"{w['khat']:.4f} in {w['iterations']}); "
        f"{b['collectives'] / b['iterations']:.1f} collectives an iteration "
        f"on rank 0; {same}/8 rows equal to one device's (recorded, not "
        f"gated); {card}")

    lcfg = get_config("llava-next-34b").replace(num_layers=LLAVA_FP32_LAYERS,
                                                dtype="float32")
    lbatch = llava_batch(torch, lcfg, ONE_DEVICE[(lcfg.name, "prompts")]
                         .cuda())
    after = lazy_after(lambda: causal_logits_after(
        torch, M, M.init(lcfg, seed=0, device="cuda"), lcfg, lbatch))
    equal += compare_decodes(torch, ranks, "llava (1, 2)", (2, 3),
                             MESH_LLAVA_PATHS,
                             lambda label: ONE_DEVICE[(lcfg.name, label)],
                             after, 64, "llava-next-34b")
    log(f"[inputs] llava (1, 2) peak a rank "
        f"{[round(ranks[i]['inputs']['llava (1, 2)']['peak'] / 2 ** 30, 2) for i in (2, 3)]}"
        f" GiB (28 / 4 heads, half the vocab a rank)")

    for name in ("self", "small"):
        key = f"draft {name} (1, 2)"
        equal += compare_decodes(torch, ranks, key, (0, 1), ("run",),
                                 lambda _: one[f"draft {name}"],
                                 after_granite, 64, "granite draft_model")
        for i in (0, 1):
            r = ranks[i]["inputs"][key]["run"]
            check(r["self_draft"] == (name == "self"),
                  f"23 {key} rank {i}: the self-draft's bundle is not the "
                  f"primary's sharded tree")
            check(2 * r["draft_kv_heads"] == r["draft_kv_whole"],
                  f"23 {key} rank {i}: the draft's cache at "
                  f"{r['draft_kv_heads']} of its {r['draft_kv_whole']} KV "
                  f"heads at model 2")
    compare_engine_records(ranks, "draft engine (1, 2)", (2, 3),
                           one["draft engine"],
                           "draft_model + exact engine, unified (1, 2)")
    compare_engine_records(ranks, "draft engine (2, 1, 2)", (0, 1, 2, 3),
                           one["draft engine"],
                           "draft_model + exact engine, disaggregated "
                           "(2, 1, 2)", launches=False)

    want = one["locality"]
    for key, idx in (("locality (1, 2)", (2, 3)), ("locality (2, 1)", (2, 3))):
        compare_engine_records(ranks, key, idx, want,
                               f"locality + exact engine {key[9:]}")
    fcfg = fixture_config(LOCALITY / "locality")
    fparams = bridge.load_checkpoint(str(LOCALITY / "locality" / "checkpoint"),
                                     fcfg, device="cuda")
    rows = ranks[2]["inputs"]["locality (2, 1)"]["static"]
    n = match_reference(torch, causal_logits_after(torch, M, fparams, fcfg),
                        rows, ONE_DEVICE[("locality", "rows")][:len(rows)],
                        "locality static batch over (2, 1)")
    log(f"[inputs] locality: {len(rows)} fields as one static batch over "
        f"(2, 1): {n}/{len(rows)} rows equal to 13a's row-alone decodes "
        f"(others at reported near-ties)")
    secs = [round(r["inputs"]["seconds"], 1) for r in ranks]
    log(f"[inputs] phase 23 on the ranks {secs}s (from each one's end of "
        f"phase 22); seconds by part on ranks 0 and 2: "
        f"{ranks[0]['inputs']['parts']}, "
        f"{ranks[2]['inputs']['parts']}")
    return equal


def lazy_logits_after(torch, M, arch):
    """``causal_logits_after`` of ``arch``'s one-device fp32 weights
    (``family_weights``), drawn on the first call."""
    return lazy_after(lambda: causal_logits_after(
        torch, M, *family_weights(torch, arch)))


def compare_mesh_families(torch, ranks, prompt_len, card) -> int:
    """Phase 22's family runs against the one-device runs of phases 16-18
    (and rwkv6-1.6b's beside the ranks' start): every sharded fp32 run's
    tokens, counters and launches a rank equal one device's (the near-tie
    rule and its router extension, each admission reported), every rank's
    expert ids of a forward equal; olmoe's engine over (1, 2) record for
    record; olmoe's bf16 serve over (1, 2) beside phase 17's (tokens/s, k̂,
    collectives an iteration, peak a rank, each first divergence a
    near-tie).  Returns the sharded runs with every row equal."""
    from repro_torch.config import get_config
    from repro_torch.models import model as M

    equal = 0
    for mesh, idx, families in (((1, 2), (2, 3), MESH_FAMILY_PATHS),
                                ((1, 4), (0, 1, 2, 3),
                                 {"olmoe-1b-7b": ("exact dense",)})):
        for arch, paths in families.items():
            cfg = get_config(arch).replace(dtype="float32",
                                           num_layers=FAMILY_FP32_LAYERS[arch])
            after = lazy_logits_after(torch, M, arch)
            runs = [(i, ranks[i]["families"][mesh][arch]) for i in idx]
            for label in paths:
                want = ONE_DEVICE[(arch, ONE_DEVICE_PATH[label])]
                same = True
                for i, r in runs:
                    got = r[label]
                    ok = compare_mesh_run(torch, after, got, want,
                                          f"{arch} {mesh} rank {i} {label}",
                                          prompt_len, cfg=cfg)
                    if ok:
                        check(nonzero(got["launches"])
                              == nonzero(want["launches"]),
                              f"22 {arch} {mesh} rank {i} {label}: launches "
                              f"{nonzero(got['launches'])} vs one device's "
                              f"{nonzero(want['launches'])}")
                    same = same and ok
                    equal += ok
                lead = runs[0][1][label]
                log(f"[mesh] {arch} {FAMILY_FP32_LAYERS[arch]} layers fp32 "
                    f"{mesh} {label}: "
                    f"{'tokens, counters and launches equal to' if same else 'near-tie divergences from'}"
                    f" one device's on ranks {list(idx)}; k̂="
                    f"{float(lead['generated'].sum()) / lead['iterations'] / 8:.4f}"
                    f", iterations {lead['iterations']} (one device "
                    f"{want['iterations']}), launches a rank "
                    f"{nonzero(lead['launches'])}; {lead['wall']:.2f}s (one "
                    f"device {want['wall']:.2f}s)")
            if cfg.mlp_type == "moe":
                ids = [r["expert ids"] for _, r in runs]
                for i, other in zip(idx, ids):
                    check(sorted(other) == sorted(ids[0]) and all(
                        np_equal(other[layer], ids[0][layer])
                        for layer in ids[0]),
                        f"22 {arch} {mesh}: rank {i}'s expert ids of a "
                        f"forward differ from rank {idx[0]}'s")
                log(f"[mesh] {arch} {mesh}: the expert ids of a forward of "
                    f"the prompts ({len(ids[0])} layers, top-"
                    f"{cfg.num_experts_per_tok} of {cfg.num_experts}) equal "
                    f"on ranks {list(idx)}")

    want = ONE_DEVICE[("olmoe-1b-7b", "engine unified paged")]
    got = [(i, ranks[i]["engine"]["olmoe (1, 2)"]["unified paged"])
           for i in (2, 3)]
    for i, g in got:
        compare_engine_runs(g, want, f"olmoe engine (1, 2) rank {i}")
        check(nonzero(g["launches"]) == nonzero(want["launches"]),
              f"22 olmoe engine (1, 2) rank {i}: launches "
              f"{nonzero(g['launches'])} vs one device's "
              f"{nonzero(want['launches'])}")
    lead = got[0][1]
    log(f"[mesh] olmoe-1b-7b engine (1, 2), unified paged, phase 17's 16 "
        f"requests: records, counters and launches equal to one device's on "
        f"ranks 2, 3 (launches a rank {nonzero(lead['launches'])}); "
        f"{lead['wall']:.2f}s (one device {want['wall']:.2f}s)")

    runs = [ranks[i]["olmoe bf16"] for i in (2, 3)]
    one = ONE_DEVICE[("olmoe-1b-7b", "bf16 serve")]
    for i, b in zip((2, 3), runs):
        check(np_equal(b["tokens"], runs[0]["tokens"]),
              f"22 olmoe bf16: rank {i}'s tokens differ from rank 2's")
        check(all(d["tie"] for d in b["divergences"]),
              f"22 olmoe bf16: rank {i} diverges from phase 17's serve beyond "
              f"{BF16_TIE_ULPS} ulps: {b['divergences']}")
    b = runs[0]
    gen = int(b["generated"].sum())
    log(f"[mesh] bf16 olmoe-1b-7b, 16 layers, sharded over (1, 2) on ranks "
        f"2, 3 (32 of 64 experts a rank): {gen / b['wall']:.1f} tokens/s "
        f"beside phase 17's single-device {one['tps']:.1f}; k̂="
        f"{gen / b['iterations'] / 8:.4f} (phase 17: {one['khat']:.4f}), "
        f"iterations {b['iterations']} ({one['iterations']}); "
        f"{b['collectives'] / b['iterations']:.1f} collectives an iteration "
        f"on rank 2; peak a rank "
        f"{[round(r['peak'] / 2 ** 30, 2) for r in runs]} GiB (one device "
        f"{one['peak'] / 2 ** 30:.2f}); launches a rank "
        f"{nonzero(b['launches'])}; first divergences from phase 17's tokens: "
        f"{len(b['divergences'])} rows, all within {BF16_TIE_ULPS} bf16 ulps "
        f"of the top logit ({[round(d['bpd_ulps'], 3) for d in b['divergences']]}); "
        f"{card}")
    return equal


def np_equal(a, b) -> bool:
    import numpy as np

    return bool(np.array_equal(np.asarray(a), np.asarray(b)))


def main() -> int:
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke.py: run it from the root of a checkout of the repo "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 means fp32
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build()
    log(f"[build] {len(_build.KERNELS)} kernels for sm_90a in "
        f"{time.perf_counter() - t0:.1f}s: "
        f"{[_build.library_path(n).name for n in _build.KERNELS]}")

    results = {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    log("[kernels] each CUDA kernel against its plain version")
    check_attention(torch, gen, results)
    check_fused_verify(torch, gen, results)
    check_fused_heads(torch, gen, results)
    check_tree_attention(torch, gen, results)
    check_paged_attention(torch, gen, results)
    check_head_dim_16(torch, gen, results)
    check_head_dim_24(torch, gen, results)
    check_family_heads(torch, gen, results)
    check_hymba_heads(torch, gen, results)
    check_family_vocab(torch, gen, results)
    check_rwkv6_scan(torch, gen, results)
    check_mt_heads_verify(torch, gen)
    check_mesh_shapes(torch, gen, results)
    check_input_shapes(torch, gen, results)
    for name, r in results.items():
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        extra = f"; {r['extra']}" if "extra" in r else ""
        log(f"  {name} @ {r['shape']}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {lib}, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}){extra}")
        f32 = r["fp32"]
        yard = ("none" if f32["yardstick_ms"] is None else
                f"{f32['yardstick_ms']:.4f} ms ({f32['yardstick']}); "
                f"yardstick / kernel {f32['yardstick_ms'] / f32['ms']:.2f}")
        log(f"    fp32: kernel {f32['ms']:.4f} ms, bound "
            f"{f32['bound_ms']:.4f} ms ({f32['bound_by']}, "
            f"{f32['ms'] / f32['bound_ms']:.1f}x), yardstick {yard}")

    stamp(t_start, "phases 1-3")
    phase4 = phase_decode(torch, results)
    stamp(t_start, "phases 4-7, 14, 15")
    gc.collect()                                  # granite's weights go first
    torch.cuda.empty_cache()
    log(f"[rwkv] granite freed: {torch.cuda.memory_allocated() / 2 ** 30:.1f} "
        f"GiB allocated")
    phase_rwkv(torch, results)
    stamp(t_start, "phases 8-9")
    gc.collect()                                  # then rwkv6's
    torch.cuda.empty_cache()
    phase_mt(torch, results)
    exact_rows = phase_fixture(torch)
    phase_draft_fixture(torch, exact_rows)
    phase_draft_launcher(torch)
    stamp(t_start, "phases 10, 15c, 15e")
    phase_quickstart(torch, card)
    phase_locality(torch, card)
    stamp(t_start, "phases 12-13")
    gc.collect()                                  # every earlier phase's
    torch.cuda.empty_cache()
    t16 = time.perf_counter()
    phase_families(torch, results)
    log(f"[families] phase 16 {time.perf_counter() - t16:.1f}s")
    gc.collect()
    torch.cuda.empty_cache()
    t17 = time.perf_counter()
    phase_moe(torch, results)
    log(f"[moe] phase 17 {time.perf_counter() - t17:.1f}s")
    gc.collect()
    torch.cuda.empty_cache()
    t18 = time.perf_counter()
    phase_hymba(torch, results)
    log(f"[hymba] phase 18 {time.perf_counter() - t18:.1f}s")
    gc.collect()
    torch.cuda.empty_cache()
    t19 = time.perf_counter()
    phase_llava(torch, results)
    log(f"[llava] phase 19 {time.perf_counter() - t19:.1f}s")
    gc.collect()
    torch.cuda.empty_cache()
    t20 = time.perf_counter()
    phase_hubert(torch, card)
    log(f"[hubert] phase 20 {time.perf_counter() - t20:.1f}s")
    gc.collect()
    torch.cuda.empty_cache()
    t21 = time.perf_counter()
    phase_rwkv_train(torch, results, card)
    log(f"[rwkv train] phase 21 {time.perf_counter() - t21:.1f}s")
    gc.collect()
    torch.cuda.empty_cache()
    phase_train(torch, phase4)
    stamp(t_start, "phase 11")
    gc.collect()                                  # every model freed
    torch.cuda.empty_cache()
    phase_mesh(torch, phase4, card)
    stamp(t_start, "phase 22")

    kernels = []
    for name in _build.KERNELS:
        r = results[name]
        check(r.get("launches", 0) > 0, f"{name} never launched on the path")
        kernels.append({"name": name, "route": "cuda", "source": r["source"],
                        "replaces": r["replaces"], "launches": r["launches"],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    log(f"[done] {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke.py: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
