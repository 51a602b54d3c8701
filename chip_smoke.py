#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one NVIDIA GPU (written for an H100) and the CUDA toolkit's ``nvcc``.
Imports neither ``jax`` nor the JAX package ``repro``.  Phases, each
printing one JSON line; any failure raises and exits non-zero:

  1. build      compile ``src/repro_torch/kernels/csrc/*.cu`` for sm_90a;
                prints each kernel's registers, shared memory and spills
                (``-Xptxas -v``).
  2. kernels    both grouped kernels against their plain PyTorch versions
                on the card at VGG-16/CIFAR first-layer width (G=4, B=64,
                K=q=3072, N=65536; plus kappa=4) and a ragged shape, for
                every slot-index pattern of the reference's tests plus an
                out-of-range index that must clamp.  Bound:
                max|kernel - plain| <= 1e-4 * max|plain|.  Gated: K1 (the
                split-K morph kernel) and K2 (split TF32 on the tensor
                cores) give the same bits on two calls at the main shape;
                K2's and torch.bmm's error against a float64 product on the
                card over the first 8,192 columns (``err_vs_fp64``), K2's
                within 1e-5 * max|fp64|.  K2's bound is the split form's (3
                x its flops at 495 TFLOP/s TF32, or its bytes), the fp32
                FFMA bound beside it.  Times kernel, plain version and
                one library call (torch.bmm over the pre-gathered weights,
                a yardstick the port never calls), and prints, not gated,
                K1's time at each split of K (the wrapper's rule picks one)
                and K2's product run on K1's FFMA kernel beside K2's own
                (``on_morph_kernel``).
  3. main_path  ``MoLeDeliveryEngine`` at alpha=3, beta=64, m=32, p=3,
                kappa=1: 4 tenants at capacity 4, rounds of 256 one-image
                requests (one (4, 64, 3072) microbatch per flush).  Checks
                the features against per-request ``MoLeSession.deliver``
                and eq. 5 against ``conv_reference`` with the channel
                permutation applied, and that both kernels' launch counters
                rose by the number of microbatches.
 3a. async_path the async front door (``AsyncDeliveryEngine``,
                max_delay_ms 5, admission block) over main_path's registry:
                4 submitter threads submit its 256 requests, 3 rounds.
                Gated: every result within 1e-4 * max of per-request
                delivery; K1 and K2 launched, no other kernel; one round
                through an injected device-phase crash (``FailureInjector``)
                resolves every rid once with the same results; a backlog
                of 64 pending requests persisted to a snapshot directory
                (``CheckpointManager``, a temp dir) restores into a fresh
                front door over a fresh registry and resolves each rid
                once, with the same results.  Printed, not gated: images/s
                beside main_path's sync engine, client-side p50/p95 latency
                (submit call to resolution), the coalesce/device/publish
                p50, submit stalls, the snapshot's save time (capture and
                write) and its restore time (load, restage, and delivery
                of the 64 requests).
 3b. served_path the TCP front door (``launch.server.DeliveryServer``, in
                process on 127.0.0.1, an ephemeral port) over an
                ``AsyncDeliveryEngine(admission="reject")`` on main_path's
                registry, driven by the client fleet (``launch.client``):
                256 one-image requests from 16 connections as one burst,
                then 256 at 1000/s with server-side network chaos (dropped
                accepts, requests lost after read, truncated and stalled
                writes) at ``serve --chaos``'s default rate 0.2, the
                clients hedging after 0.5 s, up to 24 sends in 30 s.
                Gated: ``FleetReport.assert_exactly_once()``, every rid of
                both runs ok (no client timeout), no rid lost at the
                drain, every delivered array within 1e-4 * max of
                per-request delivery of the fleet's own request, K1 and K2
                launched, no other kernel.  Printed:
                requests/s, p50/p95, shed/expired/reconnect/duplicate
                counts, retries and hedges.
 3c. sharded_path the port's sharding (``repro_torch.sharding``,
                ``launch/mesh.py``) on a one-rank NCCL group and a (1, 1)
                ("data", "model") mesh on the card (NCCL refuses two ranks
                on one device: the multi-rank runs are the CPU tests', on
                gloo).  All seven launch counters reset first.  (a) Under
                ``mesh_context``, one round of main_path's 256 requests on
                main_path's registry through a fresh engine: its delivered
                images bit-equal to an unsharded engine's on the same
                registry and round, K1 and K2 launched once a microbatch
                as there, and ``_execute`` returns a DTensor placed
                ``Shard(0)`` on "data"; (b) ``compressed_psum`` of 2^20
                normals over "data" within the reference's 0.05, int8 on
                the wire; (c) the train step at deepseek_7b's published
                width in fp32, 2 layers (1.24 B parameters), 2 sequences
                of 256 in 2 microbatches, parameters and moments placed by
                ``param_rules`` / ``opt_state_rules``, against the same
                step unsharded: loss and grad norm within 1e-5 relative,
                each gradient leaf within 1e-5 of its max|g|; (d)
                ``_apply_moe_sharded`` on one deepseek_moe_16b MoE layer at
                published widths (d 2048, 64 routed experts of 1408, 2
                shared, top-6) in fp32 on 4 x 512 tokens, the rank's own
                rows with the weights placed by ``param_rules`` and viewed
                as the train step views them, against the dense
                ``apply_moe`` (one rank: its tokens and experts are all of
                them, at the same capacity) within 1e-5 of max.  No other
                kernel runs.  Prints each reading beside its limit, the
                steps' times, the peak device memory and the phase's time.
  4. churn      6 tenants at capacity 4 (alpha=3, beta=16, m=16), so slots
                are evicted inside one flush round and the engine's
                copy-on-write of the secret stacks runs; every result must
                match per-request delivery.
 4a. features_path the continuous LM lane (``lane="features"``) of
                ``MoLeDeliveryEngine`` at Llama-3.2-Vision-90B's frontend
                width: d_in 7680 (the stubbed vision tower's patch width)
                to d_model 8192, vocab 128256, kappa 1.  2 tenants in 2
                slots (FEAT_TENANTS says why not 4), each with its own W_in
                (7680, 8192) and one shared (128256, 8192) embedding; a
                warm round, then 2 timed rounds of 8 patch streams (1,
                1024, 7680) through the default buckets, so K1 runs at x
                (2, 64, 7680) x cores (2, 7680, 7680) and K2 at (2, 64,
                7680) x (2, 7680, 8192).  Gated:
                every rid resolves once with shape (1, 1024, 8192); each
                output within 1e-5 * max of per-request
                ``LMSession.deliver_features`` on the card; each output of
                both rounds within 3 sqrt(d_in) 2^-24 * max of x @ W_in
                in float64 (the unfuse property; FEAT_UNFUSE_REL says
                why); K1 and K2 launched once per microbatch, no other
                kernel.  At these shapes, on the engine's own stacks, K1
                and K2 against their plain versions (1e-4 * max) and K2
                against float64 (1e-5 * max), with their device time in
                CUDA graphs, the plain version's, torch.bmm's and the
                bound.  Printed: positions/s from submit to take, the
                coalesce/device/publish p50, the host secret build (an
                fp64 QR of 7680^2 and the fusion per tenant) timed apart,
                and the peak device memory.
  5. kernels_k3 the decode-logits kernel (``grouped_row_gemm``, K3) against
                its plain version at the LM paths' shapes, deepseek_7b's h
                (4, 4096) x tables (6, 4096, 102400) and phi3_mini_3p8b's h
                (4, 3072) x tables (6, 3072, 32064) (``row_phi3``; its
                ragged last strip of 512 table bytes, the last 64 columns
                on either table dtype, held apart too), and ragged (R=3,
                K=3000, N=1000 and N=999): fp32 tables and the same tables
                cast to bf16, h in bf16 and fp32, every slot-index pattern
                incl. the out-of-range clamp and duplicates.  Bound: fp32 h
                max|kernel - plain| <= 1e-4 * max|plain|; bf16 h two bf16
                units in the last place of max|plain| (each side rounds
                once).  Gated: two calls give the same bits.  At
                both shapes, on 4 distinct slots with bf16 h, for bf16
                tables (the lane's head stacks: the main path) and fp32
                tables: K3 in CUDA graphs (``graph_ms``) and back to back
                (``cuda_ms``), the plain version back to back, one library
                call (torch.bmm of h[:, None, :] against the same tables, a
                yardstick the port never calls) both ways, and the byte
                bound of each table dtype.  ``row_command_r`` and
                ``row_gemma2``: K3 at the vocab-256000 decode shapes, h (4,
                8192) x (4, 8192, 256000) and h (4, 4608) x (4, 4608,
                256000), on bf16 tables only (16.78 and 9.44 GB; fp32 would
                need 33.5 GB), drawn slot by slot: against the plain version
                (two bf16 ulps) with gidx in order and reversed, two calls
                the same bits, the last slot's last 256 columns (entries
                past 2^31 and 2^33) against a float64 product; timed as
                the rows above.
  6. lm_path    ``serve --mode lm`` at deepseek_7b FULL width (30 layers,
                d_model 4096, vocab 102400, bf16) with random weights from
                a seeded generator on the card: 4 tenants at capacity 4
                (the lane's Aug-head and AugE stacks gated to be staged in
                the model's bf16; their bytes printed),
                8 requests of 32 prompt tokens, 16 generated tokens each, so
                rows retire and new ones are admitted mid-run.  Gated:
                (1) the token lane's morphed prompts equal numpy's
                perm[tokens] exactly; (2) K3 launched once per batched
                decode step; (3) at every decode step, on the lane's own
                final hidden states and stacked heads, K3's logits agree
                with the plain head (``ref.lm_head_rows_grouped_ref``, no
                K3) within two bf16 ulps of their max, and each sampled
                token is K3's argmax and lies within the tie margin (four
                bf16 ulps of the row's max|logit|) of the plain-head
                maximum; (4) each served row's logits, permuted back with
                its tenant's inverse permutation, equal ``h @ head`` on the
                unfused bf16 head within two bf16 ulps; (5) the same
                serving path on a twin cut to 2 of the 30 layers (full
                width) is held against an independent teacher-forced plain
                ``forward`` on the raw weights with the tie margin (at 30
                random layers bf16 rounding is amplified past that
                margin).  Printed, not gated: tokens/s, decode-step p50,
                where a decode step's time goes (trunk, K3, sampling), the
                admission prefill's time and a profiled step's idle share.
 6a. lm_long_prompt lm_path at deepseek_7b FULL with 4 requests of 2048
                prompt tokens, 8 generated each: every admission prefill is
                above dense_attn_max_seq (1024), so its attention runs the
                chunked flash scan (``models.layers.flash_attention``: 4 Q
                blocks of 512 by 2 KV blocks of 1024, the future block of
                the first two skipped).  Gated as lm_path, plus: the flash
                scan called exactly layers x admissions (30 x 4) times in the
                lane, and twice (once a layer) in the twin's plain
                reference, which past dense_attn_max_seq is the raw model
                served as --mole off serves it: a plain forward (prefill) of
                the 2048-token prompts, then decode steps teacher-forced
                with the lane's tokens (a forward over the generated
                positions would run the flash scan there, whose rounding is
                not decode attention's); the scan at (1, 2048, 32, 128) bf16
                against an fp32 dense attention of the same inputs, within
                twice bf16 dense attention's own distance from it.  Printed:
                each admission prefill's time and their p50, the flash
                scan's, dense attention's and SDPA's (flash backend; a
                yardstick the port never calls) time at that shape.
 6b. mole_off   ``serve.run_lm`` with ``--mole off`` on the card, on
                lm_long_prompt's weights and (the same seeded) prompts: one
                prefill of the 4 raw prompts and a greedy decode, no
                registry, engine or kernel.  Gated: all seven launch counters
                stay 0; the prompts are lm_long_prompt's; each token is the
                argmax of its plain logits; the tokens equal the lane's over
                each request's decided prefix (positions before the first
                whose plain top-1/top-2 gap is within the tie margin); the
                rest is counted, not gated.  Printed: --mole off tokens/s
                beside the lane's.
 6c. phi3_path  lm_path at phi3_mini_3p8b FULL (32 layers, d 3072, 32 heads
                of 96, vocab 32064, bf16): 4 tenants, 8 requests of 3072
                prompt tokens (3 x 1024 KV blocks, 6 Q blocks of 512), 16
                generated; K3 at h (4, 3072) x tables (4, 3072, 32064).
                Gated as lm_long_prompt (the flash scan 32 x 8 times in the
                lane, twice in the twin's plain prefill).
 6d. gemma2_path lm_path at gemma2_27b's published width (d 4608, 32 heads
                of 128 over 16 KV heads, d_ff 36864 GeGLU, vocab 256000,
                local(4096)/global layers, soft-caps 50 and 30, post-norms,
                scaled tied embeddings, bf16) cut to GEMMA2_GROUPS groups
                (the peak held at PEAK_LIMIT_GB; the constants say why): 4
                tenants, 8 requests of 6144 prompt tokens (past the window
                and dense_attn_max_seq), 16 generated; local layers hold
                rings of 4096 slots.  K3 at h (4, 4608) x (4, 4608, 256000)
                on AugE^T.  Gated as phi3_path (checks 3-4 before the final
                soft-cap, the sampled token the argmax after it; the twin
                is one group, a local and a global layer), plus the
                window-live gate: the twin's logits with the window taken
                away differ from its own by more than the tie margin.
                Printed: host_peak_rss_gb and host_secret_and_staging_s.
 6e. command_r_path lm_path at command_r_35b's published width (d 8192, 64
                heads over 8 KV heads, d_ff 22528, parallel blocks on one
                LayerNorm, vocab 256000, tied embeddings, bf16) cut to
                COMMAND_R_LAYERS layers: 4 tenants, 8 requests of 512, 16
                generated; K3 at h (4, 8192) x (4, 8192, 256000).  Gated as
                lm_path, its twin 2 layers.
 6f. moe_path   lm_path at deepseek_moe_16b FULL (28 layers: an attn
                prefix layer with a dense FFN of 10944, then 27 attn_moe
                layers of 2 shared + 64 routed experts of 1408, top-6; d
                2048, 16 heads, vocab 102400, bf16): 4 tenants, 8 requests
                of 512 (dense attention), 16 generated; K3 at h (4, 2048) x
                (4, 2048, 102400).  Gated as lm_path, plus: one routing a
                MoE layer per admission prefill and per decode step, and no
                assignment dropped in a decode step (the lane routes each
                row as a call of its own).  The twin is the prefix layer
                and one MoE layer; its plain reference prefills each prompt
                alone and decodes each sequence alone, as the lane routes
                (``plain_gaps``).  Printed: the dropped assignments of each
                admission prefill over the 27 MoE layers (capacity 64 a
                layer against a mean load of 48 an expert), and the
                smallest gap between a token's 6th and 7th router
                probability in each MoE layer of the twin.
 6g. mla_path   the same at deepseek_v2_lite_16b FULL (27 layers: an mla
                prefix layer, then 26 mla_moe layers; MLA's latent 512, q/k
                of 128 + 64 roped, v 128), prompts of 2048: past
                dense_attn_max_seq, so each admission prefill runs the
                flash scan once a layer (27 x 8) at head_dim 192 with V
                padded from 128; decode attends in MLA's absorbed form over
                the latent cache.
  7. kernels_k45 the single-tenant / per-group morph (``block_diag_matmul``,
                K4) and Aug-Conv (``aug_gemm``, K5) against their plain
                versions in fp32 and bf16: K4 at (R, kappa, q) = (256, 1,
                3072), the VGG-16/CIFAR morph, (256, 3, 1024), (1024, 8,
                960) and ragged (37, 3, 100); ``morph_rows_batched`` at
                (4, 64, 3072) with 4 cores; K5 at (256, 3072) x (3072,
                65536); ``aug_conv_forward_batched`` at (4, 64, 3072) x
                (4, 3072, 65536); ragged K5 (7, 33) x (33, 9).  Bound: fp32
                max|kernel - plain| <= 1e-4 * max|plain|, bf16 two bf16
                ulps of max|plain|.  Gated: K4 and K5 give the same bits on
                two calls at their main shapes, fp32 and bf16; K4 and K5
                fp32's error against a float64 product on the card over the
                first 8,192 columns (``err_vs_fp64``, beside torch.matmul's)
                within 1e-5 * max|fp64|.  K4 and K5 fp32's bounds are the
                split form's, the FFMA bound beside it (K4 in fp32 runs the
                split-TF32 GEMM, split as ``gemm.tf32_splits`` says; the
                route and split are printed); bf16 keeps the bf16
                tensor-core bound.  Times kernel, plain version (in
                fp32 that is one ``torch.matmul``) and one library call
                (``torch.matmul`` in the operand dtype: cuBLAS, fp32 with
                TF32 off, bf16 on the tensor cores) at the VGG-16 shapes,
                and prints, not gated, K5's product run on K4's FFMA
                kernel beside K5's own (``on_morph_kernel``).  K4 also at
                vlm_train's and whisper_train's provider morphs, (2048,
                7680) x (7680, 7680) and (24000, 384) x (384, 384) fp32:
                against its plain version, a float64 product (1e-5 *
                max|fp64|) and torch.matmul.  K4's sweep over splits is
                ``tools/k4_probe.py``'s.
  8. vgg_path   the paper's developer path at VGG-16/CIFAR width (13 convs
                64..512, 32x32, 10 classes), random weights from a seeded
                generator on the card: one provider (``DataProvider``,
                kappa=1) whose C^{ac} (805 MB fp32) is built from the VGG's
                own first-layer kernels; 256 seeded images.  The provider
                morphs the batch (K4, ``kernels.morph_rows``) and the
                developer runs Aug-VGG-16 on the morphed rows (K5 in the
                first layer, ``models.cnn.apply``).  Gated: (1) K4's rows
                equal ``DataProvider.morph_batch`` (plain) within 1e-4 *
                max; (2) K5's first-layer features equal
                ``conv_reference(D, K)[:, perm]`` within 1e-4 * max|conv|;
                (3) Aug-VGG-16 logits (permutation absorbed into
                ``convs[0].b`` and ``convs[1].w``) equal plain VGG-16 logits
                on the raw images (cuDNN, TF32 off) within 1e-3 *
                max|plain|, and the argmax agrees wherever the top-2 gap
                exceeds twice that; (4) three SGD steps (batch 64, lr 1e-3)
                from the two parameter sets (the plain first conv frozen, as
                C^{ac} is), and the loss on a fourth batch after them, agree
                within 1e-3 relative; (5) K4 and K5
                launched once per call made, K1-K3 not at all.  Printed,
                not gated: plain and Aug-VGG-16 forward p50 (batch 256,
                CUDA events), K4 per batch, the measured compute overhead
                aug/plain - 1 beside the derived 0.636 and the paper's 0.09.
  9. kernels_k6 the RWKV-6 chunked scan (``wkv6_chunked``, K6) against both
                plain versions, the chunked form (``ref.wkv6_chunked_ref``)
                and the token recurrence (``ref.wkv6_ref``), in fp32 at 40
                heads of 64, chunk 128: T = 1024, T = 384 (300 padded),
                160 heads at T = 128, T = 32 < chunk, and 80 heads at T =
                4096 (rwkv_train's microbatch), there also under strong
                decay (logw = -exp(N + 1), every chunk's product of w
                underflowing); inputs as the reference's wkv6 sweep draws
                them, s0 nonzero.  Bound: out and final state within 1e-4 *
                max|plain|.  Gated: two calls at (40, 384) and at (80,
                4096) give the same bits.  Prints the form and size
                ``gemm.scan_form`` took at each shape (the columns form at
                the prefill's, the time-chunked form at rwkv_train's) and
                its graph-timed ms.  Times kernel and plain chunked
                version at (40, 384); no PyTorch call computes the scan
                (library_ms null).  Prints, not gated: the columns form's
                floor (3 BH T D^2 FFMA-pipe instructions), its geometry (G
                threads per state column, CPT columns per thread, C
                columns a block) and shared memory, ptxas's registers and
                spills, its time at T = 32, 128, 384, 1024 (BH = 40) and at
                every block width C.  Sweeps over the chunk length are
                ``tools/k6_probe.py``'s.
                K6's times are device times from CUDA graphs of 10 calls
                (``graph_ms``; the kernel runs shorter than its wrapper's
                host time), the back-to-back time beside them.
                The backward (``kernels.wkv6_scan``: one K6 launch on
                flipped operands, two launches of the key-row scan
                ``wkv6_rows``, ``csrc/wkv6_rows.cu``) at one time-mix
                layer's training shape (BH 80 = 2 sequences x 40 heads, T
                4096, D 64, chunk 128), decays drawn as the model's
                ``_decay`` draws them at init, s0 and dS_T nonzero: the
                key-row kernel against ``ref.wkv6_rows_ref`` (1e-4 *
                max|plain|); each of dr, dk, dv, dlogw, du and ds0 against
                float64 autograd of the token recurrence (checkpointed by
                segments of 128 tokens) within 1e-4 * max|float64|, the
                fp32 autograd of the same recurrence's departure printed
                beside it; two backward calls give the same bits.  Timed:
                the key-row kernel (``graph_ms``; chunks of time in
                parallel, chained, of the library's ``gemm.rows_chunk``
                tokens) beside its plain version, its bound and, under
                ``bounds``, its form's floor (four FMA-pipe instructions
                per token, row and column), with ptxas's report, and the
                whole backward (``cuda_p50``) beside its bound.  Sweeps
                over the kernel's geometry are ``tools/k6_probe.py
                rows``'s.
 10. rwkv_path  ``serve --mode lm`` at rwkv6_3b FULL width (32 layers,
                d_model 2560, 40 heads of 64, vocab 65536, bf16), random
                weights from a seeded generator on the card: 4 tenants at
                capacity 4, 8 requests of 300 prompt tokens (every
                admission prefill is 3 chunks of 128 with 84 padded), 16
                generated tokens each.  Gated as lm_path, checks 1-4
                (check 2 also: K6 launched exactly once per layer per
                admission prefill, 32 x 8), then (5) K6's output and final
                state on one layer's operands, as the first admission
                prefill handed them over, against the token recurrence
                within 1e-4 * max, and (6) the 2-layer twin against a plain
                forward whose time-mix runs the token recurrence in K6's
                place, with the tie margin.  Printed, not gated: as
                lm_path, K6's time per prefill and its share of the
                admission prefill, as device time (``graph_ms``) and back
                to back (``cuda_p50``, the wrapper's host time included, as
                the eager prefill pays it).  Peak memory is read per LM phase
                (reset at its start).  Every path phase sets all seven
                launch counters to 0 before its run and fails if a kernel
                not on its path was launched.
 10a. train_path the train step (``launch/steps.py`` ``make_train_step``:
                loss through the chunked ``fused_ce``, per-block remat,
                gradients of 2 microbatches of 4 summed in fp32, the port's
                AdamW) at deepseek_7b's published width (d 4096, 32 heads
                of 128, d_ff 11008, vocab 102400, bf16) cut to 15 layers
                (training holds 16 B a parameter; TRAIN_LAYERS says why),
                random weights from a seed, 2048 positions a sequence (the
                flash scan and its backward), on ``Pipeline``'s stream
                morphed by its provider stage (``--mole token``): 2
                untimed and 3 timed steps, then one profiled.  Gated: (1)
                loss and grad_norm finite at every step, the optimizer's
                count equal to the steps run; (2) all seven launch counters
                0; (3) on a 2-layer twin at full width, 2 steps of the raw
                params on the raw stream against the fused params
                (``fuse_lm_params``) on the morphed stream, from one init:
                the losses of the first 2 fp32 steps and of the first bf16
                step within TRAIN_LOSS_RTOL (bf16 step 2 printed: Adam
                amplifies rounding from random init, TRAIN_GATED_STEPS);
                (4) after
                training, no leaf requires grad, and the decode lane's
                admission prefill and batched decode step on the trained
                twin return tensors without ``grad_fn`` (the twins: 2
                layers, a prefix layer and one group where there is one).
                Printed:
                train_step_ms (p50 of the timed steps), train_tokens_per_s,
                train_peak_gb, train_mfu (6 (N - V d) flops a token for
                the N active parameters, plus 6 H (d_qk + d_v) a layer and
                token per attended position, remat's recompute not counted,
                over 989 TFLOP/s),
                the profiled step's top kernels and operations and its idle
                share, and the phase's own time.
 10b. train_resume_path the training driver (``launch/train.py`` ``main``,
                its ``ResilientLoop`` and checkpoints) at phi3_mini_3p8b's
                published width (d 3072, 32 heads of 96, d_ff 8192, vocab
                32064, bf16) cut to 2 layers (RESUME_LAYERS says why), run
                through ``main(argv, cfg=...)`` with the reference's flags
                (``--mole token --seq-len 2048 --batch 8 --microbatch 2
                --warmup 4 --ckpt-every 3``; RESUME_FLAGS says why the
                warmup is 4) and checkpoints under a temp
                dir (its filesystem checked first for room): a clean run of
                8 steps, a faulty one (``--inject-failures 5``: a restore
                from step 3), a cut one (``--steps 4``, then ``--steps 8
                --resume``), and a second clean run as a control.  Gated:
                (1) loss and grad_norm finite at every step, restarts 0, 1,
                0; (2) all seven launch counters 0; (3) the faulty and resumed
                runs' losses at steps 3-7 and their final params and
                moments equal the clean run's bit for bit when the two
                clean runs are bit-equal, else within twice the clean runs'
                own largest departure; (4) just after the restore, every
                leaf holds the step-3 state's bits in the storage it had
                before the failure; (5) no leaf requires grad after the
                runs.  Printed: step p50 and tokens/s, the time to save
                one checkpoint (host copy, then write), the restore
                seconds, the checkpoint bytes, the peak, which case of gate
                3 held, and the phase's own time.
 10c. gemma2_train train_path at gemma2_27b's published width, 1 group (a
                local and a global layer, 2.31 B parameters), 2 sequences
                of 6144 in 2 microbatches, remat, bf16, ``--mole token``:
                gates 1-4 (the twins are that group, in fp32 and bf16), the
                peak held at PEAK_LIMIT_GB.  MFU counts a local layer's
                attention over its mean attended context (min(p + 1,
                4096) over the positions) and a tied head's product once.
 10d. mla_train train_path at deepseek_v2_lite_16b's published width, its
                prefix layer and 2 groups (3 layers, 1.67 B parameters), 4
                sequences of 2048 in 2 microbatches (each one routing call,
                capacity 480), remat, bf16, ``--mole token``: gates 1-4
                (the twins are the prefix layer and one MLA-MoE layer in
                fp32 and bf16), the peak held at PEAK_LIMIT_GB.  MFU counts
                the active parameters (shared and top-6 routed experts)
                and MLA's attention as 6 H (192 + 128) a token, layer and
                attended position.
 10e. recurrentgemma_train train_path at recurrentgemma_2b's published
                width and depth (26 layers: 8 groups of rec, rec, local and
                a rec, rec suffix; 2.67 B parameters; RG_TRAIN says why
                they fit), 4 sequences of 4096 in 2 microbatches (every
                local layer's window of 2048 slides), remat, bf16,
                ``--mole token``: gates 1-4 (the twins are one group and
                the suffix, 5 layers, in fp32 and bf16), the peak held at
                PEAK_LIMIT_GB.  The RG-LRU's scan runs forward and, in
                the backward, as the reverse scan of ``_LinearScan``.  MFU
                counts 6 N a token (the tied head once) and the local
                layers' attention over their mean attended context; the
                scan and the conv are elementwise and not counted.
                Printed beside the other train phases' figures: the scan's
                time forward and forward plus backward at one rec layer's
                shape and its share of the step (``scan_ms``).
 10f. vlm_path ``serve --mode lm`` (``serve.run_lm`` on a given config)
                at llama32_vision_90b's published width (d 8192, 64 heads
                of 128 over 8 KV heads, d_ff 28672 SwiGLU, vocab 128256, a
                frontend of 1024 patches of 7680, tanh-gated cross layers
                every fifth layer, bf16) cut to VLM_GROUPS of 20 groups
                (the peak held at PEAK_LIMIT_GB; the constants say why),
                both gates of every cross layer drawn in +-1 (the init's
                zeros would make every cross layer add 0): 2 tenants x 8
                requests of 512, 16 generated; the token lane morphs the
                prompts, then one tenant at a time its fused params
                (``fuse_lm_params``) prefill its 8 prompts beside all-zero
                patches, as the reference feeds them, and decode greedily.
                Gated: no kernel; each prefill fed (8, 1024, 7680) zero
                bf16 patches; a fusion and a prefill a tenant; the peak;
                every cross layer's caches after a prefill of 4 prompts
                beside random patches equal to K/V computed apart from the
                patches; and on the twin (its first attention and first
                cross layer, full width, random patches): the served
                logits unmorphed against the raw params' prefill and decode
                within two bf16 ulps, each token within the tie margin of
                an independent teacher-forced forward with no cache.
                Printed:
                prefill and decode-step p50, tokens/s, fusing a tenant.
 10g. vlm_train the train step at that width on ("attn", "cross") x 1
                group (3.876 B parameters), 2 sequences of 2048 in 2
                microbatches, remat, bf16, ``--mole embedding`` (kappa 1):
                the developer's params fused from the init (``AugProj =
                M^-1 W_in``) train on the provider stage's stream, whose
                patches K4 morphs on the card.  Gates: (1) as train_path;
                (2) K4 the only kernel, once a batch, at (2048, 7680) x
                (7680, 7680); (3) at step 1 the raw params on raw patches
                against the fused on morphed: in fp32 (no optimizer
                state) the loss, every gradient but frontend_proj's, and
                frontend_proj's against M^T times the raw one, and in
                bf16 the train step's loss, each within VLM_GATE3_K times
                the raw form's departure from a float64 evaluation (step
                2 printed: AdamW is not rotation-invariant); (4) as
                train_path.  Printed: step p50, tokens/s, MFU (6 flops a
                token for the
                parameters a token multiplies, attention over the causal
                context and the 1024 patches, and 6 a parameter and patch
                for frontend_proj and the cross K/V), the peak, a profiled
                step, the provider stage's ms a batch and K4's share.
 10h. whisper_path :func:`frontend_path` (vlm_path's serving and gates) at
                whisper_tiny's published width and depth (4 bidir encoder
                layers over 1500 frames of 384, 4 dec layers, d 384, 6 heads
                of 64, vocab 51865, bf16), the attention's query and key
                weights scaled by sqrt(H / d) (conditioned_attention says
                why): 4 tenants x 8 requests of 192, 64 generated, each
                prefill beside (8, 1500, 384) zero bf16 frames (the
                reference's); no kernel.  On random frames from the seed
                (zero frames silence the encoder and every cross
                sublayer): every dec layer's cross K/V after a prefill
                against rms_norm(encode(frames), ctx_norm) @ wk (wv)
                computed apart; the twin (the whole served model) holds
                checks 3 and 4 and puts the logits on zero frames farther
                from those on random ones than check 4's limit.
 10i. whisper_train :func:`embedding_train` (vlm_train's gates) at that
                size, the same scaled weights, 16 sequences of 448 in 2
                microbatches, remat, bf16,
                ``--mole embedding`` (kappa 1): ``enc_proj`` becomes AugProj
                and K4 morphs each batch's (24000, 384) frame rows by the
                (384, 384) core, the only kernel; gate 3's float64
                gradients for every leaf.  MFU: ``whisper_flops``.
 10j. rwkv_train train_path at rwkv6_3b's published width and depth (32
                layers, d 2560, 40 heads of 64, d_ff 8960, vocab 65536,
                3.10 B parameters; RWKV_TRAIN says why they fit), 4
                sequences of 4096 in 2 microbatches, remat, bf16, ``--mole
                token``: gates 1, 3 and 4 as train_path (the twins 2
                layers); gate 2: over the main run, K6 launched exactly 3
                times a layer, microbatch and step (remat's two forwards
                and the flipped launch of the backward) and the key-row
                scan twice, no other kernel (the twins launch only those
                two).  MFU has no attention term and does not count the
                scan's flops; the profiled step gives the scan kernels'
                device time and share (``step_profile``'s ``tracked_ms``),
                and ``scan_ms`` the scan's forward and forward plus
                backward at one layer's microbatch shape.
 11. the ``kernels`` line (K1-K6 and the key-row scan, each launched on
     its path, K6's and the key-row scan's launches including
     rwkv_train's; K3's numbers
     on bf16 tables, its fp32-table numbers beside them under
     ``fp32_tables``; K4's at the vlm and whisper providers' morphs, with
     vlm_train's and whisper_train's launches, beside its own under
     ``vlm_provider`` and ``whisper_provider``; K6's at rwkv_train's
     microbatch, graph-timed in its time-chunked form, with rwkv_train's
     calls, beside its own under ``rwkv_train``), the card's name and power
     limit, and the final ``{"ok": true, ...}`` line.
"""
from __future__ import annotations

import asyncio
import gc
import json
import math
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SEED = 0
KERNEL_NAMES = ("grouped_block_diag_matmul", "grouped_aug_gemm",
                "grouped_row_gemm", "block_diag_matmul", "aug_gemm",
                "wkv6_chunked", "wkv6_rows")
REL_TOL = 1e-4
GIDX_CASES = {      # over a 6-slot table, as in tests/test_grouped_kernels.py
    "identity": [0, 1, 2, 3],
    "partial_table": [0, 1, 2, 4],
    "out_of_order": [4, 0, 5, 2],
    "duplicates": [3, 3, 1, 3],
    "out_of_range": [1, 9, -2, 5],
}
N_SLOTS = 6
# Kernel-check shapes: the main path's (G, B, F_in, F_out) at VGG-16/CIFAR
# first-layer width, and a ragged (B, K, N).
G, B, F_IN, F_OUT = 4, 64, 3072, 65536
RAGGED_B, RAGGED_K, RAGGED_N = 3, 3000, 1000
MAIN_GEOM = dict(alpha=3, beta=64, m=32, p=3)       # kappa = 1
# The front doors over main_path's registry (async_path, served_path).
ASYNC_THREADS, ASYNC_ROUNDS, ASYNC_DELAY_MS = 4, 3, 5.0
SNAPSHOT_BACKLOG = 64           # requests persisted pending and restored
SERVED_REQUESTS, SERVED_CLIENTS = 256, 16
SERVED_CHAOS_RATE = 0.2         # serve --chaos's default rate
CHURN_GEOM = dict(alpha=3, beta=16, m=16, p=3)
# features_path: Llama-3.2-Vision-90B's frontend as the reference configures
# it (src/repro/configs/llama32_vision_90b.py: FrontendCfg d_in=7680,
# n_tokens=1024; d_model 8192; vocab 128256), kappa = 1 (q = 7680).  One
# request is one image's patch stream (1, 1024, 7680).
FEAT_ARCH = "llama32_vision_90b"
FEAT_D_IN, FEAT_D_OUT, FEAT_VOCAB, FEAT_POSITIONS = 7680, 8192, 128256, 1024
# Two tenants: each one's secret build is an fp64 QR of 7680^2 on the host
# (17-24 s a tenant on the card's host, most of the phase), so four cost
# 68-95 s of the script's 1200 s; two keep every gate and both kernels'
# launches at a group count of 2.
FEAT_TENANTS, FEAT_REQUESTS, FEAT_ROUNDS = 2, 8, 2
# The unfuse gate: three fp32 products of depth d_in lie between x and the
# delivered x @ W_in (the host's fusion M^-1 W_in, the morph K1, the
# projection K2 in split TF32, whose error is below fp32's: err_vs_fp64).  A
# depth-n fp32 dot product with round-to-nearest errs by about sqrt(n) u of
# the scale of its terms (u = 2^-24; Higham and Mary's probabilistic bound),
# and with an orthogonal core and W_in ~ N(0, 1/d_in) every product's terms
# are of the output's scale, so the three stay under
# 3 sqrt(d_in) u max|x W_in| (1.57e-5 of the max at d_in = 7680).
FP32_UNIT_ROUNDOFF = 2.0 ** -24
FEAT_UNFUSE_REL = 3 * FEAT_D_IN ** 0.5 * FP32_UNIT_ROUNDOFF
FEAT_REL_TOL = 1e-5             # the engine against per-request delivery
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
FP32_FLOP_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
# H100 SXM TF32 dense tensor cores.  K2 and K5 in fp32 run three TF32 passes
# (split TF32, csrc/aug_gemm.cu), so their bound counts 3x the flops.
TF32_FLOP_PER_S = 495e12
FP64_REL_TOL = 1e-5             # split TF32 against a float64 product
FP64_COLS = 8192                # columns of that product computed
# exp2 (the SFU's ex2): 16 results per SM per clock against the 128 fp32
# lanes' 256 flops, so the fp32 peak / 16 (k6_bound's decays).
EX2_PER_S = FP32_FLOP_PER_S / 16
# K3 and the LM path: deepseek_7b FULL, 4 decode rows.
K3_R, K3_K, K3_N = 4, 4096, 102400
K3_RAGGED = [(3, 3000, 1000), (3, 3000, 999)]
LM_ARCH, LM_TENANTS, LM_REQUESTS, LM_PROMPT, LM_GEN = "deepseek_7b", 4, 8, 32, 16
# Long prompts (lm_long_prompt, mole_off): deepseek_7b FULL, 4 requests of
# 2048 tokens, 8 generated.  Above dense_attn_max_seq (1024) every admission
# prefill runs the chunked flash scan: 4 Q blocks of 512 by 2 KV blocks of
# 1024 per layer.  FLASH_SHAPE is one layer's (B, S, H, hd) there.
LONG_PROMPT, LONG_REQUESTS, LONG_GEN = 2048, 4, 8
FLASH_SHAPE = (1, 2048, 32, 128)
# phi3_path: phi3_mini_3p8b FULL (32 layers, d 3072, 32 heads of 96, vocab
# 32064).  3072 + 16 + 1 positions stay inside its published 4k context, and
# 3072 is the longest such prompt that the flash scan's KV block (1024)
# divides.  K3 there: h (4, 3072) x tables (4, 3072, 32064); 32064 is not a
# multiple of K3's strip (128 fp32 or 256 bf16 columns): its last is 64 wide.
PHI3_ARCH, PHI3_PROMPT = "phi3_mini_3p8b", 3072
K3_PHI3 = (4, 3072, 32064)
# K6 (kernels_k6) and the RWKV path (rwkv_path): rwkv6_3b FULL, 40 heads of
# 64, chunk 128.  A 300-token prompt pads to 3 chunks (84 padded tokens).
RWKV_ARCH, RWKV_PROMPT = "rwkv6_3b", 300
K6_D, K6_CHUNK = 64, 128
K6_CASES = [(40, 1024), (40, 384), (160, 128), (40, 32),   # (BH, T)
            (80, 4096)]         # the last: rwkv_train's microbatch
# K6 at rwkv_train's shape under strong decay: logw = -exp(N + 1), so that
# every chunk's product of w underflows to 0 in fp32 (the chain carries no
# start state past a chunk).  At -exp(2 N) the plain chunked form itself
# departs 9.9e-5 of max|out| from the token recurrence at this T (its
# cumulative sums of logw), too close to REL_TOL to hold the kernel to it;
# at -exp(N + 1) it departs 2.7e-5 (both on the CPU, 2 sequences).  The card
# tests hold the kernel to the recurrence at -exp(2 N).
K6_STRONG = (80, 4096)
K6_MAIN = (40, 384)             # the prefill's shape: B = 1, T = 300 padded
K6_T_SWEEP = (32, 128, 384, 1024)   # K6's time against T at BH = 40
# K6's gradient (kernels_k6) at one time-mix layer's shape in rwkv_train: a
# microbatch of 2 sequences of 4096 over 40 heads.  The float64 oracle
# (autograd of the token recurrence) is checkpointed by segments of
# K6_GRAD_SEGMENT tokens, so it keeps 32 states and one segment's graph.
K6_TRAIN = (80, 4096)           # (BH, T)
K6_TRAIN_HEADS = 40
K6_GRAD_SEGMENT = 128
K6_GRAD_REL_TOL = 1e-4          # x max|float64| for each of the six gradients
TIE_MARGIN_ULPS = 4             # bf16 units in the last place of max|logit|
BF16_FLOP_PER_S = 989e12        # H100 SXM bf16 dense tensor cores
# K4/K5 (kernels_k45) and the developer path (vgg_path).
K4_SHAPES = [(256, 1, 3072), (256, 3, 1024), (1024, 8, 960), (37, 3, 100)]
K4_BATCHED = (4, 64, 3072)      # (G, B, F), kappa = 1, one core per group
K5_MAIN = (256, 3072, 65536)    # (B, K, N): VGG-16/CIFAR Aug-Conv, batch 256
K5_BATCHED = (4, 64, 3072, 65536)
K5_RAGGED = (7, 33, 9)
VGG_BATCH, VGG_STEP_BATCH, VGG_STEPS, VGG_LR = 256, 64, 3, 1e-3
VGG_LOGIT_TOL = 1e-3            # x max|plain logits|: 10x the first layer's
VGG_LOSS_RTOL = 1e-3
PAPER_OVERHEAD = 0.09           # "VGG-16 on CIFAR ... computational overhead only 9%"
# train_path: deepseek_7b at its published width, cut in depth.  Training
# holds 16 B a parameter at its peak (bf16 params and grads, the fp32
# microbatch sum, AdamW's two fp32 moments): 30 layers (6.91 B) need 110 GB.
# Each layer is 0.2025 B parameters, 3.24 GB; 8 layers (2.46 B, 39.3 GB of
# state) peaked at 45.87 GB (NVIDIA H100 80GB HBM3, 700.00 W), so 15 layers
# (3.87 B, 62.0 GB of state) stay under 72 GB.  2048 positions are past dense_attn_max_seq,
# so the flash scan's backward runs; a global batch of 8 in 2 microbatches
# of 4; remat on; AdamW's defaults, warmup 2.
TRAIN_ARCH, TRAIN_LAYERS, TRAIN_SEQ, TRAIN_BATCH, TRAIN_MICRO = (
    "deepseek_7b", 15, 2048, 8, 2)
# The train phases' repetitions, few so that the script and the card tests
# stay under 1000 s: 2 untimed steps, 3 timed; the twins' 2 steps hold
# every gated step (TRAIN_GATED_STEPS), and gate 3 runs no control.
TRAIN_WARMUP, TRAIN_TIMED = 2, 3            # untimed, then timed steps
TRAIN_TWIN_LAYERS, TRAIN_TWIN_STEPS = 2, 2  # gate 3: raw against fused
# Gate 3: the reference test's bound (tests/test_mole_lm.py) on the raw and
# fused twins' losses over the steps TRAIN_GATED_STEPS names; the same
# comparison in fp32 on the CPU
# (tests/test_torch_train.py::test_token_mole_training_equivalence) departs
# by at most 7.6e-8 over 3 steps.  Later steps are not gated: from random
# init at lr 3e-4 Adam amplifies rounding about tenfold a step, so the raw
# run in one microbatch (the same function summed in another order)
# departed by 8.6e-6 and 9.4e-5 at fp32 steps 2 and 3, the fused run by
# 8.1e-8 and 4.1e-5; in bf16 the fused run departs by 5.1e-5 at step 2 (the
# backward's dh = dlogits @ head^T sums over the vocabulary in the permuted
# order and rounds to bf16).  Measured on an NVIDIA H100 80GB HBM3 at
# 700.00 W.
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GATED_STEPS = {"float32": 2, "bfloat16": 1}
# train_resume_path: launch/train.py at phi3_mini_3p8b's published width, cut
# in depth.  A checkpoint holds 10 B a parameter (bf16 params, AdamW's two
# fp32 moments): embed and head are 2 x 32064 x 3072 = 0.197 B parameters,
# a layer 4 x 3072^2 + 3 x 3072 x 8192 = 0.113 B, so 2 layers are 0.423 B
# and 4.2 GB a checkpoint.  launch/train.py keeps 3 and writes a 4th before it
# drops the oldest (the cut run saves at 3, 4, 6 and 8), so a run's
# directory needs room for 4.  --steps sets the cosine's decay_steps (as in
# the reference), so the cut run (--steps 4) follows the 8-step runs'
# learning rates only while the schedule does not read decay_steps: through
# the warmup and at its last count.  A warmup of 4 covers the cut run's 4
# steps; with 2 its steps 2-3 take another rate and the resumed run starts
# from another state.
RESUME_ARCH, RESUME_LAYERS = "phi3_mini_3p8b", 2
RESUME_FLAGS = ["--mole", "token", "--seq-len", "2048", "--batch", "8",
                "--microbatch", "2", "--warmup", "4", "--ckpt-every", "3"]
RESUME_STEPS, RESUME_CUT, RESUME_FAIL, RESUME_EVERY = 8, 4, 5, 3
RESUME_KEEP = 3                 # launch/train.py's CheckpointManager(keep=3)
# gemma2_27b and command_r_35b at their published widths,
# vocab 256000, tied embeddings (the decode lane's head stack is AugE^T).
# Serving phases hold their peak device memory at PEAK_LIMIT_GB, which sets
# their depth.  gemma2_path: a group (local + global) is 2.265 GB of bf16
# weights plus 0.336 GB of KV cache (4 rows; 4096 ring slots local, 6161
# positions global); fixed, 2.36 GB of tied embedding and two 4-slot stacks
# of 9.44 GB (AugE and Aug-head, both bf16): 21.2 GB, so 23 groups need
# about 81 GB.  Prompts of 6144 are past the 4096 window, past
# dense_attn_max_seq, and a multiple of both flash blocks.  17 groups
# peaked at 67.28 GB (NVIDIA H100 80GB HBM3, 700.00 W), so 18 (69.9
# predicted) is the most under the limit.
# command_r_path: a layer is 1.409 GB; fixed, 4.19 GB of embedding and two
# 16.78 GB stacks: 37.75 GB, so 40 layers need about 94 GB.  22 layers
# peaked at 69.25 GB (same card), so 23 (70.7 predicted) is the most.
PEAK_LIMIT_GB = 72.0
# sharded_path: the train step at deepseek_7b's published width in fp32, 2
# layers: embed and head 2 x 102400 x 4096 = 0.839 B parameters, a layer
# 0.2025 B, 1.24 B in all; 20 GB of state at 16 B a parameter (fp32
# params, microbatch sum and two moments), so the unsharded and the sharded
# run with their captured gradients stay near 40 GB.  One MoE layer of
# deepseek_moe_16b in fp32: 0.55 B parameters, 2.2 GB.
SHARDED_TRAIN = dict(arch="deepseek_7b", groups=2, seq=256, global_batch=2,
                     micro=2)
SHARDED_MOE = dict(arch="deepseek_moe_16b", batch=4, seq=512)
SHARDED_REL = 1e-5      # loss, grad norm (relative); a gradient leaf, of max|g|
SHARDED_MOE_REL = 1e-5  # of max|dense apply_moe|
PSUM_ABS = 0.05         # compressed_psum: the reference's bound
PSUM_N = 1 << 20
GEMMA2_ARCH, GEMMA2_PROMPT, GEMMA2_GROUPS = "gemma2_27b", 6144, 18
COMMAND_R_ARCH, COMMAND_R_PROMPT, COMMAND_R_LAYERS = "command_r_35b", 512, 23
# K3 at their decode shapes on bf16 tables (the lane's stacks; fp32 tables
# would need 33.5 GB at command_r's and gain nothing): 16.78 and 9.44 GB.
K3_COMMAND_R = (4, 8192, 256000)
K3_GEMMA2 = (4, 4608, 256000)
# gemma2_train: the train step at gemma2 widths, 1 group (a local and a
# global layer), 2 sequences of 6144 (every local layer's window slides) in
# 2 microbatches: 2.31 B parameters, 37 GB of state at 16 B a parameter.
GEMMA2_TRAIN = dict(groups=1, seq=6144, global_batch=2, micro=2)
# deepseek_moe_16b and deepseek_v2_lite_16b at their published widths and
# depths: 28 layers (an attn prefix layer with a dense FFN of 10944, then 27
# attn_moe layers of 2 shared + 64 routed experts of 1408, top-6) and 27 (an
# mla prefix layer, then 26 mla_moe layers; MLA's latent 512, q/k 128 + 64
# roped, v 128), d 2048, 16 heads, vocab 102400, bf16: 32.75 and 31.41 GB of
# weights beside two 4-slot stacks of 1.68 GB.  moe_path's prompts of 512
# stay under dense_attn_max_seq (capacity 64 a prefill against a mean load
# of 48 an expert); mla_path's of 2048 are past it and a multiple of both
# flash blocks.
MOE_ARCH, MOE_PROMPT = "deepseek_moe_16b", 512
MLA_ARCH, MLA_PROMPT = "deepseek_v2_lite_16b", 2048
K3_MOE = (4, 2048, 102400)      # K3 at their decode shape
# mla_train: the train step at deepseek_v2_lite_16b's widths, its prefix
# layer and 2 groups (3 layers): embed and head 419.4 M parameters, the
# prefix layer 81 M, an MLA-MoE layer 584.8 M, 1.67 B in all and 26.7 GB at
# 16 B a parameter; 4 sequences of 2048 in 2 microbatches (capacity 480
# a microbatch).
MLA_TRAIN = dict(groups=2, seq=2048, global_batch=4, micro=2)
# recurrentgemma_path: recurrentgemma_2b at its published width and depth,
# 26 layers (8 groups of rec, rec, local and a rec, rec suffix), d 2560, 10
# query heads of 256 over one KV head, RG-LRU width 2560 (16 gate blocks,
# conv width 4), d_ff 7680 GeGLU, vocab 256000, tied and scaled
# embeddings, bf16: 2.673 B parameters, 5.35 GB, beside two 4-slot stacks
# of 5.24 GB (AugE and its transpose) and 67 MB of rings (8 local layers x
# 4 rows x 2048 slots x 256 x K and V x 2 B): about 16 GB before
# activations.  Prompts of 4096 are past the 2048 window (every local ring
# wraps in the prefill) and past dense_attn_max_seq (the flash scan runs
# with its window: 8 Q blocks of 512 by 4 KV blocks of 1024, those wholly
# before a block's window skipped); the model was trained at 8192.  The
# twin is 2 groups and the suffix (8 layers).
RG_ARCH, RG_PROMPT, RG_TWIN_GROUPS = "recurrentgemma_2b", 4096, 2
# recurrentgemma_train: the train step at recurrentgemma_2b's published
# width and depth.  Parameters: 2.672 B (the tied embedding 0.655 B, 18 rec
# layers of 79.4 M, 8 local layers of 73.5 M); at 16 B a parameter 42.75 GB
# of state.  Remat keeps each block's input, 26 x 2 x 4096 x 2560 x 2 B =
# 1.09 GB a microbatch; one block's recompute and backward hold the scan's
# a and h and their gradients in fp32 (4 x 84 MB at a microbatch of 2 x
# 4096 x 2560) beside the gates' fp32 intermediates, the GeGLU's (2 x 4096
# x 7680 bf16, 126 MB each) and a CE chunk's fp32 logits and their
# gradient (2 x 512 x 256000 x 4 B = 1.05 GB each): about 50-58 GB in all,
# under PEAK_LIMIT_GB, so no group is cut.  4 sequences of 4096 (past the
# window of 2048) in 2 microbatches.
RG_TRAIN = dict(groups=8, seq=4096, global_batch=4, micro=2)
K3_RG = (4, 2560, 256000)       # K3 at its decode shape: 5.24 GB of tables
# vlm_path and vlm_train: llama32_vision_90b at its published width (d 8192,
# 64 heads of 128 over 8 KV heads, d_ff 28672 SwiGLU, vocab 128256, RoPE
# 5e5, a frontend of 1024 patches of 7680, tanh-gated cross layers every
# fifth layer, bf16).  ModelConfig.param_count: 87.73 B in 100 layers; a
# group of four attention layers and a cross layer is 4.278 B (8.56 GB in
# bf16); embedding, head and frontend_proj 2.164 B (4.33 GB).  vlm_path
# serves VLM_GROUPS of the 20 groups: 6 are 25.67 B, with the tables 27.83
# B (55.7 GB); a tenant's fused embedding and head add 4.2 GB while it is
# served; a prefill of 8 rows of 512 holds its dense cross scores over the
# 1024 patches (8 x 64 x 512 x 1024 fp32, 1.07 GB, up to three such
# tensors at once): about 63-66 GB, under PEAK_LIMIT_GB (7 groups would
# add 8.56 GB).  2 tenants of 8 requests, prompts of 512, 16 generated;
# the twin serves 4 of the prompts.
VLM_ARCH, VLM_GROUPS, VLM_TENANTS, VLM_REQUESTS = "llama32_vision_90b", 6, 2, 16
VLM_PROMPT, VLM_GEN, VLM_TWIN_ROWS = 512, 16, 4
# The twin: the first attention layer and the first cross layer.  A whole
# group (5 random bf16 layers) amplifies the rounding of the serving steps
# against a forward past the tie margin: a token 30.0 bf16 ulps below the
# forward's max (NVIDIA H100 80GB HBM3, 700.00 W).  The same happens in
# fp32 on the CPU at d 1024: one attention layer departs from the forward
# by 1e-6 of max|logit|, four by up to 1.4e-2, so it is depth, not the
# cross layer (alone 1e-6).  lm_path's twins are 2 layers for that reason.
VLM_TWIN_PATTERN = ("attn", "cross")
# vlm_train: the pattern ("attn", "cross") x 1 group is 3.876 B parameters,
# 62.0 GB of state at 16 B a parameter (a full group, 6.44 B, would need
# 103 GB); remat keeps each block's input, one block's recompute and
# backward hold the cross scores (1 x 64 x 2048 x 1024 fp32, 0.54 GB) and
# their gradient, and a CE chunk's fp32 logits are 512 x 128256 x 4 B =
# 0.26 GB: about 64-68 GB.  2 sequences of 2048 in 2 microbatches; the
# provider morphs a batch's (2 x 1024, 7680) patch rows by the (7680, 7680)
# core (kappa 1) through K4, K4_VLM.
VLM_TRAIN = dict(seq=2048, global_batch=2, micro=2)
K4_VLM = (2048, 1, 7680)        # (R, kappa, q): 241.6 GFLOP, 0.36 GB
# Gate 3 of vlm_train holds the fused form against the raw form within this
# many times the raw form's own departure from a float64 evaluation (the
# CPU tests' rule, tests/test_torch_vlm.py: two fp32 evaluations agree no
# closer than each is to the float64 one); the float64 gradients are taken
# for these leaves (their fp32 copies wait on the host meanwhile).
VLM_GATE3_K = 4
VLM_FP64_LEAVES = (
    "embed", "frontend_proj", "head", "final_norm", "blocks.0.mix.wq",
    "blocks.0.ffn.wo", "blocks.1.mix.wq", "blocks.1.mix.wk",
    "blocks.1.mix.wv", "blocks.1.mix.wo", "blocks.1.mix.ctx_norm",
    "blocks.1.mix.gate_attn", "blocks.1.mix.gate_ffn", "blocks.1.ffn.wi_gate")
# whisper_path and whisper_train: whisper_tiny at its published width and
# depth, uncut (4 bidir encoder layers over a stub of 1500 frames of 384, 4
# dec decoder layers, d 384, 6 heads of 64, d_ff 1536 GELU, layernorm, vocab
# 51865, untied head, RoPE 1e4, bf16).  ModelConfig.param_count: 56,504,832
# (encoder 7,228,800: enc_proj 147,456, 4 blocks of 1,770,240, enc_norm 384;
# decoder 49,276,032: embedding and head 19,916,160 each, 4 dec blocks of
# 2,360,832, final_norm 384): 0.11 GB in bf16.  whisper_path: 4 tenants x 8
# requests, prompts of 192 and 64 generated, 256 positions within the
# published text context of 448; a tenant's prefill runs the encoder over
# (8, 1500, 384) zero frames, its dense bidirectional scores 8 x 6 x 1500^2
# fp32 = 0.43 GB a layer, and writes 4 cross caches of 8 x 1500 x 6 x 64 x
# K and V x 2 B = 18.4 MB each.  Every dec layer's cross caches are checked
# on random frames (zero frames silence the encoder and every cross
# sublayer: no bias anywhere).  The twin is the whole served model on 4 of
# the prompts and random frames.  Both phases scale the attention's query
# and key weights (conditioned_attention): with the reference's init the
# softmax is nearly one-hot, and the twin's serving steps departed from a
# forward with no cache by 2.0, 19.25, 45.8 and 96.25 bf16 ulps of
# max|logit| at 1, 2, 3 and 4 decoder layers, a served token 162 ulps below
# the forward's max at 4 (NVIDIA H100 80GB HBM3, 700.00 W), and gate 3's
# fp32 gradients departed from float64 by 4.9 of a leaf's max.
WHISPER_ARCH = "whisper_tiny"
WHISPER_PATH = dict(tenants=4, requests=32, prompt_len=192, gen=64,
                    twin_rows=4)
# whisper_train: 16 sequences of 448 (the published text context) in 2
# microbatches, so the frames go through _split_micro; training state at 16
# B a parameter is 0.9 GB; a microbatch's encoder scores are 8 x 6 x 1500^2
# fp32 = 0.43 GB a bidir layer (remat recomputes one block at a time).  The
# provider morphs a batch's (16 x 1500, 384) frame rows by the (384, 384)
# core (kappa 1) through K4: 2 x 24000 x 384^2 = 7.08 GFLOP, 67 TFLOP/s
# FFMA 0.106 ms, above the 0.022 ms its 74 MB take at 3.35 TB/s.
WHISPER_TRAIN = dict(seq=448, global_batch=16, micro=2)
# rwkv_train: the train step at rwkv6_3b's published width and depth, 32
# layers.  ModelConfig.param_count: 3,099,691,520 (embedding and head
# 65536 x 2560 each, 0.336 B; a layer 86.4 M); at 16 B a parameter (bf16
# params and grads, the fp32 microbatch sum, two fp32 moments) 49.6 GB of
# state.  Remat keeps each block's input, 32 x 2 x 4096 x 2560 x 2 B = 1.34
# GB a microbatch; one block's recompute and backward hold the time-mix's
# fp32 r, k, v, logw (2 x 4096 x 2560 x 4 B = 84 MB each), the backward's
# flipped copies and its float64 reverse sums (168 MB each), the
# channel-mix's 2 x 4096 x 8960 bf16 (73 MB) and a CE chunk's fp32 logits
# and their gradient: about 52-60 GB in all, under PEAK_LIMIT_GB, so no
# layer is cut.  4 sequences of 4096 in 2 microbatches.
RWKV_TRAIN = dict(groups=32, seq=4096, global_batch=4, micro=2)
K4_WHISPER = (24000, 1, 384)    # (R, kappa, q)


def bf16_ulp(x: float) -> float:
    """One bf16 unit in the last place at magnitude ``x`` (8 significant
    bits: 2**(floor(log2 x) - 7))."""
    return float(2.0 ** (np.floor(np.log2(x)) - 7))


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def release() -> None:
    """Free what the last phase left on the card before the next starts: its
    engines and registries sit in reference cycles, which only the cyclic
    collector frees, and otherwise stay live into a later phase's peak."""
    gc.collect()
    torch.cuda.empty_cache()


def host_peak_reset() -> bool:
    """Reset this process's peak resident set (VmHWM) by writing 5 to
    /proc/self/clear_refs; False where that is refused or VmHWM is not
    kept (the peak read after is then the process's own since it
    started)."""
    try:
        Path("/proc/self/clear_refs").write_text("5")
        return "VmHWM:" in Path("/proc/self/status").read_text()
    except OSError:
        return False


def host_peak_gb() -> float:
    """This process's peak resident set in GB: VmHWM where /proc keeps it,
    else ``getrusage``'s ru_maxrss (the peak since the process started)."""
    import resource

    try:
        for line in Path("/proc/self/status").read_text().splitlines():
            if line.startswith("VmHWM:"):
                return int(line.split()[1]) * 1024 / 1e9
    except OSError:
        pass
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9


def host_rss_gb() -> float | None:
    """This process's resident set now in GB (/proc/self/statm), or None
    where /proc does not give it."""
    import os

    try:
        pages = int(Path("/proc/self/statm").read_text().split()[1])
    except (OSError, IndexError, ValueError):
        return None
    return pages * os.sysconf("SC_PAGE_SIZE") / 1e9


def reset_launches(kernels) -> None:
    """Set every kernel wrapper's launch counter to 0."""
    for name in KERNEL_NAMES:
        getattr(kernels, name).launches = 0


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def cuda_times(fn, iters: int) -> list[float]:
    """Device time of each of ``iters`` calls of ``fn`` (after one warm-up),
    CUDA events around each."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out


def cuda_p50(fn, reps: int, inner: int) -> float:
    """Device time per call of ``fn``: CUDA events around ``inner``
    back-to-back calls (so the host's launch time overlaps the device's
    work), the p50 over ``reps`` such groups, after one warm-up."""
    return float(np.median([cuda_ms(fn, inner) for _ in range(reps)]))


def graph_ms(fn, reps: int, inner: int) -> float:
    """Device time per call of ``fn`` with the host's share taken out:
    ``inner`` calls captured in one CUDA graph, each replay timed by CUDA
    events, the p50 over ``reps`` replays, after one eager warm-up call.
    For a kernel that runs shorter than its wrapper's host time, where
    back-to-back calls (``cuda_p50``) time the host."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    ms = float(np.median([cuda_ms(graph.replay, 1) / inner for _ in range(reps)]))
    del graph
    return ms


def same_bits(x: torch.Tensor, y: torch.Tensor) -> bool:
    bits = {4: torch.int32, 2: torch.int16}[x.element_size()]
    return x.dtype == y.dtype and torch.equal(x.view(bits), y.view(bits))


def split_sweep(gemm, name, a, gidx, b) -> dict:
    """The morph kernel's time (CUDA events, 20 calls) at each of a few
    splits of K (q = 3072 at the main shapes), through its binding, which
    counts no launch; printed, not gated."""
    return {s: cuda_ms(lambda: gemm.morph(name, a, gidx, b, s), 20)
            for s in (1, 2, 3, 4, 5, 6, 8, 12)}


def morph_probe(gemm, name, run_kernel, a, gidx, b, iters: int) -> dict:
    """Not gated: ``name``'s product on the morph kernel (K1/K4's FFMA
    loop in ``csrc/morph_gemm.cu``, split by its rule, the best FFMA loop
    of the repo), timed in turns with ``name``'s own kernel (CUDA events,
    ``iters`` calls each), and the largest difference of their outputs.
    Through the binding, which counts no launch."""
    def run_morph():
        return gemm.morph(name, a, gidx, b)
    times = [cuda_ms(run_morph, iters), cuda_ms(run_kernel, iters),
             cuda_ms(run_morph, iters), cuda_ms(run_kernel, iters)]
    want = run_kernel()
    diff = float((run_morph().view(want.shape).float()
                  - want.float()).abs().max())
    del want
    G, M, K = a.shape
    return {"morph_ms": (times[0] + times[2]) / 2,
            "kernel_ms": (times[1] + times[3]) / 2, "runs_ms": times,
            "splits": gemm.morph_splits(G, M, b.shape[-1], K,
                                        gemm.sm_count(a.device)),
            "max_abs_diff": diff}


def bound_ms(n_bytes: float, flops: float,
             flop_per_s: float = FP32_FLOP_PER_S) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / flop_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def split_tf32_bound(n_bytes: float, flops: float) -> dict:
    """An fp32 K2/K5 row's bound: the split form's (3 x ``flops`` of TF32 on
    the tensor cores, or the bytes), and the fp32 FFMA bound beside it."""
    b, by = bound_ms(n_bytes, 3 * flops, TF32_FLOP_PER_S)
    return {"bound_ms": b, "bound_by": by,
            "ffma_bound_ms": bound_ms(n_bytes, flops)[0]}


def err_vs_fp64(name: str, a, b, kernel_out, library_out) -> dict:
    """Kernel and library call against a float64 product of ``a`` (G, M, K)
    and ``b`` (G, K, N) on the card over the first FP64_COLS columns;
    gated: the kernel's max error within FP64_REL_TOL * max|fp64|."""
    cols = min(FP64_COLS, b.shape[-1])
    want = torch.bmm(a.double(), b[..., :cols].double())
    scale = float(want.abs().max())
    err_k = float((kernel_out[..., :cols].double() - want).abs().max())
    err_l = float((library_out[..., :cols].double() - want).abs().max())
    del want
    check(err_k <= FP64_REL_TOL * scale,
          f"{name}: |kernel - fp64| {err_k} > {FP64_REL_TOL} * {scale}")
    return {"columns": cols, "max_abs_fp64": scale,
            "kernel_rel": err_k / scale, "library_rel": err_l / scale,
            "kernel_over_library": err_k / err_l if err_l > 0 else None,
            "limit_rel": FP64_REL_TOL}


def library_fp32_is_full() -> None:
    """The fp32 yardsticks are cuBLAS in full fp32: TF32 off."""
    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "fp32 torch.matmul would run in TF32")


# -- phase 2 ------------------------------------------------------------------

def kernel_checks(dev, kernels, ref) -> dict:
    """Both kernels vs their plain versions at full width and a ragged
    shape; returns per-kernel error and timing rows."""
    from repro_torch.kernels import gemm
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    rows: dict[str, dict] = {}
    checks = []

    def hold(name, shape_tag, got, want):
        err = float((got - want).abs().max())
        lim = REL_TOL * float(want.abs().max())
        checks.append({"kernel": name, "case": shape_tag, "max_abs_err": err,
                       "limit": lim})
        check(bool(torch.isfinite(got).all()), f"{name} {shape_tag}: non-finite")
        check(err <= lim, f"{name} {shape_tag}: |kernel - plain| {err} > {lim}")
        row = rows.setdefault(name, {"max_abs_err": 0.0})
        row["max_abs_err"] = max(row["max_abs_err"], err)

    def all_patterns(name, tag, run_kernel, run_plain):
        for case, idx in GIDX_CASES.items():
            gidx = torch.tensor(idx, dtype=torch.int32, device=dev)
            hold(name, f"{tag}/{case}", run_kernel(gidx), run_plain(gidx))

    # K2 (grouped_aug_gemm): VGG-16/CIFAR width, then ragged.
    K, N = F_IN, F_OUT
    t = randn(G, B, K)
    c_acs = randn(N_SLOTS, K, N, scale=K ** -0.5)
    all_patterns("grouped_aug_gemm", f"G{G}_B{B}_K{K}_N{N}",
                 lambda g: kernels.grouped_aug_gemm(t, g, c_acs),
                 lambda g: ref.aug_gemm_grouped_ref(t, g, c_acs))
    # Timed at the main path's shapes: S = G slots (a contiguous prefix of
    # the stack), gidx = arange(G).  The library call is torch.bmm on the
    # same stack, which is the gathered weights for this gidx.
    ident = torch.arange(G, dtype=torch.int32, device=dev)
    c_main = c_acs[:G]
    library_fp32_is_full()
    times = [
        cuda_ms(lambda: kernels.grouped_aug_gemm(t, ident, c_main), 10),
        cuda_ms(lambda: ref.aug_gemm_grouped_ref(t, ident, c_main), 10),
        cuda_ms(lambda: kernels.grouped_aug_gemm(t, ident, c_main), 10),
        cuda_ms(lambda: ref.aug_gemm_grouped_ref(t, ident, c_main), 10),
        cuda_ms(lambda: torch.bmm(t, c_main), 10),
    ]
    first = kernels.grouped_aug_gemm(t, ident, c_main)
    second = kernels.grouped_aug_gemm(t, ident, c_main)
    check(same_bits(first, second),
          "grouped_aug_gemm: two calls on the same inputs differ")
    fp64 = err_vs_fp64("grouped_aug_gemm", t, c_main, first,
                       torch.bmm(t, c_main))
    del first, second
    rows["grouped_aug_gemm"].update(
        ms=(times[0] + times[2]) / 2, plain_ms=(times[1] + times[3]) / 2,
        library_ms=times[4],
        **split_tf32_bound(4 * (G * B * K + G * K * N + G * B * N + G),
                           2 * G * B * K * N),
        timed_shape=f"t({G},{B},{K}) c_acs({G},{K},{N}) gidx=arange({G})",
        runs_ms=times, deterministic=True, err_vs_fp64=fp64,
        on_morph_kernel=morph_probe(
            gemm, "grouped_aug_gemm",
            lambda: kernels.grouped_aug_gemm(t, ident, c_main), t, ident,
            c_main, 10),
    )
    del c_acs, c_main
    t = randn(G, RAGGED_B, RAGGED_K)
    c_acs = randn(N_SLOTS, RAGGED_K, RAGGED_N, scale=RAGGED_K ** -0.5)
    all_patterns("grouped_aug_gemm",
                 f"ragged_G{G}_B{RAGGED_B}_K{RAGGED_K}_N{RAGGED_N}",
                 lambda g: kernels.grouped_aug_gemm(t, g, c_acs),
                 lambda g: ref.aug_gemm_grouped_ref(t, g, c_acs))

    # K1 (grouped_block_diag_matmul): kappa=1 (the main path), kappa=4,
    # then ragged.
    F = F_IN
    x = randn(G, B, F)
    for kappa in (1, 4):
        q = F // kappa
        cores = randn(N_SLOTS, q, q, scale=q ** -0.5)
        all_patterns("grouped_block_diag_matmul", f"G{G}_B{B}_kappa{kappa}_q{q}",
                     lambda g: kernels.grouped_block_diag_matmul(x, g, cores, kappa),
                     lambda g: ref.block_diag_matmul_grouped_ref(x, g, cores, kappa))
        if kappa == 1:
            c_main = cores[:G]
            times = [
                cuda_ms(lambda: kernels.grouped_block_diag_matmul(x, ident, c_main, 1), 20),
                cuda_ms(lambda: ref.block_diag_matmul_grouped_ref(x, ident, c_main, 1), 20),
                cuda_ms(lambda: kernels.grouped_block_diag_matmul(x, ident, c_main, 1), 20),
                cuda_ms(lambda: ref.block_diag_matmul_grouped_ref(x, ident, c_main, 1), 20),
                cuda_ms(lambda: torch.bmm(x, c_main), 20),
            ]
            b, by = bound_ms(4 * (2 * G * B * F + G * q * q + G),
                             2 * G * B * F * q)
            first = kernels.grouped_block_diag_matmul(x, ident, c_main, 1)
            second = kernels.grouped_block_diag_matmul(x, ident, c_main, 1)
            check(same_bits(first, second),
                  "grouped_block_diag_matmul: two calls on the same inputs differ")
            rows["grouped_block_diag_matmul"].update(
                ms=(times[0] + times[2]) / 2, plain_ms=(times[1] + times[3]) / 2,
                library_ms=times[4], bound_ms=b, bound_by=by,
                timed_shape=f"x({G},{B},{F}) cores({G},{q},{q}) kappa=1 gidx=arange({G})",
                runs_ms=times, deterministic=True,
                splits=gemm.morph_splits(G, B, q, q, gemm.sm_count(dev)),
                split_sweep_ms=split_sweep(gemm, "grouped_block_diag_matmul",
                                           x, ident, c_main),
            )
            del c_main, first, second
        del cores
    q = RAGGED_N
    x = randn(G, RAGGED_B, RAGGED_K)
    cores = randn(N_SLOTS, q, q, scale=q ** -0.5)
    kappa = RAGGED_K // q
    all_patterns("grouped_block_diag_matmul",
                 f"ragged_G{G}_B{RAGGED_B}_kappa{kappa}_q{q}",
                 lambda g: kernels.grouped_block_diag_matmul(x, g, cores, kappa),
                 lambda g: ref.block_diag_matmul_grouped_ref(x, g, cores, kappa))
    emit({"phase": "kernels", "checks": len(checks),
          "worst": max(checks, key=lambda c: c["max_abs_err"] / c["limit"]),
          "rows": rows})
    return rows


# -- phase 5 ------------------------------------------------------------------

def k3_bound(R: int, K: int, N: int, h_dtype, t_dtype) -> tuple[float, str]:
    """The least time for one K3 call on R distinct slots: each table read
    once (R x K x N entries of ``t_dtype``), h and the output once, the
    slot indices; 2 R K N flops of fp32 FFMA."""
    hb, tb = h_dtype.itemsize, t_dtype.itemsize
    return bound_ms(tb * R * K * N + hb * R * (K + N) + 4 * R, 2 * R * K * N)


def k3_cases(kernels, ref, gen, tag: str, R: int, K: int, N: int,
             checks: list, last_strip: bool = False) -> float:
    """K3 against its plain version on the same operands for every slot
    pattern, both table dtypes (fp32 tables, and the same tables cast to
    bf16) and both h dtypes; with ``last_strip`` also the kernel's last
    strip of 512 table bytes a row apart (ragged where N is not a multiple
    of its 128 fp32 or 256 bf16 columns).  Bound: fp32 h within 1e-4 *
    max|plain|, bf16 h two bf16 ulps of max|plain| (each side rounds once).
    Gated too: two calls give the same bits.  Returns the largest error."""
    dev = gen.device
    worst = 0.0
    t32 = torch.randn((N_SLOTS, K, N), generator=gen, device=dev) * K ** -0.5
    for t_dtype in (torch.float32, torch.bfloat16):
        tables = t32 if t_dtype == torch.float32 else t32.to(t_dtype)
        tname = str(t_dtype).split(".")[-1]
        width = 512 // t_dtype.itemsize
        strip = (N - 1) // width * width
        for h_dtype in (torch.bfloat16, torch.float32):
            h = torch.randn((R, K), generator=gen, device=dev).to(h_dtype)
            name = str(h_dtype).split(".")[-1]
            for case, idx in GIDX_CASES.items():
                gidx = torch.tensor(idx[:R], dtype=torch.int32, device=dev)
                got = kernels.grouped_row_gemm(h, gidx, tables)
                again = kernels.grouped_row_gemm(h, gidx, tables)
                want = ref.lm_head_rows_grouped_ref(h, gidx, tables)
                torch.cuda.synchronize()
                what = f"{tag}/{tname}_tables/{name}_h/{case}"
                check(got.shape == (R, N) and got.dtype == h_dtype,
                      f"K3 {what}: got {tuple(got.shape)} {got.dtype}")
                check(bool(torch.isfinite(got).all()), f"K3 {what}: non-finite")
                check(same_bits(got, again), f"K3 {what}: two calls differ")
                parts = [("all", slice(None))]
                if last_strip:
                    parts.append(("last_strip", slice(strip, None)))
                for part, cols in parts:
                    err = float((got[:, cols].float()
                                 - want[:, cols].float()).abs().max())
                    scale = float(want[:, cols].float().abs().max())
                    lim = (REL_TOL * scale if h_dtype == torch.float32
                           else 2 * bf16_ulp(scale))
                    checks.append({"case": f"{what}/{part}",
                                   "max_abs_err": err, "limit": lim})
                    check(err <= lim, f"K3 {what}/{part}: |kernel - plain| "
                                      f"{err} > {lim}")
                    worst = max(worst, err)
        del tables
    del t32
    torch.cuda.empty_cache()
    return worst


def k3_timed(gemm, kernels, ref, gen, R: int, K: int, N: int) -> dict:
    """K3 at the decode lane's shape on R distinct slots (gidx = arange(R),
    a contiguous stack of R) with bf16 h, on bf16 tables (the lane's head
    stacks in a bf16 model: the main path) and on fp32 tables of the same
    values.  Each: K3 in CUDA graphs of 10 calls (``graph_ms``) and 10
    back to back (``cuda_ms``), in turns; the plain version back to back
    (its per-row slot lookup reads the indices on the host, which a graph
    cannot capture); torch.bmm of h[:, None, :] against the same tables (a
    yardstick the port never calls; on fp32 tables it runs in fp32, on K3's
    bytes, without K3's rounding of the entries to bf16) both ways; the
    byte bound; the split of the work (``gemm.row_splits``: the grid's
    strips and each warp's rows of K)."""
    dev = gen.device
    ident = torch.arange(R, dtype=torch.int32, device=dev)
    t32 = torch.randn((R, K, N), generator=gen, device=dev) * K ** -0.5
    h = torch.randn((R, K), generator=gen, device=dev).to(torch.bfloat16)
    out = {}
    for t_dtype in (torch.bfloat16, torch.float32):
        tables = t32.to(t_dtype)
        hb = h if t_dtype == torch.bfloat16 else h.float()
        run = lambda: kernels.grouped_row_gemm(h, ident, tables)  # noqa: E731
        bmm = lambda: torch.bmm(hb[:, None, :], tables)  # noqa: E731
        g = [graph_ms(run, 5, 10), graph_ms(run, 5, 10)]
        e = [cuda_ms(run, 10), cuda_ms(run, 10)]
        b, by = k3_bound(R, K, N, h.dtype, t_dtype)
        strips, kslice = gemm.row_splits(R, K, N, t_dtype.itemsize)
        tname = str(t_dtype).split(".")[-1]
        out[tname] = {
            "ms": float(np.mean(g)), "graph_ms": g, "cuda_ms": e,
            "plain_ms": cuda_ms(lambda: ref.lm_head_rows_grouped_ref(
                h, ident, tables), 10),
            "library_ms": graph_ms(bmm, 5, 10),
            "library_cuda_ms": cuda_ms(bmm, 10),
            "bound_ms": b, "bound_by": by,
            "ms_over_bound": float(np.mean(g)) / b,
            "table_bytes": t_dtype.itemsize * R * K * N,
            "grid": [strips, R], "warp_kslice": kslice,
            "timed_shape": f"h({R},{K}) bf16, tables({R},{K},{N}) {tname}, "
                           f"gidx=arange({R})",
            "library": f"torch.bmm, {str(hb.dtype).split('.')[-1]} h "
                       f"against the same {tname} tables",
        }
        del tables
    del t32
    torch.cuda.empty_cache()
    return out


def k3_vocab_row(kernels, ref, gen, R: int, K: int, N: int) -> dict:
    """K3 at a vocab-256000 decode shape on R slots of bf16 tables (the
    lane's head stacks; drawn in bf16, slot by slot) with bf16 h: against
    its plain version, gidx = arange(R) and reversed, within two bf16 ulps
    of max|plain|; two calls the same bits; the last slot's last strip of
    256 columns (its offsets past 2^31, and at (4, 8192, 256000) past 2^33)
    also against a float64 product of the same entries, two ulps.  Timed
    as ``k3_timed`` does on bf16 tables: graph_ms, cuda_ms, the plain
    version, torch.bmm both ways, the byte bound."""
    from repro_torch.kernels import gemm

    dev = gen.device
    tables = torch.empty((R, K, N), dtype=torch.bfloat16, device=dev)
    for slot in range(R):
        tables[slot] = torch.randn((K, N), generator=gen, device=dev,
                                   dtype=torch.bfloat16) * K ** -0.5
    h = torch.randn((R, K), generator=gen, device=dev).to(torch.bfloat16)
    err, checks = 0.0, []
    for order in ("identity", "reversed"):
        idx = list(range(R)) if order == "identity" else list(range(R))[::-1]
        gidx = torch.tensor(idx, dtype=torch.int32, device=dev)
        got = kernels.grouped_row_gemm(h, gidx, tables)
        again = kernels.grouped_row_gemm(h, gidx, tables)
        want = ref.lm_head_rows_grouped_ref(h, gidx, tables)
        torch.cuda.synchronize()
        check(got.shape == (R, N) and bool(torch.isfinite(got).all()),
              f"K3 ({R}, {K}, {N}) {order}: {tuple(got.shape)}, non-finite?")
        check(same_bits(got, again), f"K3 ({R}, {K}, {N}) {order}: two calls differ")
        e = float((got.float() - want.float()).abs().max())
        lim = 2 * bf16_ulp(float(want.float().abs().max()))
        check(e <= lim, f"K3 ({R}, {K}, {N}) {order}: |kernel - plain| {e} > {lim}")
        checks.append({"case": order, "max_abs_err": e, "limit": lim})
        err = max(err, e)
        row = idx.index(R - 1)          # the row on the last slot
        cols = slice(N - 256, N)
        exact = (h[row].double() @ tables[R - 1][:, cols].double())
        e = float((got[row, cols].double() - exact).abs().max())
        lim = 2 * bf16_ulp(float(exact.abs().max()))
        check(e <= lim, f"K3 ({R}, {K}, {N}) {order}: last slot's last strip "
                        f"|kernel - fp64| {e} > {lim}")
        checks.append({"case": f"{order}/last_slot_last_strip_vs_fp64",
                       "max_abs_err": e, "limit": lim,
                       "first_entry": (R - 1) * K * N + N - 256})
        del got, again, want
    ident = torch.arange(R, dtype=torch.int32, device=dev)
    run = lambda: kernels.grouped_row_gemm(h, ident, tables)  # noqa: E731
    bmm = lambda: torch.bmm(h[:, None, :], tables)  # noqa: E731
    g = [graph_ms(run, 5, 10), graph_ms(run, 5, 10)]
    b, by = k3_bound(R, K, N, h.dtype, tables.dtype)
    strips, kslice = gemm.row_splits(R, K, N, tables.element_size())
    out = {
        "ms": float(np.mean(g)), "graph_ms": g,
        "cuda_ms": [cuda_ms(run, 10), cuda_ms(run, 10)],
        "plain_ms": cuda_ms(lambda: ref.lm_head_rows_grouped_ref(
            h, ident, tables), 10),
        "library_ms": graph_ms(bmm, 5, 10), "library_cuda_ms": cuda_ms(bmm, 10),
        "bound_ms": b, "bound_by": by, "ms_over_bound": float(np.mean(g)) / b,
        "table_bytes": tables.element_size() * R * K * N,
        "grid": [strips, R], "warp_kslice": kslice, "max_abs_err": err,
        "checks": checks,
        "timed_shape": f"h({R},{K}) bf16, tables({R},{K},{N}) bfloat16, "
                       f"gidx=arange({R})",
        "library": "torch.bmm, bfloat16 h against the same bfloat16 tables",
    }
    del tables
    torch.cuda.empty_cache()
    return out


def k3_checks(dev, kernels, ref) -> dict:
    """K3 vs its plain version at the LM paths' shapes (deepseek_7b, then
    phi3_mini_3p8b as ``row_phi3``, the MoE archs' (4, 2048, 102400) as
    ``row_moe``, the vocab-256000 shapes of command_r, gemma2 and
    recurrentgemma as ``row_command_r`` / ``row_gemma2`` /
    ``row_recurrentgemma``) and ragged shapes, every slot pattern,
    both table dtypes and both h dtypes, two calls the same bits; the timing
    rows.  Returns the deepseek row on bf16 tables (the main path's stacks), its
    fp32-table figures beside it."""
    from repro_torch.kernels import gemm

    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    checks = []
    err = k3_cases(kernels, ref, gen, f"R{K3_R}_K{K3_K}_N{K3_N}", K3_R, K3_K,
                   K3_N, checks)
    for R, K, N in K3_RAGGED:
        err = max(err, k3_cases(kernels, ref, gen, f"ragged_R{R}_K{K}_N{N}",
                                R, K, N, checks))
    R, K, N = K3_PHI3
    err_phi3 = k3_cases(kernels, ref, gen, f"phi3_R{R}_K{K}_N{N}", R, K, N,
                        checks, last_strip=True)
    timed = k3_timed(gemm, kernels, ref, gen, K3_R, K3_K, K3_N)
    phi3 = k3_timed(gemm, kernels, ref, gen, R, K, N)
    row = dict(timed["bfloat16"], max_abs_err=max(err, err_phi3),
               fp32_tables=timed["float32"])
    command_r = k3_vocab_row(kernels, ref, gen, *K3_COMMAND_R)
    gemma2 = k3_vocab_row(kernels, ref, gen, *K3_GEMMA2)
    R, K, N = K3_MOE
    err_moe = k3_cases(kernels, ref, gen, f"moe_R{R}_K{K}_N{N}", R, K, N,
                       checks)
    moe = k3_timed(gemm, kernels, ref, gen, R, K, N)
    recurrentgemma = k3_vocab_row(kernels, ref, gen, *K3_RG)
    emit({"phase": "kernels_k3", "checks": len(checks),
          "worst": max(checks, key=lambda c: c["max_abs_err"] / c["limit"]),
          "row": row, "row_phi3": dict(phi3, max_abs_err=err_phi3),
          "row_command_r": command_r, "row_gemma2": gemma2,
          "row_moe": dict(moe, max_abs_err=err_moe),
          "row_recurrentgemma": recurrentgemma})
    return row


# -- phase 9 ------------------------------------------------------------------

def k6_bound(BH: int, T: int, D: int) -> tuple[float, str]:
    """The least time the card could take for one K6 call: each input read
    once and each output written once (fp32), against the operations that
    every exact form of the scan does, whichever is slower.  Each (head,
    token) reads its query row out of the (D, D) state and adds its
    rank-one k v^T to it, D^2 multiply-adds each (4 D^2 flops on the fp32
    lanes), and needs at least one decay per channel (D exp2 on the SFU).
    The token recurrence does these and D^2 decay multiplies more; the
    chunked forms add their intra-chunk scores.  Neither surplus is
    counted, so the bound holds whatever form and chunk a kernel takes."""
    n_tok = BH * T
    flops = n_tok * 4 * D * D
    ex2 = n_tok * D
    n_bytes = 4 * (4 * BH * T * D + BH * D + BH * D * D      # r k v logw, u, s0
                   + BH * T * D + BH * D * D)                  # out, s_final
    times = {"bytes": n_bytes / HBM_BYTES_PER_S,
             "operations": max(flops / FP32_FLOP_PER_S, ex2 / EX2_PER_S)}
    by = max(times, key=times.get)
    return times[by] * 1e3, by


def k6_form_floor_ms(BH: int, T: int, D: int) -> float:
    """The floor of the kernel's own form, beside the bound: per (token,
    column, row) the state-column recurrence issues three fp32 instructions
    on the FMA pipe (the read-out FMA, the product k v[j], the decay-and-add
    FMA), 3 BH T D^2 in all, each one lane-slot of the 128 an SM issues per
    clock: the fp32 peak over its 2 flops per FMA."""
    return 3 * BH * T * D * D / (FP32_FLOP_PER_S / 2) * 1e3


def k6_train_ops(dev, gen, BH: int, T: int, heads: int):
    """One time-mix layer's scan operands in training, fp32 on the card, and
    the cotangents: r, k, v, dO ~ N(0, 1); logw as ``blocks._decay`` draws
    it at init, -exp(w0 + tanh(xw w1) w2) with w0 ~ N(0, 1) a channel (its
    init) and the data-dependent term ~ 0.1 N(0, 1) a token (w1, w2 at
    scale 0.02 over rank 64: sqrt(64) x 0.02 x E|tanh|); u ~ 0.5 N(0, 1) a
    channel (its init); s0 and dS_T ~ 0.1 N(0, 1).  Heads repeat over the
    ``BH / heads`` sequences."""
    D = K6_D

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    r, k, v, d_out = (randn(BH, T, D) for _ in range(4))
    w0 = randn(heads, D).repeat(BH // heads, 1)[:, None, :]
    logw = -torch.exp(w0 + 0.1 * randn(BH, T, D))
    u = (0.5 * randn(heads, D)).repeat(BH // heads, 1)
    s0, d_s = 0.1 * randn(BH, D, D), 0.1 * randn(BH, D, D)
    return (r, k, v, logw, u, s0), d_out, d_s


def k6_grad_oracle(ops, d_out, d_s, dtype) -> list:
    """The six gradients (r, k, v, logw, u, s0) of sum(out dO) +
    sum(s_final dS_T) by autograd of the token recurrence in ``dtype`` on
    copies of ``ops``, in segments of ``K6_GRAD_SEGMENT`` tokens under
    non-reentrant checkpoint (one segment's graph and the segments' end
    states are kept)."""
    from torch.utils.checkpoint import checkpoint

    def segment(s, r, k, v, logw, u):
        outs = []
        for t in range(r.shape[1]):
            kv = k[:, t, :, None] * v[:, t, None, :]
            outs.append(torch.bmm(r[:, t, None], s + u[:, :, None] * kv)[:, 0])
            s = torch.exp(logw[:, t])[..., None] * s + kv
        return torch.stack(outs, 1), s

    xs = [a.to(dtype, copy=True).requires_grad_() for a in ops]
    r, k, v, logw, u, s = xs
    outs = []
    with torch.enable_grad():
        for t0 in range(0, r.shape[1], K6_GRAD_SEGMENT):
            t = slice(t0, t0 + K6_GRAD_SEGMENT)
            o, s = checkpoint(segment, s, r[:, t], k[:, t], v[:, t], logw[:, t],
                              u, use_reentrant=False, preserve_rng_state=False)
            outs.append(o)
        return list(torch.autograd.grad((torch.cat(outs, 1), s), xs,
                                        (d_out.to(dtype), d_s.to(dtype))))


def rows_bound(BH: int, T: int, D: int) -> tuple[float, str]:
    """The least time for one key-row scan: x, y, z, logw and s0 read and
    out written once (fp32), against its 2 BH T D^2 FMA (the read-out and
    the decay-and-add; 4 flops) and one decay a (token, row) on the SFU."""
    n_bytes = 4 * (5 * BH * T * D + BH * D * D)
    times = {"bytes": n_bytes / HBM_BYTES_PER_S,
             "operations": max(4 * BH * T * D * D / FP32_FLOP_PER_S,
                               BH * T * D / EX2_PER_S)}
    by = max(times, key=times.get)
    return times[by] * 1e3, by


def rows_form_floor_ms(BH: int, T: int, D: int) -> float:
    """The floor of the key-row kernel's own form, beside its bound: per
    (token, row, column) the chunked form issues four fp32 instructions on
    the FMA pipe (the local pass's read-out FMA, the product x_t[i] y_t[j]
    and the decay-and-add FMA, the correction's FMA), 4 BH T D^2 in all,
    each one lane-slot of the 128 an SM issues per clock."""
    return 4 * BH * T * D * D / (FP32_FLOP_PER_S / 2) * 1e3


def k6_backward_bound(BH: int, T: int, D: int) -> tuple[float, str]:
    """The least time for K6's whole backward: r, k, v, logw, dO read and
    dr, dk, dv, dlogw written once, u, s0, s_final, dS_T read and du, ds0
    written once (fp32), against the three scans' 12 BH T D^2 flops (K6's
    read-out and rank-one update, each key-row scan's read-out and update;
    the elementwise terms are not counted)."""
    n_bytes = 4 * (9 * BH * T * D + 2 * BH * D + 4 * BH * D * D)
    times = {"bytes": n_bytes / HBM_BYTES_PER_S,
             "operations": 12 * BH * T * D * D / FP32_FLOP_PER_S}
    by = max(times, key=times.get)
    return times[by] * 1e3, by


def k6_backward_checks(dev, kernels, ref, build_report, gen) -> tuple[dict, dict]:
    """K6's gradient (``kernels.wkv6_scan``) at one time-mix layer's training
    shape ``K6_TRAIN``: the key-row kernel against its plain version and
    twice the same bits; one backward is one K6 and two key-row launches;
    the six gradients against float64 autograd of the token recurrence
    within ``K6_GRAD_REL_TOL`` of max|float64| (the fp32 autograd's
    departure beside each); two backwards give the same bits.  Returns
    (the backward's readings, the key-row kernel's row)."""
    from repro_torch.kernels import gemm

    BH, T = K6_TRAIN
    D = K6_D
    ops, d_out, d_s = k6_train_ops(dev, gen, BH, T, K6_TRAIN_HEADS)
    r, k, v, logw, u, s0 = ops
    # The key-row kernel as the backward's forward launch calls it.
    rows_ops = (k, v, d_out, logw, s0)
    got = kernels.wkv6_rows(*rows_ops)
    again = kernels.wkv6_rows(*rows_ops)
    want = ref.wkv6_rows_ref(*rows_ops)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    lim = REL_TOL * float(want.abs().max())
    check(got.shape == want.shape and bool(torch.isfinite(got).all()),
          f"key-row scan: got {tuple(got.shape)}, non-finite values")
    check(err <= lim, f"key-row scan: |kernel - plain| {err} > {lim}")
    check(same_bits(got, again), "key-row scan: two calls gave different bits")
    del got, again, want

    xs = [a.clone().requires_grad_() for a in ops]
    with torch.enable_grad():
        out, s_fin = kernels.wkv6_scan(*xs, chunk=K6_CHUNK)

    def backward():
        return torch.autograd.grad((out, s_fin), xs, (d_out, d_s),
                                   retain_graph=True)

    before = (kernels.wkv6_chunked.launches, kernels.wkv6_rows.launches)
    grads = backward()
    per_backward = (kernels.wkv6_chunked.launches - before[0],
                    kernels.wkv6_rows.launches - before[1])
    check(per_backward == (1, 2),
          f"one backward launched K6 and the key-row scan {per_backward} times")
    grads_again = backward()
    torch.cuda.synchronize()
    check(all(same_bits(a, b) for a, b in zip(grads, grads_again)),
          "K6 backward: two calls gave different bits")
    del grads_again
    want64 = k6_grad_oracle(ops, d_out, d_s, torch.float64)
    plain32 = k6_grad_oracle(ops, d_out, d_s, torch.float32)
    readings = []
    for name, g, w, p in zip(("dr", "dk", "dv", "dlogw", "du", "ds0"),
                             grads, want64, plain32):
        scale = float(w.abs().max())
        rel = float((g.double() - w).abs().max()) / scale
        readings.append({"grad": name, "max_abs_fp64": scale,
                         "kernel_rel": rel,
                         "plain_fp32_rel": float((p.double() - w).abs().max())
                         / scale,
                         "limit_rel": K6_GRAD_REL_TOL})
        check(bool(torch.isfinite(g).all()), f"K6 backward {name}: non-finite")
        check(rel <= K6_GRAD_REL_TOL,
              f"K6 backward {name}: |kernel - fp64| {rel} > {K6_GRAD_REL_TOL}"
              f" of max|fp64| (fp32 autograd {readings[-1]['plain_fp32_rel']})")
    del want64, plain32, grads
    bwd_ms = cuda_p50(backward, 3, 2)
    del out, s_fin, xs
    run_k = lambda: kernels.wkv6_rows(*rows_ops)  # noqa: E731
    run_p = lambda: ref.wkv6_rows_ref(*rows_ops)  # noqa: E731
    runs = [graph_ms(run_k, 5, 10), cuda_p50(run_p, 2, 1),
            graph_ms(run_k, 5, 10), cuda_p50(run_p, 2, 1)]
    b, by = rows_bound(BH, T, D)
    bb, bby = k6_backward_bound(BH, T, D)
    ptxas = [ln.strip() for ln in build_report["wkv6_rows"]["log"].splitlines()
             if "registers" in ln or "spill" in ln or "entry function" in ln]
    row = {"max_abs_err": err, "ms": (runs[0] + runs[2]) / 2,
           "plain_ms": (runs[1] + runs[3]) / 2, "library_ms": None,
           "bound_ms": b, "bound_by": by,
           "bounds": {"form_floor_ms": rows_form_floor_ms(BH, T, D)},
           "runs_ms": runs, "eager_ms": cuda_p50(run_k, 5, 10), "ptxas": ptxas,
           "timed_shape": f"x/y/z/logw ({BH}, {T}, {D}) fp32, s0 ({BH}, {D}, {D}),"
                          f" chunks of {gemm.rows_chunk()} tokens"}
    backward_out = {"shape": [BH, T, D], "chunk": K6_CHUNK,
                    "grads": readings,
                    "launches_per_backward": {"wkv6_chunked": per_backward[0],
                                              "wkv6_rows": per_backward[1]},
                    "backward_ms": bwd_ms, "backward_bound_ms": bb,
                    "backward_bound_by": bby,
                    "rows_max_abs_err": err, "rows_limit": lim}
    return backward_out, row


def k6_checks(dev, kernels, ref, build_report) -> tuple[dict, dict]:
    """K6 against both plain versions (the chunked form and the token
    recurrence) on the card in fp32, at the prefill's width (D 64, chunk
    128) and the shapes of ``K6_CASES``, with the input distribution of the
    reference's wkv6 sweep and a nonzero s0; gates two calls giving the same
    bits; then its backward (:func:`k6_backward_checks`).  Returns K6's
    error and timing row (timed at ``K6_MAIN``, the rwkv_path prefill's
    shape) and the key-row scan's."""
    from repro_torch.kernels import gemm

    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    checks, row = [], {"max_abs_err": 0.0}

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def scan_ops(BH, T, shift=0.0):
        r, k, v = randn(BH, T, K6_D), randn(BH, T, K6_D), randn(BH, T, K6_D)
        logw = -torch.exp(randn(BH, T, K6_D) + shift)
        return r, k, v, logw, randn(BH, K6_D), randn(BH, K6_D, K6_D) * 0.1

    sms = gemm.sm_count(dev)
    timed, per_case = None, {}
    for BH, T, decay in [*((bh, t, "ordinary") for bh, t in K6_CASES),
                         (*K6_STRONG, "strong")]:
        ops = scan_ops(BH, T, 1.0 if decay == "strong" else 0.0)
        got_o, got_s = kernels.wkv6_chunked(*ops, chunk=K6_CHUNK)
        torch.cuda.synchronize()
        chunked = ref.wkv6_chunked_ref(*ops, chunk=K6_CHUNK)
        r, k, v, logw, u, s0 = ops
        o, s = ref.wkv6_ref(r[None], k[None], v[None], logw[None], u, s0[None])
        for plain, (want_o, want_s) in (("chunked", chunked),
                                        ("recurrence", (o[0], s[0]))):
            for tag, got, want in (("out", got_o, want_o), ("state", got_s, want_s)):
                err = float((got - want).abs().max())
                lim = REL_TOL * float(want.abs().max())
                case = f"BH{BH}_T{T}_{decay}/{tag}_vs_{plain}"
                checks.append({"case": case, "max_abs_err": err, "limit": lim})
                check(got.shape == want.shape and got.dtype == torch.float32,
                      f"K6 {case}: got {tuple(got.shape)} {got.dtype}")
                check(bool(torch.isfinite(got).all()), f"K6 {case}: non-finite")
                check(err <= lim, f"K6 {case}: |kernel - plain| {err} > {lim}")
                row["max_abs_err"] = max(row["max_abs_err"], err)
        form, size = gemm.scan_form(BH, T, K6_D, sms)
        if (BH, T) in (K6_MAIN, K6_TRAIN) and decay == "ordinary":
            again_o, again_s = kernels.wkv6_chunked(*ops, chunk=K6_CHUNK)
            check(same_bits(got_o, again_o) and same_bits(got_s, again_s),
                  f"K6 ({BH}, {T}), {form} {size}: two calls gave different bits")
            del again_o, again_s
        if (BH, T) == K6_MAIN:
            timed = ops
        per_case[f"BH{BH}_T{T}" + ("_strong" if decay == "strong" else "")] = {
            "ms": graph_ms(lambda: kernels.wkv6_chunked(*ops, chunk=K6_CHUNK),
                           5, 10),
            "bound_ms": k6_bound(BH, T, K6_D)[0],
            "form": form, "C" if form == "columns" else "L": size}
        del chunked, o, s, got_o, got_s
    # Timed at the prefill's shape, kernel and plain chunked version in
    # turns: the kernel in CUDA graphs (device time; it runs shorter than
    # its wrapper's host time), and back to back as a caller sees it.  No
    # single PyTorch call computes this scan: library_ms is null.
    BH, T = K6_MAIN
    run_k = lambda: kernels.wkv6_chunked(*timed, chunk=K6_CHUNK)  # noqa: E731
    run_p = lambda: ref.wkv6_chunked_ref(*timed, chunk=K6_CHUNK)  # noqa: E731
    runs = [graph_ms(run_k, 5, 10), cuda_p50(run_p, 5, 2),
            graph_ms(run_k, 5, 10), cuda_p50(run_p, 5, 2)]
    eager = cuda_p50(run_k, 5, 10)
    b, by = k6_bound(BH, T, K6_D)
    # Printed, not gated: the time's growth in T at BH = 40 (the kernel is
    # sequential in T), and the time at every block width the kernel takes
    # at the prefill's shape through the binding (which counts no launch).
    t_sweep = {}
    for t_len in K6_T_SWEEP:
        ops = scan_ops(BH, t_len)
        t_sweep[t_len] = graph_ms(
            lambda: kernels.wkv6_chunked(*ops, chunk=K6_CHUNK), 5, 10)
    width_sweep = {c: graph_ms(lambda: gemm.scan("wkv6_chunked", *timed, width=c),
                               3, 10)
                   for c in gemm.scan_widths(K6_D)}
    G, CPT = gemm.SCAN_SPLIT[K6_D]
    C = gemm.scan_width(BH, K6_D, sms)
    ptxas = [ln.strip() for ln in build_report["wkv6"]["log"].splitlines()
             if "registers" in ln or "spill" in ln or "entry function" in ln]
    row.update(ms=(runs[0] + runs[2]) / 2, plain_ms=(runs[1] + runs[3]) / 2,
               library_ms=None, bound_ms=b, bound_by=by,
               bounds={"form_floor_ms": k6_form_floor_ms(BH, T, K6_D)},
               eager_ms=eager,
               timed_shape=f"r/k/v/logw ({BH}, {T}, {K6_D}) fp32, chunk {K6_CHUNK}",
               geometry={"form": gemm.scan_form(BH, T, K6_D, sms), "G": G,
                         "CPT": CPT, "C": C,
                         "blocks": BH * -(-K6_D // C),
                         "consumer_threads": C // CPT * G,
                         "smem_bytes": gemm.scan_smem_bytes(K6_D)},
               ptxas=ptxas, runs_ms=runs, per_case=per_case,
               t_sweep_ms=t_sweep, width_sweep_ms=width_sweep)
    del timed, ops
    release()
    backward, rows_row = k6_backward_checks(dev, kernels, ref, build_report, gen)
    emit({"phase": "kernels_k6", "checks": len(checks),
          "worst": max(checks, key=lambda c: c["max_abs_err"] / c["limit"]),
          "row": row, "backward": backward, "rows_row": rows_row})
    return row, rows_row


# -- phases 6, 6a-6c and 10 (lm_path and its long-prompt, --mole off and phi3
#    runs, rwkv_path) ---------------------------------------------------------

class HeadTap:
    """Records what the decode lane hands K3 at every batched decode step.

    While installed, ``repro_torch.launch.steps.lm_head_rows_grouped`` (the
    name the lane's step calls) is wrapped: the lane's own final-normed
    hidden states ``h``, its slot indices, the stacked Aug-heads and K3's
    logits are kept, beside the rows that step serves (their ``DecodeRow``
    objects, whose ``generated`` list the step appends to).  The wrapper
    calls the same entry point once, so each step still launches K3 once.
    """

    def __init__(self, lane):
        from repro_torch.launch import steps

        self.lane, self.steps, self.records = lane, steps, []
        self._real = steps.lm_head_rows_grouped

    def _head(self, h, gidx, heads):
        logits = self._real(h, gidx, heads)
        self.records.append({
            "h": h.clone(), "gidx": torch.as_tensor(gidx).clone(),
            "heads": heads, "logits": logits.clone(),
            "rows": [(i, r, len(r.generated))
                     for i, r in enumerate(self.lane._row)
                     if r is not None and r.remaining > 0],
        })
        return logits

    def __enter__(self):
        self.steps.lm_head_rows_grouped = self._head
        return self

    def __exit__(self, *exc):
        self.steps.lm_head_rows_grouped = self._real


def run_lane(lane, served, tenant_of, gen: int) -> dict:
    """Drive ``lane`` over the morphed prompts, ``gen`` tokens each; count
    its batched decode steps (a step that returns > 0 ran one) and time the
    pure decode steps (no admission) on the host clock (each step reads its
    tokens back)."""
    sids = [lane.submit(tenant_of[r], served[r], gen, premorphed=True)
            for r in range(len(served))]
    steps, pure_ms = 0, []
    t0 = time.monotonic()
    while len(lane.queue) or lane.active:
        queued = len(lane.queue)
        ts = time.monotonic()
        ran = lane.step() > 0
        dt = (time.monotonic() - ts) * 1e3
        steps += ran
        if ran and len(lane.queue) == queued:
            pure_ms.append(dt)
    lane.run()
    lane_s = time.monotonic() - t0
    return {"final": np.stack([lane.take(s) for s in sids]),
            "steps": steps, "pure_ms": pure_ms, "lane_s": lane_s}


def gaps_in_ulps(pos_logits: torch.Tensor, tokens: np.ndarray):
    """(max - logit[token]) in bf16 units in the last place of |max|, and
    whether the token is the first-index argmax, at every position."""
    top = pos_logits.max(dim=-1).values
    idx = torch.from_numpy(tokens).long().to(pos_logits.device)[..., None]
    picked = torch.gather(pos_logits, -1, idx)[..., 0]
    ulp = np.vectorize(bf16_ulp)(np.abs(top.float().cpu().numpy()))
    gap = (top - picked).float().cpu().numpy() / ulp
    exact = pos_logits.argmax(dim=-1).cpu().numpy() == tokens
    return gap, exact


def lane_head_checks(records, registry, head_raw, cap=None) -> dict:
    """Checks 3 and 4 on the lane's own hidden states, step by step.

    3. K3 against the plain head: ``ref.lm_head_rows_grouped_ref`` (a
       per-row ``torch.matmul`` against the slot's head cast to h's dtype;
       no K3) on the same ``h``, slot indices and stacked heads, within two
       bf16 ulps of max|plain|; and every token the step sampled is K3's
       argmax and lies within ``TIE_MARGIN_ULPS`` bf16 ulps of the row's
       max|plain| below the plain-head maximum.  Both on the logits before
       the final soft-cap ``cap`` (the lane applies it to K3's output in
       fp32 and samples after it: the token is checked as the argmax there).
    4. Unmorph against the raw weights: each served row's morphed-order
       logits, permuted back with its tenant's permutation
       (``plain[v] = morphed[perm[v]]``), against ``h @ head`` on the
       unfused bf16 head (``torch.matmul``), within two bf16 ulps of
       max|h @ head|.  This holds the fused Aug-head stack, the permutation
       conjugation and K3 without K3's own plain version.
    """
    from repro_torch.kernels import ref
    from repro_torch.models import layers as L

    worst3 = worst4 = worst_gap = 0.0
    n_rows = exact = 0
    for step, rec in enumerate(records):
        h, got = rec["h"], rec["logits"]
        plain = ref.lm_head_rows_grouped_ref(h, rec["gidx"], rec["heads"])
        check(got.shape == plain.shape and got.dtype == plain.dtype,
              f"step {step}: K3 logits {tuple(got.shape)} {got.dtype}")
        check(bool(torch.isfinite(got).all()), f"step {step}: non-finite logits")
        err = float((got.float() - plain.float()).abs().max())
        lim = 2 * bf16_ulp(float(plain.float().abs().max()))
        check(err <= lim, f"check 3, step {step}: |K3 - plain head| {err} > {lim}")
        worst3 = max(worst3, err / lim)
        raw = torch.matmul(h, head_raw)
        for i, row, n in rec["rows"]:
            tok = row.generated[n]
            check(tok == int(torch.argmax(L.softcap(got[i].float(), cap))),
                  f"step {step} row {i}: sampled {tok}, not K3's argmax")
            p = plain[i].float()
            gap = float(p.max() - p[tok]) / bf16_ulp(float(p.abs().max()))
            check(gap <= TIE_MARGIN_ULPS,
                  f"check 3, step {step} row {i}: sampled token {gap:.2f} bf16 "
                  f"ulps below the plain-head max (margin {TIE_MARGIN_ULPS})")
            worst_gap = max(worst_gap, gap)
            exact += int(tok == int(torch.argmax(p)))
            n_rows += 1
            perm = torch.from_numpy(
                registry.session(row.tenant_id).morpher.perm
            ).to(got.device)
            want = raw[i].float()
            err = float((got[i].float()[perm] - want).abs().max())
            lim = 2 * bf16_ulp(float(want.abs().max()))
            check(err <= lim, f"check 4, step {step} row {i}: |unmorphed K3 - "
                              f"h @ head| {err} > {lim}")
            worst4 = max(worst4, err / lim)
    check(n_rows > 0, "no decode step was recorded")
    return {"steps": len(records), "rows_checked": n_rows,
            "k3_vs_plain_head_worst_share_of_limit": worst3,
            "sampled_worst_gap_ulps": worst_gap,
            "sampled_is_plain_argmax_share": exact / n_rows,
            "unmorph_vs_raw_head_worst_share_of_limit": worst4}


def plain_gaps(model, params, prompts, final, dev):
    """The twin's independent plain reference on the raw weights, teacher
    forced with the lane's generations: the logits that predicted each
    generated token, as ``gaps_in_ulps``.

    Up to ``dense_attn_max_seq`` positions, one full ``forward`` over
    prompt + generation.  Longer, the raw model as ``--mole off`` serves
    it: a prefill of the prompts (a forward through the flash scan, as the
    lane's admission prefill) and a decode step per generated token fed the
    lane's token (decode attention, as the lane's steps).  A forward there
    would run the flash scan at the generated positions as well, whose
    rounding (``p`` rounded to bf16 before its product, one division at the
    end) is not decode attention's.

    An MoE model routes each call with the capacity of its own tokens, so
    its plain reference makes the calls the lane makes: a prefill of each
    prompt alone (the lane's admission prefill), then one decode step of
    that sequence alone per generated token (the lane routes each row as
    a call of its own).  One forward over all prompts and generations would
    be one call of B (P + gen) tokens, with other drops."""
    from repro_torch.models import stack as S

    cfg = model.cfg
    P, gen = prompts.shape[1], final.shape[1]
    if cfg.moe is not None:
        tokens = torch.from_numpy(final).long().to(dev)
        rows = []
        for r in range(len(prompts)):
            caches = model.init_cache(1, P + gen + 1)
            step, caches = model.prefill_with_cache(params, {
                "tokens": torch.from_numpy(prompts[r : r + 1]).long().to(dev)},
                caches)
            steps = [step[:, 0]]
            for i in range(gen - 1):
                step, caches = model.decode(params, tokens[r : r + 1, i : i + 1],
                                            P + i, caches)
                steps.append(step[:, 0])
            rows.append(torch.cat(steps))
        logits = torch.stack(rows)
    elif P + gen <= cfg.dense_attn_max_seq:
        seqs = torch.from_numpy(np.concatenate([prompts, final], axis=1)).to(dev)
        logits = S.forward(params, cfg, seqs)[0][:, P - 1 : P - 1 + gen]
    else:
        caches = model.init_cache(len(prompts), P + gen + 1)
        tokens = torch.from_numpy(final).long().to(dev)
        step, caches = model.prefill_with_cache(
            params, {"tokens": torch.from_numpy(prompts).long().to(dev)}, caches)
        steps = [step[:, 0]]
        for i in range(gen - 1):
            step, caches = model.decode(params, tokens[:, i : i + 1], P + i, caches)
            steps.append(step[:, 0])
        logits = torch.stack(steps, dim=1)
    check(bool(torch.isfinite(logits).all()), "plain logits non-finite")
    return gaps_in_ulps(logits, final)


def step_profile(fn, step_ms: float, track: tuple = ()) -> dict:
    """One call of ``fn`` under torch.profiler: device-busy time (the sum
    of the kernels' device time; CPU-side ops are left out, as they carry
    their kernels' time again), the number of kernel launches, the five
    kernels with the most device time, the eight CPU-side operations with
    the most device time of the kernels they launched themselves
    (``self_device_time_total``: an op's children count apart), and the
    idle share of an unprofiled step of ``step_ms``.  For each name in
    ``track``, the device time, launches and share of ``step_ms`` of the
    kernels whose name contains it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    events = prof.key_averages()
    kern = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    top = sorted(kern, key=lambda e: e.self_device_time_total, reverse=True)
    ops = sorted((e for e in events if e.device_type == DeviceType.CPU),
                 key=lambda e: e.self_device_time_total, reverse=True)
    return {
        "profiled_wall_ms": wall_ms,
        "device_busy_ms": busy_ms if kern else "not measured",
        "idle_share_of_step": 1 - busy_ms / step_ms if kern else "not measured",
        "kernel_launches": sum(e.count for e in kern),
        "top_kernels_ms": [[e.key[:60], e.self_device_time_total / 1e3]
                           for e in top[:5]],
        "top_ops_ms": [[e.key[:60], e.count, e.self_device_time_total / 1e3]
                       for e in ops[:8]],
        "tracked_ms": {
            name: {"ms": ms, "launches": sum(e.count for e in kern
                                             if name in e.key),
                   "share_of_step": ms / step_ms}
            for name in track
            for ms in [sum(e.self_device_time_total for e in kern
                           if name in e.key) / 1e3]},
    }


class ScanTap:
    """Counts and times the decode lane's admission prefills and keeps what
    one of them hands K6.

    While installed, the lane's prefill step and
    ``repro_torch.models.blocks.wkv6_chunked`` (the name the time-mix calls)
    are wrapped.  Each prefill is timed on the host clock between two
    ``torch.cuda.synchronize()``.  At the first prefill, the operands (r,
    k, v, logw, u, s0) of the call ``layer`` (0-based) and K6's outputs are
    cloned.  Each wrapper calls the real function once, so launch counts
    are unchanged.
    """

    def __init__(self, lane, layer: int):
        from repro_torch.models import blocks

        self.lane, self.blocks, self.layer = lane, blocks, layer
        self.prefills, self.calls, self.captured = 0, 0, None
        self.prefill_ms = []
        self._scan, self._prefill = blocks.wkv6_chunked, lane._prefill

    def _count_prefill(self, *args):
        self.prefills += 1
        torch.cuda.synchronize()
        t0 = time.monotonic()
        out = self._prefill(*args)
        torch.cuda.synchronize()
        self.prefill_ms.append((time.monotonic() - t0) * 1e3)
        return out

    def _wkv6(self, *ops, chunk):
        out = self._scan(*ops, chunk=chunk)
        if self.prefills == 1 and self.calls == self.layer:
            self.captured = {"ops": [a.clone() for a in ops], "chunk": chunk,
                             "out": out[0].clone(), "s": out[1].clone()}
        self.calls += 1
        return out

    def __enter__(self):
        self.blocks.wkv6_chunked = self._wkv6
        self.lane._prefill = self._count_prefill
        return self

    def __exit__(self, *exc):
        self.blocks.wkv6_chunked = self._scan
        self.lane._prefill = self._prefill


class RouteTap:
    """Records every MoE routing while installed: the FFN calls
    ``repro_torch.models.blocks.moe_route`` by that name, and the wrapper
    calls the real function once.  Per call: its ``calls`` (1 for a whole
    batch, the row count for the lane's decode step), its tokens, its
    dropped assignments (a device tensor, read after the run), and the
    smallest gap between a token's k-th and (k+1)-th router probability
    (a near-tie there can flip an expert between two roundings)."""

    def __init__(self):
        from repro_torch.models import blocks

        self.blocks, self.records = blocks, []
        self._real = blocks.moe_route

    def _route(self, p, xf, cfg, calls=1):
        r = self._real(p, xf, cfg, calls)
        top = torch.topk(r.probs, cfg.moe.top_k + 1, dim=-1).values
        self.records.append(
            (calls, xf.shape[0], (~r.keep).sum(),
             (top[:, -2] - top[:, -1]).min()))
        return r

    def summary(self, moe_layers: int) -> dict:
        """Dropped assignments per prefill (a call of one prompt, summed
        over its ``moe_layers`` MoE layers), those of the decode steps (one
        token a call), and the smallest router gap of each MoE layer."""
        prefill = [int(d) for c, t, d, _ in self.records if t > c]
        decode = [int(d) for c, t, d, _ in self.records if t == c]
        gaps = [float(g) for *_, g in self.records]
        return {
            "drops_per_prefill": [sum(prefill[i : i + moe_layers])
                                  for i in range(0, len(prefill), moe_layers)],
            "prefill_calls": len(prefill), "decode_calls": len(decode),
            "decode_drops": sum(decode),
            "min_router_gap_per_layer": [
                min(gaps[i::moe_layers]) for i in range(moe_layers)],
        }

    def __enter__(self):
        self.blocks.moe_route = self._route
        return self

    def __exit__(self, *exc):
        self.blocks.moe_route = self._real


class FlashTap:
    """Counts the calls of the chunked flash scan while installed: the
    attention dispatch calls ``repro_torch.models.layers.flash_attention``
    by that name above ``dense_attn_max_seq``, and the wrapper calls the
    real function once."""

    def __init__(self):
        from repro_torch.models import layers

        self.layers, self.calls = layers, 0
        self._real = layers.flash_attention

    def _flash(self, *args, **kw):
        self.calls += 1
        return self._real(*args, **kw)

    def __enter__(self):
        self.layers.flash_attention = self._flash
        return self

    def __exit__(self, *exc):
        self.layers.flash_attention = self._real


class PlainScan:
    """While installed, the time-mix runs the token recurrence
    ``ref.wkv6_ref`` in place of K6 (an independent plain scan)."""

    def __enter__(self):
        from repro_torch.kernels import ref
        from repro_torch.models import blocks

        def plain(r, k, v, logw, u, s0, *, chunk):
            out, s = ref.wkv6_ref(r[None], k[None], v[None], logw[None], u,
                                  s0[None])
            return out[0].to(r.dtype), s[0]

        self.blocks, self._scan = blocks, blocks.wkv6_chunked
        blocks.wkv6_chunked = plain
        return self

    def __exit__(self, *exc):
        self.blocks.wkv6_chunked = self._scan


def k6_against_recurrence(captured) -> dict:
    """Check 5 of rwkv_path: K6's output and final state, as the lane's
    prefill got them, against the token recurrence on the same operands,
    within 1e-4 * max|plain|."""
    from repro_torch.kernels import ref

    r, k, v, logw, u, s0 = captured["ops"]
    want_o, want_s = ref.wkv6_ref(r[None], k[None], v[None], logw[None], u,
                                  s0[None])
    res = {"shape": list(r.shape)}
    for tag, got, want in (("out", captured["out"], want_o[0]),
                           ("state", captured["s"], want_s[0])):
        err = float((got.float() - want).abs().max())
        lim = REL_TOL * float(want.abs().max())
        check(bool(torch.isfinite(got).all()), f"check 5: K6 {tag} non-finite")
        check(err <= lim, f"check 5: |K6 {tag} - recurrence| {err} > {lim}")
        res[f"{tag}_max_abs_err"], res[f"{tag}_limit"] = err, lim
    return res


def lm_path(dev, kernels, *, phase: str, arch: str, prompt_len: int,
            requests: int = LM_REQUESTS, gen: int = LM_GEN,
            ctx: dict | None = None, flash_shape: bool = False,
            groups: int | None = None,
            twin_groups: int | None = None) -> dict:
    """``serve --mode lm`` at ``arch`` FULL, ``requests`` prompts of
    ``prompt_len`` tokens, ``gen`` generated each: the token lane, then the
    continuous-batched decode lane; gated checks and a time breakdown.
    For an RWKV stack also: K6 launched once per layer per admission
    prefill, K6 on one layer's captured operands against the token
    recurrence, and the twin's plain forward through that recurrence.  For
    a stack with attention layers (a hybrid's RG-LRU layers run no
    attention): the flash scan called once per attention layer per
    admission prefill when the prompt exceeds ``dense_attn_max_seq``,
    never otherwise, in the twin's plain reference too
    (:func:`plain_gaps`).  ``flash_shape`` adds
    :func:`flash_checks`.  ``ctx``, if given, receives the weights, prompts
    and the lane's generations for a later phase.  ``groups`` cuts the
    depth to that many scanned groups; ``twin_groups`` sets the twin's
    (its prefix and suffix layers kept).  With tied embeddings the lane's
    head stack is AugE^T and the raw head of check 4 is embed^T.  With a
    sliding window the twin also runs the window-live gate
    (:func:`window_live`).  The peak device memory is held at
    PEAK_LIMIT_GB."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.lm import LMSessionRegistry
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.steps import (
        make_batched_decode_logits, make_row_prefill_step,
    )
    from repro_torch.models import Model, blocks as B, stack as S
    from repro_torch.models.blocks import moe_capacity
    from repro_torch.runtime import (
        ContinuousDecodeLane, DeliveryRequest, MoLeDeliveryEngine,
    )

    t_phase = time.monotonic()
    cfg = get_config(arch)
    if groups is not None:
        cfg = dataclasses.replace(cfg, n_groups=groups)
    rwkv = cfg.rwkv is not None
    torch.cuda.reset_peak_memory_stats()
    host_reset = host_peak_reset()
    max_len = prompt_len + gen + 1
    model = Model(cfg, dev)
    t0 = time.monotonic()
    params = model.init(SEED)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    t0 = time.monotonic()
    # one fp32 host array for every tenant (register copies nothing), cast
    # on the host: no fp32 transient on the card
    embed = params["embed"].cpu().float().numpy()
    head = (None if cfg.tie_embeddings
            else params["head"].cpu().float().numpy())
    registry = LMSessionRegistry(cfg.vocab, cfg.d_model, capacity=LM_TENANTS)
    for i in range(LM_TENANTS):
        registry.register(f"lm-{i}", embed, seed=i, head=head)
    del embed, head
    src = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=prompt_len,
                                 global_batch=requests, seed=SEED))
    prompts = src.batch(0)["tokens"]
    tenant_of = [f"lm-{r % LM_TENANTS}" for r in range(requests)]
    engine = MoLeDeliveryEngine(
        lm_registry=registry, device=dev,
        seq_buckets=tuple(sorted({8, 16, 64, prompt_len})),
    )
    lane = ContinuousDecodeLane(
        model, params, registry, rows=LM_TENANTS, max_len=max_len,
        device=dev, scheduler=engine.scheduler,
    )
    stacks = lane._refresh_plan().arrays   # stage (S, V, d) / (S, d, V)
    torch.cuda.synchronize()
    setup_s = time.monotonic() - t0
    host_gb, host_now_gb = host_peak_gb(), host_rss_gb()
    # The lane holds its Aug-heads and AugE tables in the model's activation
    # type (bf16 here: K3 reads half an fp32 stack's bytes).
    check(stacks["aug_heads"].dtype == cfg.adtype == stacks["aug_embeds"].dtype,
          f"the lane staged aug_heads {stacks['aug_heads'].dtype}, aug_embeds "
          f"{stacks['aug_embeds'].dtype} (model {cfg.adtype})")
    stack_bytes = {n: a.numel() * a.element_size() for n, a in stacks.items()}
    del stacks

    # -- the main path: provider-side token lane, then the decode lane -----
    reset_launches(kernels)
    t1 = time.monotonic()
    rids = [engine.submit(DeliveryRequest(tenant_of[r], prompts[r : r + 1],
                                          lane="tokens"))
            for r in range(requests)]
    engine.flush()
    served = np.concatenate([engine.take(r) for r in rids])
    morph_s = time.monotonic() - t1
    moe_layers = sum(k.endswith("_moe") for k in cfg.layer_kinds())
    with torch.no_grad(), HeadTap(lane) as tap, FlashTap() as flash, \
            ScanTap(lane, layer=cfg.n_layers - 1) as scan, RouteTap() as route:
        run = run_lane(lane, served, tenant_of, gen)
    launches = {n: getattr(kernels, n).launches for n in KERNEL_NAMES}
    admission_ms = scan.prefill_ms
    # Check 1: the token lane's morphed prompts are numpy's perm[tokens].
    want = np.stack([registry.session(tenant_of[r]).morpher.perm[prompts[r]]
                     for r in range(requests)])
    check(served.shape == want.shape and np.array_equal(served, want),
          "check 1: morphed prompts differ from perm[tokens]")
    # Check 2: one K3 launch per batched decode step; for an RWKV stack one
    # K6 launch per layer per admission prefill; no other kernel.
    check(launches["grouped_row_gemm"] == run["steps"] == len(tap.records),
          f"check 2: K3 launched {launches['grouped_row_gemm']} times for "
          f"{run['steps']} decode steps ({len(tap.records)} recorded)")
    check(scan.prefills == requests,
          f"{scan.prefills} admission prefills for {requests} requests")
    # The chunked flash scan: once per attention layer per admission prefill
    # above dense_attn_max_seq (the decode steps attend one position), else
    # never.
    attn_layers = attention_layers(cfg)
    long_prompt = prompt_len > cfg.dense_attn_max_seq
    flash_want = attn_layers * scan.prefills if long_prompt else 0
    check(flash.calls == flash_want,
          f"check 2: the flash scan ran {flash.calls} times, expected "
          f"{flash_want} ({attn_layers} attention layers x {scan.prefills} "
          f"prefills of {prompt_len} tokens, dense_attn_max_seq "
          f"{cfg.dense_attn_max_seq})")
    k6_want = cfg.n_layers * scan.prefills if rwkv else 0
    check(launches["wkv6_chunked"] == k6_want,
          f"check 2: K6 launched {launches['wkv6_chunked']} times, expected "
          f"{k6_want} ({cfg.n_layers} layers x {scan.prefills} prefills)")
    others = {n: c for n, c in launches.items()
              if n not in ("grouped_row_gemm", "wkv6_chunked") and c}
    check(not others, f"the LM path launched other kernels: {others}")
    # MoE: one routing a layer per admission prefill and per decode step;
    # the decode step routes each row alone, so it drops nothing.
    routing = route.summary(moe_layers) if moe_layers else None
    if routing is not None:
        check(routing["prefill_calls"] == moe_layers * scan.prefills
              and routing["decode_calls"] == moe_layers * run["steps"],
              f"check 2: MoE routings {routing['prefill_calls']} in prefills, "
              f"{routing['decode_calls']} in decode steps")
        check(routing["decode_drops"] == 0,
              f"check 2: the decode steps dropped {routing['decode_drops']} "
              f"assignments")
    del route
    final = run["final"]
    check(final.shape == (requests, gen), f"generations {final.shape}")
    check(final.min() >= 0 and final.max() < cfg.vocab, "token ids out of range")
    # Checks 3 and 4: K3 in the lane against the plain head and the raw
    # weights, on the lane's own hidden states.
    with torch.no_grad():
        heads = lane_head_checks(tap.records, registry,
                                 S.head_matrix(params, cfg), cfg.final_softcap)
    del tap
    # Check 5 (RWKV; the twin below is then check 6): K6 on one layer's
    # operands, as the first admission prefill handed them over, against
    # the token recurrence.
    k6_gate = None
    if rwkv:
        check(scan.captured is not None, "no K6 call was captured")
        with torch.no_grad():
            k6_gate = k6_against_recurrence(scan.captured)

    # -- where a decode step's time goes (CUDA events, the lane's shapes) --
    rows = LM_TENANTS
    plan = lane._plan
    sidx = torch.arange(rows, dtype=torch.int32, device=dev)
    tpos = torch.full((rows,), prompt_len + gen - 1, device=dev)
    caches = lane._caches       # the lane has finished: its rows are free
    h0 = torch.zeros((rows, 1, cfg.d_model), dtype=cfg.adtype, device=dev)
    hN = torch.randn((rows, cfg.d_model), device=dev).to(cfg.adtype)
    lg = torch.randn((rows, cfg.vocab), device=dev)
    step_p50 = float(np.median(run["pure_ms"]))
    with torch.no_grad():
        trunk_ms = cuda_ms(lambda: S.apply_stack(
            params, h0, cfg, B.RunState(mode="decode", t=tpos, row_calls=True),
            caches), 5)
        k3_ms = cuda_ms(lambda: kernels.lm_head_rows_grouped(
            hN, sidx, plan.arrays["aug_heads"]), 10)
        sample_ms = cuda_ms(lambda: torch.argmax(lg, dim=-1).cpu(), 10)
        prefill = make_row_prefill_step(model)
        one = {"blocks": [{k: c[k][:1] for k in c} for c in caches["blocks"]]}
        ptoks = torch.from_numpy(served[:1]).to(dev)
        prefill_ms = cuda_ms(lambda: prefill(
            params, plan.arrays["aug_embeds"][0], plan.arrays["aug_heads"][0],
            ptoks, one), 3)
        k6_ms = k6_eager_ms = None
        if rwkv:
            ops, chunk = scan.captured["ops"], scan.captured["chunk"]
            run_k6 = lambda: kernels.wkv6_chunked(*ops, chunk=chunk)  # noqa: E731
            k6_ms = graph_ms(run_k6, 5, 10)
            k6_eager_ms = cuda_p50(run_k6, 5, 10)
        logits_fn = make_batched_decode_logits(model)
        prof = step_profile(lambda: torch.argmax(logits_fn(
            params, plan.arrays["aug_embeds"], plan.arrays["aug_heads"], sidx,
            torch.zeros(rows, dtype=torch.int32, device=dev), tpos, caches,
        )[0], dim=-1).cpu(), step_p50)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(peak_gb <= PEAK_LIMIT_GB,
          f"peak device memory {peak_gb:.2f} GB > {PEAK_LIMIT_GB} GB")
    del lane, caches, one, scan
    torch.cuda.empty_cache()

    # The twin: the same serving path on a depth-cut twin (2 layers, full
    # width: one group of a 2-kind pattern, or ``twin_groups`` groups and
    # the prefix and suffix layers), held against an independent
    # teacher-forced plain forward on the raw weights (for RWKV through the
    # token recurrence, not K6).  At full depth random bf16 layers amplify
    # rounding past the tie margin, so that comparison is made at 2.  The
    # twin's lane serves from the main lane's staged stacks (same registry
    # version: nothing is staged again).
    n_pre, n_suf = len(cfg.prefix_pattern), len(cfg.suffix_pattern)
    cfg2 = dataclasses.replace(cfg, n_groups=twin_groups or max(
        1, (2 - n_pre - n_suf) // len(cfg.block_pattern)))
    model2 = Model(cfg2, dev)
    params2 = {k: params[k] for k in params.keys() if k != "blocks"}
    blocks = list(params["blocks"])
    params2["blocks"] = (
        blocks[:n_pre + cfg2.n_groups * len(cfg.block_pattern)]
        + blocks[len(blocks) - n_suf:])
    lane2 = ContinuousDecodeLane(model2, params2, registry, rows=LM_TENANTS,
                                 max_len=max_len, device=dev)
    lane2._plan = plan
    with torch.no_grad():
        with RouteTap() as route2:
            run2 = run_lane(lane2, served, tenant_of, gen)
        with PlainScan(), FlashTap() as flash2, RouteTap() as plain_route2:
            gap2, exact2 = plain_gaps(model2, params2, prompts, run2["final"],
                                      dev)
    # the plain reference prefills once (an MoE model: once a prompt)
    prefills2 = requests if cfg.moe is not None else 1
    check(flash2.calls == (attention_layers(cfg2) * prefills2
                           if long_prompt else 0),
          f"the twin's plain reference ran the flash scan {flash2.calls} times")
    moe_layers2 = sum(k.endswith("_moe") for k in cfg2.layer_kinds())
    twin_routing = ({"lane": route2.summary(moe_layers2),
                     "plain_reference": plain_route2.summary(moe_layers2)}
                    if moe_layers2 else None)
    del route2, plain_route2
    check(bool((gap2 <= TIE_MARGIN_ULPS).all()),
          f"check {6 if rwkv else 5}, twin ({cfg2.n_layers} layers, plain "
          f"reference): a "
          f"generated token is "
          f"{gap2.max():.2f} bf16 ulps below the plain max "
          f"(margin {TIE_MARGIN_ULPS})")
    del lane2, plan
    live = (window_live(cfg2, params2, prompts, dev)
            if cfg.sliding_window and prompt_len > cfg.sliding_window else None)
    torch.cuda.empty_cache()
    flash_gate = flash_checks(dev) if flash_shape else None

    if ctx is not None:
        ctx.update(params=params, prompts=prompts, final=final,
                   tokens_per_s=requests * gen / run["lane_s"])
    tokens = requests * gen
    out = {
        "phase": phase, "arch": arch, "layers": cfg.n_layers,
        "published_layers": get_config(arch).n_layers,
        "block_pattern": list(cfg.block_pattern),
        "sliding_window": cfg.sliding_window,
        "tie_embeddings": cfg.tie_embeddings,
        "d_model": cfg.d_model, "vocab": cfg.vocab, "dtype": cfg.dtype,
        "tenants": LM_TENANTS, "capacity": LM_TENANTS, "rows": rows,
        "requests": requests, "prompt_len": prompt_len, "gen": gen,
        "decode_steps": run["steps"], "admission_prefills": requests,
        "k3_launches": launches["grouped_row_gemm"],
        "k6_launches": launches["wkv6_chunked"],
        "dense_attn_max_seq": cfg.dense_attn_max_seq,
        "flash_block_kv": cfg.flash_block_kv,
        "attention_layers": attn_layers,
        "flash_scan_calls": flash.calls,
        "lane_admission_prefill_ms": admission_ms,
        "lane_admission_prefill_p50_ms": float(np.median(admission_ms)),
        "tokens_per_s": tokens / run["lane_s"], "lane_s": run["lane_s"],
        "token_lane_s": morph_s,
        "decode_step_p50_ms": step_p50, "trunk_ms": trunk_ms, "k3_ms": k3_ms,
        "sampling_ms": sample_ms, "admission_prefill_ms": prefill_ms,
        "k3_share_of_decode_step": k3_ms / step_p50,
        "tie_margin_ulps": TIE_MARGIN_ULPS,
        "lane_head_checks": heads,
        "decode_step_profile": prof,
        "twin": {"layers": cfg2.layer_kinds(),
                          "decode_steps": run2["steps"],
                          "forward_worst_gap_ulps": float(gap2.max()),
                          "plain_reference": (
                              "a prefill and decode steps per prompt"
                              if cfg.moe is not None
                              else "forward" if prompt_len + gen
                              <= cfg.dense_attn_max_seq
                              else "prefill and decode"),
                          "routing": twin_routing,
                          "forward_flash_scan_calls": flash2.calls,
                          "forward_exact_argmax_share": float(exact2.mean())},
        "weights_init_s": init_s, "host_secret_and_staging_s": setup_s,
        "host_peak_rss_gb": host_gb,
        "host_peak_rss_since": "phase start" if host_reset else "process start",
        "host_rss_after_staging_gb": host_now_gb,
        "aug_heads_dtype": str(cfg.adtype).split(".")[-1],
        "aug_embeds_dtype": str(cfg.adtype).split(".")[-1],
        "stack_bytes": stack_bytes,
        "peak_mem_gb": peak_gb, "peak_limit_gb": PEAK_LIMIT_GB,
        "first_generation": final[0][:12].tolist(),
        "phase_s": time.monotonic() - t_phase,
    }
    if routing is not None:
        out["moe"] = dict(routing, moe_layers=moe_layers,
                          capacity_per_prefill=moe_capacity(prompt_len, cfg),
                          experts=cfg.moe.n_routed, top_k=cfg.moe.top_k)
    if flash_gate is not None:
        out["flash_vs_dense"] = flash_gate
    if live is not None:
        out["window_live"] = live
    if rwkv:
        out.update(
            k6_vs_recurrence=k6_gate, k6_ms_per_launch=k6_ms,
            k6_ms_per_prefill=k6_ms * cfg.n_layers,
            k6_share_of_admission_prefill=k6_ms * cfg.n_layers / prefill_ms,
            k6_eager_ms_per_launch=k6_eager_ms,
            k6_eager_ms_per_prefill=k6_eager_ms * cfg.n_layers,
            k6_eager_share_of_admission_prefill=(k6_eager_ms * cfg.n_layers
                                                 / prefill_ms),
        )
    emit(out)
    return out


def attention_layers(cfg) -> int:
    """The layers whose mixer is attention (global, local or MLA)."""
    from repro_torch.models import blocks as B

    return sum(B.mixer_of(k) in ("attn", "global", "local", "mla")
               for k in cfg.layer_kinds())


def window_live(cfg, params, prompts, dev) -> dict:
    """The window-live gate: the twin's last-position logits on the first
    two prompts, with its local layers in ``cfg.sliding_window`` and with
    the window taken away (``sliding_window=None``: every layer global),
    must differ by more than the tie margin (TIE_MARGIN_ULPS bf16 ulps of
    max|logit|); otherwise the prompts never reached past the window."""
    import dataclasses

    from repro_torch.models import blocks as B, stack as S

    def last_logits(c):
        toks = torch.from_numpy(prompts[:2]).long().to(dev)
        h = S.embed_tokens(params, toks, c)
        h, _ = S.apply_stack(params, h, c, B.RunState(mode="full"), None)
        return S.lm_head(params, h[:, -1:], c)[:, 0]

    with torch.no_grad():
        win = last_logits(cfg)
        glob = last_logits(dataclasses.replace(cfg, sliding_window=None))
    diff = float((win - glob).abs().max())
    margin = TIE_MARGIN_ULPS * bf16_ulp(float(win.abs().max()))
    check(diff > margin, f"window-live gate: the twin's logits with and "
                         f"without the window differ by {diff} <= {margin}")
    return {"window": cfg.sliding_window, "prompt_len": prompts.shape[1],
            "max_abs_diff": diff, "tie_margin": margin,
            "argmax_differs_share": float(
                (win.argmax(-1) != glob.argmax(-1)).float().mean())}


def flash_checks(dev) -> dict:
    """The port's flash scan (``models.layers.flash_attention``, plain torch
    ops) at one deepseek_7b layer of a 2048-token prompt, FLASH_SHAPE in
    bf16, against an fp32 dense attention of the same bf16 inputs on the
    card; gated: within twice the distance of bf16 dense attention from
    that fp32 result.  Times the flash scan, the dense attention and
    PyTorch's SDPA on its flash backend (a yardstick the port never calls)
    on the same inputs, back to back (``cuda_ms``)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.models import layers

    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    q, k, v = (torch.randn(FLASH_SHAPE, generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))    # (B, H, S, hd)

    def sdpa():
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

    with torch.no_grad():
        exact = layers.dense_attention(q.float(), k.float(), v.float())
        errs = {}
        for name, fn in (("flash", lambda: layers.flash_attention(q, k, v)),
                         ("dense", lambda: layers.dense_attention(q, k, v)),
                         ("sdpa", lambda: sdpa().transpose(1, 2))):
            got = fn()
            torch.cuda.synchronize()
            check(got.shape == q.shape and got.dtype == torch.bfloat16
                  and bool(torch.isfinite(got).all()),
                  f"{name} attention: {tuple(got.shape)} {got.dtype}")
            errs[name] = float((got.float() - exact).abs().max())
        scale = float(exact.abs().max())
        del exact, got
        check(0 < errs["dense"] and errs["flash"] <= 2 * errs["dense"],
              f"flash scan: |flash - fp32 dense| {errs['flash']} > 2 x "
              f"|bf16 dense - fp32 dense| {errs['dense']}")
        flash_fn = lambda: layers.flash_attention(q, k, v)  # noqa: E731
        dense_fn = lambda: layers.dense_attention(q, k, v)  # noqa: E731
        times = [cuda_ms(flash_fn, 5), cuda_ms(dense_fn, 5), cuda_ms(sdpa, 10),
                 cuda_ms(flash_fn, 5), cuda_ms(dense_fn, 5), cuda_ms(sdpa, 10)]
    B, S, H, hd = FLASH_SHAPE
    n_bytes = 4 * B * S * H * hd * 2        # q, k, v in and the output, bf16
    causal_flops = 2 * 2 * B * H * hd * S * (S + 1) / 2
    # The scan's block products: Q block i reads the KV blocks up to its
    # last position (the rest lie wholly in its future and are skipped).
    bq, bkv = min(512, S), min(1024, S)
    pairs = sum((i * bq + bq - 1) // bkv + 1 for i in range(S // bq))
    formed_flops = 2 * 2 * B * H * hd * bq * bkv * pairs
    b16, by16 = bound_ms(n_bytes, causal_flops, BF16_FLOP_PER_S)
    b32, by32 = bound_ms(n_bytes, formed_flops)
    return {"shape": list(FLASH_SHAPE), "dtype": "bfloat16",
            "block_q": bq, "block_kv": bkv, "block_pairs_formed": pairs,
            "block_pairs_all": (S // bq) * (S // bkv),
            "max_abs_fp32": scale,
            "flash_err_vs_fp32": errs["flash"],
            "dense_bf16_err_vs_fp32": errs["dense"],
            "sdpa_err_vs_fp32": errs["sdpa"], "limit": 2 * errs["dense"],
            "flash_ms": (times[0] + times[3]) / 2,
            "dense_ms": (times[1] + times[4]) / 2,
            "sdpa_flash_ms": (times[2] + times[5]) / 2, "runs_ms": times,
            "bound_ms_bf16": b16, "bound_by_bf16": by16,
            "bound_ms_fp32_products": b32, "bound_by_fp32_products": by32}


class StepTap:
    """Keeps the logits of every step of ``serve --mole off``'s plain path.

    While installed, ``repro_torch.launch.steps.make_prefill_step`` and
    ``make_decode_step`` (the names ``serve._serve_plain`` imports when it
    runs) return steps that record their last-position logits (fp32, on the
    card) and, for the prefill, the prompt tokens; each calls the real step
    once."""

    def __init__(self):
        from repro_torch.launch import steps

        self.steps, self.logits, self.prompts = steps, [], None
        self._prefill, self._decode = steps.make_prefill_step, steps.make_decode_step

    def _wrap_prefill(self, model):
        step = self._prefill(model)

        def prefill(params, batch, caches):
            logits, caches = step(params, batch, caches)
            self.prompts = batch["tokens"].cpu().numpy()
            self.logits.append(logits[:, 0].float().clone())
            return logits, caches
        return prefill

    def _wrap_decode(self, model):
        step = self._decode(model)

        def decode(params, token, t, caches):
            logits, caches = step(params, token, t, caches)
            self.logits.append(logits[:, 0].float().clone())
            return logits, caches
        return decode

    def __enter__(self):
        self.steps.make_prefill_step = self._wrap_prefill
        self.steps.make_decode_step = self._wrap_decode
        return self

    def __exit__(self, *exc):
        self.steps.make_prefill_step = self._prefill
        self.steps.make_decode_step = self._decode


def mole_off_path(dev, kernels, ctx) -> dict:
    """``serve --mode lm --mole off`` on the card with lm_long_prompt's
    weights and prompts (``run_lm``: no registry, no engine, one prefill of
    the 4 raw prompts, greedy decode).  Gated: all seven launch counters stay
    0; the prompts are lm_long_prompt's; every token is the argmax of the
    plain logits it came from; and the tokens equal lm_long_prompt's lane
    generations over each request's decided prefix: the positions before
    the first whose plain top-1/top-2 gap is within the tie margin
    (``TIE_MARGIN_ULPS`` bf16 ulps of the row's max|logit|), where the
    lane's fused heads and K3 may break a near-tie another way; what is
    left is counted as undecided, never gated."""
    from repro_torch.launch import serve

    args = serve.parse_args([
        "--mode", "lm", "--arch", LM_ARCH, "--requests", str(LONG_REQUESTS),
        "--prompt-len", str(LONG_PROMPT), "--gen", str(LONG_GEN),
        "--mole", "off", "--seed", str(SEED),
    ])
    torch.cuda.reset_peak_memory_stats()
    reset_launches(kernels)
    with torch.no_grad(), StepTap() as tap:
        t0 = time.monotonic()
        off = serve.run_lm(args, params=ctx["params"])
        off_s = time.monotonic() - t0
    launches = {n: getattr(kernels, n).launches for n in KERNEL_NAMES}
    check(not any(launches.values()), f"--mole off launched kernels: {launches}")
    lane = ctx["final"]
    check(tap.prompts is not None and np.array_equal(tap.prompts, ctx["prompts"]),
          "--mole off served other prompts than lm_long_prompt")
    check(off.shape == lane.shape == (LONG_REQUESTS, LONG_GEN),
          f"--mole off generations {off.shape}, lane {lane.shape}")
    check(len(tap.logits) == LONG_GEN, f"{len(tap.logits)} plain steps recorded")
    logits = torch.stack(tap.logits, dim=1)          # (requests, gen, V)
    top2 = torch.topk(logits, 2, dim=-1).values.cpu().numpy().astype(np.float64)
    top = logits.abs().amax(dim=-1).cpu().numpy()
    check(np.array_equal(logits.argmax(dim=-1).cpu().numpy(), off),
          "--mole off: a token is not the argmax of its plain logits")
    gaps = (top2[..., 0] - top2[..., 1]) / np.vectorize(bf16_ulp)(top)
    gated = undecided = equal_after = 0
    for r in range(LONG_REQUESTS):
        decided = gaps[r] > TIE_MARGIN_ULPS
        n = LONG_GEN if decided.all() else int(np.argmin(decided))
        check(np.array_equal(off[r, :n], lane[r, :n]),
              f"request {r}: --mole off {off[r, :n].tolist()} differs from "
              f"the lane's {lane[r, :n].tolist()} over its decided prefix")
        gated += n
        undecided += LONG_GEN - n
        equal_after += int((off[r, n:] == lane[r, n:]).sum())
    check(gated > 0, "no decided position: the comparison held nothing")
    tokens = LONG_REQUESTS * LONG_GEN
    out = {"phase": "mole_off", "arch": LM_ARCH, "requests": LONG_REQUESTS,
           "prompt_len": LONG_PROMPT, "gen": LONG_GEN, "launches": launches,
           "mole_off_s": off_s, "mole_off_tokens_per_s": tokens / off_s,
           "lane_tokens_per_s": ctx["tokens_per_s"],
           "lane_over_mole_off": ctx["tokens_per_s"] * off_s / tokens,
           "tie_margin_ulps": TIE_MARGIN_ULPS,
           "gap_ulps_min": float(gaps.min()),
           "gated_prefix_tokens": gated, "undecided_tokens": undecided,
           "equal_past_the_prefix": equal_after,
           "tokens_equal": int((off == lane).sum()), "tokens": tokens,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "first_generation_off": off[0].tolist(),
           "first_generation_lane": lane[0].tolist()}
    emit(out)
    return out


# -- phases 3 and 4 (3a and 3b below main_path) --------------------------------

def make_registry(core, geom, tenants: int, capacity: int, rng):
    reg = core.SessionRegistry(geom, kappa=1, capacity=capacity)
    fan_in = geom.alpha * geom.p * geom.p
    kernels = {}
    for i in range(tenants):
        k = rng.standard_normal(
            (geom.alpha, geom.beta, geom.p, geom.p)
        ).astype(np.float32) / np.float32(np.sqrt(fan_in))
        kernels[f"tenant-{i}"] = k
        reg.register(f"tenant-{i}", k, seed=int(rng.integers(2**31)))
    return reg, kernels


def per_request(reg, req, dev) -> np.ndarray:
    data = torch.from_numpy(req.payload).to(dev)
    return reg.session(req.tenant_id).deliver(data).cpu().numpy()


def main_path(dev, core, runtime, kernels) -> dict:
    rng = np.random.default_rng(SEED)
    geom = core.ConvGeometry(**MAIN_GEOM)
    t0 = time.monotonic()
    reg, dev_kernels = make_registry(core, geom, tenants=4, capacity=4, rng=rng)
    secrets_s = time.monotonic() - t0
    engine = runtime.MoLeDeliveryEngine(reg, dev)
    requests = [
        runtime.DeliveryRequest(
            f"tenant-{i % 4}",
            rng.standard_normal((1, geom.alpha, geom.m, geom.m)).astype(np.float32),
        )
        for i in range(256)
    ]
    # Warm-up: stages the secret stacks and each session's device copies.
    for q in requests:
        engine.submit(q)
    engine.flush()
    base = [per_request(reg, q, dev) for q in requests]
    engine.stats = runtime.EngineStats()

    rounds = 5
    reset_launches(kernels)
    t0 = time.monotonic()
    feats = []
    for _ in range(rounds):
        rids = [engine.submit(q) for q in requests]
        engine.flush()
        feats.append([engine.take(r) for r in rids])
    dt_engine = time.monotonic() - t0
    counts = {n: getattr(kernels, n).launches for n in KERNEL_NAMES}
    launches = {n: counts.pop(n) for n in ("grouped_block_diag_matmul",
                                           "grouped_aug_gemm")}
    n_mb = engine.stats.microbatches
    check(n_mb >= rounds, f"expected >= {rounds} microbatches, got {n_mb}")
    for name, n in launches.items():
        check(n == n_mb, f"{name} launched {n} times for {n_mb} microbatches")
    check(not any(counts.values()),
          f"the vision path launched other kernels: {counts}")

    t0 = time.monotonic()
    for q in requests:
        per_request(reg, q, dev)
    dt_per_request = time.monotonic() - t0

    # Check 1: engine vs per-request delivery, every round.
    ref_max = max(float(np.abs(b).max()) for b in base)
    err1 = max(
        float(np.abs(f - b).max()) for fs in feats for f, b in zip(fs, base)
    )
    check(all(f.shape == (1, geom.beta, geom.n, geom.n) for f in feats[-1]),
          "engine features have the wrong shape")
    check(all(np.isfinite(f).all() for f in feats[-1]), "non-finite features")
    check(err1 <= REL_TOL * ref_max,
          f"engine vs per-request: {err1} > {REL_TOL * ref_max}")
    # Check 2: eq. 5 — the delivered features are the plain convolution
    # under the tenant's secret channel permutation.
    err2, conv_max = 0.0, 0.0
    for tenant, k in dev_kernels.items():
        idx = [i for i, q in enumerate(requests) if q.tenant_id == tenant]
        data = torch.from_numpy(
            np.concatenate([requests[i].payload for i in idx])
        ).to(dev)
        conv = core.conv_reference(data, torch.from_numpy(k).to(dev), geom)
        perm = torch.from_numpy(reg.session(tenant).provider._perm).to(dev)
        want = conv[:, perm].cpu().numpy()
        got = np.concatenate([feats[-1][i] for i in idx])
        err2 = max(err2, float(np.abs(got - want).max()))
        conv_max = max(conv_max, float(np.abs(want).max()))
    check(err2 <= REL_TOL * conv_max, f"eq. 5: {err2} > {REL_TOL * conv_max}")

    n_images = rounds * len(requests)
    out = {
        "phase": "main_path", "geom": dict(MAIN_GEOM, kappa=1),
        "tenants": 4, "capacity": 4, "requests_per_round": len(requests),
        "rounds": rounds, "microbatches": n_mb,
        "bucket_shapes": sorted(engine.stats.bucket_shapes),
        "launches": launches,
        "images_per_s_engine": n_images / dt_engine,
        "images_per_s_per_request": len(requests) / dt_per_request,
        "device_phase_p50_ms": engine.stats.phase_quantile_ms("device", 0.5),
        "coalesce_phase_p50_ms": engine.stats.phase_quantile_ms("coalesce", 0.5),
        "publish_phase_p50_ms": engine.stats.phase_quantile_ms("publish", 0.5),
        "max_err_vs_per_request": err1, "max_abs_per_request": ref_max,
        "max_err_eq5": err2, "max_abs_conv": conv_max,
        "host_secret_build_s": secrets_s,
    }
    emit(out)
    return out, (reg, requests, base)


# -- phases 3a and 3b: the async and TCP front doors over main_path's tenants

def vision_launches(kernels, phase: str) -> dict:
    """K1/K2's launches since the last reset; fails unless both ran and no
    other kernel did."""
    counts = {n: getattr(kernels, n).launches for n in KERNEL_NAMES}
    launches = {n: counts.pop(n) for n in ("grouped_block_diag_matmul",
                                           "grouped_aug_gemm")}
    check(all(launches.values()), f"{phase}: K1/K2 not launched: {launches}")
    check(not any(counts.values()), f"{phase} launched other kernels: {counts}")
    return launches


def held_against(pairs, phase: str) -> float:
    """max|delivered - per-request| over ``pairs``, gated at REL_TOL x the
    per-request deliveries' max."""
    ref_max = max(float(np.abs(want).max()) for _, want in pairs)
    err = max(float(np.abs(np.asarray(got) - want).max()) for got, want in pairs)
    check(all(np.asarray(got).shape == want.shape for got, want in pairs),
          f"{phase}: delivered arrays have the wrong shape")
    check(err <= REL_TOL * ref_max,
          f"{phase}: delivered vs per-request {err} > {REL_TOL * ref_max}")
    return err


def submit_round(front, requests) -> tuple[list, list]:
    """Submit ``requests`` from ASYNC_THREADS threads (thread w takes every
    ASYNC_THREADS-th request from w); returns the futures in request order
    and each request's client-side latency, submit call to resolution."""
    futs = [None] * len(requests)
    lat_ms = [None] * len(requests)

    def worker(w):
        for i in range(w, len(requests), ASYNC_THREADS):
            t0 = time.monotonic()
            fut = front.submit(requests[i])
            fut.add_done_callback(lambda _f, i=i, t0=t0: lat_ms.__setitem__(
                i, (time.monotonic() - t0) * 1e3))
            futs[i] = fut

    threads = [threading.Thread(target=worker, args=(w,))
               for w in range(ASYNC_THREADS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    check(not any(th.is_alive() for th in threads), "submitters hung")
    return futs, lat_ms


def resolved_once(futs, phase: str) -> list:
    """Every future's result; fails unless each rid is distinct."""
    results = [f.result(timeout=300) for f in futs]
    rids = [r.request_id for r in results]
    check(len(set(rids)) == len(rids), f"{phase}: duplicated request ids")
    return results


def async_path(dev, core, runtime, kernels, ctx, sync_ips: float) -> dict:
    from repro_torch.checkpoint import CheckpointManager

    reg, requests, base = ctx
    engine = runtime.MoLeDeliveryEngine(reg, dev)
    front = runtime.AsyncDeliveryEngine(engine, max_delay_ms=ASYNC_DELAY_MS,
                                        admission="block")
    try:
        # Warm-up: stages this engine's secret stacks.
        resolved_once(submit_round(front, requests)[0], "async_path warm-up")
        engine.stats = runtime.EngineStats()
        reset_launches(kernels)
        lat_ms, pairs = [], []
        t0 = time.monotonic()
        for _ in range(ASYNC_ROUNDS):
            futs, lat = submit_round(front, requests)
            results = resolved_once(futs, "async_path")
            lat_ms.extend(lat)
            pairs.extend((r.payload, b) for r, b in zip(results, base))
        dt = time.monotonic() - t0
        err = held_against(pairs, "async_path")
        stats = engine.stats
        phases = {f"{p}_phase_p50_ms": stats.phase_quantile_ms(p, 0.5)
                  for p in ("coalesce", "device", "publish")}
        flushes, submit_stalls = stats.flushes, stats.submit_stalls
        submit_wait_p95 = stats.submit_wait_quantile_ms(0.95)

        # One round through an injected device-phase crash: the supervisor
        # replays the round, each rid resolves once, with the same results.
        engine.injector = runtime.FailureInjector(at_phases={"device"})
        results = resolved_once(submit_round(front, requests)[0],
                                "async_path injected crash")
        check(engine.injector.fired == {"device"} and front._restarts == 1,
              "async_path: the injected device failure did not fire once")
        check(front.pending() == 0 and not engine._results,
              "async_path: results stranded after recovery")
        err_crash = held_against(
            [(r.payload, b) for r, b in zip(results, base)], "async_path crash")
    finally:
        front.close()

    # A pending backlog persisted to a snapshot directory and restored into
    # a fresh front door over a fresh registry (the secrets come from disk).
    # The fresh front door has no snapshot_dir, so it writes nothing: the
    # save is timed alone (capture and write), and so is the restore (load,
    # restage, and delivery of the backlog).
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = CheckpointManager(tmp, async_save=False)
        writer = runtime.MoLeDeliveryEngine(reg, dev)
        backlog = requests[:SNAPSHOT_BACKLOG]
        rids = [writer.submit(q) for q in backlog]
        t0 = time.monotonic()
        writer.snapshot().save(ckpt, 1)
        save_s = time.monotonic() - t0
        fresh_reg = core.SessionRegistry(reg.geom, kappa=reg.kappa,
                                         capacity=reg.capacity)
        fresh = runtime.AsyncDeliveryEngine(
            runtime.MoLeDeliveryEngine(fresh_reg, dev),
            max_delay_ms=ASYNC_DELAY_MS)
        try:
            t0 = time.monotonic()
            futs = fresh.restore(runtime.EngineSnapshot.load(ckpt))
            check(sorted(futs) == rids, "restore: replayed rids differ")
            results = resolved_once([futs[r] for r in rids], "restore")
            restore_s = time.monotonic() - t0
            check(all(r.request_id == rid for r, rid in zip(results, rids)),
                  "restore: a future resolved to another rid")
            for rid in rids:
                try:
                    fresh.engine.take(rid)
                except KeyError:
                    continue
                raise SmokeFailure(f"restore: rid {rid} redeemable twice")
            err_restore = held_against(
                [(r.payload, b) for r, b in zip(results, base)], "restore")
        finally:
            fresh.close()
    launches = vision_launches(kernels, "async_path")

    n_images = ASYNC_ROUNDS * len(requests)
    out = {
        "phase": "async_path", "threads": ASYNC_THREADS,
        "requests_per_round": len(requests), "rounds": ASYNC_ROUNDS,
        "max_delay_ms": ASYNC_DELAY_MS, "admission": "block",
        "launches": launches, "flushes": flushes,
        "images_per_s_async": n_images / dt,
        "images_per_s_sync_main_path": sync_ips,
        "client_p50_ms": float(np.percentile(lat_ms, 50)),
        "client_p95_ms": float(np.percentile(lat_ms, 95)),
        **phases,
        "submit_stalls": submit_stalls,
        "submit_wait_p95_ms": submit_wait_p95,
        "max_err_vs_per_request": err,
        "max_err_after_injected_crash": err_crash,
        "restored_backlog": len(rids), "max_err_after_restore": err_restore,
        "snapshot_save_s": save_s, "snapshot_restore_s": restore_s,
    }
    emit(out)
    return out


def served_path(dev, runtime, kernels, ctx) -> dict:
    from repro_torch.launch.client import ClientFleet, FleetConfig
    from repro_torch.launch.server import DeliveryServer

    reg, requests, _ = ctx
    geom = reg.geom
    front = runtime.AsyncDeliveryEngine(
        runtime.MoLeDeliveryEngine(reg, dev), max_delay_ms=ASYNC_DELAY_MS,
        admission="reject")

    def serve(run: str, injector, **fleet_kw) -> dict:
        async def go():
            server = DeliveryServer(front, host="127.0.0.1", port=0,
                                    injector=injector)
            await server.start()
            try:
                fleet = ClientFleet(FleetConfig(
                    port=server.port, requests=SERVED_REQUESTS,
                    clients=SERVED_CLIENTS,
                    tenants=4, batch=1, channels=geom.alpha,
                    image_size=geom.m, seed=SEED + 3, fleet_id=run,
                    keep_payloads=True, **fleet_kw))
                t0 = time.monotonic()
                report = await fleet.run()
                return report, time.monotonic() - t0
            finally:
                lost.append(await server.drain_and_stop(timeout=60.0))

        lost = []
        stats = front.engine.stats
        before = (stats.shed_requests, stats.expired_requests,
                  stats.reconnects, stats.duplicate_hits)
        report, dt = asyncio.run(go())
        report.assert_exactly_once()
        check(lost == [0], f"served_path {run}: {lost} rids lost at drain")
        check(report.mismatched_dups == 0,
              f"served_path {run}: duplicates disagreed")
        counts = report.counts()
        check(counts == {"ok": SERVED_REQUESTS},
              f"served_path {run}: outcomes {counts}")
        err = held_against(
            [(report.payloads[rid], per_request(reg, req, dev))
             for rid, req in report.requests.items()], f"served_path {run}")
        after = (stats.shed_requests, stats.expired_requests,
                 stats.reconnects, stats.duplicate_hits)
        return {
            "requests": report.submitted, "counts": counts,
            "requests_per_s": report.submitted / dt,
            "p50_ms": report.quantile_ms(0.5), "p95_ms": report.quantile_ms(0.95),
            **dict(zip(("shed", "expired", "reconnects", "duplicate_hits"),
                       (a - b for a, b in zip(after, before)))),
            "retries": report.retries, "hedges": report.hedges,
            "conn_drops": report.conn_drops, "max_err_vs_per_request": err,
        }

    try:
        # Warm-up: stages this engine's secret stacks.
        for q in requests[:4]:
            front.deliver(q, timeout=300)
        reset_launches(kernels)
        clean = serve("clean", None, trace=f"burst:{SERVED_REQUESTS}@1")
        chaos_injector = runtime.FailureInjector(
            network_phases={"accept", "read", "write", "stall"},
            network_rate=SERVED_CHAOS_RATE, stall_ms=200.0, seed=SEED)
        # Hedge after 0.5 s, up to 24 sends in a 30 s budget: at this rate
        # about one send in two fails, so a rid that runs out of sends (a
        # client timeout, which fails the gate) is a 0.58**24 event, under
        # 1e-3 over the run's 256 rids.
        chaos = serve("chaos", chaos_injector, trace="uniform:1000",
                      attempt_timeout_ms=500.0, timeout_ms=30000.0,
                      max_attempts=24)
        chaos["network_hits"] = dict(chaos_injector.network_hits)
        check(chaos_injector.network_hits, "served_path: chaos never fired")
    finally:
        front.close()
    out = {"phase": "served_path", "host": "127.0.0.1",
           "clients": SERVED_CLIENTS,
           "max_delay_ms": ASYNC_DELAY_MS, "admission": "reject",
           "chaos_rate": SERVED_CHAOS_RATE,
           "launches": vision_launches(kernels, "served_path"),
           "clean": clean, "chaos": chaos}
    emit(out)
    return out


def _leaf_grads(step, params, opt, batch):
    """One train step, and the gradients ``adamw.apply`` received in it
    (whole tensors, copied)."""
    from repro_torch.optim import adamw

    seen = {}
    real = adamw.apply

    def capture(cfg, p, grads, state):
        seen.update({n: (g.full_tensor() if hasattr(g, "full_tensor") else g)
                     .detach().clone() for n, g in grads.items()})
        return real(cfg, p, grads, state)

    adamw.apply = capture
    try:
        out = step(params, opt, batch)
    finally:
        adamw.apply = real
    return out, seen


def sharded_path(dev, core, runtime, kernels, ctx) -> dict:
    """Phase 3c (module docstring): the sharded vision flush, compressed_psum,
    the sharded train step and expert-parallel MoE on a (1, 1) mesh."""
    import dataclasses
    import datetime
    import socket

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import mesh_context, single_device_mesh
    from repro_torch.launch.steps import (TrainHParams, make_train_step,
                                          shard_train_state)
    from repro_torch.models import Model, blocks as B
    from repro_torch.models.base import init_params, param_axes
    from repro_torch.optim import adamw
    from repro_torch.optim.compress import compressed_psum
    from repro_torch.sharding import rules as R
    from repro_torch.sharding import spmd

    t_phase = time.monotonic()
    reset_launches(kernels)
    torch.cuda.reset_peak_memory_stats()
    backend = "nccl" if dev.type == "cuda" else "gloo"
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=120))
    try:
        mesh = single_device_mesh(dev.type)
        out = {"phase": "sharded_path", "backend": backend,
               "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape))}

        # (a) the vision flush on main_path's registry, sharded and not
        reg, requests, _ = ctx

        def one_round(engine):
            rids = [engine.submit(q) for q in requests]
            engine.flush()
            return [engine.take(r) for r in rids]

        k12 = ("grouped_block_diag_matmul", "grouped_aug_gemm")
        plain_engine = runtime.MoLeDeliveryEngine(reg, dev)
        want = one_round(plain_engine)
        plain_launches = {n: getattr(kernels, n).launches for n in k12}
        plain_mb = plain_engine.stats.microbatches
        del plain_engine
        release()
        engine = runtime.MoLeDeliveryEngine(reg, dev)
        t0 = time.monotonic()
        with mesh_context(mesh):
            got = one_round(engine)
            flush_s = time.monotonic() - t0
            sharded_launches = {n: getattr(kernels, n).launches
                                - plain_launches[n] for n in k12}
            for q in requests:
                engine.submit(q)
            mb = engine.queue.coalesce(reg.slot_for, max_groups=reg.capacity)
            placed = engine._execute(mb.x, mb.group_tenant,
                                     engine._refresh_plan())
        check(isinstance(placed, DTensor), "sharded_path: _execute did not "
              "return a DTensor")
        placements = [str(p) for p in placed.placements]
        check(placements == ["S(0)", "R"],
              f"sharded_path: _execute placed {placements}")
        check(len(got) == len(want) and all(
            a.shape == b.shape and np.array_equal(a, b)
            for a, b in zip(got, want)),
            "sharded_path: sharded images differ from the unsharded engine's")
        check(plain_launches == dict.fromkeys(k12, plain_mb)
              and sharded_launches == plain_launches,
              f"sharded_path: K1/K2 launched {sharded_launches} sharded, "
              f"{plain_launches} unsharded, for {plain_mb} microbatches")
        out["vision"] = {
            "requests": len(requests), "microbatch": list(mb.x.shape),
            "microbatches": plain_mb, "launches": sharded_launches,
            "bit_equal": True, "execute_placements": placements,
            "sharded_flush_s": flush_s}
        del engine, placed, got, want, mb
        release()

        # (b) compressed_psum over "data"
        gen = torch.Generator(device=dev).manual_seed(SEED)
        x = torch.randn(PSUM_N, generator=gen, device=dev)
        wire = []
        real_gather = dist.all_gather

        def gather(tensors, t, group=None, **kw):
            wire.append(str(t.dtype))
            return real_gather(tensors, t, group=group, **kw)

        dist.all_gather = gather
        try:
            summed = compressed_psum(x, "data", mesh)
        finally:
            dist.all_gather = real_gather
        err = float((summed - x).abs().max())
        check(err < PSUM_ABS, f"compressed_psum: {err} >= {PSUM_ABS}")
        check(wire == ["torch.int8", "torch.float32"],
              f"compressed_psum: the wire carried {wire}")
        out["compressed_psum"] = {"n": PSUM_N, "max_abs_err": err,
                                  "limit": PSUM_ABS, "wire": wire}
        del x, summed

        # (c) the train step, sharded against unsharded
        tr = SHARDED_TRAIN
        cfg = dataclasses.replace(get_config(tr["arch"]),
                                  n_groups=tr["groups"], dtype="float32",
                                  param_dtype="float32")
        model = Model(cfg, dev)
        step = make_train_step(model, TrainHParams(microbatch=tr["micro"]))
        rng = np.random.default_rng(SEED)
        batch = {k: torch.as_tensor(
            rng.integers(0, cfg.vocab, (tr["global_batch"], tr["seq"])),
            dtype=torch.int32, device=dev) for k in ("tokens", "targets")}

        def timed(fn):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            res = fn()
            torch.cuda.synchronize()
            return res, (time.monotonic() - t0) * 1e3

        params = model.init(SEED)
        (ref_run, ref_g), ref_ms = timed(
            lambda: _leaf_grads(step, params, adamw.init_state(params), batch))
        ref_m = ref_run[2]
        del params, ref_run
        release()
        params = model.init(SEED)
        sp, so = shard_train_state(model, params, adamw.init_state(params),
                                   mesh)
        del params
        with mesh_context(mesh):
            ((sp, so, sh_m), sh_g), sh_ms = timed(
                lambda: _leaf_grads(step, sp, so, batch))
        leaf_rel = {n: float((sh_g[n] - g).abs().max()
                             / g.abs().max().clamp_min(1e-30))
                    for n, g in ref_g.items()}
        worst = max(leaf_rel, key=leaf_rel.get)
        loss = (float(ref_m["loss"]), float(sh_m["loss"]))
        norm = (float(ref_m["grad_norm"]), float(sh_m["grad_norm"]))
        loss_rel = abs(loss[1] - loss[0]) / abs(loss[0])
        norm_rel = abs(norm[1] - norm[0]) / norm[0]
        out["train"] = {
            "arch": tr["arch"], "layers": cfg.n_layers,
            "params": model.param_count(), "dtype": "float32",
            "batch": [tr["global_batch"], tr["seq"]],
            "microbatches": tr["micro"],
            "head_placements": [str(p) for p in
                                dict(adamw.named_leaves(sp))["head"].placements],
            "loss_unsharded": loss[0], "loss_sharded": loss[1],
            "loss_rel": loss_rel, "grad_norm_unsharded": norm[0],
            "grad_norm_sharded": norm[1], "grad_norm_rel": norm_rel,
            "worst_grad_leaf": worst, "worst_grad_rel": leaf_rel[worst],
            "limit_rel": SHARDED_REL,
            "step_ms_unsharded": ref_ms, "step_ms_sharded": sh_ms}
        check(np.isfinite(loss).all() and np.isfinite(norm).all(),
              f"sharded train step: non-finite {loss} {norm}")
        check(loss_rel <= SHARDED_REL and norm_rel <= SHARDED_REL,
              f"sharded train step: loss {loss}, grad norm {norm} beyond "
              f"{SHARDED_REL} relative")
        check(leaf_rel[worst] <= SHARDED_REL,
              f"sharded train step: gradient {worst} {leaf_rel[worst]} of "
              f"max|g| > {SHARDED_REL}")
        del sp, so, ref_g, sh_g, model, step, batch
        release()

        # (d) expert-parallel MoE against the dense form
        mo = SHARDED_MOE
        mcfg = dataclasses.replace(get_config(mo["arch"]), dtype="float32",
                                   param_dtype="float32")
        gen = torch.Generator(device=dev).manual_seed(SEED)
        p = init_params(B.schema_moe(mcfg), torch.float32, gen, dev)
        x = torch.randn((mo["batch"], mo["seq"], mcfg.d_model),
                        generator=gen, device=dev)
        # the weights placed by the rules and viewed as the train step
        # views an MoE FFN; x is this rank's own tokens (all of them)
        placed = R.shard_tree(R.param_rules(mesh, fsdp=True),
                              param_axes(B.schema_moe(mcfg)), p)
        with torch.no_grad():
            dense, dense_ms = timed(lambda: B.apply_moe(p, x, mcfg))
            view = spmd.in_use(spmd.Deferred(placed, mesh, True))
            y, moe_ms = timed(lambda: B.apply_moe(view, x, mcfg))
        moe_rel = float((y - dense).abs().max() / dense.abs().max())
        out["moe"] = {
            "arch": mo["arch"], "tokens": [mo["batch"], mo["seq"]],
            "d_model": mcfg.d_model, "experts": mcfg.moe.n_routed,
            "d_ff_expert": mcfg.moe.d_ff_expert, "shared": mcfg.moe.n_shared,
            "top_k": mcfg.moe.top_k,
            "capacity": B.moe_capacity(mo["batch"] * mo["seq"], mcfg),
            "compared_with": "dense apply_moe (one rank holds every token "
                             "and expert at the dense form's capacity)",
            "max_rel_err": moe_rel, "limit_rel": SHARDED_MOE_REL,
            "bit_equal": bool(torch.equal(y, dense)),
            "ms_dense": dense_ms, "ms_sharded": moe_ms}
        check(bool(torch.isfinite(y).all()), "sharded MoE: non-finite")
        check(moe_rel <= SHARDED_MOE_REL,
              f"sharded MoE: {moe_rel} of max > {SHARDED_MOE_REL}")
        del p, placed, view, x, y, dense
    finally:
        dist.destroy_process_group()
    counts = {n: getattr(kernels, n).launches for n in KERNEL_NAMES}
    want_counts = dict.fromkeys(KERNEL_NAMES, 0)
    want_counts.update({n: 2 * plain_mb + 1 for n in k12})
    check(counts == want_counts,
          f"sharded_path launched {counts}, expected {want_counts}")
    out["launches"] = counts
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    check(out["peak_gb"] <= PEAK_LIMIT_GB,
          f"sharded_path: peak {out['peak_gb']:.2f} GB > {PEAK_LIMIT_GB}")
    out["seconds"] = time.monotonic() - t_phase
    emit(out)
    return out


def churn(dev, core, runtime) -> None:
    rng = np.random.default_rng(SEED + 1)
    geom = core.ConvGeometry(**CHURN_GEOM)
    reg, _ = make_registry(core, geom, tenants=6, capacity=4, rng=rng)
    engine = runtime.MoLeDeliveryEngine(reg, dev)
    worst, cloned_rounds, n_mb = 0.0, 0, 0
    for r in range(3):
        order = [(i + 2 * r) % 6 for i in range(6)]
        reqs = [
            runtime.DeliveryRequest(
                f"tenant-{t}",
                rng.standard_normal((1 + (t + r) % 3, geom.alpha, geom.m, geom.m))
                .astype(np.float32),
            )
            for t in order for _ in range(2)
        ]
        rids = [engine.submit(q) for q in reqs]
        work = engine.begin_flush()
        check(work is not None and len(work.items) >= 2,
              "churn: expected several microbatches in one flush round")
        n_mb += len(work.items)
        # Eviction inside the round leaves earlier items on their own
        # (cloned) stacks.
        if len({id(item.plan) for item in work.items}) > 1:
            cloned_rounds += 1
        engine.execute_flush(work)
        engine.publish_flush(work)
        check(engine.begin_flush() is None, "churn: rows left after one round")
        for rid, q in zip(rids, reqs):
            want = per_request(reg, q, dev)
            got = engine.take(rid)
            err = float(np.abs(got - want).max())
            check(err <= REL_TOL * float(np.abs(want).max()),
                  f"churn round {r}: {q.tenant_id} differs by {err}")
            worst = max(worst, err)
    check(cloned_rounds == 3, f"copy-on-write ran in {cloned_rounds}/3 rounds")
    emit({"phase": "churn", "tenants": 6, "capacity": 4, "rounds": 3,
          "microbatches": n_mb, "rounds_with_copy_on_write": cloned_rounds,
          "evictions": reg.evictions, "max_err_vs_per_request": worst})


# -- phase 4a -----------------------------------------------------------------

def features_kernels(kernels, ref, x, cores, projs) -> dict:
    """K1 and K2 at the features lane's shapes, on the engine's own stacks
    and one microbatch of the patch streams (gidx = arange(G)): each held
    against its plain version at REL_TOL, K2 also against float64
    (``err_vs_fp64``); device time in CUDA graphs (``graph_ms``), the plain
    version's and torch.bmm's (over the stack, which is the gathered
    weights for this gidx) by CUDA events, and the bound of each."""
    G, B, F = x.shape
    q, N = cores.shape[-1], projs.shape[-1]
    ident = torch.arange(G, dtype=torch.int32, device=x.device)
    out = {}
    for name, run, plain, library, n_bytes, flops, tag in (
        ("k1", lambda: kernels.grouped_block_diag_matmul(x, ident, cores, 1),
         lambda: ref.block_diag_matmul_grouped_ref(x, ident, cores, 1),
         lambda: torch.bmm(x, cores), 4 * (2 * G * B * F + G * q * q + G),
         2 * G * B * F * q,
         f"x({G},{B},{F}) cores({G},{q},{q}) kappa=1 gidx=arange({G})"),
        ("k2", lambda: kernels.grouped_aug_gemm(x, ident, projs),
         lambda: ref.aug_gemm_grouped_ref(x, ident, projs),
         lambda: torch.bmm(x, projs), 4 * (G * B * F + G * F * N + G * B * N + G),
         2 * G * B * F * N,
         f"t({G},{B},{F}) projs({G},{F},{N}) gidx=arange({G})"),
    ):
        got, want = run(), plain()
        err = float((got - want).abs().max())
        lim = REL_TOL * float(want.abs().max())
        check(bool(torch.isfinite(got).all()), f"features {name}: non-finite")
        check(err <= lim, f"features {name}: |kernel - plain| {err} > {lim}")
        row = {"shape": tag, "max_abs_err": err, "limit": lim,
               "graph_ms": graph_ms(run, 5, 10),
               "plain_ms": cuda_ms(plain, 10),
               "library_ms": cuda_ms(library, 10)}
        if name == "k1":
            b, by = bound_ms(n_bytes, flops)
            row.update(bound_ms=b, bound_by=by)
        else:
            row.update(split_tf32_bound(n_bytes, flops))
            row["err_vs_fp64"] = err_vs_fp64("features k2", x, projs, got,
                                             library())
        out[name] = row
        del got, want
    return out


def features_path(dev, core, runtime, kernels, ref) -> dict:
    """The continuous LM lane at Llama-3.2-Vision-90B's frontend width
    through ``MoLeDeliveryEngine``: FEAT_TENANTS tenants, each with its own
    (d_in, d_out) W_in, FEAT_ROUNDS timed rounds of FEAT_REQUESTS patch
    streams after a warm round, through the default buckets (max_rows 64:
    one (FEAT_TENANTS, 64, 7680) microbatch holds 64 positions of each
    tenant)."""
    t_phase = time.monotonic()
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)

    def host_randn(*shape, scale=1.0):
        """Seeded normals drawn on the card in bulk, handed over as numpy."""
        return (torch.randn(shape, generator=gen, device=dev) * scale).cpu().numpy()

    # One (V, d_model) embedding shared by every tenant: register needs it,
    # no token request asks for it, so its AugE stack is never staged.
    t0 = time.monotonic()
    embedding = host_randn(FEAT_VOCAB, FEAT_D_OUT)
    w_ins = [host_randn(FEAT_D_IN, FEAT_D_OUT, scale=FEAT_D_IN ** -0.5)
             for _ in range(FEAT_TENANTS)]
    requests = [
        runtime.DeliveryRequest(f"tenant-{i % FEAT_TENANTS}",
                                host_randn(1, FEAT_POSITIONS, FEAT_D_IN),
                                lane="features")
        for i in range(FEAT_REQUESTS)
    ]
    inputs_s = time.monotonic() - t0
    # The peak covers registration, staging, the rounds and the checks, not
    # the generator that drew the inputs on the card.
    torch.cuda.reset_peak_memory_stats()
    reg = core.LMSessionRegistry(FEAT_VOCAB, FEAT_D_OUT, d_in=FEAT_D_IN,
                                 d_out=FEAT_D_OUT, kappa=1,
                                 capacity=FEAT_TENANTS)
    # The host secret build alone: an fp64 QR of d_in^2 and the fp32 fusion
    # M^-1 W_in per tenant.
    t0 = time.monotonic()
    for i, w in enumerate(w_ins):
        reg.register(f"tenant-{i}", embedding, w_in=w, seed=SEED + 50 + i)
    secrets_s = time.monotonic() - t0
    engine = runtime.MoLeDeliveryEngine(lm_registry=reg, device=dev)

    # Warm round: stages the (S, q, q) cores and (S, d_in, d_out) projections.
    t0 = time.monotonic()
    rids = [engine.submit(q) for q in requests]
    engine.flush()
    for rid in rids:
        engine.take(rid)
    warm_s = time.monotonic() - t0
    t0 = time.monotonic()
    base = [reg.session(q.tenant_id).deliver_features(
                torch.from_numpy(q.payload).to(dev)).cpu().numpy()
            for q in requests]
    per_request_s = time.monotonic() - t0
    engine.stats = runtime.EngineStats()
    reset_launches(kernels)
    round_s, outs = [], []
    for _ in range(FEAT_ROUNDS):
        t0 = time.monotonic()
        rids = [engine.submit(q) for q in requests]
        done = engine.flush()
        results = [engine.take_result(r) for r in rids]
        round_s.append(time.monotonic() - t0)
        check(len(set(rids)) == len(rids) and sorted(done) == sorted(rids),
              f"features_path: {len(done)} of {len(rids)} rids resolved")
        outs.append([r.payload for r in results])
        try:
            engine.take(rids[0])
        except KeyError:
            pass
        else:
            raise SmokeFailure("features_path: a rid redeemable twice")
    counts = {n: getattr(kernels, n).launches for n in KERNEL_NAMES}
    launches = {n: counts.pop(n) for n in ("grouped_block_diag_matmul",
                                           "grouped_aug_gemm")}
    stats = engine.stats
    n_mb = stats.microbatches
    check(n_mb > 0 and all(n == n_mb for n in launches.values()),
          f"features_path: {launches} launches for {n_mb} microbatches")
    check(not any(counts.values()),
          f"features_path launched other kernels: {counts}")
    check(not engine._results and not engine._done
          and engine.pending_rows == 0, "features_path: results left behind")

    shape = (1, FEAT_POSITIONS, FEAT_D_OUT)
    worst_rel = 0.0
    for got_round in outs:
        for got, want in zip(got_round, base):
            check(got.shape == shape and bool(np.isfinite(got).all()),
                  f"features_path: output {got.shape}, expected {shape}")
            rel = float(np.abs(got - want).max()) / float(np.abs(want).max())
            check(rel <= FEAT_REL_TOL,
                  f"features_path: engine vs per-request {rel} > {FEAT_REL_TOL}")
            worst_rel = max(worst_rel, rel)
    # Unfuse: every delivery against x @ W_in in float64 on the card.
    t0 = time.monotonic()
    unfuse_rel = 0.0
    for i, w in enumerate(w_ins):
        w = torch.from_numpy(w).to(dev).double()
        for j, q in enumerate(requests):
            if q.tenant_id != f"tenant-{i}":
                continue
            want = torch.matmul(torch.from_numpy(q.payload).to(dev).double(), w)
            scale = float(want.abs().max())
            for got_round in outs:
                got = torch.from_numpy(got_round[j]).to(dev).double()
                rel = float((got - want).abs().max()) / scale
                check(rel <= FEAT_UNFUSE_REL, f"features_path: |delivered - "
                      f"x W_in| {rel} > {FEAT_UNFUSE_REL} of the max")
                unfuse_rel = max(unfuse_rel, rel)
    del w, want, got
    checks_s = time.monotonic() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    plan = engine._lm_plan
    x = torch.from_numpy(np.concatenate(
        [q.payload[0, :64] for q in requests[:FEAT_TENANTS]])).to(dev).view(
            FEAT_TENANTS, 64, FEAT_D_IN)
    t0 = time.monotonic()
    kernel_rows = features_kernels(kernels, ref, x, plan.arrays["embed_cores"],
                                   plan.arrays["aug_projs"])
    kernels_s = time.monotonic() - t0
    positions = FEAT_REQUESTS * FEAT_POSITIONS
    out = {
        "phase": "features_path", "arch": FEAT_ARCH, "d_in": FEAT_D_IN,
        "d_out": FEAT_D_OUT, "vocab": FEAT_VOCAB, "kappa": 1, "q": FEAT_D_IN,
        "tenants": FEAT_TENANTS, "capacity": reg.capacity,
        "requests_per_round": FEAT_REQUESTS,
        "positions_per_request": FEAT_POSITIONS, "rounds": FEAT_ROUNDS,
        "microbatches": n_mb, "max_rows": engine.max_rows,
        "bucket_shapes": sorted(stats.bucket_shapes), "launches": launches,
        "positions_per_s_submit_to_take": [positions / t for t in round_s],
        "round_s": round_s,
        "coalesce_phase_p50_ms": stats.phase_quantile_ms("coalesce", 0.5),
        "device_phase_p50_ms": stats.phase_quantile_ms("device", 0.5),
        "publish_phase_p50_ms": stats.phase_quantile_ms("publish", 0.5),
        "max_rel_err_vs_per_request": worst_rel, "limit_rel": FEAT_REL_TOL,
        "unfuse_rel_err_vs_fp64": unfuse_rel,
        "unfuse_limit_rel": FEAT_UNFUSE_REL,
        "k1": kernel_rows["k1"], "k2": kernel_rows["k2"],
        "host_inputs_s": inputs_s, "host_secret_build_s": secrets_s,
        "warm_round_s": warm_s, "per_request_s": per_request_s,
        "unfuse_check_s": checks_s, "kernel_checks_s": kernels_s,
        "phase_s": time.monotonic() - t_phase, "peak_mem_gb": peak_gb,
    }
    emit(out)
    return out


# -- phase 7 ------------------------------------------------------------------

def k4_split_form(gemm, dev, M: int, q: int, x, core, got=None) -> dict:
    """An fp32 K4 row's split-TF32 readings at ``x (M, q) @ core (q, q)``:
    the bound of the split form (3 x flops of TF32, or the bytes) with the
    FFMA bound beside it, the split the rule took, and the kernel and
    ``torch.matmul`` against a float64 product (gated: ``err_vs_fp64``)."""
    from repro_torch.kernels import block_diag_matmul

    if got is None:
        got = block_diag_matmul(x, core, 1)
    return {**split_tf32_bound(4 * (2 * M * q + q * q), 2 * M * q * q),
            "splits": gemm.tf32_splits(1, M, q, q, gemm.sm_count(dev)),
            "err_vs_fp64": err_vs_fp64("block_diag_matmul", x.view(1, M, q),
                                       core[None], got.view(1, M, q),
                                       torch.matmul(x.view(M, q), core)[None])}


def k45_checks(dev, kernels, ref) -> dict:
    """K4 and K5 vs their plain versions in fp32 and bf16 at the VGG-16
    shapes, the benchmark shapes and ragged ones; returns their error and
    timing rows (fp32, the developer path's type)."""
    from repro_torch.kernels import gemm
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    checks = []
    rows = {"block_diag_matmul": {"max_abs_err": 0.0},
            "aug_gemm": {"max_abs_err": 0.0}}
    dtypes = (torch.float32, torch.bfloat16)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def hold(name, tag, dtype, got, want):
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        scale = float(want.float().abs().max())
        lim = REL_TOL * scale if dtype == torch.float32 else 2 * bf16_ulp(scale)
        dt = str(dtype).split(".")[-1]
        checks.append({"kernel": name, "case": f"{tag}/{dt}",
                       "max_abs_err": err, "limit": lim})
        check(got.shape == want.shape and got.dtype == want.dtype,
              f"{name} {tag}/{dt}: got {tuple(got.shape)} {got.dtype}")
        check(bool(torch.isfinite(got).all()), f"{name} {tag}/{dt}: non-finite")
        check(err <= lim, f"{name} {tag}/{dt}: |kernel - plain| {err} > {lim}")
        if dtype == torch.float32:
            rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], err)

    def timed(dtype, run_kernel, run_plain, run_library, n_bytes, flops, iters):
        times = [cuda_ms(run_kernel, iters), cuda_ms(run_plain, iters),
                 cuda_ms(run_kernel, iters), cuda_ms(run_plain, iters),
                 cuda_ms(run_library, iters)]
        rate = FP32_FLOP_PER_S if dtype == torch.float32 else BF16_FLOP_PER_S
        b, by = bound_ms(n_bytes, flops, rate)
        return {"ms": (times[0] + times[2]) / 2,
                "plain_ms": (times[1] + times[3]) / 2, "library_ms": times[4],
                "bound_ms": b, "bound_by": by, "runs_ms": times}

    # K4: single-tenant morphs, then the per-group form.
    for R, kappa, q in K4_SHAPES:
        x32, core32 = randn(R, kappa * q), randn(q, q, scale=q ** -0.5)
        for dtype in dtypes:
            x, core = x32.to(dtype), core32.to(dtype)
            hold("block_diag_matmul", f"R{R}_kappa{kappa}_q{q}", dtype,
                 kernels.morph_rows(x, core, kappa),
                 ref.block_diag_matmul_ref(x, core, kappa))
            if (R, kappa, q) == K4_SHAPES[0]:
                sz = 4 if dtype == torch.float32 else 2
                # The library call: one cuBLAS product of the (R*kappa, q)
                # view in the operand dtype.
                xv = x.view(R * kappa, q)
                row = timed(
                    dtype,
                    lambda: kernels.block_diag_matmul(x, core, kappa),
                    lambda: ref.block_diag_matmul_ref(x, core, kappa),
                    lambda: torch.matmul(xv, core),
                    sz * (2 * R * kappa * q + q * q), 2 * R * kappa * q * q, 20)
                row["timed_shape"] = f"x({R},{kappa * q}) core({q},{q}) kappa={kappa}"
                first = kernels.block_diag_matmul(x, core, kappa)
                second = kernels.block_diag_matmul(x, core, kappa)
                check(same_bits(first, second),
                      f"block_diag_matmul {dtype}: two calls on the same inputs differ")
                row["deterministic"] = True
                del first, second
                row["route"] = gemm.morph_route(dtype, 1, R * kappa, q, q)
                if dtype == torch.float32:
                    row["plain_is"] = "one torch.matmul (fp32, TF32 off)"
                    row.update(k4_split_form(gemm, dev, R * kappa, q, xv, core))
                    rows["block_diag_matmul"].update(row)
                else:
                    row["splits"] = gemm.morph_splits(1, R * kappa, q, q,
                                                      gemm.sm_count(dev))
                    rows["block_diag_matmul"]["bf16"] = row
    G, Bg, F = K4_BATCHED
    x32, cores32 = randn(G, Bg, F), randn(G, F, F, scale=F ** -0.5)
    for dtype in dtypes:
        x, cores = x32.to(dtype), cores32.to(dtype)
        hold("block_diag_matmul", f"batched_G{G}_B{Bg}_F{F}", dtype,
             kernels.morph_rows_batched(x, cores, 1),
             ref.block_diag_matmul_batched_ref(x, cores, 1))
    del x32, cores32, x, cores
    # K4 at the providers' morphs of vlm_train (patches) and whisper_train
    # (frames), fp32 (the stage morphs the fp32 stream): against its plain
    # version, a float64 product and torch.matmul; not counted (the train
    # phases count their launches).
    for tag, (R, kappa, q), iters in (("vlm_provider", K4_VLM, 5),
                                      ("whisper_provider", K4_WHISPER, 20)):
        x, core = randn(R, kappa * q), randn(q, q, scale=q ** -0.5)
        got = kernels.morph_rows(x, core, kappa)
        hold("block_diag_matmul", f"{tag}_R{R}_q{q}", torch.float32, got,
             ref.block_diag_matmul_ref(x, core, kappa))
        row = timed(torch.float32,
                    lambda: kernels.block_diag_matmul(x, core, kappa),
                    lambda: ref.block_diag_matmul_ref(x, core, kappa),
                    lambda: torch.matmul(x, core),
                    4 * (2 * R * kappa * q + q * q), 2 * R * kappa * q * q,
                    iters)
        check(same_bits(got, kernels.block_diag_matmul(x, core, kappa)),
              f"block_diag_matmul at the {tag} shape: two calls differ")
        row.update(
            timed_shape=f"x({R},{kappa * q}) core({q},{q}) kappa={kappa}",
            deterministic=True, route=gemm.morph_route(x.dtype, 1, R * kappa, q, q),
            max_abs_err=float((got - ref.block_diag_matmul_ref(
                x, core, kappa)).abs().max()),
            **k4_split_form(gemm, dev, R * kappa, q, x, core, got))
        rows["block_diag_matmul"][tag] = row
        del x, core, got
        torch.cuda.empty_cache()

    # K5: single-tenant at the developer path's shape, per-group, ragged.
    B, K, N = K5_MAIN
    t32, c32 = randn(B, K), randn(K, N, scale=K ** -0.5)
    library_fp32_is_full()
    for dtype in dtypes:
        t, c = t32.to(dtype), c32.to(dtype)
        hold("aug_gemm", f"B{B}_K{K}_N{N}", dtype,
             kernels.aug_conv_forward(t, c), ref.aug_gemm_ref(t, c))
        sz = 4 if dtype == torch.float32 else 2
        n_bytes, flops = sz * (B * K + K * N + B * N), 2 * B * K * N
        row = timed(dtype,
                    lambda: kernels.aug_gemm(t, c),
                    lambda: ref.aug_gemm_ref(t, c),
                    lambda: torch.matmul(t, c),
                    n_bytes, flops, 10)
        row["timed_shape"] = f"t({B},{K}) c_ac({K},{N})"
        first = kernels.aug_gemm(t, c)
        second = kernels.aug_gemm(t, c)
        check(same_bits(first, second),
              f"aug_gemm {dtype}: two calls on the same inputs differ")
        row["deterministic"] = True
        if dtype == torch.float32:
            row.update(split_tf32_bound(n_bytes, flops))
            row["err_vs_fp64"] = err_vs_fp64(
                "aug_gemm", t[None], c[None], first[None],
                torch.matmul(t, c)[None])
        del first, second
        row["on_morph_kernel"] = morph_probe(
            gemm, "aug_gemm", lambda: kernels.aug_gemm(t, c), t[None], None,
            c[None], 10)
        if dtype == torch.float32:
            row["plain_is"] = "one torch.matmul (fp32, TF32 off)"
            rows["aug_gemm"].update(row)
        else:
            rows["aug_gemm"]["bf16"] = row
    del t32, c32, t, c
    torch.cuda.empty_cache()
    G, Bg, K, N = K5_BATCHED
    t32, c32 = randn(G, Bg, K), randn(G, K, N, scale=K ** -0.5)
    for dtype in dtypes:
        t, c = t32.to(dtype), c32.to(dtype)
        hold("aug_gemm", f"batched_G{G}_B{Bg}_K{K}_N{N}", dtype,
             kernels.aug_conv_forward_batched(t, c), ref.aug_gemm_batched_ref(t, c))
        del t, c
    del t32, c32
    torch.cuda.empty_cache()
    B, K, N = K5_RAGGED
    t32, c32 = randn(B, K), randn(K, N, scale=K ** -0.5)
    for dtype in dtypes:
        t, c = t32.to(dtype), c32.to(dtype)
        hold("aug_gemm", f"ragged_B{B}_K{K}_N{N}", dtype,
             kernels.aug_conv_forward(t, c), ref.aug_gemm_ref(t, c))
    emit({"phase": "kernels_k45", "checks": len(checks),
          "worst": max(checks, key=lambda c: c["max_abs_err"] / c["limit"]),
          "rows": rows})
    return rows


# -- phase 8 ------------------------------------------------------------------

def absorbed(params: dict, perm: torch.Tensor) -> dict:
    """The parameter set Aug-VGG needs to compute plain VGG: conv-0's output
    channels (its bias) and conv-1's input channels permuted by the secret
    channel permutation (tests/test_vgg.py)."""
    out = {"convs": [dict(c) for c in params["convs"]], "head": params["head"]}
    out["convs"][0]["b"] = params["convs"][0]["b"][perm]
    out["convs"][1] = {"w": params["convs"][1]["w"][:, perm],
                       "b": params["convs"][1]["b"]}
    return out


def sgd_losses(model, batches, aug_matrix=None) -> list[float]:
    """Loss of each of ``VGG_STEPS`` SGD steps on ``batches[:VGG_STEPS]``
    (before its update), then the loss on the next batch after them."""
    import torch.nn.functional as F

    opt = torch.optim.SGD(model.parameters(), lr=VGG_LR)
    losses = []
    for xb, yb in batches[:VGG_STEPS]:
        opt.zero_grad()
        loss = F.cross_entropy(model(xb, aug_matrix), yb)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    xb, yb = batches[VGG_STEPS]
    with torch.no_grad():
        losses.append(float(F.cross_entropy(model(xb, aug_matrix), yb)))
    return losses


def vgg_path(dev, core, kernels) -> dict:
    """The paper's developer path at VGG-16/CIFAR width: provider morph (K4),
    Aug-VGG-16 inference and training (K5), gated against plain VGG-16 on
    the raw images; the measured compute overhead."""
    from repro_torch.models import cnn

    cfg = cnn.vgg16()
    geom = cfg.first_geom
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    params = cnn.init(cfg, gen, dev)
    x = torch.randn((VGG_BATCH, geom.alpha, geom.m, geom.m), generator=gen,
                    device=dev)
    labels = torch.randint(0, cfg.classes, (VGG_BATCH,), generator=gen,
                           device=dev)
    # Provider: secrets from a numpy seed, C^{ac} from the developer's own
    # first-layer kernels (host float64 fusion, built once).
    t0 = time.monotonic()
    prov = core.DataProvider(geom, kappa=1, seed=SEED)
    kern = cnn.first_layer_kernels(params, cfg)
    aug = prov.build_aug_conv(kern.cpu().numpy())
    secrets_s = time.monotonic() - t0
    core_t = torch.from_numpy(prov._core.matrix).to(dev)
    mat = torch.from_numpy(aug.matrix).to(dev)          # what the developer gets
    perm = torch.from_numpy(aug.channel_perm).to(dev)
    p_aug = absorbed(params, perm)
    plain_model, aug_model = cnn.VGG(params, cfg), cnn.VGG(p_aug, cfg)
    # The Aug model's first layer is the fixed C^{ac}; the plain model's
    # first conv is frozen with it, so both train the same function.
    plain_model.convs[0]["w"].requires_grad_(False)

    # -- the main path: the provider morphs, the developer infers and trains
    names = KERNEL_NAMES
    for name in names:
        setattr(getattr(kernels, name), "launches", 0)
    with torch.no_grad():
        rows = kernels.morph_rows(core.unroll_batch(x), core_t, 1)
        aug_logits = cnn.apply(p_aug, rows, cfg, aug_matrix=mat)
        feats = kernels.aug_conv_forward(rows, mat)
    step = VGG_STEP_BATCH
    batches = [(rows[i : i + step], labels[i : i + step])
               for i in range(0, VGG_BATCH, step)]
    aug_losses = sgd_losses(aug_model, batches, mat)
    torch.cuda.synchronize()
    launches = {n: getattr(kernels, n).launches for n in names}
    k5_calls = 2 + VGG_STEPS + 1
    check(launches["block_diag_matmul"] == 1,
          f"gate 5: K4 launched {launches['block_diag_matmul']} times for 1 call")
    check(launches["aug_gemm"] == k5_calls,
          f"gate 5: K5 launched {launches['aug_gemm']} times for {k5_calls} calls")
    check(all(c == 0 for n, c in launches.items()
              if n not in ("block_diag_matmul", "aug_gemm")),
          f"gate 5: the developer path launched another kernel: {launches}")

    # Plain VGG-16 on the raw images (cuDNN, TF32 off), no kernel of ours.
    with torch.no_grad():
        plain_logits = cnn.apply(params, x, cfg)
        want_rows = prov.morph_batch(x)
        conv = core.conv_reference(x, kern, geom)[:, perm]
    plain_losses = sgd_losses(plain_model, [(x[i : i + step], labels[i : i + step])
                                            for i in range(0, VGG_BATCH, step)])
    # Gate 1: K4 against the provider's plain morph.
    err1 = float((rows - want_rows).abs().max())
    lim1 = REL_TOL * float(want_rows.abs().max())
    check(rows.shape == (VGG_BATCH, geom.in_features), f"rows {tuple(rows.shape)}")
    check(err1 <= lim1, f"gate 1: |K4 - morph_batch| {err1} > {lim1}")
    # Gate 2: eq. 5 on the first layer.
    feats = core.reroll_batch(feats, geom.beta, geom.n)
    err2 = float((feats - conv).abs().max())
    lim2 = REL_TOL * float(conv.abs().max())
    check(err2 <= lim2, f"gate 2: |K5 features - conv[:, perm]| {err2} > {lim2}")
    # Gate 3: the whole network.
    check(aug_logits.shape == plain_logits.shape == (VGG_BATCH, cfg.classes),
          f"logits {tuple(aug_logits.shape)}")
    check(bool(torch.isfinite(aug_logits).all()), "non-finite Aug-VGG logits")
    err3 = float((aug_logits - plain_logits).abs().max())
    lim3 = VGG_LOGIT_TOL * float(plain_logits.abs().max())
    check(err3 <= lim3, f"gate 3: |Aug-VGG - VGG logits| {err3} > {lim3}")
    top2 = plain_logits.topk(2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > 2 * lim3
    same = aug_logits.argmax(-1) == plain_logits.argmax(-1)
    check(bool(same[decided].all()),
          f"gate 3: argmax differs on {int((~same & decided).sum())} images "
          f"with a top-2 gap above {2 * lim3}")
    # Gate 4: training parity.
    rel4 = max(abs(a - p) / abs(p) for a, p in zip(aug_losses, plain_losses))
    check(rel4 <= VGG_LOSS_RTOL,
          f"gate 4: losses {aug_losses} vs {plain_losses} (rel {rel4})")
    del feats, conv, want_rows, plain_model, aug_model
    torch.cuda.empty_cache()

    # -- where the time goes (CUDA events, batch 256, after the gates) ------
    from repro_torch.core import overhead

    xr = core.unroll_batch(x)
    w0, b0 = params["convs"][0]["w"], params["convs"][0]["b"]
    with torch.no_grad():
        plain_ms = cuda_times(lambda: cnn.apply(params, x, cfg), 20)
        aug_ms = cuda_times(lambda: cnn.apply(p_aug, rows, cfg, aug_matrix=mat), 20)
        k4_ms = cuda_times(lambda: kernels.morph_rows(xr, core_t, 1), 20)
        k5_ms = cuda_times(lambda: kernels.aug_conv_forward(rows, mat), 20)
        k5_lib_ms = cuda_times(lambda: torch.matmul(rows, mat), 20)
        conv0_ms = cuda_times(
            lambda: torch.nn.functional.conv2d(x, w0, b0, padding=1), 20)
    plain_p50, aug_p50 = float(np.median(plain_ms)), float(np.median(aug_ms))
    k5_p50, k5_lib_p50 = float(np.median(k5_ms)), float(np.median(k5_lib_ms))
    derived = overhead.analyze(
        alpha=geom.alpha, beta=geom.beta, m=geom.m, n=geom.n, p=geom.p,
        kappa=1, network_macs=overhead.vgg16_cifar_macs(),
        dataset_images=60_000,
    )
    out = {
        "phase": "vgg_path", "convs": len(cfg.conv_shapes()),
        "widths": [co for _, co in cfg.conv_shapes()],
        "image": [geom.alpha, geom.m, geom.m], "classes": cfg.classes,
        "batch": VGG_BATCH, "kappa": 1, "c_ac_mb": mat.numel() * 4 / 1e6,
        "launches": {"block_diag_matmul": launches["block_diag_matmul"],
                     "aug_gemm": launches["aug_gemm"]},
        "gate1_err": err1, "gate1_limit": lim1,
        "gate2_err": err2, "gate2_limit": lim2,
        "gate3_err": err3, "gate3_limit": lim3,
        "gate3_decided_images": int(decided.sum()),
        "gate3_argmax_agree_all": float(same.float().mean()),
        "gate4_losses_aug": aug_losses, "gate4_losses_plain": plain_losses,
        "gate4_max_rel": rel4,
        "plain_forward_p50_ms": plain_p50, "aug_forward_p50_ms": aug_p50,
        "k4_per_batch_p50_ms": float(np.median(k4_ms)),
        "k5_per_batch_p50_ms": k5_p50,
        "k5_library_fp32_p50_ms": k5_lib_p50,
        "plain_first_conv_p50_ms": float(np.median(conv0_ms)),
        "measured_overhead": aug_p50 / plain_p50 - 1,
        # the same forward with fp32 torch.matmul's time in K5's place
        "overhead_at_library_k5": (aug_p50 - k5_p50 + k5_lib_p50) / plain_p50 - 1,
        "derived_overhead_eq17": derived.compute_overhead_ratio,
        "paper_overhead": PAPER_OVERHEAD,
        "extra_macs_per_image": derived.aug_extra_macs_per_sample,
        "network_macs_per_image": derived.network_macs_per_sample,
        "host_secret_build_s": secrets_s,
    }
    emit(out)
    return out

# -- phase 12 -------------------------------------------------------------------

def train_path(dev, kernels, *, phase: str = "train_path",
               arch: str = TRAIN_ARCH, groups: int = TRAIN_LAYERS,
               seq: int = TRAIN_SEQ, global_batch: int = TRAIN_BATCH,
               micro: int = TRAIN_MICRO,
               peak_limit_gb: float | None = None) -> dict:
    """The train step of ``launch/steps.py`` at ``arch``'s published width
    (deepseek_7b by default), ``groups`` scanned groups, ``global_batch``
    sequences of ``seq`` in ``micro`` microbatches, on ``Pipeline``'s
    morphed stream (``--mole token``); gates 1-4 of the module docstring
    (the twins of gate 3 are 2 layers: one group of a 2-kind pattern);
    step time, tokens/s, MFU, the peak (held at ``peak_limit_gb`` where
    given) and a profiled step.  An RWKV-6 stack's gate 2 counts K6 and
    the key-row scan exactly (``scan_launches``)."""
    import dataclasses

    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.core.deploy import fuse_lm_params
    from repro_torch.data import DataConfig, Pipeline, ProviderStage
    from repro_torch.launch.steps import (
        TrainHParams, make_batched_decode_logits, make_row_prefill_step,
        make_train_step,
    )
    from repro_torch.models import (
        Model, ParamTree, blocks as B, layers as L, stack as S,
    )
    from repro_torch.models.base import MoLeCfg
    from repro_torch.optim import adamw

    t_phase = time.monotonic()
    cfg = dataclasses.replace(get_config(arch), n_groups=groups,
                              mole=MoLeCfg(enabled=True, mode="token",
                                           seed=SEED))
    hp = TrainHParams(optimizer=adamw.AdamWConfig(warmup_steps=TRAIN_WARMUP),
                      microbatch=micro, remat=True)
    data = DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=global_batch,
                      seed=SEED)

    def on_card(batch):
        return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}

    torch.cuda.reset_peak_memory_stats()
    reset_launches(kernels)
    model = Model(cfg, dev)
    n_params = model.param_count()
    params = model.init(SEED)
    opt = adamw.init_state(params)
    step = make_train_step(model, hp)
    pipe = Pipeline(data, model_cfg=cfg)
    metrics, step_ms = [], []
    for _ in range(TRAIN_WARMUP + TRAIN_TIMED):
        batch = on_card(next(pipe))
        torch.cuda.synchronize()
        t0 = time.monotonic()
        params, opt, m = step(params, opt, batch)
        torch.cuda.synchronize()
        step_ms.append((time.monotonic() - t0) * 1e3)
        metrics.append(m)
    p50 = float(np.median(step_ms[TRAIN_WARMUP:]))

    def profiled():
        nonlocal params, opt
        params, opt, m = step(params, opt, batch)
        metrics.append(m)

    prof = step_profile(profiled, p50, track=(
        ("wkv6_columns", "wkv6_chunks", "wkv6_rows") if cfg.rwkv is not None else ()))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if peak_limit_gb is not None:
        check(peak_gb <= peak_limit_gb,
              f"peak device memory {peak_gb:.2f} GB > {peak_limit_gb} GB")
    # Gate 2 over the main run: exactly the scan's launches an RWKV-6 stack
    # makes, no kernel otherwise.
    launches = {n: getattr(kernels, n).launches for n in KERNEL_NAMES}
    want_launches = dict.fromkeys(KERNEL_NAMES, 0)
    want_launches.update(scan_launches(cfg, micro, len(metrics)))
    check(launches == want_launches,
          f"gate 2: {phase} launched {launches}, expected {want_launches}")
    # Gate 1: finite loss and grad_norm at every step; count = steps run.
    losses = [float(m["loss"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    check(all(np.isfinite(losses)) and all(np.isfinite(norms)),
          f"gate 1: non-finite loss {losses} or grad_norm {norms}")
    check(int(opt["count"]) == len(metrics),
          f"gate 1: opt count {int(opt['count'])} after {len(metrics)} steps")
    del params, opt, step, model, batch, metrics
    release()

    # Gate 3: the raw params on the raw stream against the fused params on
    # the morphed stream, from one init, on a 2-layer twin at full width
    # (both runs do not fit beside each other at TRAIN_LAYERS), in fp32 and
    # in bf16.
    fixed = len(cfg.prefix_pattern) + len(cfg.suffix_pattern)
    twin_groups = max(1, (TRAIN_TWIN_LAYERS - fixed) // len(cfg.block_pattern))

    def twin_losses(dtype):
        twin = dataclasses.replace(cfg, n_groups=twin_groups,
                                   dtype=dtype, param_dtype=dtype)
        model = Model(twin, dev)
        raw_cfg = dataclasses.replace(twin, mole=MoLeCfg())

        def run(params, model_cfg, microbatch):
            step = make_train_step(model, dataclasses.replace(
                hp, microbatch=microbatch))
            stream = Pipeline(data, model_cfg=model_cfg)
            opt, out = adamw.init_state(params), []
            for _ in range(TRAIN_TWIN_STEPS):
                params, opt, m = step(params, opt, on_card(next(stream)))
                out.append(float(m["loss"]))
            return params, out

        _, raw = run(model.init(SEED), raw_cfg, micro)
        release()
        fused = ParamTree(fuse_lm_params(
            model.init(SEED), twin,
            token_morpher=ProviderStage.for_model(twin).token_morpher))
        fused, morphed = run(fused, twin, micro)
        out = {"raw": raw, "fused": morphed,
               "fused_rel": [abs(a - b) / abs(a) for a, b in zip(raw, morphed)],
               "gated_steps": TRAIN_GATED_STEPS[dtype]}
        check(max(out["fused_rel"][:out["gated_steps"]]) <= TRAIN_LOSS_RTOL,
              f"gate 3: {dtype} twin, raw against fused losses {out}")
        return model, fused, out

    _, fused, twin_fp32 = twin_losses("float32")
    del fused
    release()
    twin_model, fused, twin_bf16 = twin_losses(cfg.dtype)
    # Gate 2 over the twins: no kernel but the scan's.
    others = {n: getattr(kernels, n).launches for n in KERNEL_NAMES
              if n not in scan_launches(cfg, 1, 1)}
    check(not any(others.values()), f"gate 2: {phase}'s twins launched {others}")

    # Gate 4: the trained tree serves without recording a graph: the decode
    # lane's admission prefill and batched decode step on it (K3 runs here,
    # after the counters were read).
    check(not any(p.requires_grad for p in fused.parameters()),
          "gate 4: a leaf still requires grad after training")
    prompt = torch.from_numpy(
        next(Pipeline(data, model_cfg=twin_model.cfg))["tokens"][:1, :32]).to(dev)
    caches = twin_model.init_cache(1, 40)
    embed = fused["embed"]
    head = S.head_matrix(fused, twin_model.cfg).contiguous()   # K3's layout
    first, caches = make_row_prefill_step(twin_model)(fused, embed, head,
                                                      prompt, caches)
    logits, caches = make_batched_decode_logits(twin_model)(
        fused, embed[None], head[None], torch.zeros(1, dtype=torch.int32,
                                                    device=dev),
        first, torch.full((1,), 32, device=dev), caches)
    outs = [first, logits] + [x for c in caches["blocks"] for x in c.values()]
    check(all(o.grad_fn is None and not o.requires_grad for o in outs),
          "gate 4: a serving output after training carries a graph")
    check(bool(torch.isfinite(logits).all()), "gate 4: non-finite logits")
    del fused, caches, logits, outs
    release()

    # Not gated: the flash scan at one layer's shape of the step (GQA's
    # K/V heads, and in the window for local layers), forward and forward +
    # backward, beside SDPA's (a yardstick the port never calls; without a
    # window); a step runs micro x layers x (forward + forward and backward:
    # remat runs each block's forward twice).
    gen = torch.Generator(device=dev).manual_seed(SEED)
    B_, H, Hkv, hd = global_batch // micro, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kinds = cfg.layer_kinds()
    attn_kinds = [k for k in kinds if B.mixer_of(k) not in ("rec", "rwkv")]
    qkv = [torch.randn(B_, seq, h_, hd, generator=gen, device=dev)
           .to(cfg.adtype).requires_grad_() for h_ in (H, Hkv, Hkv)]
    go = torch.randn(B_, seq, H, hd, generator=gen, device=dev).to(cfg.adtype)

    def flash(backward, window):
        with torch.enable_grad():
            o = L.flash_attention(*qkv, window=window,
                                  block_kv=cfg.flash_block_kv,
                                  logit_cap=cfg.attn_softcap,
                                  scale=cfg.attn_scale)
            if backward:
                torch.autograd.grad(o, qkv, go)

    def sdpa():
        q, k, v = (a.transpose(1, 2) for a in qkv)
        o = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                           enable_gqa=H != Hkv)
        torch.autograd.grad(o, qkv, go.transpose(1, 2))

    flash_ms = {"shape": [B_, seq, H, hd], "kv_heads": Hkv,
                "sdpa_forward_backward": cuda_ms(sdpa, 3) if attn_kinds else None}
    share = 0.0
    for kind in sorted(set(attn_kinds)):
        window = cfg.sliding_window if kind == "local" else None
        fw = cuda_ms(lambda: flash(False, window), 3)
        fb = cuda_ms(lambda: flash(True, window), 3)
        tag = "" if window is None else "_window"
        flash_ms[f"forward{tag}"], flash_ms[f"forward_backward{tag}"] = fw, fb
        share += micro * kinds.count(kind) * (fw + fb) / p50
    flash_ms["share_of_step"] = share
    del qkv, go
    release()
    scan_ms = None
    n_rec, n_rwkv = kinds.count("rec"), kinds.count("rwkv")
    if n_rec:
        scan_ms = rec_scan_ms(dev, gen, (B_, seq, cfg.rnn.d_rnn or cfg.d_model))
    if n_rwkv:
        scan_ms = rwkv_scan_ms(dev, kernels, gen, B_, H, seq, cfg.rwkv)
    if scan_ms is not None:
        scan_ms["share_of_step"] = micro * (n_rec + n_rwkv) * (
            scan_ms["forward"] + scan_ms["forward_backward"]) / p50

    # Model flops a step (remat's recompute not counted): 6 N a token for
    # the weights a token uses (N the active parameters: an MoE layer's
    # shared and top-k routed experts, not the others), less the embedding
    # lookup's V d where the head is a matrix of its own (a tied head's
    # product is the embedding's V d); and for attention 6 H (d_qk + d_v)
    # a token and layer per attended position (12 H hd where q, k and v are
    # hd wide; MLA's q/k are qk_nope + qk_rope, its v v_head), the mean
    # attended context being (S + 1) / 2 causal and, in a window W, its
    # mean over the S positions of min(p + 1, W).  The recurrent scans
    # (RG-LRU, RWKV-6) are not counted.
    tokens, d = global_batch * seq, cfg.d_model
    n_active = cfg.active_param_count()
    pos = np.arange(1, seq + 1)
    ctx_sum = sum(float(np.minimum(pos, cfg.sliding_window).mean())
                  if k == "local" else (seq + 1) / 2 for k in attn_kinds)
    if cfg.mla is not None:
        d_qk, d_v = cfg.mla.qk_nope + cfg.mla.qk_rope, cfg.mla.v_head
    else:
        d_qk = d_v = hd
    flops = tokens * (6 * (n_active - (0 if cfg.tie_embeddings
                                       else cfg.vocab * d))
                      + 6 * H * (d_qk + d_v) * ctx_sum)
    out = {"phase": phase, "arch": arch, "layers": cfg.n_layers,
           "published_layers": get_config(arch).n_layers,
           "block_pattern": list(cfg.block_pattern),
           "sliding_window": cfg.sliding_window,
           "params": n_params, "active_params": n_active, "seq_len": seq,
           "global_batch": global_batch, "microbatches": micro,
           "remat": True, "mole": "token", "launches": launches,
           "losses": losses, "grad_norms": norms,
           "step_ms": step_ms, "train_step_ms": p50,
           "train_tokens_per_s": tokens / (p50 / 1e3),
           "train_peak_gb": peak_gb, "peak_limit_gb": peak_limit_gb,
           "train_mfu": flops / (p50 / 1e3) / BF16_FLOP_PER_S,
           "flops_per_step": flops, "attended_context_per_token": ctx_sum,
           "scan_flops_counted": False,
           "train_step_profile": prof, "flash_ms": flash_ms,
           "scan_ms": scan_ms,
           "mole_twin": {"layers": twin_groups * len(cfg.block_pattern) + fixed,
                         "fp32": twin_fp32,
                         "bf16": twin_bf16, "limit_rel": TRAIN_LOSS_RTOL},
           "phase_s": time.monotonic() - t_phase}
    emit(out)
    return out


def scan_launches(cfg, micro: int, steps: int) -> dict:
    """The kernel launches ``steps`` train steps of ``micro`` microbatches
    make: for an RWKV-6 stack, K6 three times a layer and microbatch
    (remat's two forwards and the flipped launch of its backward) and the
    key-row scan twice; none otherwise."""
    if cfg.rwkv is None:
        return {}
    n = cfg.n_layers * micro * steps
    return {"wkv6_chunked": 3 * n, "wkv6_rows": 2 * n}


def rwkv_scan_ms(dev, kernels, gen, batch: int, heads: int, T: int,
                 rwkv) -> dict:
    """The time-mix scan (``kernels.wkv6_scan``) at one layer's microbatch
    shape in fp32 on ``k6_train_ops``'s operands: forward alone (one K6
    launch) and forward plus backward (two K6 and two key-row launches).
    A train step runs it micro x layers times each way (remat runs each
    block's forward twice)."""
    BH = batch * heads
    ops, d_out, d_s = k6_train_ops(dev, gen, BH, T, heads=heads)
    xs = [a.requires_grad_() for a in ops]

    def forward():
        with torch.no_grad():
            kernels.wkv6_scan(*xs, chunk=rwkv.chunk)

    def forward_backward():
        with torch.enable_grad():
            out, s_fin = kernels.wkv6_scan(*xs, chunk=rwkv.chunk)
            torch.autograd.grad((out, s_fin), xs, (d_out, d_s))

    out = {"shape": [BH, T, rwkv.head_dim], "forward": cuda_ms(forward, 3),
           "forward_backward": cuda_ms(forward_backward, 3)}
    del xs, ops, d_out, d_s
    release()
    return out


def rec_scan_ms(dev, gen, shape) -> dict:
    """The RG-LRU's scan (``blocks._linear_scan``) at one rec layer's
    microbatch shape in fp32, decays in [0.9, 1): forward alone and
    forward plus the reverse scan of its backward.  A train step runs it
    micro x rec layers times each way (remat runs each block's forward
    twice)."""
    from repro_torch.models import blocks as B

    a = (0.9 + 0.1 * torch.rand(shape, generator=gen, device=dev)
         ).requires_grad_()
    b = torch.randn(shape, generator=gen, device=dev).requires_grad_()
    gh = torch.randn(shape, generator=gen, device=dev)

    def forward():
        with torch.no_grad():
            B._linear_scan(a, b)

    def forward_backward():
        with torch.enable_grad():
            torch.autograd.grad(B._linear_scan(a, b), (a, b), gh)

    out = {"shape": list(shape), "forward": cuda_ms(forward, 3),
           "forward_backward": cuda_ms(forward_backward, 3)}
    del a, b, gh
    release()
    return out


def host_state(state) -> dict:
    """A trainer state's leaves copied to the host: the params, the two
    moments and the count."""
    from repro_torch.checkpoint.manager import tree_leaves

    opt = state["opt"]
    return {"params": [p.detach().cpu() for p in tree_leaves(state["params"])],
            "moments": [t.cpu() for t in tree_leaves([opt["m"], opt["v"]])],
            "count": int(opt["count"])}


def state_departure(state, host: dict) -> dict:
    """The largest |state - host| over the params and over the moments, and
    whether every leaf (the count too) holds the same bits."""
    now = host_state(state)
    out = {"same_bits": now["count"] == host["count"]}
    for key in ("params", "moments"):
        dep = 0.0
        for a, b in zip(now[key], host[key]):
            out["same_bits"] &= same_bits(a, b)
            dep = max(dep, float((a.float() - b.float()).abs().max()))
        out[key] = dep
    return out


def train_resume_path(dev, kernels) -> dict:
    """``launch/train.py``'s ``main`` at phi3_mini_3p8b's published width,
    ``RESUME_LAYERS`` layers, through a failure, a restore and a resume;
    gates 1-5 of the module docstring; step time, save and restore times,
    checkpoint bytes, the peak."""
    import dataclasses
    import shutil

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.manager import tree_leaves
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models import Model
    from repro_torch.runtime import ResilientLoop

    t_phase = time.monotonic()
    cfg = dataclasses.replace(get_config(RESUME_ARCH), n_groups=RESUME_LAYERS)
    n_params = Model(cfg, dev).param_count()
    ckpt_bytes = n_params * (cfg.pdtype.itemsize + 8) + 4
    root = Path(tempfile.mkdtemp(prefix="train_resume_"))
    free = shutil.disk_usage(root).free
    check(free >= (RESUME_KEEP + 1) * ckpt_bytes,
          f"train_resume_path: {free / 1e9:.1f} GB free under {root}, a run "
          f"needs {(RESUME_KEEP + 1) * ckpt_bytes / 1e9:.1f} GB for "
          f"{RESUME_KEEP + 1} checkpoints of {ckpt_bytes / 1e9:.2f} GB")
    obs = {"loops": []}

    def on_restore(state):
        # Gate 4: the step-RESUME_EVERY state's bits, in the storage the
        # leaves had when the step failed.
        leaves = tree_leaves(state)
        check([leaf.data_ptr() for leaf in leaves] == obs["ptrs"],
              "gate 4: a restored leaf moved to other storage")
        check(all(same_bits(leaf.detach().cpu(), want)
                  for leaf, want in zip(leaves, obs["at_ckpt"])),
              "gate 4: a restored leaf differs from the checkpointed state")
        obs["restored"] = int(state["opt"]["count"])
        return state

    class Observed(ResilientLoop):
        """``train.main``'s loop with its restore timed and watched:
        the leaves' storage after each step, a host copy of the state it
        checkpoints at RESUME_EVERY."""

        def __init__(self, step_fn, ckpt, *args, **kw):
            def observed(state, batch):
                state, m = step_fn(state, batch)
                leaves = tree_leaves(state)
                obs["ptrs"] = [leaf.data_ptr() for leaf in leaves]
                if obs.get("capture") == int(state["opt"]["count"]):
                    obs["at_ckpt"] = [leaf.detach().cpu() for leaf in leaves]
                return state, m

            restore_into = ckpt.restore_into

            def timed_restore(step, tree):
                t0 = time.monotonic()
                extra = restore_into(step, tree)
                torch.cuda.synchronize()
                obs["restore_s"] = time.monotonic() - t0
                return extra

            ckpt.restore_into = timed_restore
            super().__init__(observed, ckpt, *args, on_restore=on_restore, **kw)
            obs["loops"].append(self)

    def run(name, *flags):
        obs["loops"].clear()
        state, hist = train.main(
            ["--arch", RESUME_ARCH] + RESUME_FLAGS + [
                "--device", str(dev), "--ckpt-dir",
                            str(root / name), *flags], cfg=cfg)
        losses = {h["step"]: float(h["loss"]) for h in hist if "loss" in h}
        norms = [float(h["grad_norm"]) for h in hist if "loss" in h]
        check(all(np.isfinite(list(losses.values()))) and all(np.isfinite(norms)),
              f"gate 1: {name}: non-finite loss {losses} or grad_norm {norms}")
        check(not any(p.requires_grad for p in state["params"].parameters()),
              f"gate 5: {name}: a leaf requires grad after training")
        return state, hist, losses, sum(loop.restarts for loop in obs["loops"])

    torch.cuda.reset_peak_memory_stats()
    reset_launches(kernels)
    saved = train.ResilientLoop
    train.ResilientLoop = Observed
    try:
        state, hist, clean_losses, r_clean = run(
            "clean", "--steps", str(RESUME_STEPS))
        wall_ms = [h["wall_s"] * 1e3 for h in hist if "loss" in h]
        clean = host_state(state)
        step_dir = root / "clean" / cfg.name / f"step_{RESUME_STEPS:08d}"
        disk_bytes = sum(f.stat().st_size for f in step_dir.iterdir())
        # One save of the final state, timed as the loop pays it: the host
        # copy (save returns), then the writer's file writes (wait).
        probe = CheckpointManager(root / "save_probe", keep=1)
        t0 = time.monotonic()
        probe.save(RESUME_STEPS, state, extra={"data": {"index": 0}})
        save_host_s = time.monotonic() - t0
        probe.wait()
        save_s = time.monotonic() - t0
        del state, probe
        release()
        for name in ("clean", "save_probe"):
            shutil.rmtree(root / name)

        obs["capture"] = RESUME_EVERY
        state, hist, faulty_losses, r_faulty = run(
            "faulty", "--steps", str(RESUME_STEPS), "--inject-failures",
            str(RESUME_FAIL))
        obs.pop("capture")
        events = [h["event"] for h in hist if "event" in h]
        faulty = state_departure(state, clean)
        del state, obs["at_ckpt"]
        release()
        shutil.rmtree(root / "faulty")

        _, _, cut_losses, r_cut = run("cut", "--steps", str(RESUME_CUT))
        release()
        state, _, resumed_losses, r_resumed = run(
            "cut", "--steps", str(RESUME_STEPS), "--resume")
        resumed = state_departure(state, clean)
        del state
        release()
        shutil.rmtree(root / "cut")

        state, _, control_losses, r_control = run(
            "control", "--steps", str(RESUME_STEPS), "--ckpt-every", "100")
        control = state_departure(state, clean)
        del state
        release()
    finally:
        train.ResilientLoop = saved
        shutil.rmtree(root, ignore_errors=True)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    check((r_clean, r_faulty, r_cut + r_resumed, r_control) == (0, 1, 0, 0),
          f"gate 1: restarts clean {r_clean}, faulty {r_faulty}, cut "
          f"{r_cut} + {r_resumed}, control {r_control}")
    check(events == [f"restored@{RESUME_EVERY}: injected failure at step "
                     f"{RESUME_FAIL}"] and obs["restored"] == RESUME_EVERY,
          f"gate 4: faulty run's events {events}")
    launches = {n: getattr(kernels, n).launches for n in KERNEL_NAMES}
    check(not any(launches.values()),
          f"gate 2: train_resume_path launched {launches}")

    # Gate 3: against the clean run, bit for bit if the control is, else
    # within twice the control's departure, losses and state alike.
    def loss_dep(losses):
        return max(abs(losses[s] - clean_losses[s])
                   for s in range(RESUME_EVERY, RESUME_STEPS))

    control["losses"] = max(abs(control_losses[s] - clean_losses[s])
                            for s in range(RESUME_STEPS))
    control["same_bits"] &= control_losses == clean_losses
    faulty["losses"] = loss_dep(faulty_losses)
    resumed["losses"] = loss_dep({**cut_losses, **resumed_losses})
    bit_for_bit = control["same_bits"]
    for name, dep in (("faulty", faulty), ("resumed", resumed)):
        if bit_for_bit:
            check(dep["same_bits"] and dep["losses"] == 0.0,
                  f"gate 3: the clean runs are bit-equal, the {name} run "
                  f"departs: {dep}")
        else:
            for key in ("losses", "params", "moments"):
                check(dep[key] <= 2 * control[key],
                      f"gate 3: the {name} run's {key} depart by "
                      f"{dep[key]}, twice the control's is "
                      f"{2 * control[key]}")

    tokens = int(RESUME_FLAGS[RESUME_FLAGS.index("--batch") + 1]) * int(
        RESUME_FLAGS[RESUME_FLAGS.index("--seq-len") + 1])
    p50 = float(np.median(wall_ms[1:]))
    out = {"phase": "train_resume_path", "arch": RESUME_ARCH,
           "layers": cfg.n_layers, "params": n_params,
           "flags": RESUME_FLAGS, "launches": launches,
           "losses": {"clean": clean_losses, "faulty": faulty_losses,
                      "cut": cut_losses, "resumed": resumed_losses,
                      "control": control_losses},
           "step_ms": wall_ms, "step_p50_ms": p50,
           "tokens_per_s": tokens / (p50 / 1e3),
           "ckpt_bytes": disk_bytes, "ckpt_state_bytes": ckpt_bytes,
           "save_host_copy_s": save_host_s, "save_s": save_s,
           "restore_s": obs["restore_s"], "disk_free_gb": free / 1e9,
           "peak_gb": peak_gb,
           "gate3": {"bit_for_bit": bit_for_bit, "control": control,
                     "faulty": faulty, "resumed": resumed},
           "phase_s": time.monotonic() - t_phase}
    emit(out)
    return out


# -- phases 10f-10i: the frontend models (vision-language, audio) ----------------

def live_gates(params, cfg, seed: int) -> list[float]:
    """Both tanh gates of every cross layer drawn uniform in +-1 from
    ``seed``, in place.  ``Model.init`` draws them as zeros (the
    reference's init), and a cross layer then adds exactly 0 to the
    residual: a broken cross-attention would serve and train unseen."""
    gen = torch.Generator().manual_seed(seed)
    drawn = []
    for kind, p in zip(cfg.layer_kinds(), params["blocks"]):
        if kind == "cross":
            for name in ("gate_attn", "gate_ffn"):
                g = float(torch.rand((), generator=gen)) * 2 - 1
                p["mix"][name].data.fill_(g)
                drawn.append(g)
    return drawn


class ServeTap:
    """Times what ``serve.run_lm``'s per-tenant path runs for a frontend
    model.  While installed, ``repro_torch.core.deploy.fuse_lm_params`` and
    ``repro_torch.launch.steps.make_prefill_step`` / ``make_decode_step``
    (the names ``_serve_per_tenant`` reads when it runs) are wrapped: each
    call is timed on the host clock between two ``torch.cuda.synchronize()``
    and calls the real function once; a prefill also records its inputs'
    shapes and dtypes and the largest magnitude of its patches or frames."""

    def __init__(self):
        from repro_torch.core import deploy
        from repro_torch.launch import steps

        self.deploy, self.steps = deploy, steps
        self._fuse = deploy.fuse_lm_params
        self._prefill, self._decode = steps.make_prefill_step, steps.make_decode_step
        self.fuse_s, self.prefill_ms, self.decode_ms, self.inputs = [], [], [], []

    @staticmethod
    def _timed(out: list, scale: float, fn, *args):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        res = fn(*args)
        torch.cuda.synchronize()
        out.append((time.monotonic() - t0) * scale)
        return res

    def _wrap_fuse(self, *args, **kwargs):
        return self._timed(self.fuse_s, 1.0,
                           lambda: self._fuse(*args, **kwargs))

    def _wrap_prefill(self, model):
        step = self._prefill(model)
        key = model.cfg.frontend.batch_key

        def prefill(params, batch, caches):
            self.inputs.append({k: [list(v.shape), str(v.dtype).split(".")[-1]]
                                for k, v in batch.items()})
            self.inputs[-1]["max_abs_" + key] = float(batch[key].abs().max())
            return self._timed(self.prefill_ms, 1e3, step, params, batch,
                               caches)
        return prefill

    def _wrap_decode(self, model):
        step = self._decode(model)
        return lambda *a: self._timed(self.decode_ms, 1e3, step, *a)

    def __enter__(self):
        self.deploy.fuse_lm_params = self._wrap_fuse
        self.steps.make_prefill_step = self._wrap_prefill
        self.steps.make_decode_step = self._wrap_decode
        return self

    def __exit__(self, *exc):
        self.deploy.fuse_lm_params = self._fuse
        self.steps.make_prefill_step = self._prefill
        self.steps.make_decode_step = self._decode


def cross_sublayers(cfg, params, caches) -> list:
    """``(cross-attention params, its cache)`` for every cross sublayer in
    layer order: a vlm's ``cross`` layers, each ``dec`` layer's cross
    part."""
    if cfg.family == "audio":
        return [(p["cross"], c["cross"]) for p, c in
                zip(params["dec"]["blocks"], caches["dec"]["blocks"])]
    return [(p["mix"], c) for k, p, c in
            zip(cfg.layer_kinds(), params["blocks"], caches["blocks"])
            if k == "cross"]


def frontend_input(dev, cfg, rows: int) -> torch.Tensor:
    """Random patches or frames (rows, n_tokens, d_in) fp32 from the seed."""
    fe = cfg.frontend
    g = torch.Generator(device=dev).manual_seed(SEED + 11)
    return torch.randn((rows, fe.n_tokens, fe.d_in), generator=g, device=dev)


def cross_cache_check(dev, model, params, prompts) -> dict:
    """One prefill (``make_prefill_step``) of the served model on
    ``prompts`` beside random patches or frames; every cross sublayer's
    caches must hold rms_norm(ctx, ctx_norm) @ wk (and wv), with ctx
    computed apart (a vlm's patches @ frontend_proj, an audio model's
    encoder output), within two bf16 ulps of their max."""
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import layers as L, stack as S, whisper as W

    cfg = model.cfg
    rows, P = prompts.shape
    x = frontend_input(dev, cfg, rows)
    worst = 0.0
    with torch.no_grad():
        caches = model.init_cache(rows, P + 1)
        _, caches = make_prefill_step(model)(
            params, {"tokens": torch.from_numpy(prompts).long().to(dev),
                     cfg.frontend.batch_key: x}, caches)
        ctx = (W.encode(params, x, cfg) if cfg.family == "audio"
               else S.project_ctx(params, cfg, x))
        cross = cross_sublayers(cfg, params, caches)
        check(len(cross) > 0, "no cross sublayer")
        for mix, c in cross:
            cn = L.rms_norm(ctx, mix["ctx_norm"]).float()
            for name in ("k", "v"):
                want = torch.einsum("bsd,dhk->bshk", cn, mix["w" + name].float())
                err = float((c[name].float() - want).abs().max())
                lim = 2 * bf16_ulp(float(want.abs().max()))
                check(err <= lim, f"cross cache {name} off by {err} > {lim}")
                worst = max(worst, err / lim)
    return {"cross_sublayers": len(cross), "rows": rows, "prompt_len": P,
            "worst_share_of_limit": worst}


def frontend_twin(dev, model, params, prompts, tenant_seed: int,
                  gen: int) -> dict:
    """The twin of a frontend model's serving path (``model`` and
    ``params``: the vlm's first attention and cross layers, or the whole
    whisper model) on random patches or frames from the
    seed.  One tenant's fused params serve the morphed prompts through
    ``make_prefill_step`` (which writes the cross caches) and greedy
    ``make_decode_step`` (which reads them and never sees the frontend's
    input).  Gated: (4) the served logits, unmorphed with the tenant's
    permutation (``plain[v] = morphed[perm[v]]``), against the raw params'
    prefill and decode steps teacher-forced with the unmorphed tokens,
    within two bf16 ulps of max|raw|; (3) each unmorphed token within the
    tie margin (TIE_MARGIN_ULPS bf16 ulps of max|logit|) of the maximum of
    an independent teacher-forced forward on the raw params with no cache
    (``Model.logits``: the context and its K/V computed anew); and for an
    audio model the forward's logits on all-zero frames lie farther than
    check 4's limit from those on the random ones (the serving path's zero
    frames silence the encoder and every cross sublayer).  Printed for
    both: that distance in bf16 ulps."""
    from repro_torch.core.deploy import fuse_lm_params
    from repro_torch.core.lm import TokenMorpher
    from repro_torch.launch.steps import make_decode_step, make_prefill_step

    cfg = model.cfg
    key = cfg.frontend.batch_key
    rows, P = prompts.shape
    x = frontend_input(dev, cfg, rows)
    tm = TokenMorpher.create(tenant_seed, cfg.vocab)
    prefill, decode = make_prefill_step(model), make_decode_step(model)

    def serve_steps(p, toks, forced=None):
        caches = model.init_cache(rows, P + gen + 1)
        lg, caches = prefill(p, {"tokens": torch.from_numpy(toks).long().to(dev),
                                 key: x}, caches)
        out, logits = [], [lg[:, 0].float()]
        for i in range(gen - 1):
            tok = (torch.argmax(lg[:, 0], -1) if forced is None
                   else torch.from_numpy(forced[:, i]).to(dev))
            out.append(tok)
            lg, caches = decode(p, tok[:, None].long(), P + i, caches)
            logits.append(lg[:, 0].float())
        out.append(torch.argmax(lg[:, 0], -1))
        return torch.stack(logits, 1), torch.stack(out, 1).cpu().numpy()

    with torch.no_grad():
        fused = fuse_lm_params(params, cfg, token_morpher=tm)
        served_lg, served = serve_steps(fused, tm.perm[prompts])
        del fused
        final = tm.inv_perm[served]
        raw_lg, _ = serve_steps(params, prompts, forced=final)
        perm = torch.from_numpy(tm.perm).to(dev)
        unmorphed = served_lg[..., perm]
        err4 = float((unmorphed - raw_lg).abs().max())
        lim4 = 2 * bf16_ulp(float(raw_lg.abs().max()))
        check(err4 <= lim4, f"twin check 4: |unmorphed served - raw steps| "
                            f"{err4} > {lim4}")
        seqs = torch.from_numpy(np.concatenate([prompts, final[:, :-1]], 1)
                                ).long().to(dev)
        fwd = model.logits(params, {"tokens": seqs, key: x})[:, P - 1:]
        gap, exact = gaps_in_ulps(fwd, final)
        check(bool((gap <= TIE_MARGIN_ULPS).all()),
              f"twin check 3: a token is {gap.max():.2f} bf16 ulps below "
              f"the forward's max (margin {TIE_MARGIN_ULPS})")
        steps_vs_fwd = float((raw_lg - fwd).abs().max())
        zero = model.logits(params, {"tokens": seqs,
                                     key: torch.zeros_like(x)})[:, P - 1:]
        live = float((zero - fwd).abs().max())
        # the audio serving path feeds zero frames, which silence the
        # encoder and every cross sublayer: the twin must be farther off
        if cfg.family == "audio":
            check(live > lim4, f"twin: logits on zero and on random {key} "
                               f"{live} apart, not above check 4's {lim4}")
    fwd_ulp = bf16_ulp(float(fwd.abs().max()))
    return {"layers": cfg.layer_kinds(), "enc_layers": cfg.frontend.enc_layers,
            "rows": rows, "prompt_len": P, "gen": gen, key: list(x.shape),
            "unmorph_vs_raw_steps_max_abs": err4, "unmorph_limit": lim4,
            "forward_worst_gap_ulps": float(gap.max()),
            "forward_exact_argmax_share": float(exact.mean()),
            "steps_vs_forward_max_ulps": steps_vs_fwd / fwd_ulp,
            f"zero_vs_random_{key}_max_ulps": live / fwd_ulp}


def frontend_path(dev, kernels, *, phase: str, arch: str, cfg, tenants: int,
                  requests: int, prompt_len: int, gen: int, twin_rows: int,
                  twin, prepare=None) -> dict:
    """``serve --mode lm`` (``serve.run_lm``) of a frontend model on
    ``cfg`` (the published config, cut or not) with random weights from the
    seed (``prepare(params, cfg)`` then sets what the init leaves dead and
    returns it): the token lane morphs the prompts, then one tenant at a
    time its fused params prefill its prompts beside all-zero patches or
    frames and decode greedily.  Gated: no kernel launched (all seven
    counters 0); every prefill fed (rows, n_tokens, d_in) zero bf16 inputs;
    one fusion and one prefill a tenant and a decode step a generated token
    after the first; the generations' shape and range; the peak at
    PEAK_LIMIT_GB; every cross sublayer's caches after a prefill of the
    first ``twin_rows`` prompts beside random inputs
    (:func:`cross_cache_check`); the checks of :func:`frontend_twin` on
    ``twin(model, params)`` (a ``(model, params)`` pair) serving those
    prompts.  Printed: prefill and
    decode-step p50, tokens/s, the fusing time a tenant, the peak."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch import serve
    from repro_torch.models import Model

    t_phase = time.monotonic()
    torch.cuda.reset_peak_memory_stats()
    host_reset = host_peak_reset()
    model = Model(cfg, dev)
    t0 = time.monotonic()
    params = model.init(SEED)
    prepared = prepare(params, cfg) if prepare else None
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    args = serve.parse_args([
        "--mode", "lm", "--arch", arch, "--requests", str(requests),
        "--tenants", str(tenants), "--prompt-len", str(prompt_len),
        "--gen", str(gen), "--mole", "token", "--seed", str(SEED)])
    reset_launches(kernels)
    with torch.no_grad(), ServeTap() as tap:
        t0 = time.monotonic()
        final = serve.run_lm(args, params=params, cfg=cfg)
        serve_s = time.monotonic() - t0
    launches = {n: getattr(kernels, n).launches for n in KERNEL_NAMES}
    check(not any(launches.values()), f"{phase} launched kernels: {launches}")
    rows = requests // tenants
    fe, key = cfg.frontend, cfg.frontend.batch_key
    check(len(tap.fuse_s) == len(tap.prefill_ms) == tenants
          and len(tap.decode_ms) == tenants * (gen - 1),
          f"{len(tap.fuse_s)} fusions, {len(tap.prefill_ms)} prefills, "
          f"{len(tap.decode_ms)} decode steps for {tenants} tenants")
    for seen in tap.inputs:
        check(seen["tokens"][0] == [rows, prompt_len]
              and seen[key] == [[rows, fe.n_tokens, fe.d_in], "bfloat16"]
              and seen["max_abs_" + key] == 0.0,
              f"a prefill was fed {seen}")
    check(final.shape == (requests, gen)
          and final.min() >= 0 and final.max() < cfg.vocab,
          f"generations {final.shape}, ids {final.min()}..{final.max()}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(peak_gb <= PEAK_LIMIT_GB,
          f"peak device memory {peak_gb:.2f} GB > {PEAK_LIMIT_GB} GB")
    prompts = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=prompt_len,
                                     global_batch=requests, seed=SEED)
                          ).batch(0)["tokens"]
    caches_out = cross_cache_check(dev, model, params, prompts[:twin_rows])
    twin_model, twin_params = twin(model, params)
    twin_out = frontend_twin(dev, twin_model, twin_params,
                             prompts[:twin_rows], SEED, gen)
    tokens = requests * gen
    dev_s = (sum(tap.fuse_s) + sum(tap.prefill_ms) / 1e3
             + sum(tap.decode_ms) / 1e3)
    out = {"phase": phase, "arch": arch, "layers": cfg.n_layers,
           "enc_layers": fe.enc_layers,
           "published_layers": get_config(arch).n_layers,
           "block_pattern": list(cfg.block_pattern), "groups": cfg.n_groups,
           "params": model.param_count(), "d_model": cfg.d_model,
           "vocab": cfg.vocab, "frontend": [fe.kind, fe.n_tokens, fe.d_in],
           "dtype": cfg.dtype, "prepared": prepared, "tenants": tenants,
           "requests": requests, "rows_per_prefill": rows,
           "prompt_len": prompt_len, "gen": gen, "launches": launches,
           "prefill_inputs": tap.inputs[0],
           "prefill_ms": tap.prefill_ms,
           "prefill_p50_ms": float(np.median(tap.prefill_ms)),
           "decode_step_p50_ms": float(np.median(tap.decode_ms)),
           "fuse_s_per_tenant": tap.fuse_s,
           "developer_s": dev_s, "tokens_per_s": tokens / dev_s,
           "run_lm_s": serve_s, "tokens_per_s_run_lm": tokens / serve_s,
           "weights_init_s": init_s, "peak_mem_gb": peak_gb,
           "peak_limit_gb": PEAK_LIMIT_GB, "host_peak_rss_gb": host_peak_gb(),
           "host_peak_rss_since": ("phase start" if host_reset
                                   else "process start"),
           "tie_margin_ulps": TIE_MARGIN_ULPS, "cross_caches": caches_out,
           "twin": twin_out, "first_generation": final[0][:12].tolist(),
           "phase_s": time.monotonic() - t_phase}
    emit(out)
    return out


def vlm_path(dev, kernels) -> dict:
    """:func:`frontend_path` at llama32_vision_90b's published width cut to
    VLM_GROUPS groups, both gates of every cross layer drawn in +-1
    (:func:`live_gates`): 2 tenants x 8 requests of 512, 16 generated, each
    prefill beside (8, 1024, 7680) zero patches; the twin is the first
    attention and the first cross layer (VLM_TWIN_PATTERN says why)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import Model

    cfg = dataclasses.replace(get_config(VLM_ARCH), n_groups=VLM_GROUPS)

    def twin(model, params):
        cfg2 = dataclasses.replace(cfg, block_pattern=VLM_TWIN_PATTERN,
                                   n_groups=1)
        params2 = {k: params[k] for k in params.keys() if k != "blocks"}
        kinds = cfg.layer_kinds()
        params2["blocks"] = [params["blocks"][kinds.index(k)]
                             for k in VLM_TWIN_PATTERN]
        return Model(cfg2, dev), params2

    return frontend_path(
        dev, kernels, phase="vlm_path", arch=VLM_ARCH, cfg=cfg,
        tenants=VLM_TENANTS, requests=VLM_REQUESTS, prompt_len=VLM_PROMPT,
        gen=VLM_GEN, twin_rows=VLM_TWIN_ROWS, twin=twin,
        prepare=lambda params, cfg: live_gates(params, cfg, SEED))


def conditioned_attention(params, cfg) -> float:
    """Every attention's query and key weights, (d, H, hd), scaled by
    sqrt(H / d) in place, in the encoder's and the decoder's blocks, self
    and cross; returns the factor.  ``Model.init`` draws them at 1/sqrt(H)
    (fan-in is a weight's second to last axis, the reference's init), so q
    and k have a std of sqrt(d / H) = 8 at whisper_tiny's width, the
    scores a std of 64 and the softmax is nearly one-hot: the fp32
    gradients are then rounding noise, and the decoder's serving steps
    depart from a forward with no cache by more than the tie margin.
    Scaled, q and k have unit std, as a trained model's do."""
    H, d = cfg.n_heads, cfg.d_model
    f = math.sqrt(H / d)
    subs = [b["mix"] for b in params["enc_blocks"]] + [
        b[k] for b in params["dec"]["blocks"] for k in ("mix", "cross")]
    for p in subs:
        for name in ("wq", "wk"):
            p[name].data.mul_(f)
    return f


def whisper_path(dev, kernels) -> dict:
    """:func:`frontend_path` at whisper_tiny's published width and depth
    (WHISPER_PATH), the attention's query and key weights scaled
    (:func:`conditioned_attention`): 4 tenants x 8 requests of 192, 64
    generated, each prefill beside (8, 1500, 384) zero frames; every dec
    layer's cross caches checked on random frames; the twin is the whole
    served model."""
    from repro_torch.configs import get_config

    return frontend_path(dev, kernels, phase="whisper_path", arch=WHISPER_ARCH,
                         cfg=get_config(WHISPER_ARCH),
                         twin=lambda model, params: (model, params),
                         prepare=conditioned_attention, **WHISPER_PATH)


class MorphTap:
    """Records what the provider stage hands K4: while installed,
    ``repro_torch.data.pipeline.morph_rows`` (the name the stage calls) is
    wrapped; each call records its operands' shapes and its device time
    (host clock between two ``torch.cuda.synchronize()``), and calls the
    real entry point once."""

    def __init__(self):
        from repro_torch.data import pipeline

        self.pipeline, self.calls = pipeline, []
        self._real = pipeline.morph_rows

    def _morph(self, x, core, kappa):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        out = self._real(x, core, kappa)
        torch.cuda.synchronize()
        self.calls.append({"x": list(x.shape), "core": list(core.shape),
                           "kappa": int(kappa),
                           "ms": (time.monotonic() - t0) * 1e3})
        return out

    def __enter__(self):
        self.pipeline.morph_rows = self._morph
        return self

    def __exit__(self, *exc):
        self.pipeline.morph_rows = self._real


def vlm_flops(cfg, n_params: int, seq: int, global_batch: int) -> float:
    """Model flops of a vlm train step (remat's recompute not counted): 6
    a token for the parameters a token's path multiplies (all but the
    embedding table, frontend_proj and the cross layers' wk / wv, which
    act on the patches); attention 12 H hd a token per attended position,
    (S + 1) / 2 for a causal layer and the 1024 patches for a cross layer;
    and per sequence, frontend_proj and the cross layers' K/V projections
    over its 1024 patches, 6 flops a parameter and patch."""
    H, hd, d = cfg.n_heads, cfg.head_dim, cfg.d_model
    fe = cfg.frontend
    kinds = cfg.layer_kinds()
    n_cross, n_self = kinds.count("cross"), kinds.count("attn")
    per_patch = fe.d_in * d + n_cross * 2 * d * cfg.n_kv_heads * hd
    tokens = global_batch * seq
    return (tokens * (6 * (n_params - cfg.vocab * d - per_patch)
                      + 12 * H * hd * (n_self * (seq + 1) / 2
                                       + n_cross * fe.n_tokens))
            + global_batch * 6 * fe.n_tokens * per_patch)


def whisper_flops(cfg, n_params: int, seq: int, global_batch: int) -> float:
    """Model flops of a whisper train step (remat's recompute not counted),
    per sequence of S decoder tokens over F frames: a token 6 flops a
    decoder parameter its path multiplies (all but the embedding table and
    the cross layers' wk / wv, which act on the frames) and 12 H hd per
    attended position in each dec layer, (S + 1) / 2 causal and the F
    frames in its cross sublayer; per sequence, the encoder's 6 N_enc F
    and 12 H hd F^2 a bidir layer, and the cross K/V projections, 6 x 2 d
    H hd F a dec layer."""
    from repro_torch.checkpoint.manager import tree_leaves
    from repro_torch.models.whisper import whisper_schema

    H, hd, d = cfg.n_heads, cfg.head_dim, cfg.d_model
    F, L_enc, L_dec = cfg.frontend.n_tokens, cfg.frontend.enc_layers, cfg.n_layers
    n_dec = sum(math.prod(p.shape)
                for p in tree_leaves(whisper_schema(cfg)["dec"]))
    n_enc = n_params - n_dec
    kv = 2 * d * cfg.n_kv_heads * hd
    per_token = n_dec - cfg.vocab * d - L_dec * kv
    tokens = global_batch * seq
    return (tokens * (6 * per_token + L_dec * 12 * H * hd * ((seq + 1) / 2 + F))
            + global_batch * (6 * n_enc * F + L_enc * 12 * H * hd * F * F
                              + L_dec * 6 * kv * F))


def embedding_train(dev, kernels, *, phase: str, arch: str, cfg, k4_shape,
                    seq: int, global_batch: int, micro: int, flops,
                    fp64_passes=None, prepare=None) -> dict:
    """The train step of a frontend model on ``cfg`` (the published width,
    cut or not), ``--mole embedding`` (kappa 1), random weights from the
    seed (``prepare(params, cfg)`` sets what the init leaves dead): the
    developer's params are fused from the init (the first product on the
    frontend's input, ``frontend_proj`` or ``enc_proj``, becomes AugProj =
    M^-1 W_in) and train on the provider stage's morphed stream, which K4
    morphs on the card.  Gates: (1) loss and grad_norm finite, the count
    equal to the steps; (2) K4 the only kernel, launched once a batch at
    ``k4_shape``; (3) embedding-mode equality at step 1
    (:func:`mole_gate`, and the bf16 run's step-1 loss against the raw
    params' on the raw stream within VLM_GATE3_K times the raw bf16 loss's
    departure from float64; step 2 printed, not gated: AdamW is not
    rotation-invariant); (4) after training no leaf requires grad, and a
    prefill and a decode step on the trained params return tensors without
    a graph.  Printed: step p50, tokens/s, MFU (``flops(cfg, n_params,
    seq, global_batch)`` a step over 989 TFLOP/s), the peak, the profiled
    step's top operations and idle share, the provider's ms a batch (K4
    and the whole stage)."""
    import dataclasses

    from repro_torch.checkpoint.manager import tree_leaves
    from repro_torch.configs import get_config
    from repro_torch.core.deploy import fuse_lm_params
    from repro_torch.data import DataConfig, Pipeline
    from repro_torch.launch.steps import (
        TrainHParams, make_decode_step, make_prefill_step, make_train_step,
    )
    from repro_torch.models import Model, ParamTree
    from repro_torch.models.base import MoLeCfg
    from repro_torch.optim import adamw

    t_phase = time.monotonic()
    raw_cfg = cfg
    cfg = dataclasses.replace(
        raw_cfg, mole=MoLeCfg(enabled=True, mode="embedding", kappa=1, seed=SEED))
    key = cfg.frontend.batch_key
    hp = TrainHParams(optimizer=adamw.AdamWConfig(warmup_steps=TRAIN_WARMUP),
                      microbatch=micro, remat=True)
    data = DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=global_batch,
                      seed=SEED)

    def on_card(batch):
        return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}

    def init(m, c):
        p = m.init(SEED)
        return p, (prepare(p, c) if prepare else None)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    pipe = Pipeline(data, model_cfg=cfg, device=dev)   # the core: fp64 QR
    core_s = time.monotonic() - t0
    em = pipe.provider.embed_morpher
    model = Model(cfg, dev)
    n_params = model.param_count()
    params, prepared = init(model, cfg)
    params = ParamTree(fuse_lm_params(params, cfg, embed_morpher=em))
    opt = adamw.init_state(params)
    step = make_train_step(model, hp)
    reset_launches(kernels)
    metrics, step_ms, stage_ms = [], [], []
    with MorphTap() as morph:
        for _ in range(TRAIN_WARMUP + TRAIN_TIMED):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            batch = on_card(next(pipe))
            torch.cuda.synchronize()
            stage_ms.append((time.monotonic() - t0) * 1e3)
            t0 = time.monotonic()
            params, opt, m = step(params, opt, batch)
            torch.cuda.synchronize()
            step_ms.append((time.monotonic() - t0) * 1e3)
            metrics.append(m)
        p50 = float(np.median(step_ms[TRAIN_WARMUP:]))

        def profiled():
            nonlocal params, opt
            params, opt, m = step(params, opt, on_card(next(pipe)))
            metrics.append(m)

        prof = step_profile(profiled, p50)
    launches = {n: getattr(kernels, n).launches for n in KERNEL_NAMES}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(peak_gb <= PEAK_LIMIT_GB,
          f"peak device memory {peak_gb:.2f} GB > {PEAK_LIMIT_GB} GB")
    # Gate 1.
    losses = [float(m["loss"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    check(all(np.isfinite(losses)) and all(np.isfinite(norms)),
          f"gate 1: non-finite loss {losses} or grad_norm {norms}")
    check(int(opt["count"]) == len(metrics),
          f"gate 1: opt count {int(opt['count'])} after {len(metrics)} steps")
    # Gate 2: K4 alone, once a batch (the warmup's step() call draws one
    # batch more for profiling), at the provider's shape.
    R, kappa, q = k4_shape
    batches = pipe.index
    check(launches["block_diag_matmul"] == batches == len(morph.calls)
          and not any(c for n, c in launches.items()
                      if n != "block_diag_matmul"),
          f"gate 2: launches {launches} for {batches} batches")
    check(all(c["x"] == [R, kappa * q] and c["core"] == [q, q]
              for c in morph.calls), f"gate 2: K4 saw {morph.calls}")
    # Gate 4: the trained params serve without a graph.
    check(not any(p.requires_grad for p in params.parameters()),
          "gate 4: a leaf still requires grad after training")
    with torch.no_grad():
        toks = batch["tokens"][:1, :32].long()
        caches = model.init_cache(1, 40)
        lg, caches = make_prefill_step(model)(
            params, {"tokens": toks, key: batch[key][:1]}, caches)
        lg2, caches = make_decode_step(model)(
            params, torch.argmax(lg[:, 0], -1)[:, None], 32, caches)
    outs = [lg, lg2] + tree_leaves(caches)
    check(all(o.grad_fn is None and not o.requires_grad for o in outs),
          "gate 4: a serving output after training carries a graph")
    check(bool(torch.isfinite(lg2).all()), "gate 4: non-finite logits")
    del params, opt, step, batch, metrics, caches, lg, lg2, outs
    release()

    # Gate 3, bf16: the raw params on the raw stream, 2 steps, against the
    # fused run's first two (its step 1 gated below, step 2 printed).
    raw_model = Model(raw_cfg, dev)
    raw_params, _ = init(raw_model, raw_cfg)
    raw_opt = adamw.init_state(raw_params)
    raw_step = make_train_step(raw_model, hp)
    raw_pipe = Pipeline(data, model_cfg=raw_cfg)
    raw_losses = []
    for _ in range(2):
        raw_params, raw_opt, m = raw_step(raw_params, raw_opt,
                                          on_card(next(raw_pipe)))
        raw_losses.append(float(m["loss"]))
    del raw_params, raw_opt, raw_step, raw_model
    release()
    mole = mole_gate(dev, raw_cfg, data, em, fp64_passes, prepare)
    rel1 = abs(losses[0] - raw_losses[0]) / abs(raw_losses[0])
    dep_bf16 = abs(raw_losses[0] - mole["loss_fp64"]) / abs(mole["loss_fp64"])
    check(rel1 <= VLM_GATE3_K * dep_bf16,
          f"gate 3 (bf16): step-1 losses fused {losses[0]} raw "
          f"{raw_losses[0]}: {rel1} > {VLM_GATE3_K} x {dep_bf16}")
    # K4 at the provider's shape (not counted).
    x = torch.from_numpy(np.random.default_rng(SEED).standard_normal(
        (R, kappa * q)).astype(np.float32)).to(dev)
    core = torch.from_numpy(em.core.matrix).to(dev)
    k4_ms = cuda_ms(lambda: kernels.morph_rows(x, core, kappa), 10)
    del x, core, pipe, raw_pipe
    release()

    tokens = global_batch * seq
    n_flops = flops(cfg, n_params, seq, global_batch)
    out = {"phase": phase, "arch": arch, "layers": cfg.n_layers,
           "enc_layers": cfg.frontend.enc_layers,
           "published_layers": get_config(arch).n_layers,
           "block_pattern": list(cfg.block_pattern), "params": n_params,
           "prepared": prepared, "seq_len": seq, "global_batch": global_batch,
           "microbatches": micro, "remat": True, "mole": "embedding",
           "kappa": kappa, "launches": launches, "k4_calls": morph.calls[:1],
           "losses": losses, "grad_norms": norms, "step_ms": step_ms,
           "train_step_ms": p50, "train_tokens_per_s": tokens / (p50 / 1e3),
           "train_peak_gb": peak_gb, "peak_limit_gb": PEAK_LIMIT_GB,
           "train_mfu": n_flops / (p50 / 1e3) / BF16_FLOP_PER_S,
           "flops_per_step": n_flops, "train_step_profile": prof,
           "provider_stage_ms_per_batch": float(np.median(stage_ms)),
           "provider_k4_ms_per_batch": float(np.median(
               [c["ms"] for c in morph.calls])),
           "k4_device_ms": k4_ms, "core_qr_s": core_s,
           "mole_gate": dict(mole, bf16_step1_rel=rel1,
                             bf16_raw_vs_fp64_rel=dep_bf16,
                             bf16_raw_losses=raw_losses,
                             bf16_fused_losses=losses[:2],
                             bf16_step2_rel_not_gated=abs(
                                 losses[1] - raw_losses[1]) / abs(raw_losses[1]),
                             k=VLM_GATE3_K),
           "phase_s": time.monotonic() - t_phase}
    emit(out)
    return out


def vlm_train(dev, kernels, seq: int = VLM_TRAIN["seq"],
              global_batch: int = VLM_TRAIN["global_batch"],
              micro: int = VLM_TRAIN["micro"]) -> dict:
    """:func:`embedding_train` at llama32_vision_90b's published width on
    the pattern ("attn", "cross") x 1 group, live gates; K4 at (2048,
    7680) x (7680, 7680); gate 3's float64 gradients for VLM_FP64_LEAVES,
    the two tables a pass each."""
    import dataclasses

    from repro_torch.configs import get_config

    tables = ("embed", "head")
    return embedding_train(
        dev, kernels, phase="vlm_train", arch=VLM_ARCH,
        cfg=dataclasses.replace(get_config(VLM_ARCH),
                                block_pattern=("attn", "cross"), n_groups=1),
        k4_shape=K4_VLM, seq=seq, global_batch=global_batch, micro=micro,
        flops=vlm_flops,
        fp64_passes=[(n,) for n in tables] + [
            tuple(n for n in VLM_FP64_LEAVES if n not in tables)],
        prepare=lambda params, cfg: live_gates(params, cfg, SEED))


def whisper_train(dev, kernels, seq: int = WHISPER_TRAIN["seq"],
                  global_batch: int = WHISPER_TRAIN["global_batch"],
                  micro: int = WHISPER_TRAIN["micro"]) -> dict:
    """:func:`embedding_train` at whisper_tiny's published width and depth
    (WHISPER_TRAIN), the attention's query and key weights scaled
    (:func:`conditioned_attention`); K4 at (24000, 384) x (384, 384), the
    frames of a batch; gate 3's float64 gradients for every leaf in one
    pass."""
    from repro_torch.configs import get_config

    return embedding_train(
        dev, kernels, phase="whisper_train", arch=WHISPER_ARCH,
        cfg=get_config(WHISPER_ARCH), k4_shape=K4_WHISPER, seq=seq,
        global_batch=global_batch, micro=micro, flops=whisper_flops,
        prepare=conditioned_attention)


def max_rel_departure(host: torch.Tensor, exact: torch.Tensor) -> float:
    """max|host - exact| / max|exact|, ``host`` (on the host) moved to
    ``exact``'s device slice by slice (2^26 entries), so no copy of the
    whole leaf is made there."""
    a, b = host.reshape(-1), exact.reshape(-1)
    step = 1 << 26
    err = max(float((a[i:i + step].to(b.device).double() - b[i:i + step])
                    .abs().max()) for i in range(0, b.numel(), step))
    return err / float(b.abs().max())


def mole_gate(dev, raw_cfg, data, em, fp64_passes=None, prepare=None) -> dict:
    """Gate 3 of an embedding-mode train phase in fp32, at step 1, with no
    optimizer state (8 B a parameter): on the stream's first batch, the raw
    params on the raw patches or frames against the fused params (AugProj
    = M^-1 W_in, fp32, in ``frontend_proj`` or ``enc_proj``) on the
    provider's morphed ones (K4).  With an orthogonal core the two losses
    and every gradient but AugProj's are equal, and dL/dAugProj = M^T
    dL/dW_in.  Each is held within VLM_GATE3_K times the raw form's own
    departure from the same model evaluated with float64 products (norms,
    attention scores and the CE's logits stay fp32, as in the fp32 run) on
    the same batch: the loss, and each gradient of a leaf whose float64
    gradient is taken at its own departure, every other leaf at the
    largest of theirs.  ``fp64_passes`` lists the leaves whose float64
    gradients are taken, a tuple a pass (None: every leaf in one pass; a
    vlm's would need 31 GB beside its 31 GB of float64 params).  Returns
    the figures and the float64 loss."""
    import dataclasses

    from repro_torch.core.deploy import fuse_lm_params
    from repro_torch.data import Pipeline, ProviderStage
    from repro_torch.launch import steps
    from repro_torch.models import Model, ParamTree
    from repro_torch.optim import adamw

    c32 = dataclasses.replace(raw_cfg, dtype="float32", param_dtype="float32")
    proj = "enc_proj" if c32.family == "audio" else "frontend_proj"
    model = Model(c32, dev)
    params = model.init(SEED)
    if prepare:
        prepare(params, c32)
    raw = {k: torch.as_tensor(v, device=dev)
           for k, v in next(Pipeline(data, model_cfg=raw_cfg)).items()}
    morphed = ProviderStage(embed_morpher=em, device=dev)(raw)

    def grads(p, batch, wanted=None):
        names, leaves = zip(*adamw.named_leaves(p))
        if wanted is not None:
            names, leaves = zip(*[(n, t) for n, t in zip(names, leaves)
                                  if n in wanted])
        with torch.enable_grad(), steps._grad_on(leaves):
            loss = model.loss(p, batch, remat=True)
            g = torch.autograd.grad(loss, leaves)
        return float(loss.detach()), dict(zip(names, g))

    loss_raw, g_raw = grads(params, raw)
    fused = ParamTree(fuse_lm_params(params, c32, embed_morpher=em))
    loss_fused, g_fused = grads(fused, morphed)
    del fused
    worst, worst_leaf, fused_rel = 0.0, None, {}
    for n, g in g_raw.items():
        if n == proj:
            continue
        rel = float((g_fused[n] - g).abs().max()) / float(g.abs().max())
        fused_rel[n] = rel
        if rel > worst:
            worst, worst_leaf = rel, n
    q, kappa = em.core.q, em.core.kappa
    core = torch.from_numpy(em.core.matrix).to(dev)
    gp = g_raw[proj]
    want = torch.matmul(core.T, gp.reshape(kappa, q, -1)).reshape(gp.shape)
    proj_rel = float((g_fused[proj] - want).abs().max()) / float(
        want.abs().max())
    del g_fused, want, core
    passes = fp64_passes or [tuple(g_raw)]
    kept = {n: g_raw[n].cpu() for p in passes for n in p}   # off the card
    del g_raw
    release()
    # The float64 evaluation of the raw form, on the same weights.
    c64 = dataclasses.replace(c32, dtype="float64", param_dtype="float64")
    model = Model(c64, dev)
    for p in params.parameters():
        p.data = p.data.double()
    # Each pass's gradients are compared slice by slice and freed.
    deps = {}
    for wanted in passes:
        loss64, g64 = grads(params, raw, wanted=set(wanted))
        for n, g in g64.items():
            deps[n] = max_rel_departure(kept.pop(n), g)
        del g64
        release()
    dep_loss = abs(loss_raw - loss64) / abs(loss64)
    dep_grad = max(deps.values())
    del params
    release()
    loss_rel = abs(loss_fused - loss_raw) / abs(loss_raw)
    k = VLM_GATE3_K
    # Both evaluations take the CE's log-sum-exp of fp32 logits (as the
    # reference does), so the losses may agree to the bit: one fp32 unit
    # roundoff is the least departure the bound assumes.
    loss_dep = max(dep_loss, FP32_UNIT_ROUNDOFF)
    check(loss_rel <= k * loss_dep,
          f"gate 3 (fp32): losses fused {loss_fused} raw {loss_raw}: "
          f"{loss_rel} > {k} x {loss_dep}")
    for n, rel in fused_rel.items():
        dep = deps.get(n, dep_grad)
        check(rel <= k * dep, f"gate 3 (fp32): gradient {n} {rel} > {k} x "
                              f"{dep}")
    check(proj_rel <= k * deps[proj],
          f"gate 3 (fp32): dAugProj against M^T dW_in {proj_rel} > {k} x "
          f"{deps[proj]}")
    closest = sorted(deps, key=lambda n: -(fused_rel.get(n, proj_rel)
                                           / max(deps[n], 1e-30)))
    return {"fp32_loss_raw": loss_raw, "fp32_loss_fused": loss_fused,
            "fp32_loss_rel": loss_rel, "fp32_grad_worst_rel": worst,
            "fp32_grad_worst_leaf": worst_leaf,
            "fp32_dAugProj_vs_MT_dWin_rel": proj_rel,
            "loss_fp64": loss64, "fp32_raw_vs_fp64_loss_rel": dep_loss,
            "fp32_raw_vs_fp64_grad_rel": dep_grad,
            "fp64_leaves": len(deps),
            "closest_leaves_fused_vs_raw_and_raw_vs_fp64": {
                n: [fused_rel.get(n, proj_rel), deps[n]]
                for n in closest[:16]}}


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; needs a GPU")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import core, kernels, runtime
    from repro_torch.kernels import build, ref

    dev = runtime.resolve_device(None)
    t0 = time.monotonic()
    report = build.build_all()
    emit({"phase": "build", "seconds": time.monotonic() - t0,
          "libraries": {
              n: {"seconds": r["seconds"], "path": str(Path(r["path"]).relative_to(ROOT)),
                  "ptxas": [ln.strip() for ln in r["log"].splitlines()
                            if "registers" in ln or "spill" in ln
                            or "entry function" in ln or "Performance" in ln]}
              for n, r in report.items()}})

    rows = kernel_checks(dev, kernels, ref)
    release()
    main, ctx = main_path(dev, core, runtime, kernels)
    release()
    async_path(dev, core, runtime, kernels, ctx, main["images_per_s_engine"])
    release()
    served_path(dev, runtime, kernels, ctx)
    release()
    sharded_path(dev, core, runtime, kernels, ctx)
    del ctx
    release()
    churn(dev, core, runtime)
    release()
    features_path(dev, core, runtime, kernels, ref)
    release()
    rows["grouped_row_gemm"] = k3_checks(dev, kernels, ref)
    release()
    lm = lm_path(dev, kernels, phase="lm_path", arch=LM_ARCH,
                 prompt_len=LM_PROMPT)
    release()
    long_ctx = {}
    lm_path(dev, kernels, phase="lm_long_prompt", arch=LM_ARCH,
            prompt_len=LONG_PROMPT, requests=LONG_REQUESTS, gen=LONG_GEN,
            ctx=long_ctx, flash_shape=True)
    release()
    mole_off_path(dev, kernels, long_ctx)
    del long_ctx
    release()
    lm_path(dev, kernels, phase="phi3_path", arch=PHI3_ARCH,
            prompt_len=PHI3_PROMPT)
    release()
    for phase, arch, prompt, depth in (
            ("gemma2_path", GEMMA2_ARCH, GEMMA2_PROMPT, GEMMA2_GROUPS),
            ("command_r_path", COMMAND_R_ARCH, COMMAND_R_PROMPT,
             COMMAND_R_LAYERS)):
        out = lm_path(dev, kernels, phase=phase, arch=arch, prompt_len=prompt,
                      groups=depth)
        check(out["k3_launches"] > 0, f"{phase}: K3 was not launched")
        release()
    for phase, arch, prompt in (("moe_path", MOE_ARCH, MOE_PROMPT),
                                ("mla_path", MLA_ARCH, MLA_PROMPT)):
        out = lm_path(dev, kernels, phase=phase, arch=arch, prompt_len=prompt)
        check(out["k3_launches"] > 0, f"{phase}: K3 was not launched")
        release()
    out = lm_path(dev, kernels, phase="recurrentgemma_path", arch=RG_ARCH,
                  prompt_len=RG_PROMPT, twin_groups=RG_TWIN_GROUPS)
    check(out["k3_launches"] > 0, "recurrentgemma_path: K3 was not launched")
    release()
    rows.update(k45_checks(dev, kernels, ref))
    release()
    vgg = vgg_path(dev, core, kernels)
    release()
    rows["wkv6_chunked"], rows["wkv6_rows"] = k6_checks(dev, kernels, ref,
                                                        report)
    release()
    rwkv = lm_path(dev, kernels, phase="rwkv_path", arch=RWKV_ARCH,
                   prompt_len=RWKV_PROMPT)
    release()
    train_path(dev, kernels)
    release()
    train_resume_path(dev, kernels)
    release()
    train_path(dev, kernels, phase="gemma2_train", arch=GEMMA2_ARCH,
               peak_limit_gb=PEAK_LIMIT_GB, **GEMMA2_TRAIN)
    release()
    train_path(dev, kernels, phase="mla_train", arch=MLA_ARCH,
               peak_limit_gb=PEAK_LIMIT_GB, **MLA_TRAIN)
    release()
    train_path(dev, kernels, phase="recurrentgemma_train", arch=RG_ARCH,
               peak_limit_gb=PEAK_LIMIT_GB, **RG_TRAIN)
    release()
    rwkv_train = train_path(dev, kernels, phase="rwkv_train", arch=RWKV_ARCH,
                            peak_limit_gb=PEAK_LIMIT_GB, **RWKV_TRAIN)
    release()
    vlm_path(dev, kernels)
    release()
    vlm = vlm_train(dev, kernels)
    release()
    whisper_path(dev, kernels)
    release()
    whisper = whisper_train(dev, kernels)
    release()
    launches = dict(main["launches"], grouped_row_gemm=lm["k3_launches"],
                    wkv6_chunked=(rwkv["k6_launches"]
                                  + rwkv_train["launches"]["wkv6_chunked"]),
                    wkv6_rows=rwkv_train["launches"]["wkv6_rows"],
                    **vgg["launches"])
    launches["block_diag_matmul"] += (vlm["launches"]["block_diag_matmul"]
                                      + whisper["launches"]["block_diag_matmul"])
    check(all(launches[n] > 0 for n in KERNEL_NAMES),
          f"a kernel was not launched on its path: {launches}")

    csrc = "src/repro_torch/kernels/csrc/"
    kernel_rows = {   # name -> (source, replaced TPU kernel)
        "grouped_block_diag_matmul": ("morph_gemm.cu",
                                      "src/repro/kernels/grouped.py:80"),
        "grouped_aug_gemm": ("aug_gemm.cu", "src/repro/kernels/grouped.py:157"),
        "grouped_row_gemm": ("row_gemm.cu", "src/repro/kernels/grouped.py:206"),
        # K4 in fp32 (every main path's) on the split-TF32 GEMM; in bf16
        # and small fp32 products on morph_gemm.cu (gemm.morph_route).
        "block_diag_matmul": ("aug_gemm.cu",
                              "src/repro/kernels/block_diag.py:45"),
        "aug_gemm": ("aug_gemm.cu", "src/repro/kernels/aug_gemm.py:41"),
        "wkv6_chunked": ("wkv6.cu", "src/repro/kernels/wkv6.py:71"),
        # No Pallas kernel: the gradient JAX takes through the XLA chunked
        # scan.
        "wkv6_rows": ("wkv6_rows.cu",
                      "src/repro/models/blocks.py:732 (_wkv_chunked's "
                      "gradient; no Pallas kernel)"),
    }
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")

    def figures(row: dict) -> dict:
        # a kernel's computed floors (K6's and the key-row scan's form
        # floors) stand beside its bound, under "bounds"
        out = {k: row[k] for k in keys[:4]}
        if "bounds" in row:
            out["bounds"] = row["bounds"]
        out["library_ms"] = row["library_ms"]
        return out

    line = [
        {"name": name, "route": "cuda", "source": csrc + src,
         "replaces": replaces, "launches": launches[name],
         "max_abs_err": rows[name]["max_abs_err"], **figures(rows[name])}
        for name, (src, replaces) in kernel_rows.items()
    ]
    # K3's figures are on bf16 tables, the decode lane's head stacks; its
    # figures on fp32 tables of the same values stand beside them.
    k3 = line[list(kernel_rows).index("grouped_row_gemm")]
    k3["fp32_tables"] = {k: rows["grouped_row_gemm"]["fp32_tables"][k]
                         for k in keys}
    # K4's figures are at the developer path's morph (VGG-16/CIFAR); at the
    # vlm provider's patch morph and the whisper provider's frame morph they
    # stand beside them, with the launches of vlm_train's and whisper_train's
    # runs (the rest of K4's launches are vgg_path's).
    k4 = line[list(kernel_rows).index("block_diag_matmul")]
    for tag, run in (("vlm_provider", vlm), ("whisper_provider", whisper)):
        row = rows["block_diag_matmul"][tag]
        k4[tag] = dict(
            {k: row[k] for k in keys + ("max_abs_err", "timed_shape")},
            launches=run["launches"]["block_diag_matmul"])
    # K6's figures are at the prefill's shape (the columns form); at
    # rwkv_train's microbatch (the time-chunked form) they stand beside them,
    # graph-timed, with rwkv_train's calls.
    k6 = line[list(kernel_rows).index("wkv6_chunked")]
    train_case = rows["wkv6_chunked"]["per_case"]["BH{}_T{}".format(*K6_TRAIN)]
    k6["rwkv_train"] = dict(train_case, bound_by=k6_bound(*K6_TRAIN, K6_D)[1],
                            launches=rwkv_train["launches"]["wkv6_chunked"],
                            timed_shape="r/k/v/logw ({}, {}, {}) fp32".format(
                                *K6_TRAIN, K6_D))
    emit({"kernels": line})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    print(smi.stdout.strip().splitlines()[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
