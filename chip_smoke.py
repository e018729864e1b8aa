#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``scratchpad_tpu_torch``) on one GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:

1. device: the card's name and power limit (``nvidia-smi``); no CUDA
   device is a failure.
2. build: compiles every CUDA kernel of the port from ``scratchpad_tpu_torch/
   csrc`` with ``nvcc`` for sm_90a, one ``nvcc`` per source, in parallel,
   and with them the decode kernel's four stage variants (``-DSPTPU_DECODE_
   STAGE=1, 2, 3, 5``, variant libraries of the same source). ``[sass]``
   lines count the tensor-core (``HGMMA``, ``IGMMA``, ``HMMA``, ``IMMA``)
   and asynchronous-copy (``LDGSTS``, ``UTMALDG``, ``UBLKCP``)
   instructions of the decode, extend, W4A8, W4A16, delta and probe
   libraries (``SASS_LIBRARIES``) from ``cuobjdump --dump-sass``, and of
   the W4 kernels' split-step instantiations (``SPLIT_FUNCTIONS``: the
   groups that cut a step, each must hold wgmma); a library without a
   tensor-core instruction fails, and so does a decode or probe library
   without ``HMMA`` or ``HGMMA``, a W4A16 or delta library without
   ``HGMMA``, a W4A8 library without the integer ``IGMMA``, or any of these
   five without an asynchronous copy. Then the grammar backend's host
   libraries (``csrc/fsm.cpp``, ``csrc/pda.cpp``) with the host compiler.
3. kernels: each kernel's wrapper against its plain PyTorch version on the
   same inputs (the plain version computes and returns f32). Attention, on
   bf16 pages and on int8 and fp8 (e4m3) pages with per-(token, head) bf16
   scales: decode at batch 1, 2 and 64 and contexts of 1, 15, 16, 17, 256
   and 4096 tokens (``DECODE_CHECK_B``, ``DECODE_CHECK_CTX``), rows ending
   a token before, on and after a boundary of the decode plan's splits
   (``split_edge_lens``), head_dim 64 and 128, 4 and 3 query heads per kv
   head (Llama-3.2-1B's and 3B's), with ``seq_len == 0`` rows; where the
   plan splits a row across CTAs, a second call must give the same bits;
   extend shapes with mixed
   chunk lengths, cached prefixes and padded tokens. The KV quantizer on the
   card must match itself on the CPU bit for bit. The
   4-bit GEMMs: Llama-3.2-1B's seven matrices at M of 1, 64, 65, 129, 200
   and 2048 (``W4_CHECK_M``), groups of 64 and 32 at three of them
   (``W4_SMALL_GROUPS``), a group of 120 (GPT-OSS's 2880 -> 5760, at M 1,
   64, 300 and 8192) and of 100 with a padded Out (groups that cut a
   tensor-core step: split steps), a group of 24 (``W4_MMA_GROUPS``: W4A8's
   ``mma.sync`` remainder), W4A16's ``mma.sync`` remainder
   (``W4A16_MMA_GROUPS``: groups of 1 and 8, and a K that is no multiple
   of 8), ``quantize_stacked``'s zero points
   outside the code range (``W4_STACKED_RESTS``: groups of one sign, a
   constant column; at g 120 nearly constant groups whose zero points lie
   near -31,000 and above 2,064), each GEMM on the same
   int8 (W4A8) or bf16 (W4A16) rows as its plain version; the row
   quantizer must match its plain version bit for bit. The grouped int8 delta kernel of the toppings
   path: Llama-3.2-1B's projection shapes (2048 -> 2048, 512, 8192; 8192 ->
   2048) and 2048 -> 1000 at 1, 7, 64, 65, 129 and 2048 tokens, over five
   slot layouts (one slot; all eight mixed; a slot with no tokens; a
   LoRA-only slot; no adapter at all). Where the W4A8, W4A16 or delta
   launch plan splits K across CTAs, a second call must give the same
   bits. The soft cap and the
   static sliding window at Mistral-7B's shape (G 4, head_dim 128): decode
   at B 1 and 64, contexts 256, 4096 and 8192, for each (cap, W) of
   ``CAPS_WINDOWS`` over bf16 pages and ``CAPS_WINDOWS_8BIT`` over int8 and
   fp8 pages, and rows whose window's first token falls a token before, on
   and after a split boundary (``SPLIT_EDGE_WINDOWS``), split calls
   bit-equal; extend with a 2048-token chunk on 6,000 cached tokens and
   mixed chunks whose window edge falls inside a query tile and a page; and
   ``decode_attention_pallas`` (the port of ``pallas_decode._decode_kernel``)
   at its JAX test's shape with cap 30 and W 8, and at Mistral-7B's. Tolerance:
   |kernel - plain| <= ATOL + RTOL * |plain| elementwise (see below);
   padding and zero rows must come out as exact zeros, and rows outside a
   delta slot bit-equal to the delta kernel's input. The decode ablation
   probe (``decode_ablate``, the port of ``_ablate.py::make_kernel``) in all
   five modes at the JAX probe's shape (B 64, Hkv 8, page 16, 16-page
   chunks) at ctx 192 and 1000 (chunk and page edges inside the rows), with
   rows of 0 and 1 tokens, at G 1, 2, 3, 4 and 8 and Dp 64 and 128, and at
   ctx 4096 (16 chunks: the cross-chunk rescale; ``ABLATE_CHECKS``): its
   ``out`` within one bf16 ulp of the plain version's, its ``aux`` with
   ``m`` exact and ``l`` and the checksum within ATOL + 2**-12 * |plain|
   (``aux_tolerance``: aux is f32, never rounded to bf16), one launch a
   call, and a second call bit-equal (the row counters left at 0). The decode
   kernel's stage cuts (1, 2, 3 and 5) against their plain functions
   (``gqa_decode.py::paged_decode_attention_stage_plain``) at each shape
   the stage table times (Llama-3.2-1B's, 3B's and Mistral-7B's decode at
   B 64, ctx 4096), within ATOL + RTOL * |plain|. Head_dim 256 over bf16
   pages (Gemma) at Gemma-2-2B's (G 2, Hkv 4) and Gemma-3-1B's (G 4, Hkv 1)
   shapes: decode at B 1, 2 and 64 and every ``DECODE_CHECK_CTX``, padding
   rows, split-edge rows, and rows whose window's first token falls a token
   before, on and after a split boundary or a page edge, under each (cap,
   window) of ``CAPS_WINDOWS_256`` (caps none and 50; windows none, 4096,
   512 and 1) on the same pool in turn; extend on ``EXTEND_CASES_256``
   (mixed chunks, cached prefixes, padding, a 2048-token chunk over 6,000
   cached tokens); and Gemma's layers in turn on one pool (local, global,
   local) through both kernels, the two local calls bit-equal. Rows 1dq
   and 3dq, head_dim 256 over int8 and fp8 pages at the same two shapes:
   decode on ``DECODE_CASES_256_8BIT`` (one row split across the card, B 64
   unsplit, padding rows, rows whose window's first token falls a token
   before, on and after a split boundary or a page edge) and extend on
   ``EXTEND_CASES_256``, each under ``CAPS_WINDOWS_256_8BIT`` (windows 4096
   and 512, each with and without the cap of 50), split calls bit-equal. Attention
   sinks (``check_sinks``) at GPT-OSS's shape (Hkv 8, G 8, head_dim 64)
   over bf16, int8 and fp8 pages, without a window and with its 128, sinks
   of N(0, 2^2) and of 100 (above every score): decode at B 1, 2 and 64
   and contexts of 1 to 4096 tokens (``SINK_CHECK_CTX``), split-edge and
   padding rows, split calls bit-equal; extend on mixed chunks. Llama-4's
   chunk (``check_chunks``) at Scout's shape (Hkv 8, head_dim 128, G 5) and
   G 4 over bf16, int8 and fp8 pages, chunks of 16, 100, 1000 and 8192
   (``CHUNK_SIZES``): decode on rows a token before, on and after a chunk
   edge and past two chunks (split across the card), one row of 2C + 17
   (split), and B 64 (one CTA a row and head), split calls bit-equal; extend
   on a prompt across the edge, a chunk after a cached prefix that starts a
   token before it, a one-token row and padding tokens, so that query
   tiles straddle the edge. Rows 1, 3, 1q and 3q at a tp 2 rank's heads of
   Llama-3.1-8B (Hkv 4, G 4, D 128; ``check_tp_heads``). Gemma 3's
   bidirectional image spans
   (``check_spans``, rows 3m and 3qm) over bf16, int8 and fp8 pages at
   ``SPAN_SHAPES`` (Gemma-3-4B's G 2 at D 256; G 6 and 1 at D 128), without
   a window and with one of 128 (shorter than a span), on ``SPAN_ROWS``: a
   256-token span across query tiles beside a second span, a span after a
   cached prefix, rows without spans, padding tokens (exact zeros); the
   spans must move the output, and spans with a chunk are refused.
4. engines: ``Engine.generate`` at full width and depth with random
   weights: Llama-3.2-1B in bf16, then with ``quantization="w4a8"``, then
   W4A16 on the same engine and codes (every ``QuantLinear`` switched to
   its A16 route); Llama-3.2-3B with ``quantization="w4a8"`` and
   ``kv_cache_dtype="auto"``, which must resolve to int8 KV, then the same
   weights with bf16 KV (its first ``BF16KV_LAYERS`` layers, not timed);
   Llama-3.2-1B in bf16 with fp8 KV; Mistral-7B-v0.1
   (its published config, window 4096) in bf16 under
   ``attention_backend="auto"``, then under ``"pallas"`` on the same
   weights (its first ``MISTRAL_PALLAS_LAYERS`` layers); Qwen3-8B in bf16
   (qk-norm, an untied head; not timed since PR 23, whose
   ``phase_tp_families`` it pays for), then with W4A8 at ``QWEN3_W4A8_LAYERS``
   layers and the int8 KV that ``"auto"`` gives its full depth (logits
   only, not timed); Gemma-2-2B in bf16 at ``GEMMA2_LAYERS`` layers
   (head_dim 256, window 4096 on alternate layers, caps 50 and 30) with
   ``WINDOW_REQUESTS``, not timed; Gemma-3-1B
   (``GEMMA3_1B``, its config.json: window 512 on five layers of six, one
   kv head; ``GEMMA3_LAYERS`` of its 26 layers) with ``GEMMA3_REQUESTS``,
   not timed; Gemma-2-2B on int8 KV at
   ``GEMMA_KV8_LAYERS`` layers (rows 1dq and 3dq on a served path,
   ``GEMMA_KV8_REQUESTS`` across the window's edge, the 8-bit gate 1e-1),
   then on fp8 KV at the same depth, neither timed; GPT-OSS-20B at full width
   and ``GPT_OSS_LAYERS`` layers in bf16 (sinks, window 128 on alternate
   layers, 32 experts, top 4) with ``GPT_OSS_REQUESTS``, not timed, where
   dropping the sinks must
   move each prompt's logits by at least ``SINK_MOVE`` times the
   kernel-vs-plain reading; GPT-OSS W4 at ``GPT_OSS_W4_LAYERS`` layers with
   int8 KV, W4A8 then W4A16 on the same codes (rows 6 and 7 at its groups
   of 120), and Qwen3-30B-A3B (``QWEN3_30B_A3B``, its config.json: 128
   experts, top 8) at ``QWEN3_MOE_LAYERS`` layers in bf16, neither timed;
   Llama-4 Scout's text decoder (``LLAMA4_SCOUT``, its config) at
   ``LLAMA4_LAYERS`` layers in bf16 (chunks of 8192 on three rope layers, a
   global NoPE layer, 16 experts top 1 and a shared expert, G 5) with
   ``LLAMA4_REQUESTS``, not timed, where dropping the chunk must move the
   logits of each row past the chunk's edge by at least ``CHUNK_MOVE`` times
   the kernel-vs-plain reading; DeepSeek-V2-Lite (``DEEPSEEK_V2_LITE``, its
   config.json: multi-head latent attention over a latent pool of 1,152
   bytes a token and layer, YaRN, one dense layer, then 64 routed experts
   top 6 beside 2 shared ones) at full width and ``DEEPSEEK_LAYERS`` layers
   in bf16, not timed: it must
   launch neither attention kernel, and its plain path is HF's expanded
   form (``ExpandedMla``), which without its rope term must move the logits
   by at least ``ROPE_MOVE`` times the reading; Apertus-8B (``APERTUS_8B``,
   its config.json: weighted qk-norm, the xIELU MLP) at ``APERTUS_LAYERS``
   of its 32 layers in bf16, not timed (Mistral-7B's run times its
   attention shapes). The vision engines, not timed (``phase_vlm``): Qwen2-VL-2B (the
   ``qwen2-vl-2b`` preset at full width and depth, its 32-layer tower at 448
   px) with two one-image requests, a two-image request, a video of
   ``VIDEO_FRAMES`` frames and a text request; Gemma-3-4B-it
   (``GEMMA3_4B_MM``, its config.json: SigLIP at 896 px, 27 layers, 256
   tokens an image) at ``GEMMA3_MM_LAYERS`` of its 34 decoder layers, on
   bf16 KV (row 3m) and on fp8 KV with the same weights (row 3qm); and
   LLaVA-1.5-7B (``LLAVA_15_7B``, its config.json: CLIP ViT-L/14 at 336 px,
   layer -2) at ``LLAVA_LAYERS`` of 32: each request's tokens; the attention
   kernels once a layer and forward (Gemma 3: the extend launches with
   spans once a layer and extend forward whose batch carries them); the
   first prompt with another image reuses only the text before its image
   and answers otherwise; kernel-path logits against the plain path's as
   the text engines'; the other image must move them by ``IMAGE_MOVE``
   times the reading, and on Gemma 3 leaving the spans out by ``SPAN_MOVE``
   times it. Llama-3.2-11B-Vision (``LLAMA32_11B_VISION``, its config.json:
   a tiled ViT of 32 + 8 layers at 560 px, four tiles of 1,601 patches;
   cross layers every fifth) at ``MLLAMA_LAYERS`` of its 40 decoder layers
   (self 0-2, cross 3, self 4-7, cross 8, self 9), the tower at full depth,
   not timed (``phase_mllama``): images at 1 x 1, 1 x 2 (2 of 4 tiles live)
   and 2 x 2 behind image-first prompts, one behind Llama 3's system and
   user headers, and a text request in one batch over ``MLLAMA_SLOTS``
   cross slots (two image requests wait for a freed slot); rows 3 and 1
   launch once a self layer and forward, the cross layers neither; the chat
   prompt with another image or none reuses no page of the chat request
   (its every row attends the image), and with its own image again reuses
   the prompt past it; the logits and image-move checks of ``phase_vlm``;
   the first cross layer against an unblocked reference; ``[mllama]``
   lines with the tower's ms an image, the cross buffer's GiB, the KV
   tokens and the card.
   Llama-3.1-8B with fp8 weights and fp8 KV (BASELINE config 4)
   at ``FP8_LAYERS`` of 32, not timed, with its weights' bytes against bf16.
   Tensor parallelism (``phase_tp``, ``[tp ...]`` lines): Llama-3.1-8B at
   full width and depth in bf16 at tp 1, then at tp 2 on the same weights
   (the engine spawns rank 1; both ranks on cuda:0 over gloo, since NCCL
   takes one rank a GPU), on bf16 and then int8 KV (8 layers since PR 23), each tp 1 engine freed
   before its ranks start: every rank's launches of the pool's decode and
   extend kernels (32 a forward of their mode, over 4 kv heads), its
   collectives (66 a forward) and its digests of the sampled ids and
   logprobs and of the gathered logits, which must equal the leader's;
   logits against tp 1 within ``LOGIT_RTOL`` and the argmax and (bf16) the
   greedy ids the same but at a tie; a decode step's wall and rank 0's
   device time at tp 1 and tp 2; and the four kernels at the rank's shapes,
   timed. The other text families at tp 2 (``phase_tp_families``,
   ``TP_FAMILIES``): Gemma-2-2B on bf16 and int8 KV, GPT-OSS-20B,
   Qwen3-30B-A3B (through ``attention_backend="pallas"``), Llama-4
   Scout and DeepSeek-V2-Lite, each at full width and its tp 1 engine's
   depth, held by the same checks (``check_tp_engine``) to the reference
   that its tp 1 engine gave just after its own phase (``tp_reference``):
   rows 1d/3d, 1dq/3dq, 1s/3s, 1c/3c and 9 once a layer a forward on each
   rank; two collectives a layer and forward plus two (GPT-OSS, whose
   experts are whole on every rank: one); every rank's router picks (MoE)
   equal to the leader's; the logits gated on the rows whose routing picked
   tp 1's experts, the others logged with the router's margins.
   The engines that are checked only and whose kernels other
   engines hold serve shorter request sets (``UNTIMED_REQUESTS``,
   ``TOPPINGS_REQUESTS``, ``GPT_OSS_W4_REQUESTS``, ``GEMMA3_REQUESTS``;
   ``mistral-7b-pallas`` the two prompts past its window);
   ``kv_cache_dtype="auto"`` must give W4 GPT-OSS-20B bf16 KV and W4
   Qwen3-30B-A3B int8, as the JAX rule does. Each serves greedy requests of different lengths, two that
   share a long prefix (radix hit), one longer than
   ``chunked_prefill_size``; Mistral-7B a 6,000-token prompt and a 4,090-token
   one whose decode crosses the window's edge (``WINDOW_REQUESTS``), and the
   window must move the long prompt's logits by at least ``WINDOW_MOVE``
   times the kernel-vs-plain reading against the plain path without it.
   Under ``pallas`` every decode launch goes through
   ``decode_attention_pallas``, under ``auto`` none. Toppings: after
   its own phase, the bf16 1B engine registers two LoRA adapters (rank 16,
   all seven targets, scaling 2.0) and one int8 delta adapter (q, v, gate
   and down of every layer) and serves the request set again with each
   request naming none or one of them (``1b-toppings``; the two prompts
   that share a prefix name different adapters and must not share KV); the
   W4A8 engine does the same after its W4A16 phase (``w4a8-toppings``);
   neither toppings engine is timed. The delta kernel must launch once per projection and layer of
   every forward whose batch names an adapter.
   Every kernel's launch count is set to 0 just before and read just
   after; attention must launch at least layers x forwards of its mode
   (the 8-bit kernels for an 8-bit pool, and the bf16 ones never there),
   each W4 kernel of the route (6 x layers + 1) x forwards. The model's
   logits on the kernel path are held against the plain path (plain
   attention, plain W4 GEMMs and the plain delta function; not for the 3B
   engine with bf16 KV, whose kernels the others hold) for each prompt's
   first generated token and one decode step after it (the toppings
   engines: one mixed batch of none, LoRA and delta rows, extend and one
   decode step, where each adapter must also move its rows' logits by at
   least ``ADAPTER_MOVE`` times the reading): the argmax must agree on every row but
   those whose plain top-2 logits are equal or adjacent bf16 values (the
   logits are bf16, so ties occur), and max
   |diff| must stay within LOGIT_RTOL of max |logit|. After each
   engine's checks, while all checks hold (but the toppings engines'): its
   decode tokens/s at batch 64 with 128-token prompts and 128 new tokens,
   and the device's busy share
   of its decode steps: device time per step over three decode windows
   of a profiled run (``torch.profiler``) against the timed run's wall per
   step; the trace of those windows, exported and read back by
   ``tools/analyze_trace.py``, gives ``[profile <label>]`` lines of device
   time by category and the top 5 ops.
   The decode tokens/s span the decode phase of the bench run, from the
   first window's dispatch to the last window's fetch (host work between
   windows included), with overlap at the engine's default: on, as the auto
   rule resolves it on the card. A timed run that records no window fails.
   Serving: after its own phase, the bf16 1B engine serves over HTTP
   (``phase_serve``): the port's ``ServerApp`` on 127.0.0.1, driven by
   ``urllib``: ``/health``; four sequential greedy completions (16 to 700
   prompt tokens) whose ids must equal ``Engine.generate`` of each prompt
   alone; 16 concurrent completions of 16 to 1,024 prompt tokens and 64 new
   tokens; a streamed completion whose deltas join to the unstreamed ids;
   echo scoring of prompt + [t1], whose last entry must agree with
   generate's logprob of t1 within ``ECHO_TOL`` (the entry before it, a
   planted off-by-one, must not); embeddings of unit norm, bit-equal on a
   repeat; ``/metrics`` histograms that are not empty; and the decode and
   extend kernels launched over the phase. ``[serve]`` lines give the
   requests, the wall and the server's own TTFT and ITL p50 and p99.
   Then the bench batch with overlap on and off in turns (``phase_overlap``,
   an ``[overlap 1b-bf16]`` line: decode tokens/s, device ms a step, busy
   share; each setting's profiled run must repeat its tokens), whose greedy
   tokens must be equal both ways. Then custom logit
   processors on the same engine (``phase_custom``, a ``[custom]`` line):
   one greedy batch whose rows ban their own free ids, take a per-row
   ``custom_params`` boost, or take no processor; no banned id appears, the
   rows boosted by 0 and those without a processor give their free ids, and
   no pipelined window carries a processor row. Constrained
   decoding follows the 1B toppings engine, on a Llama-3.2-1B bf16 engine
   built with ``tokenizer_path="chars"`` (``phase_grammar``, ``[grammar]``
   lines): regex, JSON-schema, EBNF (DFA and pushdown) and structural-tag
   requests through ``Engine.generate`` beside a free one and through the
   HTTP server (chat ``response_format``; completions' ``regex``, ``ebnf``,
   ``json_schema``), every output valid; a literal-heavy regex in fewer
   forwards than half its tokens; every state mask walked by the native
   ``fsm`` and ``pda`` libraries.
   Each engine's serving run, and the warm-up run of its bench batch,
   print a ``[prefill <label>]`` line: the extend forwards, their device ms
   (CUDA-event spans) and their wall ms (``tools/prefill_ab.py::
   PrefillTimer``).
   Phases 3 and 4 record a failed check and go on, so that a faulty
   kernel still shows every reading; the script exits non-zero after
   phase 4 if any check failed.
5. times, with the engines freed: each kernel's median device time at the
   main path's shapes, beside its bound (bytes at 3.35 TB/s, or operations
   at 989 TFLOP/s bf16 / 1,979 TOPS int8, whichever is larger), its plain
   version's time and one PyTorch call as a yardstick the port never calls
   (``scaled_dot_product_attention`` on K/V gathered dense, and dequantized
   to bf16, beforehand; ``torch.matmul`` of bf16 x with the weight
   dequantized to bf16 beforehand; for the delta kernel ``torch.bmm`` of
   each delta slot's rows with its panel dequantized and scaled to bf16
   beforehand), at 1B decode (bs 64, one and three delta slots) and one
   2048-token prefill chunk; decode at every shape of ``DECODE_TIMED``, B 1
   (split across the card) at 4096 and 8192 tokens among them. At
   GPT-OSS-20B's (G 8, head_dim 64), with its sinks and, in turns, without
   them (``DECODE_TIMED_SINKS``; extend at 64 x (128, 128) and a 2048-token
   chunk on 8192 with and without its window of 128; no library call
   computes a sink). At Llama-4 Scout's (G 5, head_dim 128) with its chunk
   of 8192 and, in turns, without it: decode at bs 64 and B 1 at ctx 12,000
   (3,808 live keys a row), extend over positions 6,952 to 8,999 (across the
   edge) and at 64 x (128, 128); the bound counts the chunk's keys and
   pairs only, the library call masks the chunk. At
   Gemma-2-2B's (G 2, Hkv 4, head_dim 256): decode at bs 64, ctx 4096 and
   8192 with its window of 4096, and B 1 at 8192 (``DECODE_TIMED_256``);
   extend at 64 x (128, 128) and a 2048-token chunk on 8192 with W 4096;
   and rows 1dq and 3dq there on int8 and fp8 pages, each beside the bf16
   pages it was quantized from in turns (``DECODE_TIMED_256_8BIT``; extend
   at 64 x (128, 128) and the 2048-token chunk on 8192 with W 4096). Rows
   3m and 3qm at Gemma-3-4B's shape (G 2, Hkv 4, D 256): a 2,048-token
   prompt holding seven 256-token spans (``GEMMA3_SPANS``), without a
   window and with its local 1024 (bf16), and on int8 and fp8 pages, each
   with and without the spans in turns; the library call takes the spans
   in its boolean mask. At Mistral-7B's shape: decode at bs 64 and ctx
   4096 and 8192 without a window and 8192 with W 4096 (through both
   wrappers), the 2048-token extend chunk on 4096, 5120 and 8192 tokens
   without a window and on 8192 with it; the bound counts the live window
   only, the library call masks the window. And the host's microseconds per
   ``write_kv`` call into a bf16, int8 and fp8 pool. Then the
   kernel-profiling entry point, this slice's main path:
   ``tools/decode_ablate.py``'s ``main`` with its defaults, every launch
   count set to 0 just before and read just after; the probe must launch in
   every mode, 16 layers a chain, and the stage cuts and the decode kernel
   must launch. It prints the mode table (each mode's ms per 16 chained
   layers at the JAX probe's shape, its plain version's and its bounds) and
   the stage table (each cut's ms at the 1B, 3B and 7B decode shapes beside
   the full decode's bound). And ``tools/w4_kernel_bench.py``'s ``main``
   with ``--route a8`` at GPT-OSS's widths (groups of 120 and 100), which
   must launch the wgmma kernel (``w4a8_matmul``, split steps) and never
   the ``mma.sync`` one, then at a group of 24, which must launch
   ``w4a8_matmul_mma``, counted the same way.
6. one JSON line with every kernel's numbers (the tensor-parallel rows with
   each rank's launches), one with the engines', one with the serving,
   grammar, custom-processor, spec, memory and tensor-parallel phases', the
   ``nvidia-smi`` line, and as the last line
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

from scratchpad_tpu_torch.tools.prefill_ab import MISTRAL_7B, PrefillTimer
from scratchpad_tpu_torch.tools.timing import BF16_FLOPS, bound_ms, device_ms

ROOT = Path(__file__).resolve().parent
# H100 SXM, dense (the memory rate and the bf16 rate are in tools/timing.py)
INT8_OPS = 1979e12
# Kernel vs plain version. Every kernel accumulates in f32 and rounds only
# its output to bf16, which moves a value by at most 2**-8 of itself; ATOL
# covers the order of the f32 sums. A kernel that drops one page of a
# 4096-token context misses this by far (PERF.md, Findings).
ATOL, RTOL = 1e-4, 2.0**-8
# Kernel-path vs plain-path logits, relative to the largest |logit|, by
# engine. bf16 and W4A16: each path rounds its attention and GEMM outputs
# to bf16 on its own, and the difference grows through 16 layers of random
# weights. Sound kernels read up to 1.585e-2 (bf16) and 1.812e-2 (W4A16); a
# decode kernel that drops its last page reads 5.2e-2 to 0.38, one that
# drops a page of the prefill 0.37 to 0.73 (PERF.md, Findings). W4A8 adds
# the int8 rounding of every GEMM's input: a bf16 ulp of difference
# upstream moves an x8 by one, and that moves an output by ax * |w|; sound
# kernels read up to 5.036e-2 there.
# The 8-bit KV engines quantize each new K/V row on each path, so a bf16
# ulp upstream moves a code by one, as an x8 of W4A8. Sound kernels read
# 5.500e-2 (3B W4A8, int8 KV) and 1.916e-2 (1B bf16, fp8 KV); a decode kernel
# without the V scale, or an extend kernel that scales V by the K scale,
# gives worst readings of 0.515 to 0.796 in both, and fp8 decode without
# the sign bit 1.526 (PERF.md, Findings). The 3B engine with bf16 KV is not
# compared. GPT-OSS-20B (held at the kernel path's routing, see
# SameRouting): its witness (phase_engine's ``witness``) shows the first
# layer's attention outputs differing from the plain path's at 0.1 % to
# 0.2 % of their elements, by one bf16 ulp, and the gap growing layer by
# layer; at its full 24 layers it read 3.036e-2 against 3.378e-2 for the
# plain path with one-ulp noise at that share, and took 5e-2. At its
# GPT_OSS_LAYERS (4) it reads 1.897e-2 against the control's 2.038e-2, so
# it takes the bf16 engines' 3e-2 again. The other engines cut in depth
# take gates near 1.5 to 3 times their cut readings (PERF.md, Findings):
# DeepSeek-V2-Lite at DEEPSEEK_LAYERS 1.298e-2 (control 1.486e-2), 2e-2;
# Gemma-2-2B at GEMMA2_LAYERS 4.665e-3, 1e-2; its int8 and fp8 KV engines
# at GEMMA_KV8_LAYERS 3.205e-3 and 3.895e-3, 1e-2.
LOGIT_RTOL = {
    "bf16": 3e-2, "w4a8": 1e-1, "w4a16": 3e-2, "3b-w4a8": 1e-1, "1b-fp8kv": 5e-2,
    "1b-toppings": 5e-2, "w4a8-toppings": 1e-1, "mistral-7b": 3e-2, "mistral-7b-pallas": 3e-2,
    "qwen3-8b": 3e-2, "qwen3-8b-w4a8": 1e-1, "gemma-2-2b": 1e-2, "gemma-3-1b": 3e-2,
    "gpt-oss-20b": 3e-2, "gpt-oss-w4a8": 1e-1, "gpt-oss-w4a16": 1e-1, "qwen3-30b-a3b": 3e-2,
    "llama4-scout": 3e-2, "apertus-8b": 3e-2, "gemma-2-2b-int8kv": 1e-2, "gemma-2-2b-fp8kv": 1e-2,
    "deepseek-v2-lite": 2e-2, "qwen2-vl-2b": 3e-2, "gemma-3-4b-mm": 3e-2, "gemma-3-4b-mm-fp8kv": 1e-1,
    "llava-1.5-7b": 3e-2, "llama-3.1-8b-fp8": 1e-1, "llama-3.2-11b-vision": 3e-2,
    # tensor parallelism: Llama-3.1-8B at tp 2 against tp 1 on the same
    # weights (phase_tp), the bf16 engines' and the 8-bit KV engines' gates
    "llama-3.1-8b-tp2": 3e-2, "llama-3.1-8b-tp2-int8kv": 1e-1,
    # the other text families at tp 2 against their tp 1 engines
    # (phase_tp_families), the same gates
    "gemma-2-2b-tp2": 3e-2, "gemma-2-2b-tp2-int8kv": 1e-1, "gpt-oss-20b-tp2": 3e-2,
    "qwen3-30b-a3b-tp2": 3e-2, "llama4-scout-tp2": 3e-2,
    "deepseek-v2-lite-tp2": 3e-2,
    # quantized weights at tp 2 against their tp 1 engines (phase_tp_quant),
    # the same gates by KV pages, 3e-2 on bf16 KV and 1e-1 on 8-bit, and
    # the 8-bit gate for W4A8 on bf16 KV too: each engine quantizes its own
    # activation rows at int8, as an 8-bit KV engine its K/V rows. On one
    # H100 the 8B pair read 6.163e-2 with each rank's partial product of o
    # and down rounded to bf16, 3.804e-2 with it kept f32 until the group's
    # sum, as now, and its twin's own kernel and plain paths 4.892e-2 apart
    # on the same codes (PERF.md, Findings)
    "llama-3.1-8b-w4a8-tp2": 1e-1, "gpt-oss-20b-w4a8-tp2": 1e-1, "gpt-oss-20b-w4a16-tp2": 1e-1,
    "llama-3.1-8b-fp8-tp2": 1e-1,
}
# The argmax must agree on every row but a bf16 tie at the top. W4A8 also
# excuses a row whose plain top-2 gap is at most this share of max |logit|:
# its sound kernels flip one row of the request set at a gap of 1.439e-2
# (PERF.md, Findings). A flip needs the two logits' differences to sum to
# the gap, so an excuse that scales with the row's own max |diff| would
# pass every flip; this one is a fixed floor. The 8-bit KV engines take it
# too, since each path quantizes its own K/V rows. Qwen3-8B W4A8 (8 layers,
# int8 KV) takes the toppings engines' 3e-2: its sound kernels flip a row
# at a gap of 2.128e-2, with max |diff| 5.0e-2 (PERF.md, Findings). The
# W4 GPT-OSS engines (int8 KV, both routes) take the same 1e-1 and 3e-2;
# GPT-OSS-20B the 8-bit engines' 2e-2: at its full 24 layers its kernel
# path flipped rows at plain top-2 gaps of 7.463e-3 to 1.429e-2, and its
# witness's control (the plain path with one-ulp noise) one at 7.463e-3
# (PERF.md, Findings).
ARGMAX_FLOOR = {
    "bf16": 0.0, "w4a8": 2e-2, "w4a16": 0.0, "3b-w4a8": 2e-2, "1b-fp8kv": 2e-2,
    "1b-toppings": 3e-2, "w4a8-toppings": 3e-2, "mistral-7b": 0.0, "mistral-7b-pallas": 0.0,
    "qwen3-8b": 0.0, "qwen3-8b-w4a8": 3e-2, "gemma-2-2b": 0.0, "gemma-3-1b": 0.0,
    "gpt-oss-20b": 2e-2, "gpt-oss-w4a8": 3e-2, "gpt-oss-w4a16": 3e-2, "qwen3-30b-a3b": 0.0,
    "llama4-scout": 0.0, "apertus-8b": 0.0, "gemma-2-2b-int8kv": 2e-2, "gemma-2-2b-fp8kv": 2e-2,
    "deepseek-v2-lite": 0.0, "qwen2-vl-2b": 0.0, "gemma-3-4b-mm": 0.0, "gemma-3-4b-mm-fp8kv": 2e-2,
    "llava-1.5-7b": 0.0, "llama-3.1-8b-fp8": 2e-2, "llama-3.2-11b-vision": 0.0,
    # the spec engines' tokens against the target's teacher-forced chain
    # (phase_spec), one extend of prompt + output: a path of other shapes
    # than the decode steps and verify forwards that chose them, so the
    # gap is that of two bf16 paths, not of a kernel and its plain version.
    # The bf16 engines take GPT-OSS-20B's 2e-2: the same engines' plain
    # decode, teacher-forced alike (phase_spec's control), part from the
    # chain at top-2 gaps of 1.471e-2 (1B) and 1.299e-2 (8B), as speculation
    # does (1.471e-2 at the 1B); the W4A8 int8-KV engine Qwen3-8B W4A8's 3e-2
    # (PERF.md, Findings)
    "1b-ngram": 2e-2, "1b-draft-self": 2e-2, "8b-draft-1b": 2e-2, "8b-eagle": 2e-2, "8b-w4a8-ngram": 3e-2,
    # tp 2 against tp 1 (phase_tp): two bf16 paths as well, since tp 2 rounds
    # each rank's partial product of o and down to bf16 where tp 1 rounds
    # one sum, so they take the spec engines' 2e-2; the int8 pair too, as
    # the 8-bit KV engines
    "llama-3.1-8b-tp2": 2e-2, "llama-3.1-8b-tp2-int8kv": 2e-2,
    "gemma-2-2b-tp2": 2e-2, "gemma-2-2b-tp2-int8kv": 2e-2, "gpt-oss-20b-tp2": 2e-2,
    "qwen3-30b-a3b-tp2": 2e-2, "llama4-scout-tp2": 2e-2,
    "deepseek-v2-lite-tp2": 2e-2,
    "llama-3.1-8b-w4a8-tp2": 2e-2, "gpt-oss-20b-w4a8-tp2": 2e-2, "gpt-oss-20b-w4a16-tp2": 2e-2,
    "llama-3.1-8b-fp8-tp2": 2e-2,
}
# A spec engine may excuse as ties at most this many more of its tokens
# than its plain-decode control excuses of the same requests' tokens (both
# teacher-forced alike), so that the floor above cannot hide a verify path
# that shifts the logits: each excused token is a bf16 rounding event of
# either chain, and the five engines' counts were at or under their
# controls' (PERF.md, Findings).
SPEC_TIE_SLACK = 4
# Each adapter must move its rows' logits (max|adapted - base| / max|base|)
# by at least this many times the engine's kernel-vs-plain reading, so that
# a kernel that adds nothing fails.
ADAPTER_MOVE = 10.0
# The same for a sliding window: the kernel path's logits of a prompt longer
# than the window against the plain path's without the window, so that a
# window that masks nothing fails.
WINDOW_MOVE = 10.0
# The same for attention sinks: the kernel path's logits against the plain
# path's without the sinks (GPT-OSS), so that sinks the kernels drop fail;
# on the prompts that fit the local window, where every layer's softmax
# holds at most that many keys beside the sink (on longer prompts a sink of
# N(0, 2^2) weighs less against a global layer's sum: logged, not gated).
SINK_MOVE = 10.0
# The same for Llama-4's chunked attention: the kernel path's logits of each
# row whose query sits past the first chunk's edge against the plain path's
# without the chunk (every layer global), so that a chunk that masks
# nothing fails.
CHUNK_MOVE = 10.0
# The same for DeepSeek's latent attention, whose "plain path" is HF's
# expanded form (``ExpandedMla``): that form without the q_rope . k_rope term
# of its scores must move the logits by this many times the reading, so
# that a yardstick blind to the rope half of the latent fails.
ROPE_MOVE = 10.0
# the toppings engines' requests, in the order of phase_engine's prompts
# and its second request: the last two share a 600-token prefix under
# different adapters
TOPPINGS = ["ad1", "dl1", None, "ad2", "ad1", "dl1", "ad2", "dl1"]
FAILURES: list[str] = []


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(ok: bool, msg: str) -> None:
    """Record a failed correctness check and go on (see phase 4)."""
    if not ok:
        print(f"chip_smoke CHECK FAILED: {msg}", file=sys.stderr, flush=True)
        FAILURES.append(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# --------------------------------------------------------------- helpers


def seeded(seed: int):
    import torch

    return torch.Generator(device="cuda").manual_seed(seed)


def make_pool(lens, Hkv, D, ps, layers, gen):
    """Random bf16 K/V pools [layers, pages, ps, Hkv, D] and a page table
    whose pages are shuffled; page 0 is the dump page, like the engine's."""
    import torch

    B = len(lens)
    need = [max(-(-n // ps), 1) for n in lens]
    total = sum(need) + 1
    perm = torch.randperm(total - 1, generator=gen, device="cuda") + 1
    pt = torch.zeros(B, max(need), dtype=torch.int32, device="cuda")
    o = 0
    for b, n in enumerate(need):
        pt[b, :n] = perm[o : o + n].to(torch.int32)
        o += n
    shape = (layers, total, ps, Hkv, D)
    k = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    return k, v, pt


def quant_pages(k, v, kind: str):
    """bf16 pages as they are (``kind`` "bf16"), or as int8 / fp8 codes with
    bf16 scales through the KV quantizer: (k, v, k_scale, v_scale). V is
    scaled down first, so that K and V scales differ."""
    import torch

    from scratchpad_tpu_torch.ops.attention import quantize_rows

    if kind == "bf16":
        return k, v, None, None
    code = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}[kind]
    kc, ks = quantize_rows(k, code)
    vc, vs = quantize_rows(v * 0.05, code)
    return kc, vc, ks, vs


def at(t, l: int):
    return None if t is None else t[l]


def decode_kernel(q, k, v, ks, vs, pt, lens, scale, cap=None, window=None, sinks=None, chunk=None):
    """The decode wrapper of the pages' kind."""
    from scratchpad_tpu_torch.ops.attention import paged_decode_attention, paged_decode_attention_quant

    if ks is None:
        return paged_decode_attention(q, k, v, pt, lens, scale, cap, window, sinks, chunk)
    return paged_decode_attention_quant(q, k, v, ks, vs, pt, lens, scale, cap, window, sinks, chunk)


def extend_kernel(q, k, v, ks, vs, pt, kv_lens, cu, scale, cap=None, window=None, sinks=None, chunk=None,
                  spans=None):
    from scratchpad_tpu_torch.ops.attention import paged_extend_attention, paged_extend_attention_quant

    if ks is None:
        return paged_extend_attention(q, k, v, pt, kv_lens, cu, scale, cap, window, sinks, chunk, spans)
    return paged_extend_attention_quant(q, k, v, ks, vs, pt, kv_lens, cu, scale, cap, window, sinks, chunk,
                                        spans)


# kernel of each attention route, by the pages' kind
DECODE = {"bf16": "paged_decode_attention", "int8": "paged_decode_attention_quant",
          "fp8": "paged_decode_attention_quant"}
EXTEND = {"bf16": "paged_extend_attention", "int8": "paged_extend_attention_quant",
          "fp8": "paged_extend_attention_quant"}


def max_err(out, ref) -> tuple[float, float]:
    """max |out - ref| and the largest ratio of |out - ref| to its
    tolerance (<= 1 passes); ``ref`` is the plain version's f32 output."""
    d = (out.float() - ref).abs()
    ratio = d / (ATOL + RTOL * ref.abs())
    return float(d.max()), float(ratio.max())


# ------------------------------------------------------------ phase 1 & 2


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def phase_device():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA device")
    name = torch.cuda.get_device_name(0)
    smi_line = card_line()
    log(
        f"[device] {name}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.device_count()} device(s)"
    )
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return name, smi_line


def sass_counts(sass: str, opcodes) -> dict:
    """How many instructions of each opcode a ``cuobjdump --dump-sass``
    listing holds (``/*0280*/ @!P1 HGMMA.64x64x16.F32.BF16 ...``)."""
    ops = []
    for line in sass.splitlines():
        words = line.split("*/", 1)[1].split() if line.lstrip().startswith("/*") and "*/" in line else []
        words = [w for w in words if not w.startswith("@")]
        if words:
            ops.append(words[0].split(".")[0])
    return {op: ops.count(op) for op in opcodes}


# the libraries whose SASS phase 2 counts: the decode and extend kernels,
# the three GEMMs on csrc/sm90_gemm.cuh, which must hold wgmma (the
# integer IGMMA for W4A8, HGMMA for the others) and asynchronous copies,
# and the ablation probe; the decode kernel and the probe a tensor-core
# instruction (HMMA: mma.sync) and an asynchronous copy (LDGSTS: cp.async,
# UTMALDG: a TMA load, UBLKCP: a bulk copy)
SASS_LIBRARIES = ("paged_decode_attention", "paged_extend_attention", "w4a8_matmul", "w4a16_matmul",
                  "delta_matmul", "decode_ablate")
HMMA_LIBRARIES = ("paged_decode_attention", "decode_ablate")
# the W4 kernels' instantiations for groups that cut a tensor-core step
# (split steps), by a piece of their mangled names, and the wgmma each must
# hold: W4A16's mainloop op W4Op<BN, 5, true>, W4A8's W4A8Op<128, 5, true>
# and its decode kernel <NT, 1, true>
SPLIT_FUNCTIONS = {
    "w4a16_matmul": (("W4OpILi64ELi5ELb1E", "W4OpILi128ELi5ELb1E", "W4OpILi256ELi5ELb1E"), "HGMMA"),
    "w4a8_matmul": (("W4A8OpILi128ELi5ELb1E", "w4a8_decode_kernelILi8ELi1ELb1E", "w4a8_decode_kernelILi16ELi1ELb1E",
                     "w4a8_decode_kernelILi32ELi1ELb1E", "w4a8_decode_kernelILi64ELi1ELb1E"), "IGMMA"),
}


def sass_functions(sass: str) -> dict:
    """A ``cuobjdump --dump-sass`` listing cut into its functions: {mangled
    name: its lines}."""
    funcs, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            funcs[name] = []
        elif name is not None:
            funcs[name].append(line)
    return {n: "\n".join(lines) for n, lines in funcs.items()}
SASS_OPCODES = ("HGMMA", "IGMMA", "HMMA", "IMMA", "LDGSTS", "UTMALDG", "UBLKCP")
ASYNC_COPIES = ("LDGSTS", "UTMALDG", "UBLKCP")


def phase_build():
    from scratchpad_tpu_torch.ops.attention.gqa_decode import DECODE_STAGE_TARGETS
    from scratchpad_tpu_torch.utils import native

    t0 = time.monotonic()
    report = native.build(native.KERNEL_SOURCES + DECODE_STAGE_TARGETS)
    for name, r in report.items():
        log(f"[build] {name}: {r['seconds']:.1f} s")
        entry = ""  # the kernel (mangled name) ptxas reports on
        for line in r["log"].splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line.strip()
            elif any(w in line for w in ("registers", "spill", "error", "warning")):
                log(f"[build]   {entry}: {line.strip()}" if "registers" in line or "spill" in line
                    else f"[build]   {line.strip()}")
    log(f"[build] all kernels in {time.monotonic() - t0:.1f} s")
    # the grammar backend's host libraries (csrc/fsm.cpp, csrc/pda.cpp)
    for name, r in native.build_host().items():
        log(f"[build] {name} ({native.host_compiler()}): {r['seconds']:.1f} s {r['log'].strip()}")
    # what the tensor-core kernels run on: products (HGMMA and IGMMA are
    # wgmma over bf16 and int8, HMMA and IMMA mma.sync) and asynchronous
    # copies (LDGSTS is cp.async, UTMALDG a TMA load), counted in their SASS
    for name in SASS_LIBRARIES:
        lib = native._lib_path(name)
        sass = subprocess.run(
            [str(Path(native.nvcc_path()).parent / "cuobjdump"), "--dump-sass", str(lib)],
            capture_output=True, text=True, timeout=300,
        )
        count = sass_counts(sass.stdout, SASS_OPCODES)
        log(f"[sass] {lib.name}: " + ", ".join(f"{op} {n}" for op, n in count.items()))
        if name in SPLIT_FUNCTIONS:
            pieces, wgmma = SPLIT_FUNCTIONS[name]
            funcs = sass_functions(sass.stdout)
            for piece in pieces:
                found = [f for f in funcs if piece in f]
                n = sum(sass_counts(funcs[f], (wgmma,))[wgmma] for f in found)
                log(f"[sass]   split steps, {piece}: {len(found)} function(s), {wgmma} {n}")
                if not found or n == 0:
                    fail(f"the {name} library's split-step instantiation {piece} has no {wgmma}")
        if sass.returncode != 0 or count["HGMMA"] + count["IGMMA"] + count["HMMA"] + count["IMMA"] == 0:
            fail(f"the {name} library has no tensor-core instruction (cuobjdump rc {sass.returncode})")
        copies = sum(count[op] for op in ASYNC_COPIES)
        if name in HMMA_LIBRARIES:
            if count["HMMA"] + count["HGMMA"] == 0 or copies == 0:
                fail(f"the {name} library has no HMMA or HGMMA or no asynchronous copy: {count}")
            continue
        wgmma = "IGMMA" if name == "w4a8_matmul" else "HGMMA"
        if name != "paged_extend_attention" and (count[wgmma] == 0 or copies == 0):
            fail(f"the {name} library has no {wgmma} (wgmma) or no asynchronous copy: {count}")


# --------------------------------------------------------------- phase 3


# B and contexts of the decode checks: one row (split across 256 CTAs at
# 4096 tokens), two, and the bench's 64; contexts on either side of a page
# (and a 16-token slice) edge, a short and a long one
DECODE_CHECK_B = (1, 2, 64)
DECODE_CHECK_CTX = (1, 15, 16, 17, 256, 4096)


def split_edge_lens(ctx: int, Hkv: int, D: int, G: int, window=None, batch: int = 4) -> list[int]:
    """Four rows of a page table ``ctx`` tokens wide whose last token (or,
    with ``window``, the window's first) falls one token before, on and one
    token after a boundary of ``decode_plan``'s splits, beside a row of
    ``ctx``; the plan is that of ``batch`` rows (these four and any the
    caller adds)."""
    from scratchpad_tpu_torch.ops.attention.gqa_decode import decode_plan

    plan = decode_plan(batch, Hkv, -(-ctx // 16), D, G)
    span = plan.split_pages * 16
    if plan.splits < 2 or span + (window or 0) + 1 > ctx:
        raise ValueError(f"no split boundary to test at ctx {ctx}, window {window}: {plan}")
    edge = span * max(1, (ctx - (window or 0) - 1) // span // 2) + (window or 0)
    return [ctx, edge - 1, edge, edge + 1]


def decode_lens(case, gen, D: int, G: int):
    """Row lengths of a decode check: ``(B, ctx)`` rows of ctx // 2 to ctx
    tokens, the first of ctx; "padding" rows of 0 beside real ones; "split
    edges" (``split_edge_lens`` at 4096 tokens)."""
    import torch

    if case == "padding":
        lens = [300, 0, 17, 0]
    elif case == "split edges":
        lens = split_edge_lens(4096, 8, D, G)
    else:
        B, ctx = case
        t = torch.randint(ctx // 2, ctx + 1, (B,), generator=gen, device="cuda")
        t[0] = ctx
        return t.to(torch.int32)
    return torch.tensor(lens, dtype=torch.int32, device="cuda")


def check_decode(errs: dict) -> None:
    """bf16, int8 and fp8 pages; G = 4 (Hq 32) and G = 3 (Hq 24) over Hkv 8;
    head_dim 64 and 128; B 1, 2 and 64 at each context of
    ``DECODE_CHECK_CTX``, a batch with padding rows, which must come out as
    exact zeros, and rows ending one token before, on and after a boundary
    of the plan's splits. Where the plan splits a row, a second call must
    give the same bits."""
    import torch

    from scratchpad_tpu_torch.ops.attention import paged_decode_attention_plain
    from scratchpad_tpu_torch.ops.attention.gqa_decode import decode_plan

    Hkv, ps = 8, 16
    seed = 0
    for kind in ("bf16", "int8", "fp8"):
        for G in (4, 3):
            for D in (64, 128):
                cases = [(B, ctx) for B in DECODE_CHECK_B for ctx in DECODE_CHECK_CTX]
                for case in cases + ["padding", "split edges"]:
                    seed += 1
                    gen = seeded(seed)
                    lens = decode_lens(case, gen, D, G)
                    k, v, pt = make_pool(lens.tolist(), Hkv, D, ps, 1, gen)
                    k, v, ks, vs = quant_pages(k[0], v[0], kind)
                    q = torch.randn(len(lens), Hkv * G, D, generator=gen, device="cuda").to(torch.bfloat16)
                    scale = 1.0 / math.sqrt(D)
                    out = decode_kernel(q, k, v, ks, vs, pt, lens, scale)
                    ref = paged_decode_attention_plain(q.float(), k, v, pt, lens, scale, ks, vs)
                    plan = decode_plan(len(lens), Hkv, pt.shape[1], D, G)
                    same = plan.splits == 1 or torch.equal(out, decode_kernel(q, k, v, ks, vs, pt, lens, scale))
                    torch.cuda.synchronize()
                    e, ratio = max_err(out, ref)
                    zero = bool((out[lens == 0] == 0).all())
                    errs[DECODE[kind]] = max(errs[DECODE[kind]], e)
                    what = case if isinstance(case, str) else f"B={case[0]} ctx={case[1]}"
                    log(
                        f"[check] decode {kind} G={G} D={D} {what}: max_abs_err {e:.3e}, "
                        f"max err/tol {ratio:.3f} (tol {ATOL}+{RTOL}*|ref|), zero rows exact: {zero}"
                        + (f"; {plan.splits} splits, second call bit-equal: {same}" if plan.splits > 1 else "")
                    )
                    check(
                        ratio <= 1 and zero,
                        f"{kind} decode kernel disagrees with its plain version at G={G} D={D} {what}",
                    )
                    check(same, f"{kind} decode kernel's split calls differ at G={G} D={D} {what}")


def extend_case(chunks, D, T_pad, seed, G=4, Hkv=8):
    """chunks: (q_len, kv_len) per sequence; tokens past the chunks up to
    T_pad are padding."""
    import torch

    gen = seeded(seed)
    ps = 16
    q_lens = [c[0] for c in chunks]
    kv_lens = torch.tensor([c[1] for c in chunks], dtype=torch.int32, device="cuda")
    cu = torch.zeros(len(chunks) + 1, dtype=torch.int32, device="cuda")
    cu[1:] = torch.cumsum(torch.tensor(q_lens, device="cuda"), 0).to(torch.int32)
    T = max(T_pad, sum(q_lens))
    k, v, pt = make_pool(kv_lens.tolist(), Hkv, D, ps, 1, gen)
    q = torch.randn(T, Hkv * G, D, generator=gen, device="cuda").to(torch.bfloat16)
    return q, k[0], v[0], pt, kv_lens, cu


def check_extend(errs: dict) -> None:
    import torch

    from scratchpad_tpu_torch.ops.attention import paged_extend_attention_plain

    cases = [
        # fresh prompt, chunk after a cached prefix, short tail, decode-like row
        ([(1000, 1000), (512, 2560), (7, 1031), (1, 300)], 2048),
        # a chunked prefill's second chunk next to fresh prompts, T = 4096
        ([(2048, 4096), (1500, 1500), (300, 845), (200, 200)], 4096),
    ]
    seed = 200
    worst = 0.0
    for kind in ("bf16", "int8", "fp8"):
        for G in (4, 3):
            for D in (64, 128):
                for chunks, T_pad in cases:
                    seed += 1
                    q, k, v, pt, kv_lens, cu = extend_case(chunks, D, T_pad, seed, G)
                    k, v, ks, vs = quant_pages(k, v, kind)
                    scale = 1.0 / math.sqrt(D)
                    out = extend_kernel(q, k, v, ks, vs, pt, kv_lens, cu, scale)
                    ref = paged_extend_attention_plain(q.float(), k, v, pt, kv_lens, cu, scale, ks, vs)
                    torch.cuda.synchronize()
                    e, ratio = max_err(out, ref)
                    n_real = int(cu[-1])
                    zero = bool((out[n_real:] == 0).all())
                    errs[EXTEND[kind]] = max(errs[EXTEND[kind]], e)
                    worst = max(worst, ratio)
                    log(
                        f"[check] extend {kind} G={G} D={D} chunks={chunks} T={q.shape[0]}: "
                        f"max_abs_err {e:.3e}, max err/tol {ratio:.3f}, {q.shape[0] - n_real} "
                        f"padded tokens zero: {zero}"
                    )
                    check(
                        ratio <= 1 and zero,
                        f"{kind} extend kernel disagrees with its plain version at G={G} D={D} chunks={chunks}",
                    )
    log(f"[check] extend: worst err/tol {worst:.3f} over {seed - 200} cases")


# (logit_cap, sliding_window) of the windowed checks at Mistral-7B's shape:
# a cap alone, a window on a page edge (4096), edges inside a page and a
# 64-token KV tile (1000), both, and a window of one token
CAPS_WINDOWS = [(None, None), (50.0, None), (None, 4096), (None, 1000), (30.0, 1000), (None, 1)]
CAPS_WINDOWS_8BIT = [(30.0, 1000), (None, 4096)]
# the windows whose first token the split-edge rows put one token before, on
# and one after a boundary of the decode plan's splits
SPLIT_EDGE_WINDOWS = (1000, 4096)
# q of the capped checks is scaled up so that scores reach the cap: at the
# N(0, 1) scores of unit q and K, a cap of 30 moves a score by under 1e-2,
# and a kernel that skips the cap read only 4.95x the tolerance (PERF.md,
# Findings)
CAP_Q_SCALE = 8.0


def capped_q(q, cap):
    return q if cap is None else (q.float() * CAP_Q_SCALE).to(q.dtype)


def cap_window(cap, window) -> str:
    return f"cap={cap} W={window}"


def check_window_decode(errs: dict) -> None:
    """The decode kernels with a soft cap and a static window at Mistral-7B's
    shape (Hq 32, Hkv 8, D 128, page 16): B 1 and 64 at contexts 256, 4096
    and 8192 (B 64 with two rows of length 0 and one of length 1), and a
    batch of padding rows; bf16 pages at every (cap, W) of ``CAPS_WINDOWS``,
    int8 and fp8 pages at those of ``CAPS_WINDOWS_8BIT``."""
    import torch

    from scratchpad_tpu_torch.ops.attention import paged_decode_attention_plain

    from scratchpad_tpu_torch.ops.attention.gqa_decode import decode_plan

    Hkv, G, D, ps = 8, 4, 128, 16
    scale = 1.0 / math.sqrt(D)
    seed = 10_000
    for kind, grid in (("bf16", CAPS_WINDOWS), ("int8", CAPS_WINDOWS_8BIT), ("fp8", CAPS_WINDOWS_8BIT)):
        cases = [(B, ctx) for B in (1, 64) for ctx in (256, 4096, 8192)]
        for case in cases + ["padding"] + [("split edges", w) for w in SPLIT_EDGE_WINDOWS]:
            seed += 1
            gen = seeded(seed)
            if case == "padding":
                lens = torch.tensor([5000, 0, 17, 0], dtype=torch.int32, device="cuda")
            elif case[0] == "split edges":
                lens = torch.tensor(split_edge_lens(8192, Hkv, D, G, case[1]), dtype=torch.int32, device="cuda")
            else:
                B, ctx = case
                lens = torch.randint(ctx // 2, ctx + 1, (B,), generator=gen, device="cuda")
                lens[0] = ctx
                if B > 1:
                    lens[-3:] = torch.tensor([0, 1, 0], device="cuda")
                lens = lens.to(torch.int32)
            k, v, pt = make_pool(lens.tolist(), Hkv, D, ps, 1, gen)
            k, v, ks, vs = quant_pages(k[0], v[0], kind)
            q = torch.randn(len(lens), Hkv * G, D, generator=gen, device="cuda").to(torch.bfloat16)
            plan = decode_plan(len(lens), Hkv, pt.shape[1], D, G)
            for cap, window in grid:
                if case[0] == "split edges" and window != case[1]:
                    continue  # those rows put this window's edge on the splits' boundaries
                qc = capped_q(q, cap)
                out = decode_kernel(qc, k, v, ks, vs, pt, lens, scale, cap, window)
                ref = paged_decode_attention_plain(qc.float(), k, v, pt, lens, scale, ks, vs, cap, window)
                same = plan.splits == 1 or torch.equal(
                    out, decode_kernel(qc, k, v, ks, vs, pt, lens, scale, cap, window))
                torch.cuda.synchronize()
                e, ratio = max_err(out, ref)
                zero = bool((out[lens == 0] == 0).all())
                errs[DECODE[kind]] = max(errs[DECODE[kind]], e)
                what = case if isinstance(case, str) else (
                    f"split edges {lens.tolist()}" if case[0] == "split edges" else f"B={case[0]} ctx={case[1]}")
                log(
                    f"[check] decode {kind} Mistral shape {what} {cap_window(cap, window)}: "
                    f"max_abs_err {e:.3e}, max err/tol {ratio:.3f}, zero rows exact: {zero}"
                    + (f"; {plan.splits} splits, second call bit-equal: {same}" if plan.splits > 1 else "")
                )
                check(
                    ratio <= 1 and zero,
                    f"{kind} decode kernel disagrees with its plain version at the Mistral shape "
                    f"{what} {cap_window(cap, window)}",
                )
                check(same, f"{kind} decode kernel's split calls differ at the Mistral shape {what} "
                            f"{cap_window(cap, window)}")
            del k, v, ks, vs


def check_window_extend(errs: dict) -> None:
    """The extend kernels with (cap, W) of (None, 4096) and (30, 1000) at
    Mistral-7B's shape: a 2048-token chunk on 6,000 cached tokens, and mixed
    chunks whose window edge falls inside a query tile and inside a page,
    beside a fresh prompt and padded tokens; bf16 pages, and int8 and fp8
    pages at (30, 1000)."""
    import torch

    from scratchpad_tpu_torch.ops.attention import paged_extend_attention_plain

    cases = [
        ([(2048, 8048)], 2048),
        ([(100, 1100), (37, 1037), (300, 300), (1, 5000), (250, 4346)], 720),
    ]
    scale = 1.0 / math.sqrt(128)
    seed = 11_000
    worst, n = 0.0, 0
    for kind, grid in (("bf16", [(None, 4096), (30.0, 1000)]), ("int8", [(30.0, 1000)]),
                       ("fp8", [(30.0, 1000)])):
        for chunks, T_pad in cases:
            seed += 1
            q, k, v, pt, kv_lens, cu = extend_case(chunks, 128, T_pad, seed, G=4)
            k, v, ks, vs = quant_pages(k, v, kind)
            n_real = int(cu[-1])
            for cap, window in grid:
                qc = capped_q(q, cap)
                out = extend_kernel(qc, k, v, ks, vs, pt, kv_lens, cu, scale, cap, window)
                ref = paged_extend_attention_plain(
                    qc.float(), k, v, pt, kv_lens, cu, scale, ks, vs, cap, window
                )
                torch.cuda.synchronize()
                e, ratio = max_err(out, ref)
                zero = bool((out[n_real:] == 0).all())
                errs[EXTEND[kind]] = max(errs[EXTEND[kind]], e)
                worst, n = max(worst, ratio), n + 1
                log(
                    f"[check] extend {kind} Mistral shape chunks={chunks} T={q.shape[0]} "
                    f"{cap_window(cap, window)}: max_abs_err {e:.3e}, max err/tol {ratio:.3f}, "
                    f"{q.shape[0] - n_real} padded tokens zero: {zero}"
                )
                check(
                    ratio <= 1 and zero,
                    f"{kind} extend kernel disagrees with its plain version at the Mistral shape "
                    f"chunks={chunks} {cap_window(cap, window)}",
                )
            del k, v, ks, vs
    log(f"[check] extend at the Mistral shape, cap and window: worst err/tol {worst:.3f} over {n} cases")


# Gemma's attention at head_dim 256 (bf16 pages): (G, Hkv) of Gemma-2-2B
# (8 query and 4 kv heads) and of Gemma-3-1B (4 and 1)
HEAD256_SHAPES = ((2, 4), (4, 1))
# (cap, window) of the head_dim 256 checks: Gemma 2's attention cap of 50 and
# local window of 4096, Gemma 3's window of 512, a window of one token
CAPS_WINDOWS_256 = [(None, None), (50.0, None), (None, 4096), (50.0, 4096), (None, 512), (None, 1)]
# the windows whose first token the page-edge rows put a token before, on
# and after a page edge, and the split-edge rows on a split boundary
EDGE_WINDOWS_256 = (512, 4096)
# the kernels' entries of the head_dim 256 branch in the kernels line
DECODE_256 = "paged_decode_attention (head_dim 256, per-layer window)"
EXTEND_256 = "paged_extend_attention (head_dim 256, per-layer window)"
# rows 6 and 7 at GPT-OSS's groups of 120, on a served engine
W4A8_G120 = "w4a8_matmul (groups of 120, GPT-OSS)"
W4A16_G120 = "w4a16_matmul (groups of 120, GPT-OSS)"


def page_edge_lens(window: int, page: int = 16) -> list[int]:
    """Rows whose window's first token (len - W) falls one token before, on
    and one token after a page edge, beside a row whose first token lies
    inside a page."""
    edge = 5 * page
    return [window + edge - 1, window + edge, window + edge + 1, window + 40 * page + 3]


def head256_lens(case, gen, Hkv: int, G: int):
    """Row lengths of a head_dim 256 decode check (see ``check_decode_256``)."""
    import torch

    D = 256
    if case == "padding":
        lens = [300, 0, 17, 0]
    elif case == "split edges":
        lens = split_edge_lens(4096, Hkv, D, G)
    elif case[0] == "split edges":
        lens = split_edge_lens(8192, Hkv, D, G, case[1])
    elif case[0] == "page edges":
        lens = page_edge_lens(case[1])
    else:
        B, ctx = case
        t = torch.randint(ctx // 2, ctx + 1, (B,), generator=gen, device="cuda")
        t[0] = ctx
        return t.to(torch.int32)
    return torch.tensor(lens, dtype=torch.int32, device="cuda")


def check_decode_256(errs: dict) -> None:
    """The decode kernel at head_dim 256 over bf16 pages at Gemma-2-2B's and
    Gemma-3-1B's (G, Hkv): B 1, 2 and 64 at each context of
    ``DECODE_CHECK_CTX``, a batch with ``seq_len == 0`` rows, rows ending a
    token before, on and after a boundary of the plan's splits, rows whose
    window's first token falls a token before, on and after a split boundary
    or a page edge, each (cap, window) of ``CAPS_WINDOWS_256`` on the same
    pool in turn (the edge rows at their own window only). Where the plan
    splits a row, a second call must give the same bits."""
    import torch

    from scratchpad_tpu_torch.ops.attention import paged_decode_attention, paged_decode_attention_plain
    from scratchpad_tpu_torch.ops.attention.gqa_decode import decode_plan

    D, ps = 256, 16
    scale = 1.0 / math.sqrt(D)
    seed, n, worst = 20_000, 0, 0.0
    for G, Hkv in HEAD256_SHAPES:
        cases = [(B, ctx) for B in DECODE_CHECK_B for ctx in DECODE_CHECK_CTX] + ["padding", "split edges"]
        cases += [(edge, w) for edge in ("split edges", "page edges") for w in EDGE_WINDOWS_256]
        for case in cases:
            seed += 1
            gen = seeded(seed)
            lens = head256_lens(case, gen, Hkv, G)
            k, v, pt = make_pool(lens.tolist(), Hkv, D, ps, 1, gen)
            k, v = k[0], v[0]
            q = torch.randn(len(lens), Hkv * G, D, generator=gen, device="cuda").to(torch.bfloat16)
            plan = decode_plan(len(lens), Hkv, pt.shape[1], D, G)
            edge = isinstance(case, tuple) and isinstance(case[0], str)
            what = case if isinstance(case, str) else (
                f"{case[0]} {lens.tolist()}" if edge else f"B={case[0]} ctx={case[1]}")
            for cap, window in CAPS_WINDOWS_256:
                if edge and (window != case[1] or cap is not None):
                    continue
                qc = capped_q(q, cap)
                out = paged_decode_attention(qc, k, v, pt, lens, scale, cap, window)
                ref = paged_decode_attention_plain(qc.float(), k, v, pt, lens, scale, None, None, cap, window)
                same = plan.splits == 1 or torch.equal(
                    out, paged_decode_attention(qc, k, v, pt, lens, scale, cap, window))
                torch.cuda.synchronize()
                e, ratio = max_err(out, ref)
                zero = bool((out[lens == 0] == 0).all())
                errs[DECODE_256] = max(errs[DECODE_256], e)
                worst, n = max(worst, ratio), n + 1
                log(
                    f"[check] decode bf16 G={G} Hkv={Hkv} D=256 {what} {cap_window(cap, window)}: "
                    f"max_abs_err {e:.3e}, max err/tol {ratio:.3f}, zero rows exact: {zero}"
                    + (f"; {plan.splits} splits, second call bit-equal: {same}" if plan.splits > 1 else "")
                )
                check(ratio <= 1 and zero, f"decode kernel disagrees with its plain version at "
                                           f"G={G} Hkv={Hkv} D=256 {what} {cap_window(cap, window)}")
                check(same, f"decode kernel's split calls differ at G={G} Hkv={Hkv} D=256 {what} "
                            f"{cap_window(cap, window)}")
            del k, v
    log(f"[check] decode at head_dim 256: worst err/tol {worst:.3f} over {n} cases")


# head_dim 256 extend cases: mixed chunks, cached prefixes and padded
# tokens; window edges inside a query tile and a page; a 2048-token chunk
# over 6,000 cached tokens, whose window of 4096 starts inside its KV tiles
EXTEND_CASES_256 = [
    ([(1000, 1000), (512, 2560), (7, 1031), (1, 300)], 2048),
    ([(100, 1100), (37, 1037), (300, 300), (1, 5000), (250, 4346)], 720),
    ([(2048, 8048)], 2048),
]


def check_extend_256(errs: dict) -> None:
    """The extend kernel at head_dim 256 over bf16 pages at Gemma-2-2B's and
    Gemma-3-1B's (G, Hkv), each case of ``EXTEND_CASES_256`` under each
    (cap, window) of ``CAPS_WINDOWS_256`` on the same pool in turn; padded
    tokens must come out as exact zeros."""
    import torch

    from scratchpad_tpu_torch.ops.attention import paged_extend_attention, paged_extend_attention_plain

    scale = 1.0 / 16.0
    seed, n, worst = 21_000, 0, 0.0
    for G, Hkv in HEAD256_SHAPES:
        for chunks, T_pad in EXTEND_CASES_256:
            seed += 1
            q, k, v, pt, kv_lens, cu = extend_case(chunks, 256, T_pad, seed, G, Hkv)
            n_real = int(cu[-1])
            for cap, window in CAPS_WINDOWS_256:
                qc = capped_q(q, cap)
                out = paged_extend_attention(qc, k, v, pt, kv_lens, cu, scale, cap, window)
                ref = paged_extend_attention_plain(qc.float(), k, v, pt, kv_lens, cu, scale, None, None,
                                                   cap, window)
                torch.cuda.synchronize()
                e, ratio = max_err(out, ref)
                zero = bool((out[n_real:] == 0).all())
                errs[EXTEND_256] = max(errs[EXTEND_256], e)
                worst, n = max(worst, ratio), n + 1
                log(
                    f"[check] extend bf16 G={G} Hkv={Hkv} D=256 chunks={chunks} T={q.shape[0]} "
                    f"{cap_window(cap, window)}: max_abs_err {e:.3e}, max err/tol {ratio:.3f}, "
                    f"{q.shape[0] - n_real} padded tokens zero: {zero}"
                )
                check(ratio <= 1 and zero, f"extend kernel disagrees with its plain version at G={G} "
                                           f"Hkv={Hkv} D=256 chunks={chunks} {cap_window(cap, window)}")
            del k, v
    log(f"[check] extend at head_dim 256: worst err/tol {worst:.3f} over {n} cases")


def check_window_sequence_256() -> None:
    """Gemma's layers in turn on one pool: local (window 4096), global (no
    window), local again, through both kernels at Gemma-2-2B's shape. Each
    call must agree with its plain version, the two local calls must give
    the same bits, and the global call must differ from them (a window that
    leaks from one call to the next fails here)."""
    import torch

    from scratchpad_tpu_torch.ops.attention import (
        paged_decode_attention,
        paged_decode_attention_plain,
        paged_extend_attention,
        paged_extend_attention_plain,
    )

    G, Hkv, D, W = 2, 4, 256, 4096
    scale = 1.0 / 16.0
    gen = seeded(22_000)
    lens = torch.randint(W + 1, 8193, (64,), generator=gen, device="cuda").to(torch.int32)
    k, v, pt = make_pool(lens.tolist(), Hkv, D, 16, 1, gen)
    q = torch.randn(64, Hkv * G, D, generator=gen, device="cuda").to(torch.bfloat16)
    q_ext, k_ext, v_ext, pt_ext, kv_lens, cu = extend_case([(2048, 8048), (300, 5000)], D, 2400, 22_001, G, Hkv)
    runs = {
        "decode": (lambda w: paged_decode_attention(q, k[0], v[0], pt, lens, scale, 50.0, w),
                   lambda w: paged_decode_attention_plain(q.float(), k[0], v[0], pt, lens, scale, None, None,
                                                          50.0, w)),
        "extend": (lambda w: paged_extend_attention(q_ext, k_ext, v_ext, pt_ext, kv_lens, cu, scale, 50.0, w),
                   lambda w: paged_extend_attention_plain(q_ext.float(), k_ext, v_ext, pt_ext, kv_lens, cu,
                                                          scale, None, None, 50.0, w)),
    }
    for name, (kern, plain) in runs.items():
        outs = [kern(w) for w in (W, None, W)]
        torch.cuda.synchronize()
        ratios = [max_err(o, plain(w))[1] for o, w in zip(outs, (W, None, W))]
        same = torch.equal(outs[0], outs[2])
        moved = float((outs[0].float() - outs[1].float()).abs().max())
        log(
            f"[check] {name} D=256 window sequence local, global, local: err/tol {ratios[0]:.3f}, "
            f"{ratios[1]:.3f}, {ratios[2]:.3f}; locals bit-equal: {same}; global moves by {moved:.3e}"
        )
        check(max(ratios) <= 1 and same and moved > 0,
              f"{name} kernel at head_dim 256: a per-layer window leaks between calls")
    del k, v, k_ext, v_ext


# rows 1dq and 3dq: 8-bit pages at head_dim 256 (Gemma on int8 or fp8 KV),
# under Gemma 2's window of 4096 and Gemma 3's of 512, each with and without
# the cap of 50
CAPS_WINDOWS_256_8BIT = [(None, None), (None, 4096), (50.0, 4096), (None, 512), (50.0, 512)]
DECODE_CASES_256_8BIT = [(1, 17), (1, 4096), (2, 8192), (64, 4096), "padding", ("split edges", 512),
                         ("split edges", 4096), ("page edges", 512), ("page edges", 4096)]
DECODE_256_8BIT = "paged_decode_attention_quant (head_dim 256, per-layer window)"
EXTEND_256_8BIT = "paged_extend_attention_quant (head_dim 256, per-layer window)"


def check_decode_256_8bit(errs: dict) -> None:
    """Row 1dq: the decode kernel at head_dim 256 over int8 and fp8 pages at
    Gemma-2-2B's and Gemma-3-1B's (G, Hkv), on ``DECODE_CASES_256_8BIT``
    (one row split across the card, B 64 unsplit, padding rows, rows whose
    window's first token falls a token before, on and after a split boundary
    or a page edge) under each (cap, window) of ``CAPS_WINDOWS_256_8BIT``
    (the edge rows at their own window, with and without the cap). Where
    the plan splits a row, a second call must give the same bits."""
    import torch

    from scratchpad_tpu_torch.ops.attention import paged_decode_attention_plain
    from scratchpad_tpu_torch.ops.attention.gqa_decode import decode_plan

    D, ps = 256, 16
    scale = 1.0 / math.sqrt(D)
    seed, n, worst, splits = 23_000, 0, 0.0, 0
    for kind in ("int8", "fp8"):
        for G, Hkv in HEAD256_SHAPES:
            for case in DECODE_CASES_256_8BIT:
                seed += 1
                gen = seeded(seed)
                edge = isinstance(case, tuple) and isinstance(case[0], str)
                lens = head256_lens(case, gen, Hkv, G)
                k, v, pt = make_pool(lens.tolist(), Hkv, D, ps, 1, gen)
                k, v, ks, vs = quant_pages(k[0], v[0], kind)
                q = torch.randn(len(lens), Hkv * G, D, generator=gen, device="cuda").to(torch.bfloat16)
                plan = decode_plan(len(lens), Hkv, pt.shape[1], D, G)
                what = case if isinstance(case, str) else (
                    f"{case[0]} {lens.tolist()}" if edge else f"B={case[0]} ctx={case[1]}")
                for cap, window in CAPS_WINDOWS_256_8BIT:
                    if edge and window != case[1]:
                        continue
                    qc = capped_q(q, cap)
                    out = decode_kernel(qc, k, v, ks, vs, pt, lens, scale, cap, window)
                    ref = paged_decode_attention_plain(qc.float(), k, v, pt, lens, scale, ks, vs, cap, window)
                    same = plan.splits == 1 or torch.equal(
                        out, decode_kernel(qc, k, v, ks, vs, pt, lens, scale, cap, window))
                    torch.cuda.synchronize()
                    e, ratio = max_err(out, ref)
                    zero = bool((out[lens == 0] == 0).all())
                    errs[DECODE_256_8BIT] = max(errs[DECODE_256_8BIT], e)
                    worst, n, splits = max(worst, ratio), n + 1, splits + (plan.splits > 1)
                    log(
                        f"[check] decode {kind} G={G} Hkv={Hkv} D=256 {what} {cap_window(cap, window)}: "
                        f"max_abs_err {e:.3e}, max err/tol {ratio:.3f}, zero rows exact: {zero}"
                        + (f"; {plan.splits} splits, second call bit-equal: {same}" if plan.splits > 1 else "")
                    )
                    check(ratio <= 1 and zero, f"{kind} decode kernel disagrees with its plain version at "
                                               f"G={G} Hkv={Hkv} D=256 {what} {cap_window(cap, window)}")
                    check(same, f"{kind} decode kernel's split calls differ at G={G} Hkv={Hkv} D=256 {what} "
                                f"{cap_window(cap, window)}")
                del k, v
    log(f"[check] 8-bit decode at head_dim 256: worst err/tol {worst:.3f} over {n} cases ({splits} split)")


def check_extend_256_8bit(errs: dict) -> None:
    """Row 3dq: the extend kernel at head_dim 256 over int8 and fp8 pages at
    Gemma-2-2B's and Gemma-3-1B's (G, Hkv), each case of
    ``EXTEND_CASES_256`` (window edges inside a query tile and a KV tile)
    under each (cap, window) of ``CAPS_WINDOWS_256_8BIT``; padded tokens
    must come out as exact zeros."""
    import torch

    from scratchpad_tpu_torch.ops.attention import paged_extend_attention_plain

    scale = 1.0 / 16.0
    seed, n, worst = 24_000, 0, 0.0
    for kind in ("int8", "fp8"):
        for G, Hkv in HEAD256_SHAPES:
            for chunks, T_pad in EXTEND_CASES_256:
                seed += 1
                q, k, v, pt, kv_lens, cu = extend_case(chunks, 256, T_pad, seed, G, Hkv)
                k, v, ks, vs = quant_pages(k, v, kind)
                n_real = int(cu[-1])
                for cap, window in CAPS_WINDOWS_256_8BIT:
                    qc = capped_q(q, cap)
                    out = extend_kernel(qc, k, v, ks, vs, pt, kv_lens, cu, scale, cap, window)
                    ref = paged_extend_attention_plain(qc.float(), k, v, pt, kv_lens, cu, scale, ks, vs,
                                                       cap, window)
                    torch.cuda.synchronize()
                    e, ratio = max_err(out, ref)
                    zero = bool((out[n_real:] == 0).all())
                    errs[EXTEND_256_8BIT] = max(errs[EXTEND_256_8BIT], e)
                    worst, n = max(worst, ratio), n + 1
                    log(
                        f"[check] extend {kind} G={G} Hkv={Hkv} D=256 chunks={chunks} T={q.shape[0]} "
                        f"{cap_window(cap, window)}: max_abs_err {e:.3e}, max err/tol {ratio:.3f}, "
                        f"{q.shape[0] - n_real} padded tokens zero: {zero}"
                    )
                    check(ratio <= 1 and zero, f"{kind} extend kernel disagrees with its plain version at "
                                               f"G={G} Hkv={Hkv} D=256 chunks={chunks} {cap_window(cap, window)}")
                del k, v
    log(f"[check] 8-bit extend at head_dim 256: worst err/tol {worst:.3f} over {n} cases")


# GPT-OSS's attention (gpt-oss-20b: 64 query heads over Hkv 8, head_dim 64),
# its local window of 128 and none (its global layers); sinks of N(0, 2^2)
# and ones far above every score, whose term is the softmax's max
SINK_SHAPE = (8, 8, 64)  # Hkv, G, D
SINK_WINDOWS = (None, 128)
SINK_KINDS = ("normal", "above")
SINK_CHECK_CTX = (1, 17, 128, 129, 1000, 4096)
# the kernels' entries of the sinks branch in the kernels line
DECODE_SINKS = "paged_decode_attention (sinks)"
EXTEND_SINKS = "paged_extend_attention (sinks)"


def sink_values(kind: str, Hq: int, gen):
    """f32 [Hq] sinks: N(0, 2^2) ("normal"), or 100 (far above every score:
    each row's max is its sink, and its weights' sum goes to about zero)."""
    import torch

    if kind == "normal":
        return 2.0 * torch.randn(Hq, generator=gen, device="cuda")
    return torch.full((Hq,), 100.0, device="cuda")


def check_sinks(errs: dict) -> None:
    """Both attention kernels' sinks branch at GPT-OSS's shape (Hkv 8, G 8,
    head_dim 64) over bf16, int8 and fp8 pages, without a window and with
    its window of 128, each kind of ``SINK_KINDS``: decode at B 1, 2 and 64
    and every context of ``SINK_CHECK_CTX`` (B 1 at 4096 split across the
    card), rows ending a token before, on and after a split boundary, rows
    of length 0 (exact zeros); a split call bit-equal on a repeat. Extend on
    mixed chunks, cached prefixes and padding tokens (exact zeros)."""
    import torch

    from scratchpad_tpu_torch.ops.attention import paged_decode_attention_plain, paged_extend_attention_plain
    from scratchpad_tpu_torch.ops.attention.gqa_decode import decode_plan

    Hkv, G, D = SINK_SHAPE
    ps, scale = 16, 1.0 / math.sqrt(D)
    seed, n, worst = 30_000, 0, 0.0
    cases = [(B, ctx) for B in DECODE_CHECK_B for ctx in SINK_CHECK_CTX] + ["padding", "split edges"]
    for kind in ("bf16", "int8", "fp8"):
        for case in cases:
            seed += 1
            gen = seeded(seed)
            lens = decode_lens(case, gen, D, G)
            k, v, pt = make_pool(lens.tolist(), Hkv, D, ps, 1, gen)
            k, v, ks, vs = quant_pages(k[0], v[0], kind)
            q = torch.randn(len(lens), Hkv * G, D, generator=gen, device="cuda").to(torch.bfloat16)
            plan = decode_plan(len(lens), Hkv, pt.shape[1], D, G)
            what = case if isinstance(case, str) else f"B={case[0]} ctx={case[1]}"
            for window in SINK_WINDOWS:
                for sk in SINK_KINDS:
                    sinks = sink_values(sk, Hkv * G, gen)
                    out = decode_kernel(q, k, v, ks, vs, pt, lens, scale, None, window, sinks)
                    ref = paged_decode_attention_plain(q.float(), k, v, pt, lens, scale, ks, vs, None,
                                                       window, sinks)
                    same = plan.splits == 1 or torch.equal(
                        out, decode_kernel(q, k, v, ks, vs, pt, lens, scale, None, window, sinks))
                    torch.cuda.synchronize()
                    e, ratio = max_err(out, ref)
                    zero = bool((out[lens == 0] == 0).all()) and bool(torch.isfinite(out.float()).all())
                    errs[DECODE_SINKS] = max(errs[DECODE_SINKS], e)
                    worst, n = max(worst, ratio), n + 1
                    log(
                        f"[check] decode {kind} sinks {sk} G={G} D={D} {what} window={window}: "
                        f"max_abs_err {e:.3e}, max err/tol {ratio:.3f}, zero rows exact: {zero}"
                        + (f"; {plan.splits} splits, second call bit-equal: {same}" if plan.splits > 1 else "")
                    )
                    check(ratio <= 1 and zero, f"{kind} decode kernel with sinks ({sk}) disagrees with its "
                                               f"plain version at {what} window={window}")
                    check(same, f"{kind} decode kernel's split calls with sinks differ at {what} window={window}")
            del k, v
    log(f"[check] decode with sinks: worst err/tol {worst:.3f} over {n} cases")
    ext_cases = [
        ([(1000, 1000), (512, 2560), (7, 1031), (1, 300)], 2048),
        ([(2048, 4096), (1500, 1500), (300, 845), (200, 200)], 4096),
    ]
    n, worst = 0, 0.0
    for kind in ("bf16", "int8", "fp8"):
        for chunks, T_pad in ext_cases:
            seed += 1
            q, k, v, pt, kv_lens, cu = extend_case(chunks, D, T_pad, seed, G, Hkv)
            k, v, ks, vs = quant_pages(k, v, kind)
            n_real = int(cu[-1])
            for window in SINK_WINDOWS:
                for sk in SINK_KINDS:
                    sinks = sink_values(sk, Hkv * G, seeded(seed))
                    out = extend_kernel(q, k, v, ks, vs, pt, kv_lens, cu, scale, None, window, sinks)
                    ref = paged_extend_attention_plain(q.float(), k, v, pt, kv_lens, cu, scale, ks, vs, None,
                                                       window, sinks)
                    torch.cuda.synchronize()
                    e, ratio = max_err(out, ref)
                    zero = bool((out[n_real:] == 0).all())
                    errs[EXTEND_SINKS] = max(errs[EXTEND_SINKS], e)
                    worst, n = max(worst, ratio), n + 1
                    log(
                        f"[check] extend {kind} sinks {sk} G={G} D={D} chunks={chunks} window={window}: "
                        f"max_abs_err {e:.3e}, max err/tol {ratio:.3f}, padded tokens zero: {zero}"
                    )
                    check(ratio <= 1 and zero, f"{kind} extend kernel with sinks ({sk}) disagrees with its "
                                               f"plain version at chunks={chunks} window={window}")
    log(f"[check] extend with sinks: worst err/tol {worst:.3f} over {n} cases")


# Llama-4's chunked attention: Scout's shape (Hkv 8, D 128, G 5) and G 4;
# chunks on a page edge (16), inside a page (100), 1000, and Scout's 8192
CHUNK_SHAPE = (8, 5, 128)  # Hkv, G, D
CHUNK_SIZES = (16, 100, 1000, 8192)
# the kernels' entries of the chunk branch in the kernels line
DECODE_CHUNK = "paged_decode_attention (chunk)"
EXTEND_CHUNK = "paged_extend_attention (chunk)"


def chunk_decode_lens(case, C: int, gen):
    """Row lengths of a chunked decode check: "edges", a token before, on and
    after a chunk edge, past two chunks, and a row of 0 (five rows, split
    across the card); "split", one row of 2C + 17; "B=64", rows of C to
    1.5 C + 17 tokens, the first of 1.5 C + 17 (one CTA a row and head)."""
    import torch

    if case == "edges":
        lens = [C - 1, C, C + 1, 2 * C + 17, 0]
    elif case == "split":
        lens = [2 * C + 17]
    else:
        top = C + C // 2 + 17
        t = torch.randint(C, top + 1, (64,), generator=gen, device="cuda")
        t[0] = top
        return t.to(torch.int32)
    return torch.tensor(lens, dtype=torch.int32, device="cuda")


def chunk_extend_chunks(C: int) -> list:
    """(q_len, kv_len): a fresh prompt across the chunk edge at C, a chunk
    after a cached prefix whose first query sits a token before it, a
    one-token row past two chunks, and a short fresh prompt; the query
    tiles (128 / G tokens of G heads) straddle the edges at every offset
    the lengths give."""
    return [(C + 150, C + 150), (300, C + 299), (1, 2 * C + 17), (64, 64)]


def check_chunks(errs: dict) -> None:
    """Both attention kernels' chunk branch over bf16, int8 and fp8 pages at
    G 5 and 4 (Hkv 8, D 128) and each chunk of ``CHUNK_SIZES``: decode on
    the rows of ``chunk_decode_lens`` (a split and an unsplit launch; a
    split call bit-equal on a repeat; rows of length 0 exact zeros);
    extend on ``chunk_extend_chunks`` and padding tokens (exact zeros)."""
    import torch

    from scratchpad_tpu_torch.ops.attention import paged_decode_attention_plain, paged_extend_attention_plain
    from scratchpad_tpu_torch.ops.attention.gqa_decode import decode_plan

    Hkv, _, D = CHUNK_SHAPE
    ps, scale = 16, 1.0 / math.sqrt(D)
    seed, n, worst = 40_000, 0, 0.0
    for kind in ("bf16", "int8", "fp8"):
        for G in (5, 4):
            for C in CHUNK_SIZES:
                for case in ("edges", "split", "B=64"):
                    seed += 1
                    gen = seeded(seed)
                    lens = chunk_decode_lens(case, C, gen)
                    k, v, pt = make_pool(lens.tolist(), Hkv, D, ps, 1, gen)
                    k, v, ks, vs = quant_pages(k[0], v[0], kind)
                    q = torch.randn(len(lens), Hkv * G, D, generator=gen, device="cuda").to(torch.bfloat16)
                    plan = decode_plan(len(lens), Hkv, pt.shape[1], D, G)
                    out = decode_kernel(q, k, v, ks, vs, pt, lens, scale, chunk=C)
                    ref = paged_decode_attention_plain(q.float(), k, v, pt, lens, scale, ks, vs, chunk_size=C)
                    same = plan.splits == 1 or torch.equal(out, decode_kernel(q, k, v, ks, vs, pt, lens, scale,
                                                                              chunk=C))
                    torch.cuda.synchronize()
                    e, ratio = max_err(out, ref)
                    zero = bool((out[lens == 0] == 0).all())
                    errs[DECODE_CHUNK] = max(errs[DECODE_CHUNK], e)
                    worst, n = max(worst, ratio), n + 1
                    what = f"{case} {lens.tolist()[:5]}"
                    log(
                        f"[check] decode {kind} chunk {C} G={G} D={D} {what}: max_abs_err {e:.3e}, "
                        f"max err/tol {ratio:.3f}, zero rows exact: {zero}"
                        + (f"; {plan.splits} splits, second call bit-equal: {same}" if plan.splits > 1 else "")
                    )
                    check(ratio <= 1 and zero, f"{kind} decode kernel with chunk {C} disagrees with its plain "
                                               f"version at G={G} {what}")
                    check(same, f"{kind} decode kernel's split calls with chunk {C} differ at G={G} {what}")
                    del k, v, ks, vs
    log(f"[check] decode with a chunk: worst err/tol {worst:.3f} over {n} cases")
    n, worst = 0, 0.0
    for kind in ("bf16", "int8", "fp8"):
        for G in (5, 4):
            for C in CHUNK_SIZES:
                seed += 1
                chunks = chunk_extend_chunks(C)
                q, k, v, pt, kv_lens, cu = extend_case(chunks, D, sum(c[0] for c in chunks) + 29, seed, G, Hkv)
                k, v, ks, vs = quant_pages(k, v, kind)
                n_real = int(cu[-1])
                out = extend_kernel(q, k, v, ks, vs, pt, kv_lens, cu, scale, chunk=C)
                ref = paged_extend_attention_plain(q.float(), k, v, pt, kv_lens, cu, scale, ks, vs, chunk_size=C)
                torch.cuda.synchronize()
                e, ratio = max_err(out, ref)
                zero = bool((out[n_real:] == 0).all())
                errs[EXTEND_CHUNK] = max(errs[EXTEND_CHUNK], e)
                worst, n = max(worst, ratio), n + 1
                log(
                    f"[check] extend {kind} chunk {C} G={G} D={D} chunks={chunks}: max_abs_err {e:.3e}, "
                    f"max err/tol {ratio:.3f}, padded tokens zero: {zero}"
                )
                check(ratio <= 1 and zero, f"{kind} extend kernel with chunk {C} disagrees with its plain "
                                           f"version at G={G} chunks={chunks}")
                del k, v, ks, vs
    log(f"[check] extend with a chunk: worst err/tol {worst:.3f} over {n} cases")


# rows 3m and 3qm: the extend kernel's bidirectional image spans (Gemma 3
# multimodal), through the bf16 and 8-bit wrappers
EXTEND_SPANS = "paged_extend_attention (spans)"
EXTEND_SPANS_8BIT = "paged_extend_attention_quant (spans)"
# (Hkv, G, D): Gemma-3-4B's (the served path), Qwen2-VL-2B's and
# LLaVA-1.5-7B's groups at D 128 (their engines carry no spans)
SPAN_SHAPES = ((4, 2, 256), (2, 6, 128), (8, 1, 128))
SPAN_WINDOWS = (None, 128)  # Gemma 3's local window is 1024: 128 is shorter than a span
# (q_len, kv_len) a row and its spans, absolute [s0, s1), (0, 0) for none:
# a 256-token span across several query tiles beside a second span, a span
# after a cached prefix, a row without spans, a one-token row, a padding row
SPAN_ROWS = [
    ((700, 700), [(10, 266), (300, 556)]),
    ((400, 1000), [(650, 906), (0, 0)]),
    ((90, 90), [(0, 0), (0, 0)]),
    ((1, 33), [(0, 0), (0, 0)]),
    ((0, 0), [(0, 0), (0, 0)]),
]
# seven 256-token image spans in a 2,048-token prompt (the timed shape)
GEMMA3_SPANS = [(16 + 272 * i, 16 + 272 * i + 256) for i in range(7)]


def check_spans(errs: dict) -> None:
    """Rows 3m and 3qm: the extend kernel's span branch over bf16, int8 and
    fp8 pages at ``SPAN_SHAPES``, without a window and with one of 128
    (shorter than a span), on ``SPAN_ROWS`` and padding tokens (exact
    zeros); the spans must move the output (the same call without them), and
    a call with spans and a chunk is refused."""
    import torch

    from scratchpad_tpu_torch.ops.attention import paged_extend_attention_plain

    seed, n, worst = 50_000, 0, {EXTEND_SPANS: 0.0, EXTEND_SPANS_8BIT: 0.0}
    chunks = [r[0] for r in SPAN_ROWS]
    for kind in ("bf16", "int8", "fp8"):
        name = EXTEND_SPANS if kind == "bf16" else EXTEND_SPANS_8BIT
        for Hkv, G, D in SPAN_SHAPES:
            for window in SPAN_WINDOWS:
                seed += 1
                q, k, v, pt, kv_lens, cu = extend_case(chunks, D, sum(c[0] for c in chunks) + 29, seed, G, Hkv)
                k, v, ks, vs = quant_pages(k, v, kind)
                spans = torch.tensor([r[1] for r in SPAN_ROWS], dtype=torch.int32, device="cuda")
                scale, n_real = 1.0 / math.sqrt(D), int(cu[-1])
                out = extend_kernel(q, k, v, ks, vs, pt, kv_lens, cu, scale, window=window, spans=spans)
                causal = extend_kernel(q, k, v, ks, vs, pt, kv_lens, cu, scale, window=window)
                ref = paged_extend_attention_plain(q.float(), k, v, pt, kv_lens, cu, scale, ks, vs,
                                                   sliding_window=window, mm_spans=spans)
                torch.cuda.synchronize()
                e, ratio = max_err(out, ref)
                zero = bool((out[n_real:] == 0).all())
                moved = float((out.float() - causal.float()).abs().max())
                errs[name] = max(errs[name], e)
                worst[name], n = max(worst[name], ratio), n + 1
                log(
                    f"[check] extend {kind} spans G={G} Hkv={Hkv} D={D} window={window}: max_abs_err "
                    f"{e:.3e}, max err/tol {ratio:.3f}, padded tokens zero: {zero}, the spans move the "
                    f"output by {moved:.3e}"
                )
                check(ratio <= 1 and zero, f"{kind} extend kernel with spans disagrees with its plain "
                                           f"version at G={G} D={D} window={window}")
                check(moved > 1e-2, f"{kind} extend kernel: the spans do not move the output at G={G} D={D}")
                del k, v, ks, vs
    q, k, v, pt, kv_lens, cu = extend_case(chunks, 128, sum(c[0] for c in chunks), seed + 1, 4, 2)
    try:
        extend_kernel(q, k, v, None, None, pt, kv_lens, cu, 0.1, chunk=64, spans=spans)
        check(False, "the extend kernel took spans with a chunk")
    except ValueError as e:
        check("chunk" in str(e), f"spans with a chunk: refused for another reason: {e}")
    log(f"[check] extend with spans: worst err/tol {worst} over {n} cases")


def decode_meta(pt, lens):
    """A decode ``ForwardMeta`` over page table ``pt`` and lengths ``lens``,
    for the model-facing ``decode_attention_pallas`` (which reads only those
    two)."""
    import torch

    from scratchpad_tpu_torch.executor.forward_meta import ForwardMeta, ForwardMode

    rows = torch.arange(len(lens), device="cuda")
    return ForwardMeta(
        mode=ForwardMode.DECODE, tokens=rows, positions=rows, out_cache_loc=rows,
        req_indices=rows, page_table=pt, seq_lens=lens, extend_lens=torch.ones_like(lens),
        last_token_idx=rows,
    )


def pallas_case(B: int, Hq: int, Hkv: int, D: int, ctx: int, gen):
    """q, a one-layer bf16 pool and a decode ``ForwardMeta`` for
    ``decode_attention_pallas``: B rows of up to ``ctx`` tokens at page 16,
    the last row of length 0 when B > 1."""
    import torch

    from scratchpad_tpu_torch.memory.kv_cache import KVCache

    lens = torch.randint(max(ctx // 2, 1), ctx + 1, (B,), generator=gen, device="cuda")
    lens[0] = ctx
    if B > 1:
        lens[-1] = 0
    lens = lens.to(torch.int32)
    k, v, pt = make_pool(lens.tolist(), Hkv, D, 16, 1, gen)
    q = torch.randn(B, Hq, D, generator=gen, device="cuda").to(torch.bfloat16)
    return q, KVCache(k, v), decode_meta(pt, lens)


def check_pallas_decode(errs: dict) -> None:
    """Row 9's wrapper, ``decode_attention_pallas``, at its JAX test's shape
    (``tests/test_pallas_kernels.py::make_case``: B 4, Hq 8, Hkv 2, D 64,
    page 16, up to 256 tokens) with cap 30 and window 8, and at Mistral-7B's
    decode shape (B 64, ctx 8192, W 4096), against the plain version; its
    launch count must rise once a call."""
    from scratchpad_tpu_torch.ops.attention import decode_attention_pallas, paged_decode_attention_plain

    for i, (B, Hq, Hkv, D, ctx, cap, window) in enumerate(
        [(4, 8, 2, 64, 256, 30.0, 8), (64, 32, 8, 128, 8192, None, 4096)]
    ):
        q, kv, meta = pallas_case(B, Hq, Hkv, D, ctx, seeded(12_000 + i))
        q = capped_q(q, cap)
        before = decode_attention_pallas.launches
        scale = 1.0 / math.sqrt(D)
        out = decode_attention_pallas(q, kv, 0, meta, sm_scale=scale, logit_cap=cap, sliding_window=window)
        counted = decode_attention_pallas.launches - before
        ref = paged_decode_attention_plain(
            q.float(), kv.k[0], kv.v[0], meta.page_table, meta.seq_lens, scale, None, None, cap, window
        )
        e, ratio = max_err(out, ref)
        zero = bool((out[meta.seq_lens == 0] == 0).all())
        errs["decode_attention_pallas"] = max(errs["decode_attention_pallas"], e)
        log(
            f"[check] decode_attention_pallas B={B} Hq={Hq} Hkv={Hkv} D={D} ctx={ctx} "
            f"{cap_window(cap, window)}: max_abs_err {e:.3e}, max err/tol {ratio:.3f}, zero rows "
            f"exact: {zero}, launches counted: {counted}"
        )
        check(ratio <= 1 and zero and counted == 1,
              f"decode_attention_pallas disagrees with its plain version at B={B} D={D}")


def check_kv_quantizer() -> None:
    """The KV quantizer (plain PyTorch on both devices) on the card against
    itself on the CPU, bit for bit: Llama-3.2-3B's K/V rows of a 2048-token
    chunk over six decades, a zero row, and rows whose bf16 scale rounds down
    so that |x / scale| passes the code range (127.49 and 449.7)."""
    import torch

    from scratchpad_tpu_torch.ops.attention import quantize_rows

    gen = seeded(600)
    x = torch.randn(2048, 8, 128, generator=gen, device="cuda")
    x *= 10.0 ** torch.randint(-3, 4, (2048, 8, 1), generator=gen, device="cuda")
    x[5] = 0
    for kind, code, limit in (("int8", torch.int8, 127.0), ("fp8", torch.float8_e4m3fn, 448.0)):
        x[9] = 0
        x[9, :, :16] = torch.linspace(-limit * 1.0039, limit * 1.0039, 16, device="cuda")
        for xb in (x.to(torch.bfloat16), x):
            codes, scale = quantize_rows(xb, code)
            ref_codes, ref_scale = quantize_rows(xb.cpu(), code)
            torch.cuda.synchronize()
            n_diff = int((codes.view(torch.uint8).cpu() != ref_codes.view(torch.uint8)).sum())
            s_diff = int((scale.cpu() != ref_scale).sum())
            finite = bool(torch.isfinite(codes.float()).all())
            log(
                f"[check] kv quantizer {kind} on {xb.dtype} rows [2048, 8, 128]: {n_diff} codes "
                f"and {s_diff} scales differ from the CPU; all codes finite: {finite}"
            )
            check(n_diff == 0 and s_diff == 0 and finite, f"{kind} KV quantizer on the card differs from the CPU")


def llama_1b_matrices():
    """(name, In, Out, calls per forward) of Llama-3.2-1B's quantized
    matrices: six per layer, gate|up fused, and the tied head."""
    from scratchpad_tpu_torch.config.model_config import get_preset

    c = get_preset("llama-3.2-1b")
    H, I, V, L = c.hidden_size, c.intermediate_size, c.vocab_size, c.num_hidden_layers
    q_out, kv_out = c.num_attention_heads * c.head_dim, c.num_kv_heads * c.head_dim
    return [
        ("wq", H, q_out, L), ("wk", H, kv_out, L), ("wv", H, kv_out, L), ("wo", q_out, H, L),
        ("gate_up", H, 2 * I, L), ("down", I, H, L), ("lm_head", H, V, 1),
    ]


def random_w4(In: int, Out: int, copies: int, gen, group: int | None = None, zeros: tuple = (0, 16)):
    """``copies`` random weights [In -> Out] in the packed layout, with the
    stored width ``quantize_stacked`` gives such a matrix and its group (or
    ``group``): random code bytes, bf16 scales in [0.005, 0.02), integral
    zero points in ``[zeros[0], zeros[1])``, 0..15 unless asked."""
    import torch

    from scratchpad_tpu_torch.ops.quant.w4_matmul import padded_in
    from scratchpad_tpu_torch.ops.quant.w4a16 import stacked_group_size, stacked_out_width

    g = group or stacked_group_size(In)
    N, _ = stacked_out_width(Out)
    G = In // g
    q = torch.randint(0, 256, (copies, N, padded_in(In) // 2), generator=gen, device="cuda",
                      dtype=torch.uint8)
    s = (torch.rand(copies, G, N, generator=gen, device="cuda") * 0.015 + 0.005).to(torch.bfloat16)
    z = torch.randint(*zeros, (copies, G, N), generator=gen, device="cuda").to(torch.bfloat16)
    return q, s, z, g


# M of the W4 checks at Llama-3.2-1B's matrices: decode (the W4A8 decode
# kernel's token tiles of 8 and 64), the edges of the launch plans (64 | 65
# rows, one and two 128-row tiles), a prefill chunk
W4_CHECK_M = (1, 64, 65, 129, 200, 2048)
# groups of 64 and 32 (folds inside W4A8's and W4A16's k blocks) at three
# of the 1B's matrices: (name, group, Ms)
W4_SMALL_GROUPS = [("wq", 64, (1, 64, 200)), ("wk", 32, (5, 64, 129)), ("down", 32, (64, 300))]
# zero points outside the code range (-8..24: quantize_stacked gives a group
# of one sign such a zero, which W4A8 adds as a rest at the group's end) at a
# K whose last k block has zero-filled steps: 320 at prefill (M 65, 200;
# 128-deep blocks), 352 at decode (M 1, 64; 64-deep blocks). (name, In,
# Out, group, Ms)
W4_ZERO_RESTS = [("rest 320", 320, 1000, 32, (65, 200)), ("rest 352", 352, 1000, 32, (1, 64))]
W4_REST_ZEROS = (-8, 25)
# quantize_stacked's own zero points outside the code range (stacked_rest_w4):
# groups of one sign, a constant column (a zero of about -5e7) and nearly
# constant ones (-500 to -2,000), which W4A16 forms as a clamped code and a
# rest; (name, In, Out, Ms): group 128 at K 2048, group 112 at K 224 (not a
# multiple of 128, its last 64-deep block half zero-filled), decode and
# prefill
W4_STACKED_RESTS = [("stacked rest 2048", 2048, 512, (1, 64, 200)), ("stacked rest 224", 224, 1000, (1, 64, 130))]
# quantize_stacked's zero points far outside the code range at GPT-OSS's
# group of 120 (stacked_far_w4: nearly constant groups, zero points near
# -31,000, -300 and 2,070), through the split steps: (name, In, Out, Ms)
W4_STACKED_FAR = [("stacked far 2880", 2880, 640, (1, 64, 300))]
# a group below a 32-deep step, which W4A8 leaves to its mma.sync kernel
# (and W4A16 takes on split steps): (name, In, Out, group, Ms)
W4_MMA_GROUPS = [("g24", 2880, 5760, 24, (1, 64, 300))]
# what W4A16 leaves to its mma.sync kernel (w4a16_plan gives None): the
# group quantize_stacked gives In 262 (half 131, a prime: g 1), a K that is
# no multiple of 8 under a group the split path would take (131), and a
# group below a 16-deep step at GPT-OSS's width (8); W4A8 takes the first
# and last on its mma.sync kernel, 131 on split steps. (name, In, Out,
# group, Ms)
W4A16_MMA_GROUPS = [
    ("In 262", 262, 1000, 1, (1, 64, 300)), ("In 262 g131", 262, 1000, 131, (1, 64, 300)),
    ("g8", 2880, 5760, 8, (1, 64, 300)),
]


def stacked_rest_w4(In: int, Out: int, seed: int):
    """A weight [In -> Out] quantized by ``quantize_stacked`` (host numpy,
    from ``seed``) and packed on the card, with groups of one sign, a
    constant column and nearly constant ones: (q, s, z, group)."""
    import numpy as np

    from scratchpad_tpu_torch.ops.quant.w4_matmul import pack_w4
    from scratchpad_tpu_torch.ops.quant.w4a16 import quantize_stacked, stacked_group_size

    rng = np.random.default_rng(seed)
    g = stacked_group_size(In)
    w = (rng.normal(size=(1, In, Out)) / np.sqrt(In)).astype(np.float32)
    w[0, :g, :7] = np.abs(w[0, :g, :7]) + 0.01
    w[0, g:, 7:13] = -np.abs(w[0, g:, 7:13]) - 0.02
    w[0, :, 13] = 0.5
    w[0, :, 14:30] = 0.5 + 3e-2 * w[0, :, 14:30]
    q, s, z = (t[0].cuda() for t in pack_w4(quantize_stacked(w)))
    return q, s, z, g


def stacked_far_w4(In: int, Out: int, seed: int):
    """A weight [In -> Out] quantized by ``quantize_stacked`` (host numpy,
    from ``seed``) and packed on the card, whose first columns pair a nearly
    constant group of 0.5 (zero point near -31,000 in columns 0 and 2, -300
    in column 1) with one of -0.5 (near 2,070): (q, s, z, group)."""
    import numpy as np

    from scratchpad_tpu_torch.ops.quant.w4_matmul import pack_w4
    from scratchpad_tpu_torch.ops.quant.w4a16 import quantize_stacked, stacked_group_size

    rng = np.random.default_rng(seed)
    g = stacked_group_size(In)
    w = (rng.normal(size=(1, In, Out)) / np.sqrt(In)).astype(np.float32)
    for col, g0, zero in ((0, 0, 31000.0), (1, 0, 300.0), (2, 2, 31000.0)):
        w[0, g0 * g:(g0 + 1) * g, col] = 0.5 + rng.uniform(0, 1, g) * 7.5 / zero
        w[0, (g0 + 1) * g:(g0 + 2) * g, col] = -0.5 - rng.uniform(0, 1, g) * 7.5 / 2055.0
    q, s, z = (t[0].cuda() for t in pack_w4(quantize_stacked(w)))
    return q, s, z, g


def check_w4(errs: dict) -> None:
    """The row quantizer bit for bit, and both W4 GEMMs against their plain
    versions on the same int8 rows (W4A8, whose f32 output must round to
    its bf16 one bit for bit) or bf16 rows (W4A16), at
    Llama-3.2-1B's seven matrices and each M of ``W4_CHECK_M``, at
    ``W4_SMALL_GROUPS``, ``W4_ZERO_RESTS``, ``W4_STACKED_RESTS`` and
    ``W4_STACKED_FAR``; at GPT-OSS's 2880 -> 5760 (g 120, M 1, 64, 300 and
    8192) and at 1800 -> 1000 (g 100, Out padded to 1024), whose groups cut
    tensor-core steps (split steps), at ``W4_MMA_GROUPS`` (W4A8's
    mma.sync kernel) and at ``W4A16_MMA_GROUPS`` (W4A16's, which its plan
    must name). Row M // 2 is zeros: its outputs must be exact zeros.
    Where a plan splits K, a second call must give the same bits. Each
    case's seconds end its line."""
    import torch

    from scratchpad_tpu_torch.ops.quant.w4_matmul import (
        quantize_activations_plain,
        quantize_rows_int8,
        w4a8_matmul,
        w4a8_matmul_plain,
        w4a8_plan,
        w4a16_matmul,
        w4a16_matmul_plain,
        w4a16_plan,
    )

    mats = {name: (In, Out) for name, In, Out, _ in llama_1b_matrices()}
    plain = (0, 16)
    cases = [(name, In, Out, M, None, plain) for name, In, Out, _ in llama_1b_matrices() for M in W4_CHECK_M]
    cases += [(name, *mats[name], M, g, plain) for name, g, ms in W4_SMALL_GROUPS for M in ms]
    cases += [("gpt-oss gate_up", 2880, 5760, M, None, plain) for M in (1, 64, 300, 8192)]
    cases += [("g100", 1800, 1000, M, None, plain) for M in (1, 64, 300)]
    cases += [(name, In, Out, M, g, plain) for name, In, Out, g, ms in W4_MMA_GROUPS for M in ms]
    mma16 = len(cases)
    cases += [(name, In, Out, M, g, plain) for name, In, Out, g, ms in W4A16_MMA_GROUPS for M in ms]
    mma16 = range(mma16, len(cases))
    cases += [(name, In, Out, M, g, W4_REST_ZEROS) for name, In, Out, g, ms in W4_ZERO_RESTS for M in ms]
    cases += [(name, In, Out, M, None, "stacked") for name, In, Out, ms in W4_STACKED_RESTS for M in ms]
    cases += [(name, In, Out, M, None, "far") for name, In, Out, ms in W4_STACKED_FAR for M in ms]
    for i, (name, In, Out, M, group, zero_range) in enumerate(cases):
        t_case = time.monotonic()
        gen = seeded(3000 + i)
        if zero_range == "stacked":
            q, s, z, g = stacked_rest_w4(In, Out, 3000 + i)
        elif zero_range == "far":
            q, s, z, g = stacked_far_w4(In, Out, 3000 + i)
        else:
            q, s, z, g = random_w4(In, Out, 1, gen, group, zero_range)
            q, s, z = q[0], s[0], z[0]
        x = torch.randn(M, In, generator=gen, device="cuda").to(torch.bfloat16)
        zero = M // 2 if M > 1 else None
        if zero is not None:
            x[zero] = 0
        if zero_range == "far" and M > 2:  # rows of one value: a pair of groups cancels
            x[M - 1] = 1.0
        x8, ax, gsum = quantize_rows_int8(x, g)
        ref = quantize_activations_plain(x, g)
        exact = all(torch.equal(a, b) for a, b in zip((x8, ax, gsum), ref))
        n_diff = int((x8 != ref[0]).sum())
        eq = max(float((a.float() - b.float()).abs().max()) for a, b in zip((x8, ax, gsum), ref))
        y8 = w4a8_matmul(x8, ax, gsum, q, s, z, g, Out)
        e8, r8 = max_err(y8, w4a8_matmul_plain(x8, ax, gsum, q, s, z, g, Out))
        # the f32 output (a tensor-parallel rank's row-parallel partial):
        # the same f32 values that the bf16 output rounds
        y8f = w4a8_matmul(x8, ax, gsum, q, s, z, g, Out, f32=True)
        f32_same = y8f.dtype == torch.float32 and torch.equal(y8f.to(torch.bfloat16), y8)
        y16 = w4a16_matmul(x, q, s, z, g, Out)
        e16, r16 = max_err(y16, w4a16_matmul_plain(x, q, s, z, g, Out))
        plan8 = w4a8_plan(M, Out, In, g, s.shape[1])
        split8 = plan8 is not None and plan8.splits > 1
        same8 = not split8 or torch.equal(y8, w4a8_matmul(x8, ax, gsum, q, s, z, g, Out))
        plan = w4a16_plan(M, Out, In, g, s.shape[1])
        split = plan is not None and plan.splits > 1
        same = not split or torch.equal(y16, w4a16_matmul(x, q, s, z, g, Out))
        torch.cuda.synchronize()
        zeros = zero is None or bool((y8[zero] == 0).all() and (y16[zero] == 0).all())
        k8 = "w4a8_matmul" if plan8 is not None else "w4a8_matmul_mma"
        errs["quantize_rows_int8"] = max(errs["quantize_rows_int8"], eq)
        errs[k8] = max(errs[k8], e8)
        errs["w4a16_matmul"] = max(errs["w4a16_matmul"], e16)
        if g == 120:  # GPT-OSS's groups (rows 6 and 7 on their served path)
            errs[W4A8_G120] = max(errs[W4A8_G120], e8)
            errs[W4A16_G120] = max(errs[W4A16_G120], e16)
        route8 = f"plan {plan8.config}, split K {plan8.splits}" if plan8 is not None else "mma.sync"
        route16 = f"plan {plan.config}" if plan is not None else "mma.sync"
        log(
            f"[check] w4 {name} {In}->{Out} g={g} M={M}: quantizer exact {exact} "
            f"({n_diff} x8 differ); w4a8 ({route8}) max_abs_err {e8:.3e}, err/tol {r8:.3f}"
            + (f", second call bit-equal: {same8}" if split8 else "")
            + f", f32 output rounds to the bf16 one: {f32_same}"
            + f"; w4a16 ({route16}) max_abs_err {e16:.3e}, err/tol {r16:.3f}; zero row exact: {zeros}"
            + (f"; split K {plan.splits}, second call bit-equal: {same}" if split else "")
            + f" ({time.monotonic() - t_case:.2f} s)"
        )
        check((plan is None) == (i in mma16), f"w4a16 at {name} g={g} M={M} took route {route16}")
        check(exact, f"row quantizer differs from its plain version at {name} M={M}")
        check(r8 <= 1 and zeros, f"w4a8 kernel disagrees with its plain version at {name} g={g} M={M}")
        check(r16 <= 1 and zeros, f"w4a16 kernel disagrees with its plain version at {name} g={g} M={M}")
        check(same8, f"w4a8 split-K calls differ at {name} g={g} M={M}")
        check(f32_same, f"w4a8's f32 output does not round to its bf16 output at {name} g={g} M={M}")
        check(same, f"w4a16 split-K calls differ at {name} g={g} M={M}")
        del q, s, z, x, x8, y8, y8f, y16
        torch.cuda.empty_cache()


def llama_1b_projections():
    """(name, In, Out, calls per forward) of Llama-3.2-1B's distinct
    projection shapes, as the toppings pools keep them (gate and up apart)."""
    from scratchpad_tpu_torch.config.model_config import get_preset

    c = get_preset("llama-3.2-1b")
    H, I, L = c.hidden_size, c.intermediate_size, c.num_hidden_layers
    q_out, kv_out = c.num_attention_heads * c.head_dim, c.num_kv_heads * c.head_dim
    assert q_out == H
    return [
        ("wq|wo", H, q_out, 2 * L), ("wk|wv", H, kv_out, 2 * L),
        ("gate|up", H, I, 2 * L), ("down", I, H, L),
    ]


# pool adapters of the delta checks: 3 and 0 carry no delta (3 is LoRA only)
DELTA_HAS = [0, 1, 1, 0, 1, 1, 1, 1]
# (active_adapters, the slots tokens take)
DELTA_LAYOUTS = {
    "one slot": ([0, 2, 0, 0, 0, 0, 0, 0], [1]),
    "all eight mixed": ([0, 1, 2, 3, 4, 5, 6, 7], list(range(8))),
    "a slot with no tokens": ([0, 1, 2, 4, 0, 0, 0, 0], [0, 1, 3]),
    "a LoRA-only slot": ([0, 3, 0, 0, 0, 0, 0, 0], [0, 1]),
    "no adapter": ([0] * 8, [0]),
}


def delta_pool(In: int, Out: int, layers: int, gen, N: int = 8):
    """A random delta pool like the manager's: int8 codes ``[N, layers, In,
    Out]`` (slot 0 zero) and f32 per-out-channel scales, with the flags of
    ``DELTA_HAS`` and scalings 0.5 to 2.0."""
    import torch

    dq = torch.randint(-127, 128, (N, layers, In, Out), generator=gen, device="cuda", dtype=torch.int8)
    dq[0] = 0
    ds = torch.rand(N, layers, Out, generator=gen, device="cuda") * 2e-3
    has = torch.tensor(DELTA_HAS[:N], dtype=torch.int32, device="cuda")
    return dq, ds, has, torch.linspace(0.5, 2.0, N, device="cuda")


def delta_rows(T: int, choices, gen):
    import torch

    pick = torch.randint(0, len(choices), (T,), generator=gen, device="cuda")
    return torch.tensor(choices, dtype=torch.int32, device="cuda")[pick]


# tokens of the delta checks: decode, the launch plan's edges (64 | 65 rows,
# 128 | 129), a prefill chunk; and an Out that no tile width divides
DELTA_CHECK_T = (1, 7, 64, 65, 129, 2048)
DELTA_EDGE = ("out 1000", 2048, 1000, 0)


def check_delta(errs: dict) -> None:
    """The grouped delta kernel against its plain version's f32 sums on
    the rows of delta slots, at Llama-3.2-1B's projection shapes and at
    ``DELTA_EDGE``, each T of ``DELTA_CHECK_T`` and every layout of
    ``DELTA_LAYOUTS``; every other row must come out bit-equal to the input.
    Where the plan splits K, a second call must give the same bits."""
    import torch

    from scratchpad_tpu_torch.ops.ldmm import delta_matmul_grouped, delta_matmul_grouped_plain
    from scratchpad_tpu_torch.ops.quant.w4_matmul import gemm_plan

    for i, (name, In, Out, _) in enumerate(llama_1b_projections() + [DELTA_EDGE]):
        gen = seeded(8000 + i)
        dq, ds, has, scaling = delta_pool(In, Out, 3, gen)  # checked at layer 1 of 3
        for T in DELTA_CHECK_T:
            x = torch.randn(T, In, generator=gen, device="cuda").to(torch.bfloat16)
            out0 = torch.randn(T, Out, generator=gen, device="cuda").to(torch.bfloat16)
            for layout, (active, choices) in DELTA_LAYOUTS.items():
                act = torch.tensor(active, dtype=torch.int32, device="cuda")
                slots = delta_rows(T, choices, gen)
                args = (x, dq, ds, 1, act, has, scaling, slots)
                got = delta_matmul_grouped(out0.clone(), *args)
                ref = delta_matmul_grouped_plain(out0.float(), *args)
                splits = gemm_plan(T, Out, In, slots=len(active) - 1).splits
                same = splits == 1 or torch.equal(got, delta_matmul_grouped(out0.clone(), *args))
                torch.cuda.synchronize()
                touched = (slots > 0) & (has[act[slots].long()] > 0)
                e, ratio = max_err(got[touched], ref[touched]) if bool(touched.any()) else (0.0, 0.0)
                kept = bool(torch.equal(got[~touched], out0[~touched]))
                errs["delta_matmul_grouped"] = max(errs["delta_matmul_grouped"], e)
                log(
                    f"[check] delta {name} {In}->{Out} T={T} {layout}: {int(touched.sum())} rows in "
                    f"delta slots, max_abs_err {e:.3e}, err/tol {ratio:.3f}; other rows bit-equal: {kept}"
                    + (f"; split K {splits}, second call bit-equal: {same}" if splits > 1 else "")
                )
                check(
                    ratio <= 1 and kept,
                    f"delta kernel disagrees with its plain version at {name} T={T} {layout}",
                )
                check(same, f"delta split-K calls differ at {name} T={T} {layout}")
        del dq, ds
        torch.cuda.empty_cache()


def bf16_ulp_err(out, ref) -> tuple[float, float]:
    """max |out - ref| of two bf16 tensors and its largest ratio to one bf16
    ulp of ``ref`` (<= 1 passes)."""
    import torch

    r = ref.float()
    ulp = torch.ldexp(torch.ones_like(r), torch.frexp(r)[1] - 8)
    d = (out.float() - r).abs()
    return float(d.max()), float((d / ulp).max())


# check_decode_ablate's cases (ctx, G, Dp) at B 64, Hkv 8, page 16, 16-page
# chunks: the JAX probe's ctx 192 and 1000 (4 chunks) at every G the kernel
# is built for, and 4096 (16 chunks)
ABLATE_CHECKS = [(ctx, G, Dp) for ctx in (192, 1000) for G in (3, 4) for Dp in (64, 128)] + [
    (ctx, G, Dp) for ctx in (192, 1000) for G in (1, 2, 8) for Dp in (64, 128)
] + [(4096, 4, 128), (4096, 1, 64), (4096, 8, 128)]


def check_decode_ablate(errs: dict) -> None:
    """Row 10, the decode ablation probe, against its plain version in all
    five modes at each of ``ABLATE_CHECKS``, rows of up to ctx tokens with
    one of 0 and one of 1, over a random pool and page table. ``out``
    within one bf16 ulp, ``aux`` within ``aux_tolerance`` (m exact); one
    launch a call, and a second call bit-equal: the last CTA of a row
    writes its ``out`` and resets the row's counter."""
    import torch

    from scratchpad_tpu_torch.ops.attention import decode_ablate, decode_ablate_plain
    from scratchpad_tpu_torch.ops.attention.decode_ablate import MODES, aux_tolerance

    B, Hkv, ps, CP = 64, 8, 16, 16
    for i, (ctx, G, Dp) in enumerate(ABLATE_CHECKS):
        gen = seeded(14_001 + i)
        P = -(-ctx // (CP * ps)) * CP
        pages = B * P + 1
        kv = torch.randn(pages, ps, 2 * Hkv, Dp, generator=gen, device="cuda").to(torch.bfloat16)
        pt = torch.randint(0, pages, (B, P), generator=gen, device="cuda", dtype=torch.int32)
        q = torch.randn(B, Hkv * G, Dp, generator=gen, device="cuda").to(torch.bfloat16)
        lens = torch.randint(ctx // 2, ctx + 1, (B,), generator=gen, device="cuda")
        lens[0], lens[1], lens[2] = ctx, 0, 1
        lens = lens.to(torch.int32)
        for mode in MODES:
            before = decode_ablate.launches
            out, aux = decode_ablate(q, kv, pt, lens, mode)
            counted = decode_ablate.launches - before
            again, again_aux = decode_ablate(q, kv, pt, lens, mode)
            ref_out, ref_aux = decode_ablate_plain(q, kv, pt, lens, mode)
            torch.cuda.synchronize()
            e, ulps = bf16_ulp_err(out, ref_out)
            tol = aux_tolerance(ref_aux, mode, ATOL)
            d = (aux - ref_aux).abs()
            m_exact = bool((d[..., 0] == 0).all())
            aux_ratio = float((d[..., 1:] / tol[..., 1:]).max())
            same = bool(torch.equal(again, out) and torch.equal(again_aux, aux))
            errs["decode_ablate"] = max(errs["decode_ablate"], e)
            log(
                f"[check] decode_ablate {mode} ctx={ctx} G={G} Dp={Dp}: out max_abs_err "
                f"{e:.3e} ({ulps:.2f} bf16 ulp), aux m exact: {m_exact}, aux l/checksum "
                f"max err/tol {aux_ratio:.3f}, launches counted: {counted}, second call "
                f"bit-equal: {same}"
            )
            check(ulps <= 1 and m_exact and aux_ratio <= 1 and counted == 1 and same,
                  f"decode_ablate {mode} disagrees with its plain version at ctx={ctx} "
                  f"G={G} Dp={Dp}")
        del kv
    torch.cuda.empty_cache()


def check_decode_stages() -> None:
    """The decode kernel's stage cuts (variant libraries: stages 1, 2, 3 and
    5) against their plain functions at every shape the stage table times
    (``tools/decode_ablate.STAGE_SHAPES``: Llama-3.2-1B, 3B and Mistral-7B):
    B 64, ctx 4096, page 16, Hkv 8, lengths down to 2048 and one padding
    row."""
    import torch

    from scratchpad_tpu_torch.ops.attention.gqa_decode import (
        DECODE_STAGES,
        paged_decode_attention_stage,
        paged_decode_attention_stage_plain,
    )
    from scratchpad_tpu_torch.tools.decode_ablate import STAGE_SHAPES

    for label, (G, D) in STAGE_SHAPES.items():
        gen = seeded(15_000 + G + D)
        lens = torch.randint(2048, 4097, (64,), generator=gen, device="cuda")
        lens[0], lens[1] = 4096, 0
        lens = lens.to(torch.int32)
        k, v, pt = make_pool(lens.tolist(), 8, D, 16, 1, gen)
        q = torch.randn(64, 8 * G, D, generator=gen, device="cuda").to(torch.bfloat16)
        scale = 1.0 / math.sqrt(D)
        for stage in (s for s in DECODE_STAGES if s != 4):
            out = paged_decode_attention_stage(stage, q, k[0], v[0], pt, lens, scale)
            ref = paged_decode_attention_stage_plain(stage, q, k[0], v[0], pt, lens, scale)
            torch.cuda.synchronize()
            e, ratio = max_err(out, ref)
            zero = bool((out[lens == 0] == 0).all())
            log(f"[check] decode stage {stage} {label} G={G} D={D} B=64 ctx=4096: max_abs_err "
                f"{e:.3e}, max err/tol {ratio:.3f}, zero rows exact: {zero}")
            check(ratio <= 1 and zero,
                  f"decode stage {stage} disagrees with its plain function at {label}")
        del k, v
        torch.cuda.empty_cache()


# --------------------------------------------------------- phase 5 (kernels)


def dense_kv(cache, scale, pt, ps: int, B: int, n: int):
    """The first n cached tokens of each sequence as dense bf16 [B, Hkv, n,
    D] (dequantized for 8-bit pages), for the library yardstick."""
    import torch

    from scratchpad_tpu_torch.ops.attention.gqa_decode import gather_kv_rows

    slots = (pt.long()[:, :, None] * ps + torch.arange(ps, device="cuda")).reshape(B, -1)[:, :n]
    return gather_kv_rows(cache, scale, slots).to(torch.bfloat16).transpose(1, 2).contiguous()


def with_zero_key(t):
    """Dense ``[B, Hkv, S, D]`` keys or values with one zero row appended
    (``[B, Hkv, S + 1, D]``): the sink's key and value for the library
    yardstick."""
    import torch

    return torch.cat([t, t.new_zeros(*t.shape[:2], 1, t.shape[3])], dim=2)


def sink_mask(keep, sinks, dtype=None):
    """The additive ``attn_mask [1, Hq, Lq, S + 1]`` (bf16, or ``dtype``) of
    SDPA over keys that end in a zero key (``with_zero_key``): 0 where
    ``keep [Lq, S]``
    holds, -inf elsewhere, and each query head's sink in the last column.
    The zero key's score is 0, so its masked score is the sink, and its zero
    value adds nothing: the softmax with a sink, in one PyTorch call."""
    import torch

    Lq, S = keep.shape
    m = torch.zeros(1, sinks.numel(), Lq, S + 1, dtype=dtype or torch.bfloat16, device=keep.device)
    m[..., :S].masked_fill_(~keep, float("-inf"))
    m[..., S] = sinks.to(m.dtype)[:, None]
    return m


def check_sink_yardstick(lib, plain, what: str) -> None:
    """The sinks' library call computes the kernel's function: within 2^-5
    of the plain version's max |output| (SDPA rounds in bf16: it read
    7.8e-3 and 1.6e-2 from the plain versions on the card; sinks dropped or
    of the wrong sign move a row that sees a few keys by tens of per cent).
    ``tests/test_torch_sinks.py`` holds its construction in f32 within
    1e-5."""
    err, scale = float((lib.float() - plain.float()).abs().max()), float(plain.float().abs().max())
    log(f"[time] the sinks' SDPA yardstick against the plain {what}: max|diff| {err:.3e} of max|out| {scale:.3e}")
    check(err <= 2**-5 * scale, f"the sinks' SDPA yardstick differs from the plain {what} by {err:.3e}")


def time_decode(B: int, ctx: int, D: int = 64, G: int = 4, kind: str = "bf16",
                window=None, wrapper: str = "auto", Hkv: int = 8, sinks: bool = False,
                chunk: int | None = None, beside_bf16: bool = False) -> dict:
    """Decode at page 16 over Hkv 8: Llama-3.2-1B is G 4, D 64; 3B is G 3,
    D 128; Mistral-7B G 4, D 128, with its window of 4096; Gemma-2-2B G 2,
    D 256 over Hkv 4, its local layers' window 4096; GPT-OSS-20B G 8, D
    64, its local window 128. ``kind``: bf16 pages, or int8 / fp8 codes
    with bf16 scales. ``wrapper`` "pallas": the kernel through
    ``decode_attention_pallas`` (row 9). The bound counts the bytes and
    operations of the live window only; the library call attends over every
    token, the window as its ``attn_mask``. ``sinks``: N(0, 2^2) sinks, the
    kernel timed with and without them in turns (with, without, without,
    with; ``ms_without_sinks``); the library call attends over one more,
    zero key and value, whose additive mask is each head's sink
    (``sink_mask``). ``chunk``: Llama-4's chunk, timed with and without
    it in turns the same way (``ms_without_chunk``); the bound counts the
    query's chunk only, and the library call masks the chunk.
    ``beside_bf16``: 8-bit pages timed in turns with the bf16 pages they
    were quantized from, the same call (``ms_bf16``)."""
    import torch
    import torch.nn.functional as F

    from scratchpad_tpu_torch.memory.kv_cache import KVCache
    from scratchpad_tpu_torch.ops.attention import decode_attention_pallas, paged_decode_attention_plain

    ps = 16
    elem = 2 if kind == "bf16" else 1
    per_layer = B * ctx * Hkv * D * 2 * elem
    layers = max(2, min(16, -(-256 * 2**20 // per_layer)))
    gen = seeded(1000 + B + ctx + D + G)
    lens = torch.full((B,), ctx, dtype=torch.int32, device="cuda")
    k, v, pt = make_pool(lens.tolist(), Hkv, D, ps, layers, gen)
    k16, v16 = (k, v) if beside_bf16 else (None, None)
    k, v, ks, vs = quant_pages(k, v, kind)
    q = torch.randn(B, Hkv * G, D, generator=gen, device="cuda").to(torch.bfloat16)
    scale = 1.0 / math.sqrt(D)
    sk = sink_values("normal", Hkv * G, gen) if sinks else None
    if wrapper == "pallas":
        meta, pool = decode_meta(pt, lens), KVCache(k, v)
        kern = lambda l: decode_attention_pallas(q, pool, l, meta, sm_scale=scale, sliding_window=window)
    else:
        kern = lambda l: decode_kernel(q, k[l], v[l], at(ks, l), at(vs, l), pt, lens, scale, None, window, sk,
                                       chunk)
    plain = lambda l: paged_decode_attention_plain(
        q, k[l], v[l], pt, lens, scale, at(ks, l), at(vs, l), None, window, sk, chunk
    )
    if sinks or chunk:
        bare = lambda l: decode_kernel(q, k[l], v[l], at(ks, l), at(vs, l), pt, lens, scale, None, window)
        turns = [device_ms(fn, layers, 50) for fn in (kern, bare, bare, kern)]
    if beside_bf16:
        b16 = lambda l: decode_kernel(q, k16[l], v16[l], None, None, pt, lens, scale, None, window)
        turns = [device_ms(fn, layers, 50) for fn in (kern, b16, b16, kern)]
    # dense [B, Hkv, S, D] bf16 copies for the library call, made once
    kd = [dense_kv(k[l], at(ks, l), pt, ps, B, ctx) for l in range(layers)]
    vd = [dense_kv(v[l], at(vs, l), pt, ps, B, ctx) for l in range(layers)]
    q4 = q.view(B, Hkv * G, 1, D)
    first = (ctx - 1) // chunk * chunk if chunk else max(ctx - (window or ctx), 0)
    mask = None
    if window is not None or chunk:
        mask = (torch.arange(ctx, device="cuda") >= first)[None, None, None, :]
    if sinks:
        kd, vd = [with_zero_key(t) for t in kd], [with_zero_key(t) for t in vd]
        keep = torch.arange(ctx, device="cuda")[None, :] >= ctx - (window or ctx)
        mask = sink_mask(keep, sk)
    lib = lambda l: F.scaled_dot_product_attention(
        q4, kd[l], vd[l], attn_mask=mask, scale=scale, enable_gqa=True
    )
    if sinks:
        check_sink_yardstick(lib(0).view(B, Hkv * G, D), plain(0), "decode")
    live = ctx - first
    kv_bytes = B * live * Hkv * 2 * (D * elem + (0 if kind == "bf16" else 2))
    nbytes = q.numel() * 2 * 2 + kv_bytes + pt.numel() * 4 + B * 4
    flops = 4.0 * B * live * Hkv * G * D
    b, by = bound_ms(nbytes, flops)
    r = dict(
        shape=f"{kind} pages, B={B} ctx={ctx} window={window} Hq={Hkv * G} Hkv={Hkv} D={D} "
        f"page={ps}" + (" (decode_attention_pallas)" if wrapper == "pallas" else "")
        + (", sinks" if sinks else "") + (f", chunk {chunk} ({live} live keys a row)" if chunk else ""),
        ms=(turns[0] + turns[3]) / 2 if sinks or chunk or beside_bf16 else device_ms(kern, layers, 50),
        plain_ms=device_ms(plain, layers, 5),
        library_ms=device_ms(lib, layers, 50),
        bound_ms=b,
        bound_by=by,
    )
    if sinks or chunk or beside_bf16:
        r["ms_bf16" if beside_bf16 else "ms_without_sinks" if sinks else "ms_without_chunk"] = (
            (turns[1] + turns[2]) / 2)
    del kd, vd, k, v, k16, v16
    torch.cuda.empty_cache()
    return r


def time_extend(chunks, D: int = 64, G: int = 4, kind: str = "bf16", window=None,
                Hkv: int = 8, sinks: bool = False, chunk: int | None = None,
                beside_bf16: bool = False, spans=None) -> dict:
    """The extend at page 16 over Hkv 8 (or ``Hkv``); with ``window`` (or
    ``chunk``), the bound counts the keys some query's window (or chunk)
    holds and the pairs the windows (chunks) attend. ``sinks`` and
    ``chunk``: as ``time_decode``'s (the library call's mask is then
    ``[1, Hq, q_len, kv_len + 1]``, or the chunk's boolean one), and so is
    ``beside_bf16``. ``spans``: every sequence's bidirectional spans, timed
    with and without them in turns; the bound counts the pairs they add and
    the library call takes them in its boolean mask."""
    import torch
    import torch.nn.functional as F

    from scratchpad_tpu_torch.ops.attention import paged_extend_attention_plain

    ps = 16
    elem = 2 if kind == "bf16" else 1
    kv_total = sum(c[1] for c in chunks)
    per_layer = kv_total * Hkv * D * 2 * elem
    layers = max(2, min(16, -(-256 * 2**20 // per_layer)))
    gen = seeded(2000 + len(chunks) + D + G)
    q_lens = [c[0] for c in chunks]
    kv_lens = torch.tensor([c[1] for c in chunks], dtype=torch.int32, device="cuda")
    cu = torch.zeros(len(chunks) + 1, dtype=torch.int32, device="cuda")
    cu[1:] = torch.cumsum(torch.tensor(q_lens, device="cuda"), 0).to(torch.int32)
    T = sum(q_lens)
    k, v, pt = make_pool(kv_lens.tolist(), Hkv, D, ps, layers, gen)
    k16, v16 = (k, v) if beside_bf16 else (None, None)
    k, v, ks, vs = quant_pages(k, v, kind)
    q = torch.randn(T, Hkv * G, D, generator=gen, device="cuda").to(torch.bfloat16)
    scale = 1.0 / math.sqrt(D)
    sk = sink_values("normal", Hkv * G, gen) if sinks else None
    mm = None if spans is None else torch.tensor([spans] * len(chunks), dtype=torch.int32, device="cuda")
    kern = lambda l: extend_kernel(q, k[l], v[l], at(ks, l), at(vs, l), pt, kv_lens, cu, scale, None,
                                   window, sk, chunk, mm)
    plain = lambda l: paged_extend_attention_plain(
        q, k[l], v[l], pt, kv_lens, cu, scale, at(ks, l), at(vs, l), None, window, sk, chunk, mm
    )
    if sinks or chunk or spans:
        bare = lambda l: extend_kernel(q, k[l], v[l], at(ks, l), at(vs, l), pt, kv_lens, cu, scale, None,
                                       window)
        turns = [device_ms(fn, layers, 10) for fn in (kern, bare, bare, kern)]
    if beside_bf16:
        b16 = lambda l: extend_kernel(q, k16[l], v16[l], None, None, pt, kv_lens, cu, scale, None, window)
        turns = [device_ms(fn, layers, 10) for fn in (kern, b16, b16, kern)]
    # library yardstick: one SDPA call over the batch when every sequence
    # has the same (q_len, kv_len), with the tail-aligned causal mask
    assert len(set(chunks)) == 1, "library yardstick needs one (q_len, kv_len)"
    ql, kl = chunks[0]
    B = len(chunks)
    kd = [dense_kv(k[l], at(ks, l), pt, ps, B, kl) for l in range(layers)]
    vd = [dense_kv(v[l], at(vs, l), pt, ps, B, kl) for l in range(layers)]
    qd = q.view(B, ql, Hkv * G, D).transpose(1, 2).contiguous()
    j = torch.arange(kl, device="cuda")[None, :]
    p = (kl - ql + torch.arange(ql, device="cuda"))[:, None]
    keep = (j <= p) & (j > p - (window or kl + 1))
    if chunk:
        keep &= j >= p // chunk * chunk
    for s0, s1 in spans or ():
        keep |= (p >= s0) & (p < s1) & (j >= s0) & (j < s1)
    if sinks:
        kd, vd = [with_zero_key(t) for t in kd], [with_zero_key(t) for t in vd]
        mask = sink_mask(keep, sk)
        lib = lambda l: F.scaled_dot_product_attention(
            qd, kd[l], vd[l], attn_mask=mask, scale=scale, enable_gqa=True
        )
        check_sink_yardstick(lib(0).transpose(1, 2).reshape(T, Hkv * G, D), plain(0), "extend")
    elif ql == kl and window is None and not chunk and not spans:
        lib = lambda l: F.scaled_dot_product_attention(
            qd, kd[l], vd[l], is_causal=True, scale=scale, enable_gqa=True
        )
    else:
        lib = lambda l: F.scaled_dot_product_attention(
            qd, kd[l], vd[l], attn_mask=keep, scale=scale, enable_gqa=True
        )
    # pairs (query, key) attended, and the keys some query's window (or
    # chunk) holds: from the first query's first live key to the last key
    W = window or max(c[1] for c in chunks) + 1

    def start(p_):
        lo = p_ // chunk * chunk if chunk else max(p_ - W + 1, 0)
        return min([lo] + [s0 for s0, s1 in spans or () if s0 <= p_ < s1])

    def end(p_, k_):  # the last key the query sees
        return max([p_] + [min(s1, k_) - 1 for s0, s1 in spans or () if s0 <= p_ < s1])

    attended = sum(end(p_, k_) + 1 - start(p_) for q_, k_ in chunks for p_ in range(k_ - q_, k_))
    live = sum(k_ - min(start(p_) for p_ in range(k_ - q_, k_)) for q_, k_ in chunks)
    kv_bytes = live * Hkv * 2 * (D * elem + (0 if kind == "bf16" else 2))
    nbytes = T * Hkv * G * D * 2 * 2 + kv_bytes + pt.numel() * 4
    flops = 4.0 * attended * Hkv * G * D
    b, by = bound_ms(nbytes, flops)
    r = dict(
        shape=f"{kind} pages, {len(chunks)} x (q_len {ql}, kv_len {kl}) window={window} "
        f"Hq={Hkv * G} Hkv={Hkv} D={D} page={ps}" + (", sinks" if sinks else "")
        + (f", chunk {chunk}" if chunk else "") + (f", {len(spans)} spans" if spans else ""),
        ms=(turns[0] + turns[3]) / 2 if sinks or chunk or spans or beside_bf16 else device_ms(kern, layers, 10),
        plain_ms=device_ms(plain, layers, 2, reps=3),
        library_ms=device_ms(lib, layers, 10),
        bound_ms=b,
        bound_by=by,
    )
    if sinks or chunk or spans or beside_bf16:
        key = ("ms_bf16" if beside_bf16 else "ms_without_sinks" if sinks else "ms_without_chunk" if chunk
               else "ms_without_spans")
        r[key] = (turns[1] + turns[2]) / 2
    del kd, vd, k, v, k16, v16
    torch.cuda.empty_cache()
    return r


def time_w4(name: str, In: int, Out: int, M: int, group: int | None = None) -> dict:
    """Both W4 GEMMs at one matrix and M: median device ms beside the bound,
    the plain versions and ``torch.matmul`` of bf16 x with the weight
    dequantized to bf16 beforehand (a yardstick the port never calls).
    Calls cycle over enough weight copies (up to 128 MiB of codes) that the
    weights do not stay in L2, as on the main path. ``group``: another
    group than ``quantize_stacked``'s."""
    import torch

    from scratchpad_tpu_torch.ops.quant.w4_matmul import (
        padded_in,
        quantize_rows_int8,
        unpack_w4,
        w4a8_matmul,
        w4a8_matmul_plain,
        w4a16_matmul,
        w4a16_matmul_plain,
    )

    Kp = padded_in(In)
    copies = max(2, min(64, -(-128 * 2**20 // (Out * Kp // 2))))
    gen = seeded(4000 + In + Out + M)
    q, s, z, g = random_w4(In, Out, copies, gen, group)
    G = In // g
    x = torch.randn(M, In, generator=gen, device="cuda").to(torch.bfloat16)
    x8, ax, gsum = quantize_rows_int8(x, g)
    deq = [
        ((unpack_w4(q[l], In)[:, :Out].float() + 8.0 - z[l, :, :Out].float().repeat_interleave(g, 0))
         * s[l, :, :Out].float().repeat_interleave(g, 0)).to(torch.bfloat16)
        for l in range(min(copies, max(2, -(-256 * 2**20 // (In * Out * 2)))))
    ]
    iters = 50 if M <= 64 else 10
    w_bytes = Out * In / 2 + 2 * G * Out * 2
    a8_bytes = M * Kp + M * 4 + M * G * 4 + w_bytes + M * Out * 2
    a16_bytes = M * In * 2 + w_bytes + M * Out * 2
    ops = 2.0 * M * In * Out
    r = dict(shape=f"{name} {In}->{Out} g={g} M={M}")
    r["w4a8_matmul"] = dict(
        ms=device_ms(lambda l: w4a8_matmul(x8, ax, gsum, q[l], s[l], z[l], g, Out), copies, iters),
        plain_ms=device_ms(lambda l: w4a8_matmul_plain(x8, ax, gsum, q[l], s[l], z[l], g, Out), copies, 2, reps=3),
        library_ms=device_ms(lambda l: torch.matmul(x, deq[l % len(deq)]), len(deq), iters),
        nbytes=a8_bytes, ops=ops, peak=INT8_OPS,
    )
    r["w4a16_matmul"] = dict(
        ms=device_ms(lambda l: w4a16_matmul(x, q[l], s[l], z[l], g, Out), copies, iters),
        plain_ms=device_ms(lambda l: w4a16_matmul_plain(x, q[l], s[l], z[l], g, Out), copies, 2, reps=3),
        library_ms=r["w4a8_matmul"]["library_ms"],
        nbytes=a16_bytes, ops=ops, peak=BF16_FLOPS,
    )
    for t in (r["w4a8_matmul"], r["w4a16_matmul"]):
        t["bound_ms"], t["bound_by"] = bound_ms(t["nbytes"], t["ops"], t["peak"])
    del q, s, z, deq
    torch.cuda.empty_cache()
    return r


def time_quantizer(In: int, M: int) -> dict:
    """The row quantizer at one (M, In), g 128: bytes bound (x read, x8, ax
    and gsum written); no single PyTorch call computes it."""
    import torch

    from scratchpad_tpu_torch.ops.quant.w4_matmul import (
        padded_in,
        quantize_activations_plain,
        quantize_rows_int8,
    )

    copies = max(2, min(64, -(-128 * 2**20 // (M * In * 2))))
    xs = torch.randn(copies, M, In, generator=seeded(5000 + In + M), device="cuda").to(torch.bfloat16)
    nbytes = M * In * 2 + M * padded_in(In) + M * 4 + M * (In // 128) * 4
    b, by = bound_ms(nbytes, 0.0)
    r = dict(
        shape=f"M={M} In={In} g=128",
        ms=device_ms(lambda l: quantize_rows_int8(xs[l], 128), copies, 50),
        plain_ms=device_ms(lambda l: quantize_activations_plain(xs[l], 128), copies, 5),
        library_ms=None,
        bound_ms=b,
        bound_by=by,
    )
    del xs
    torch.cuda.empty_cache()
    return r


# the row quantizer's timed shapes (In, M): the 1B's two input widths at
# decode and at the bench prefill
QUANT_TIMED = [(In, M) for In in (2048, 8192) for M in (64, 8192)]


def w4_timed_shapes():
    """(name, In, Out, calls per 1B decode forward, M) of phase_w4_timing:
    Llama-3.2-1B's matrices at M 64 and (but the head) 8192, then the groups
    that cut a tensor-core step (GPT-OSS's 2880 -> 5760 at g 120, M 64 and
    8192; 1800 -> 1000 at g 100, M 64), outside the per-forward sums."""
    shapes = [
        (name, In, Out, calls, M)
        for name, In, Out, calls in llama_1b_matrices()
        for M in ((64,) if name == "lm_head" else (64, 8192))
    ]
    shapes += [("gpt-oss gate_up", 2880, 5760, 0, 64), ("g100", 1800, 1000, 0, 64)]
    return shapes + [("gpt-oss gate_up", 2880, 5760, 0, 8192)]


def phase_w4_timing() -> dict:
    """Every W4 matrix of Llama-3.2-1B at decode (M = 64) and prefill
    (M = 8192, the bench prefill of 64 x 128) shapes; the head at M = 64
    only, since it runs on each sequence's last token. Per kernel, the
    per-forward sums at bs 64 (calls x ms over the seven matrices) go to the
    ``kernels`` line. The groups that the JAX package's u8 half-plane
    kernels served (120 at GPT-OSS's 2880 -> 5760, and 100), which cut a
    tensor-core step, are timed beside them, outside those sums, W4A8's
    mma.sync kernel at ``W4_MMA_GROUPS``'s group of 24 (M 64), and both
    mma.sync kernels at ``W4A16_MMA_GROUPS``'s group of 8 (M 64)."""
    rows = []
    for name, In, Out, calls, M in w4_timed_shapes():
        wall = time.monotonic()
        r = time_w4(name, In, Out, M)
        r["calls"] = calls
        rows.append(r)
        for k in ("w4a8_matmul", "w4a16_matmul"):
            t = r[k]
            log(
                f"[time] {k} {r['shape']}: {t['ms']:.4f} ms; bound {t['bound_ms']:.4f} ms "
                f"({t['bound_by']}); plain {t['plain_ms']:.4f} ms; torch.matmul bf16 "
                f"{t['library_ms']:.4f} ms"
            )
        log(f"[time] {r['shape']}: timed in {time.monotonic() - wall:.1f} s")
    quant = {(In, M): time_quantizer(In, M) for In, M in QUANT_TIMED}
    for r in quant.values():
        log(
            f"[time] quantize_rows_int8 {r['shape']}: {r['ms']:.4f} ms; bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}); plain {r['plain_ms']:.4f} ms"
        )
    per_fwd = {}
    dec = [r for r in rows if r["shape"].endswith("M=64")]
    for k in ("w4a8_matmul", "w4a16_matmul"):
        total = {
            f: sum(r["calls"] * r[k][f] for r in dec)
            for f in ("ms", "plain_ms", "library_ms", "nbytes", "ops")
        }
        per_fwd[k] = dict(
            shape="one decode forward of Llama-3.2-1B at bs 64 (6 matrices x 16 layers + head)",
            **{f: total[f] for f in ("ms", "plain_ms", "library_ms")},
        )
        per_fwd[k]["bound_ms"], per_fwd[k]["bound_by"] = bound_ms(
            total["nbytes"], total["ops"], dec[0][k]["peak"]
        )
    # per forward: 5 of the 6 per-layer inputs and the head's are 2048 wide
    n2048, n8192 = 5 * 16 + 1, 16
    a, b = quant[(2048, 64)], quant[(8192, 64)]
    per_fwd["quantize_rows_int8"] = dict(
        shape="one decode forward of Llama-3.2-1B at bs 64 (81 calls at In 2048, 16 at In 8192)",
        **{f: n2048 * a[f] + n8192 * b[f] for f in ("ms", "plain_ms", "bound_ms")},
        library_ms=None,
        bound_by="bytes",
    )
    log(
        f"[time] W4A8 linear, one decode forward of Llama-3.2-1B at bs 64 (97 quantizer and 97 "
        f"GEMM calls): {per_fwd['quantize_rows_int8']['ms'] + per_fwd['w4a8_matmul']['ms']:.4f} ms; "
        f"torch.matmul bf16 {per_fwd['w4a8_matmul']['library_ms']:.4f} ms"
    )
    # W4A8's mma.sync kernel: the groups below a 32-deep step
    name, In, Out, g, _ = W4_MMA_GROUPS[0]
    r = time_w4(name, In, Out, 64, g)
    t = r["w4a8_matmul"]
    log(f"[time] w4a8_matmul_mma {r['shape']}: {t['ms']:.4f} ms; bound {t['bound_ms']:.4f} ms "
        f"({t['bound_by']}); plain {t['plain_ms']:.4f} ms; torch.matmul bf16 {t['library_ms']:.4f} ms")
    per_fwd["w4a8_matmul_mma"] = dict(t, shape=r["shape"])
    # both mma.sync kernels: a group below a 16-deep step
    name, In, Out, g, _ = W4A16_MMA_GROUPS[-1]
    r = time_w4(name, In, Out, 64, g)
    for k in ("w4a8_matmul", "w4a16_matmul"):
        t = r[k]
        log(f"[time] {k}_mma {r['shape']}: {t['ms']:.4f} ms; bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']}); plain {t['plain_ms']:.4f} ms; torch.matmul bf16 {t['library_ms']:.4f} ms")
    return dict(rows=rows, quant=quant, per_forward=per_fwd)


def time_delta(In: int, Out: int, T: int, n_delta: int) -> dict:
    """The grouped delta kernel at one projection: T rows spread round-robin
    over slots 0..3 (the engine bench's none, LoRA, LoRA, delta) with
    ``n_delta`` of slots 1..3 holding a delta adapter, or, for
    ``n_delta == 0``, one prefill chunk of T rows all in one delta slot.
    Bound: the bytes of each active delta slot's panel, scales, rows of x
    and rows of out read and written, or 2 * rows * In * Out operations at
    the bf16 rate. Library yardstick: ``torch.bmm`` of each delta slot's rows
    with its panel dequantized and scaled to bf16 beforehand. Calls cycle
    over enough layers (up to 128 MiB of codes) to leave L2 cold."""
    import torch

    from scratchpad_tpu_torch.ops.ldmm import delta_matmul_grouped, delta_matmul_grouped_plain

    layers = max(2, min(64, -(-128 * 2**20 // (In * Out))))
    gen = seeded(9000 + In + Out + T + n_delta)
    dq, ds, _, scaling = delta_pool(In, Out, layers, gen, N=4)
    if n_delta:
        has = torch.tensor([0] + [int(j >= 4 - n_delta) for j in range(1, 4)], dtype=torch.int32, device="cuda")
        slots = (torch.arange(T, device="cuda") % 4).to(torch.int32)
    else:
        has = torch.tensor([0, 1, 0, 0], dtype=torch.int32, device="cuda")
        slots = torch.ones(T, dtype=torch.int32, device="cuda")
    act = torch.tensor([0, 1, 2, 3, 0, 0, 0, 0], dtype=torch.int32, device="cuda")
    x = torch.randn(T, In, generator=gen, device="cuda").to(torch.bfloat16)
    out = torch.randn(T, Out, generator=gen, device="cuda").to(torch.bfloat16)
    delta_slots = [j for j in range(1, 4) if int(has[j])]
    rows = [(slots == j).nonzero()[:, 0] for j in delta_slots]
    n_rows = sum(len(r) for r in rows)
    xs = torch.stack([x[r] * scaling[j] for r, j in zip(rows, delta_slots)]).to(torch.bfloat16)
    n_lib = max(2, min(layers, -(-256 * 2**20 // (len(delta_slots) * In * Out * 2))))
    deq = [
        torch.stack([(dq[j, l].float() * ds[j, l]).to(torch.bfloat16) for j in delta_slots])
        for l in range(n_lib)
    ]
    args = lambda l: (x, dq, ds, l, act, has, scaling, slots)
    nbytes = len(delta_slots) * (In * Out + Out * 4) + n_rows * (In * 2 + Out * 2 * 2)
    b, by = bound_ms(nbytes, 2.0 * n_rows * In * Out)
    iters = 50 if T <= 64 else 10
    what = (
        f"bs {T}, {n_delta} of 3 adapter slots with a delta" if n_delta
        else f"one prefill chunk of {T} tokens in one delta slot"
    )
    r = dict(
        shape=f"{In}->{Out}, {what} ({n_rows} rows)",
        ms=device_ms(lambda l: delta_matmul_grouped(out, *args(l)), layers, iters),
        plain_ms=device_ms(lambda l: delta_matmul_grouped_plain(out, *args(l)), layers, 2, reps=3),
        library_ms=device_ms(lambda l: torch.bmm(xs, deq[l % n_lib]), n_lib, iters),
        bound_ms=b,
        bound_by=by,
        nbytes=nbytes,
        ops=2.0 * n_rows * In * Out,
    )
    del dq, ds, deq
    torch.cuda.empty_cache()
    return r


def phase_delta_timing() -> dict:
    """The delta kernel at each distinct projection of Llama-3.2-1B: bs 64
    with one and with three delta slots, and one 2048-token prefill chunk.
    Per forward (16 layers x 7 projections) at bs 64 with one delta slot,
    the sums of calls x time go to the ``kernels`` line."""
    rows = {}
    for name, In, Out, calls in llama_1b_projections():
        for T, n_delta in ((64, 1), (64, 3), (2048, 0)):
            r = time_delta(In, Out, T, n_delta)
            r["calls"] = calls
            rows[(name, T, n_delta)] = r
            log(
                f"[time] delta_matmul_grouped {name} {r['shape']}: {r['ms']:.4f} ms; bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']}); plain {r['plain_ms']:.4f} ms; "
                f"torch.bmm bf16 {r['library_ms']:.4f} ms"
            )
    per_fwd = {}
    for n_delta in (1, 3):
        dec = [r for (_, T, n), r in rows.items() if T == 64 and n == n_delta]
        tot = {f: sum(r["calls"] * r[f] for r in dec) for f in ("ms", "plain_ms", "library_ms", "nbytes", "ops")}
        per_fwd[n_delta] = dict(
            shape=f"one decode forward of Llama-3.2-1B at bs 64 (7 projections x 16 layers), "
            f"{n_delta} of 3 adapter slots with a delta",
            **{f: tot[f] for f in ("ms", "plain_ms", "library_ms")},
        )
        per_fwd[n_delta]["bound_ms"], per_fwd[n_delta]["bound_by"] = bound_ms(tot["nbytes"], tot["ops"])
        p = per_fwd[n_delta]
        log(
            f"[time] delta_matmul_grouped {p['shape']}: {p['ms']:.4f} ms; bound {p['bound_ms']:.4f} ms "
            f"({p['bound_by']}); plain {p['plain_ms']:.4f} ms; torch.bmm bf16 {p['library_ms']:.4f} ms"
        )
    return per_fwd


def time_kv_write(D: int) -> dict:
    """Host microseconds per ``write_kv`` call (the host's launch work,
    before a synchronize) and host plus device, for one decode step's K/V
    at bs 64, Hkv 8, by pool dtype: the 8-bit pools quantize each row with
    plain PyTorch ops before they scatter it."""
    import torch

    from scratchpad_tpu_torch.memory.kv_cache import KVCacheConfig, create_kv_cache
    from scratchpad_tpu_torch.ops.attention import write_kv

    B, Hkv, ps, n = 64, 8, 16, 300
    gen = seeded(7000 + D)
    k = torch.randn(B, Hkv, D, generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn(B, Hkv, D, generator=gen, device="cuda").to(torch.bfloat16)
    loc = torch.arange(B, device="cuda") * ps + ps
    r = {}
    for kind, code in (("bf16", None), ("int8", torch.int8), ("fp8", torch.float8_e4m3fn)):
        pool = create_kv_cache(
            KVCacheConfig(1, B + 1, ps, Hkv, D, torch.bfloat16, quantized=code is not None,
                          quant_dtype=code or torch.int8),
            torch.device("cuda"),
        )
        for _ in range(10):
            write_kv(pool, k, v, 0, loc)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            write_kv(pool, k, v, 0, loc)
        host = (time.perf_counter() - t) / n * 1e6
        torch.cuda.synchronize()
        r[kind] = (host, (time.perf_counter() - t) / n * 1e6)
        log(
            f"[time] write_kv {kind} pool, B={B} Hkv={Hkv} D={D}: host {host:.1f} us per call, "
            f"host and device {r[kind][1]:.1f} us per call"
        )
    return r


# the decode timings, (B, ctx, D, G, kind, window, wrapper), each kernel's
# main shape first: bs 64 at 256 and 4096 tokens and B 1 (split across the
# card) at Llama-3.2-1B's (G 4, D 64), 3B's (G 3, D 128) and Mistral-7B's
# (G 4, D 128) shapes, the 7B's window, and 8-bit pages
DECODE_TIMED = [
    (64, 256, 64, 4, "bf16", None, "auto"), (64, 4096, 64, 4, "bf16", None, "auto"),
    (64, 4096, 128, 3, "bf16", None, "auto"), (64, 4096, 128, 4, "bf16", None, "auto"),
    (64, 8192, 128, 4, "bf16", None, "auto"), (64, 8192, 128, 4, "bf16", 4096, "auto"),
    (1, 4096, 64, 4, "bf16", None, "auto"), (1, 4096, 128, 3, "bf16", None, "auto"),
    (1, 8192, 128, 4, "bf16", None, "auto"),
    (64, 8192, 128, 4, "bf16", 4096, "pallas"),
    (64, 4096, 128, 3, "int8", None, "auto"), (64, 4096, 128, 3, "fp8", None, "auto"),
    (64, 4096, 64, 4, "int8", None, "auto"), (64, 4096, 64, 4, "fp8", None, "auto"),
    (64, 256, 128, 3, "int8", None, "auto"),
]


# Gemma-2-2B's decode (G 2, D 256, Hkv 4) at bs 64 under its local window
# of 4096 at ctx 4096 and 8192, and one row of 8192 tokens (a global layer)
DECODE_TIMED_256 = [
    (64, 8192, 256, 2, "bf16", 4096, "auto"), (64, 4096, 256, 2, "bf16", 4096, "auto"),
    (1, 8192, 256, 2, "bf16", None, "auto"),
]


# rows 1dq and 3dq at Gemma-2-2B's shape on 8-bit pages, each beside the
# bf16 pages it was quantized from in turns: decode at bs 64 under the local
# window of 4096 (ctx 8192, int8 and fp8; ctx 4096) and one global row of
# 8192 tokens (split across the card)
DECODE_TIMED_256_8BIT = [
    (64, 8192, 256, 2, "int8", 4096, "auto"), (64, 8192, 256, 2, "fp8", 4096, "auto"),
    (64, 4096, 256, 2, "int8", 4096, "auto"), (1, 8192, 256, 2, "int8", None, "auto"),
]


# GPT-OSS-20B's decode with its sinks (G 8, D 64, Hkv 8): bs 64 at 4096
# tokens on a global layer and under its local window of 128, one row of
# 4096 (split across the card), int8 pages
DECODE_TIMED_SINKS = [
    (64, 4096, 64, 8, "bf16", None, "auto"), (64, 4096, 64, 8, "bf16", 128, "auto"),
    (1, 4096, 64, 8, "bf16", None, "auto"), (64, 4096, 64, 8, "int8", None, "auto"),
]


def decode_timed_kernel(kind: str, wrapper: str) -> str:
    """The kernel name a ``DECODE_TIMED`` row times."""
    return "decode_attention_pallas" if wrapper == "pallas" else DECODE[kind]


def phase_timing() -> dict:
    """The first row of each kernel is its main shape in the ``kernels``
    line: Llama-3.2-1B's for the bf16 kernels, 3B's (G 3, D 128) for the
    8-bit ones, Mistral-7B's (G 4, D 128, window 4096, ctx 8192) for
    ``decode_attention_pallas``. At Mistral-7B's shape the window's rows
    time ctx 4096 and 8192 without the window beside ctx 8192 with it, and
    the 2048-token extend chunk on 4096, 5120 (as many attended pairs as
    the window's 4096 a query) and 8192 tokens beside 8192 with it. The
    decode rows are ``DECODE_TIMED``."""
    t = {}
    for B, ctx, D, G, kind, window, wrapper in DECODE_TIMED:
        t.setdefault(decode_timed_kernel(kind, wrapper), []).append(
            time_decode(B, ctx, D, G, kind, window, wrapper))
    t.update({
        "paged_extend_attention": [
            time_extend([(128, 128)] * 64),
            time_extend([(2048, 8192)]),
            time_extend([(128, 128)] * 64, 128, 3),
            time_extend([(2048, 4096)], 128, 4), time_extend([(2048, 5120)], 128, 4),
            time_extend([(2048, 8192)], 128, 4), time_extend([(2048, 8192)], 128, 4, window=4096),
            # a speculative verification at Llama-3.1-8B's shape: 64
            # requests of k + 1 = 5 rows on 4,096 tokens
            time_extend([(SPEC_K + 1, 4096)] * 64, 128, 4),
        ],
        "paged_extend_attention_quant": [
            time_extend([(128, 128)] * 64, 128, 3, "int8"),
            time_extend([(2048, 8192)], 128, 3, "int8"),
            time_extend([(128, 128)] * 64, 128, 3, "fp8"),
        ],
    })
    for name, rows in t.items():
        for r in rows:
            log(
                f"[time] {name} {r['shape']}: {r['ms']:.4f} ms; bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']}); plain {r['plain_ms']:.4f} ms; library {r['library_ms']:.4f} ms"
            )
    # head_dim 256, Gemma-2-2B's shape (G 2 over Hkv 4), its local window
    t[DECODE_256] = [time_decode(*row, Hkv=4) for row in DECODE_TIMED_256]
    t[EXTEND_256] = [
        time_extend([(128, 128)] * 64, 256, 2, Hkv=4),
        time_extend([(2048, 8192)], 256, 2, window=4096, Hkv=4),
    ]
    for name in (DECODE_256, EXTEND_256):
        for r in t[name]:
            log(
                f"[time] {name} {r['shape']}: {r['ms']:.4f} ms; bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']}); plain {r['plain_ms']:.4f} ms; library {r['library_ms']:.4f} ms"
            )
    # rows 1dq and 3dq (8-bit pages at D 256), each beside bf16 pages in turns
    t[DECODE_256_8BIT] = [time_decode(*row, Hkv=4, beside_bf16=True) for row in DECODE_TIMED_256_8BIT]
    t[EXTEND_256_8BIT] = [
        time_extend([(128, 128)] * 64, 256, 2, "int8", Hkv=4, beside_bf16=True),
        time_extend([(128, 128)] * 64, 256, 2, "fp8", Hkv=4, beside_bf16=True),
        time_extend([(2048, 8192)], 256, 2, "int8", window=4096, Hkv=4, beside_bf16=True),
    ]
    for name in (DECODE_256_8BIT, EXTEND_256_8BIT):
        for r in t[name]:
            log(
                f"[time] {name} {r['shape']}: {r['ms']:.4f} ms (bf16 pages, in turns: "
                f"{r['ms_bf16']:.4f} ms, x{r['ms'] / r['ms_bf16']:.4f}); bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']}); plain {r['plain_ms']:.4f} ms; library {r['library_ms']:.4f} ms "
                f"(SDPA on the pages dequantized to dense bf16)"
            )
    # the sinks branch at GPT-OSS-20B's shape (G 8, D 64), each row timed
    # with and without its sinks in turns
    Hkv, G, D = SINK_SHAPE
    t[DECODE_SINKS] = [time_decode(*row, Hkv=Hkv, sinks=True) for row in DECODE_TIMED_SINKS]
    t[EXTEND_SINKS] = [
        time_extend([(128, 128)] * 64, D, G, sinks=True),
        time_extend([(2048, 8192)], D, G, sinks=True),
        time_extend([(2048, 8192)], D, G, window=128, sinks=True),
    ]
    for name in (DECODE_SINKS, EXTEND_SINKS):
        for r in t[name]:
            log(
                f"[time] {name} {r['shape']}: {r['ms']:.4f} ms (without the sinks, in turns: "
                f"{r['ms_without_sinks']:.4f} ms, x{r['ms'] / r['ms_without_sinks']:.4f}); bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']}); plain {r['plain_ms']:.4f} ms; library "
                f"{r['library_ms']:.4f} ms (SDPA over one more, zero key, the sink its mask)"
            )
    # the chunk branch at Llama-4 Scout's shape (Hkv 8, G 5, D 128) and chunk
    # (8192), each row timed with and without its chunk in turns: decode at
    # ctx 12,000 (3,808 live keys a row), B 64 and B 1 (split across the
    # card); extend over positions 6,952 to 8,999 (across the edge at
    # 8,192) and 64 x (128, 128)
    Hkv, G, D = CHUNK_SHAPE
    t[DECODE_CHUNK] = [time_decode(B, 12000, D, G, Hkv=Hkv, chunk=8192) for B in (64, 1)]
    t[EXTEND_CHUNK] = [
        time_extend([(2048, 9000)], D, G, Hkv=Hkv, chunk=8192),
        time_extend([(128, 128)] * 64, D, G, Hkv=Hkv, chunk=8192),
    ]
    for name in (DECODE_CHUNK, EXTEND_CHUNK):
        for r in t[name]:
            log(
                f"[time] {name} {r['shape']}: {r['ms']:.4f} ms (without the chunk, in turns: "
                f"{r['ms_without_chunk']:.4f} ms, x{r['ms'] / r['ms_without_chunk']:.4f}); bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']}); plain {r['plain_ms']:.4f} ms; library "
                f"{r['library_ms']:.4f} ms (SDPA, the chunk as a boolean mask)"
            )
    # rows 3m and 3qm at Gemma-3-4B's shape (Hkv 4, G 2, D 256): a
    # 2,048-token prompt holding seven 256-token spans, without a window and
    # with its local layers' 1024, each timed with and without the spans in
    # turns; the 8-bit rows on int8 and fp8 pages
    t[EXTEND_SPANS] = [
        time_extend([(2048, 2048)], 256, 2, Hkv=4, spans=GEMMA3_SPANS),
        time_extend([(2048, 2048)], 256, 2, Hkv=4, window=1024, spans=GEMMA3_SPANS),
    ]
    t[EXTEND_SPANS_8BIT] = [
        time_extend([(2048, 2048)], 256, 2, kind, Hkv=4, spans=GEMMA3_SPANS) for kind in ("int8", "fp8")
    ]
    for name in (EXTEND_SPANS, EXTEND_SPANS_8BIT):
        for r in t[name]:
            log(
                f"[time] {name} {r['shape']}: {r['ms']:.4f} ms (without the spans, in turns: "
                f"{r['ms_without_spans']:.4f} ms, x{r['ms'] / r['ms_without_spans']:.4f}); bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']}); plain {r['plain_ms']:.4f} ms; library "
                f"{r['library_ms']:.4f} ms (SDPA, the spans in a boolean mask)"
            )
    for D in (128, 64):
        time_kv_write(D)
    return t


def phase_profiling_tools() -> dict:
    """This slice's main path: the kernel-profiling entry point,
    ``tools/decode_ablate.py``'s ``main`` with its defaults, every launch
    count set to 0 just before and read just after. Returns its rows, the
    launch counts and the number of 16-layer chains it ran."""
    from scratchpad_tpu_torch.ops import KERNEL_WRAPPERS, reset_launch_counts
    from scratchpad_tpu_torch.ops.attention.gqa_decode import paged_decode_attention_stage
    from scratchpad_tpu_torch.tools import decode_ablate as tool

    reset_launch_counts()
    paged_decode_attention_stage.launches = 0
    t = time.monotonic()
    rows = tool.main([])
    counts = {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}
    counts["decode_stage"] = paged_decode_attention_stage.launches
    log(f"[probe] tools/decode_ablate.py main: {time.monotonic() - t:.1f} s, launches {counts}")
    modes = [r for r in rows if r["table"] == "mode"]
    stages = [r for r in rows if r["table"] == "stage"]
    check(len(modes) == 5 and counts["decode_ablate"] >= 5 * 16,
          f"the probe ran {len(modes)} modes with {counts['decode_ablate']} launches")
    check(counts["decode_stage"] > 0 and counts["paged_decode_attention"] > 0,
          f"the stage table launched the cuts {counts['decode_stage']} times and the decode kernel "
          f"{counts['paged_decode_attention']} times")
    for r in modes:
        log(
            f"[probe] {r['mode']:12s} {r['ms']:.4f} ms per {r['layers']} layers, "
            f"{r['ms_per_call']:.4f} ms a call; bound {r['bound_ms']:.4f} ms (live rows), "
            f"{r['bound_chunk_ms']:.4f} ms (chunk-padded); plain {r['plain_ms']:.4f} ms a call"
        )
    for r in stages:
        log(
            f"[stage] {r['model']} {r['shape']} stage {r['stage']} ({r['what']}): {r['ms']:.4f} ms, "
            f"{r['ms_over_bound']:.2f}x the decode's bound {r['bound_ms']:.4f} ms"
        )
    return {"rows": rows, "counts": counts}


def phase_w4a8_mma_bench() -> dict:
    """The W4A8 paths no served model takes: ``tools/w4_kernel_bench.py``'s
    ``main`` with ``--route a8`` at GPT-OSS's 2880 -> 5760 (group 120) and
    1800 -> 1000 (group 100), whose groups cut a 32-deep step, which must
    launch ``w4a8_matmul`` (split steps) and never ``w4a8_matmul_mma``; then
    at ``W4_MMA_GROUPS``'s group of 24, which must launch the mma.sync
    kernel. Every launch count is set to 0 just before each run and read
    just after. Returns the second run's launch counts."""
    from scratchpad_tpu_torch.ops import KERNEL_WRAPPERS, reset_launch_counts
    from scratchpad_tpu_torch.tools import w4_kernel_bench as tool

    name, In, Out, g, _ = W4_MMA_GROUPS[0]
    runs = [("GPT-OSS's groups", ["--shape", "gpt-oss gate_up:2880:5760", "--shape", "g100:1800:1000"], [120, 100]),
            (f"group {g}", ["--group", str(g), "--shape", f"{name}:{In}:{Out}"], [g])]
    counts = {}
    for label, args, groups in runs:
        reset_launch_counts()
        t = time.monotonic()
        rows = tool.main(["--route", "a8", "--bs", "64", "--iters", "8", *args])
        counts = {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}
        log(f"[bench] tools/w4_kernel_bench.py --route a8 at {label}: {time.monotonic() - t:.1f} s, "
            f"launches {counts}")
        for r in rows:
            log(f"[bench] {r['name']} {r['In']}->{r['Out']} g={r['group']} bs {r['bs']}: {r['us']:.2f} us, "
                f"{r['GBs']:.1f} GB/s, finite {r['finite']}")
        check(all(r["finite"] for r in rows) and [r["group"] for r in rows] == groups,
              f"w4_kernel_bench at {label}: {rows}")
        mma = groups == [g]
        check((counts["w4a8_matmul_mma"] > 0) == mma and (counts["w4a8_matmul"] > 0) != mma,
              f"{label} launched w4a8_matmul_mma {counts['w4a8_matmul_mma']} and w4a8_matmul "
              f"{counts['w4a8_matmul']} times")
    return {"rows": rows, "counts": counts}


# --------------------------------------------------------------- phase 4


def make_engine(quantization=None, preset="llama-3.2-1b", kv_cache_dtype="auto", params=None,
                model_config=None, attention_backend="auto", max_total_tokens=None, tokenizer_path=None,
                **extra):
    """An engine with seeded random weights, or with ``params`` (a state
    dict of the same model, for example another engine's quantized one);
    ``model_config`` in place of the preset; ``max_total_tokens`` caps the
    KV pool (else 0.85 of free memory); ``tokenizer_path`` as a user gives
    it (``"chars"``: the port's character tokenizer); ``extra``: other
    ``ServerArgs`` fields (speculation, the host tier, offload)."""
    import torch

    from scratchpad_tpu_torch.config import ServerArgs
    from scratchpad_tpu_torch.server.engine import Engine

    gc.collect()
    torch.cuda.empty_cache()  # each engine's pool takes 0.85 of free memory
    t0 = time.monotonic()
    engine = Engine(
        ServerArgs(
            preset=None if model_config else preset, random_weights=True, dtype="bfloat16",
            device="cuda", quantization=quantization, kv_cache_dtype=kv_cache_dtype,
            attention_backend=attention_backend, max_total_tokens=max_total_tokens,
            tokenizer_path=tokenizer_path, **extra,
        ),
        model_config=model_config,
        params=params,
    )
    runner = engine.scheduler.runner
    name = model_config.architecture if model_config else preset
    log(
        f"[engine] {name} {quantization or 'bf16'}, attention_backend={attention_backend}, "
        f"kv_cache_dtype={kv_cache_dtype} -> "
        f"{runner.kv_cache_dtype} KV, ready in {time.monotonic() - t0:.1f} s "
        f"({runner.quantize_seconds:.1f} s of it quantizing on the host): "
        f"{runner.param_bytes / 2**30:.3f} GiB of parameters and buffers, "
        f"{runner.max_total_num_tokens} KV tokens ({runner.kv_bytes_per_token()} B each)"
    )
    return engine


def topping_states(cfg):
    """Two LoRA adapters (rank 16 on all seven targets of every layer;
    peft names) and one delta adapter (HF [out, in] deltas on q, v, gate and
    down of every layer), as numpy from seeds 11, 12 and 13. Each moves a
    projection's output by about a third of the base output's size: A is
    N(0, 1/In), B N(0, 0.04^2) under scaling 2.0, the delta N(0, 0.008^2)."""
    import numpy as np

    H, I, L, D = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers, cfg.head_dim
    q, kv = cfg.num_attention_heads * D, cfg.num_kv_heads * D
    dims = {
        "q_proj": ("self_attn", H, q), "k_proj": ("self_attn", H, kv),
        "v_proj": ("self_attn", H, kv), "o_proj": ("self_attn", q, H),
        "gate_proj": ("mlp", H, I), "up_proj": ("mlp", H, I), "down_proj": ("mlp", I, H),
    }
    loras = []
    for seed in (11, 12):
        rng = np.random.default_rng(seed)
        st = {}
        for l in range(L):
            for t, (mod, din, dout) in dims.items():
                pre = f"base_model.model.model.layers.{l}.{mod}.{t}"
                st[f"{pre}.lora_A.weight"] = rng.standard_normal((16, din), np.float32) / np.float32(math.sqrt(din))
                st[f"{pre}.lora_B.weight"] = rng.standard_normal((dout, 16), np.float32) * np.float32(0.04)
        loras.append(st)
    rng = np.random.default_rng(13)
    delta = {
        f"model.layers.{l}.{dims[t][0]}.{t}.weight":
            rng.standard_normal((dims[t][2], dims[t][1]), np.float32) * np.float32(0.008)
        for l in range(L)
        for t in ("q_proj", "v_proj", "gate_proj", "down_proj")
    }
    return loras, delta


def register_toppings(engine, states, label: str) -> None:
    """ad1, ad2 (LoRA, scaling 2.0) and dl1 (delta) through
    ``Engine.register_topping``; logs the host seconds it takes, the pools'
    bytes on the card and the card's free memory after."""
    import torch

    loras, delta = states
    t = time.monotonic()
    engine.register_topping("ad1", state=loras[0], scaling=2.0)
    engine.register_topping("ad2", state=loras[1], scaling=2.0)
    engine.register_topping("dl1", delta_state=delta)
    torch.cuda.synchronize()
    secs = time.monotonic() - t
    free, total = torch.cuda.mem_get_info()
    log(
        f"[engine {label}] registered ad1, ad2 (LoRA rank 16, 7 targets x "
        f"{engine.model_config.num_hidden_layers} layers, scaling 2.0) and dl1 (int8 delta on "
        f"q, v, gate, down) in {secs:.1f} s of host; topping pools "
        f"{engine.toppings_manager.device_bytes() / 2**30:.3f} GiB on the card; "
        f"{free / 2**30:.2f} of {total / 2**30:.2f} GiB free"
    )


def batch_logits(runner, prompts, next_tokens, names=None):
    """The model's f32 logits [B, V] after one extend of ``prompts`` as one
    batch, and after one decode step of ``next_tokens`` (one a row), on
    pages borrowed from the engine's idle pool and returned after.
    ``names``: each row's adapter (None for none), or None for a batch that
    names no adapter."""
    import numpy as np

    from scratchpad_tpu_torch.executor.forward_meta import ForwardMode
    from scratchpad_tpu_torch.executor.model_runner import WorkerBatch
    from scratchpad_tpu_torch.sampling.batch_info import SamplingBatchInfo
    from scratchpad_tpu_torch.toppings.manager import MAX_ACTIVE_TOPPINGS

    ps, B = runner.page_size, len(prompts)
    lens = [len(p) for p in prompts]
    pages = [runner.page_allocator.alloc(-(-(n + 1) // ps)) for n in lens]
    try:
        if any(p is None for p in pages):
            fail("no free pages for the logits check")
        pt = np.zeros((B, max(len(p) for p in pages)), np.int32)
        locs = []
        for i, (p, n) in enumerate(zip(pages, lens)):
            pt[i, : len(p)] = p
            pos = np.arange(n + 1)
            locs.append(p[pos // ps] * ps + pos % ps)
        extra = {}
        if names is not None:
            order = sorted({n for n in names if n})
            active = np.zeros(MAX_ACTIVE_TOPPINGS, np.int32)
            active[1 : 1 + len(order)] = [runner.toppings_manager.lookup(n) for n in order]
            slots = np.array([order.index(n) + 1 if n else 0 for n in names], np.int32)
            extra = dict(active_adapters=active, adapter_slots=slots)
        common = dict(
            page_table=pt,
            sampling_info=SamplingBatchInfo.from_reqs([], B, runner.model_config.vocab_size),
            **extra,
        )
        ext = WorkerBatch(
            mode=ForwardMode.EXTEND,
            tokens=np.concatenate([np.asarray(p) for p in prompts]),
            positions=np.concatenate([np.arange(n) for n in lens]),
            out_cache_loc=np.concatenate([l[:-1] for l in locs]),
            req_indices=np.repeat(np.arange(B), lens),
            seq_lens=np.array(lens),
            extend_lens=np.array(lens),
            **common,
        )
        dec = WorkerBatch(
            mode=ForwardMode.DECODE,
            tokens=np.asarray(next_tokens),
            positions=np.array(lens),
            out_cache_loc=np.array([l[-1] for l in locs]),
            req_indices=np.arange(B),
            seq_lens=np.array(lens) + 1,
            extend_lens=np.ones(B, np.int64),
            **common,
        )
        return runner.forward_logits(ext), runner.forward_logits(dec)
    finally:
        for p in pages:
            if p is not None:
                runner.page_allocator.free(p)


def check_toppings_logits(engine, label: str) -> float:
    """One mixed batch (two rows each of none, ad1, ad2 and dl1; 5 to 1,000
    tokens), extend and one decode step: kernel path against plain path
    with the engine's gate and argmax rule, and each adapter's rows against
    the same batch naming no adapter, which must move by at least
    ``ADAPTER_MOVE`` times the worst kernel-vs-plain reading. Returns that
    reading."""
    import numpy as np
    import torch

    runner = engine.scheduler.runner
    V = runner.model_config.vocab_size
    rng = np.random.default_rng(5)
    names = [None, "ad1", "ad2", "dl1"] * 2
    prompts = [rng.integers(1, V, n).tolist() for n in (5, 37, 128, 300, 511, 64, 200, 1000)]
    firsts = [p[0] for p in prompts]
    kern = batch_logits(runner, prompts, firsts, names)
    with PlainPath(runner.model):
        plain = batch_logits(runner, prompts, firsts, names)
    base = batch_logits(runner, prompts, firsts)
    tol, worst = LOGIT_RTOL[label], 0.0
    for step in (0, 1):
        for i, name in enumerate(names):
            a, b = kern[step][i], plain[step][i]
            check(bool(torch.isfinite(a).all() and torch.isfinite(b).all()), f"{label}: non-finite logits")
            scale = float(b.abs().max())
            rel = float((a - b).abs().max()) / scale
            worst = max(worst, rel)
            top2 = torch.topk(b, 2).values
            gap = float(top2[0] - top2[1])
            tie = gap <= max(
                math.ldexp(1.0, math.frexp(abs(float(top2[0])))[1] - 8), ARGMAX_FLOOR[label] * scale
            )
            same = bool(a.argmax() == b.argmax())
            check(rel <= tol, f"{label}: row {i} ({name}) step {step}: kernel-path logits differ by {rel:.3e}")
            check(same or tie, f"{label}: row {i} ({name}) step {step}: argmax differs outside a tie")
            if not same:
                log(
                    f"[engine {label}] mixed row {i} ({name}) step {step}: argmax {int(a.argmax())} vs "
                    f"{int(b.argmax())}; plain top-2 gap {gap / scale:.3e} of max|logit| (tie {tie})"
                )
    moves = {}
    for step in (0, 1):
        for i, name in enumerate(names):
            d = float((kern[step][i] - base[step][i]).abs().max()) / float(base[step][i].abs().max())
            moves.setdefault(name, []).append(d)
    log(
        f"[engine {label}] mixed batch of {len(names)} rows, extend and decode: kernel vs plain "
        f"worst max|diff|/max|logit| {worst:.3e} (tol {tol}); move against no adapter, min over "
        f"rows: "
        + ", ".join(f"{n or 'none'} {min(m):.3e}" for n, m in moves.items())
        + f" (none rows: max {max(moves[None]):.3e})"
    )
    for name in ("ad1", "ad2", "dl1"):
        check(
            min(moves[name]) >= ADAPTER_MOVE * worst,
            f"{label}: {name} moves its rows' logits by {min(moves[name]):.3e}, under "
            f"{ADAPTER_MOVE} x the kernel-vs-plain reading {worst:.3e}",
        )
    return worst


def set_w4_route(model, a8: bool) -> None:
    from scratchpad_tpu_torch.models.common import QuantLinear

    for m in model.modules():
        if isinstance(m, QuantLinear):
            m.a8 = a8


class PlainPath:
    """Within the block, the model runs every kernel's plain version: the
    attention functions it holds, the W4 functions ``QuantLinear`` calls
    (module globals of ``models.common``) and the delta function
    ``apply_topping`` calls (a module global of ``toppings.manager``)."""

    def __init__(self, model):
        self.model = model

    def __enter__(self):
        from scratchpad_tpu_torch.models import common
        from scratchpad_tpu_torch.ops.attention import decode_attention_plain, extend_attention_plain
        from scratchpad_tpu_torch.ops import ldmm
        from scratchpad_tpu_torch.ops.quant import w4_matmul
        from scratchpad_tpu_torch.toppings import manager

        self.saved_delta = manager.delta_matmul_grouped
        manager.delta_matmul_grouped = ldmm.delta_matmul_grouped_plain
        self.saved_attn = (self.model.decode_attention, self.model.extend_attention)
        self.saved_w4 = (common.quantize_rows_int8, common.w4a8_matmul, common.w4a16_matmul)
        self.model.decode_attention, self.model.extend_attention = (
            decode_attention_plain, extend_attention_plain,
        )
        common.quantize_rows_int8 = w4_matmul.quantize_activations_plain
        common.w4a8_matmul = w4_matmul.w4a8_matmul_plain
        common.w4a16_matmul = w4_matmul.w4a16_matmul_plain

    def __exit__(self, *exc):
        from scratchpad_tpu_torch.models import common
        from scratchpad_tpu_torch.toppings import manager

        manager.delta_matmul_grouped = self.saved_delta
        self.model.decode_attention, self.model.extend_attention = self.saved_attn
        common.quantize_rows_int8, common.w4a8_matmul, common.w4a16_matmul = self.saved_w4


def weights_fingerprint(model, layers: int) -> list[float]:
    """f32 sums of the embedding and of the first ``layers`` layers' first
    and last projections: equal for two draws from one seed, whatever the
    depth of either model."""
    return [float(model.embed.weight.float().sum())] + [
        float(t.float().sum())
        for layer in list(model.layers)[:layers]
        for t in (layer.wq.weight, layer.down.weight)
    ]


class NoWindow:
    """Within the block, the model attends without its sliding window."""

    def __init__(self, model):
        self.cfg = model.cfg

    def __enter__(self):
        self.saved, self.cfg.sliding_window = self.cfg.sliding_window, None

    def __exit__(self, *exc):
        self.cfg.sliding_window = self.saved


class SameRouting:
    """For a MoE model: ``record()`` keeps the experts that each token's
    router picks in every layer of the forwards inside it (the model's
    ``top_experts``, one call a layer and forward), and ``replay()`` makes
    the forwards inside it pick the same ones, in the same order, counting
    the (token, layer) picks where the model's own router would have chosen
    another set. The routing weights still come from each forward's own
    router logits. A top-k pick across a near-tie of two router logits is
    a discontinuity: one bf16 rounding upstream flips it, and the token's
    output moves by a whole expert's share, which no kernel tolerance
    covers; so the plain path is held to the kernel path at the kernel
    path's routing, and the reading at its own routing is logged beside."""

    def __init__(self, model):
        self.model = model
        self.picks = []
        self.flips = self.picked = 0

    @contextlib.contextmanager
    def record(self):
        inner = self.model.top_experts

        def recording(scores):
            topi = inner(scores)
            self.picks.append(topi)
            return topi

        self.model.top_experts = recording
        try:
            yield
        finally:
            del self.model.top_experts  # the class's method again

    @contextlib.contextmanager
    def replay(self):
        inner = self.model.top_experts
        picks = iter(self.picks)

        def replaying(scores):
            topi = next(picks)
            own = inner(scores)
            differ = (own.sort(dim=-1).values != topi.sort(dim=-1).values).any(dim=-1)
            self.flips += int(differ.sum())
            self.picked += differ.numel()
            return topi

        self.model.top_experts = replaying
        try:
            yield
        finally:
            del self.model.top_experts


class LayerTrace:
    """Within the block, keeps each layer's attention output (the input of
    its ``wo``) and MoE input (the input of its ``_moe``, on the layers that
    have experts) of every forward, on the host, in call order, with its
    layer."""

    def __init__(self, model):
        self.model = model
        self.attn, self.moe = [], []

    def __enter__(self):
        keep = lambda into, l: lambda module, inputs, output: into.append((l, inputs[0].detach().cpu()))
        self.hooks = [layer.wo.register_forward_hook(keep(self.attn, l))
                      for l, layer in enumerate(self.model.layers)]
        index = {id(layer): l for l, layer in enumerate(self.model.layers)}
        inner = self.model._moe

        def moe(h, layer):
            self.moe.append((index[id(layer)], h.detach().cpu()))
            return inner(h, layer)

        self.model._moe = moe
        return self

    def __exit__(self, *exc):
        for h in self.hooks:
            h.remove()
        del self.model._moe  # the class's method again

    def gaps(self, ref: "LayerTrace", layers: int) -> tuple[list, list]:
        """Per layer, the worst max|self - ref| / max|ref| over the traced
        forwards: of the attention outputs, and of the MoE inputs (0 for a
        layer without experts)."""
        out = []
        for xs, ys in ((self.attn, ref.attn), (self.moe, ref.moe)):
            g = [0.0] * layers
            for (l, x), (m, y) in zip(xs, ys, strict=True):
                assert l == m, (l, m)
                y = y.float()
                g[l] = max(g[l], float((x.float() - y).abs().max() / y.abs().max()))
            out.append(g)
        return out


class UlpNoise:
    """Within the block (inside ``PlainPath`` or ``ExpandedMla``), each
    attention call's bf16 output moves by one ulp, up or down at random, at a random ``share`` of
    its nonzero elements: a second plain path, as far from the first as a
    kernel whose outputs differ from the plain ones by one ulp at that share
    (the witness's control)."""

    def __init__(self, model, share: float, seed: int):
        import torch

        self.model, self.share = model, share
        self.gen = torch.Generator(device=next(model.parameters()).device).manual_seed(seed)

    def noisy(self, fn):
        import torch

        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            r = torch.rand(out.shape, generator=self.gen, device=out.device)
            step = (r < self.share / 2).short() - ((r >= self.share / 2) & (r < self.share)).short()
            return (out.view(torch.int16) + step * (out != 0)).view(out.dtype)

        return call

    def __enter__(self):
        if self.model.cfg.is_mla:  # DeepSeek: its latent attention's output
            self.saved = self.model.__dict__.get("latent_attention")
            self.model.latent_attention = self.noisy(self.model.latent_attention)
            return
        self.saved = (self.model.decode_attention, self.model.extend_attention)
        self.model.decode_attention, self.model.extend_attention = (self.noisy(f) for f in self.saved)

    def __exit__(self, *exc):
        if not self.model.cfg.is_mla:
            self.model.decode_attention, self.model.extend_attention = self.saved
        elif self.saved is None:
            del self.model.latent_attention
        else:
            self.model.latent_attention = self.saved


def fmt_layers(g: list) -> str:
    return "[" + ", ".join(f"{x:.2e}" for x in g) + "]"


class NoChunk:
    """Within the block, the model (Llama-4) attends without its chunks:
    every layer's ``chunk_size`` None."""

    def __init__(self, model):
        self.model = model

    def __enter__(self):
        self.saved = self.model.layer_chunks
        self.model.layer_chunks = [None] * len(self.saved)

    def __exit__(self, *exc):
        self.model.layer_chunks = self.saved


class NoSinks:
    """Within the block, the model (GPT-OSS) attends without its sinks: its
    ``attention_kwargs`` pass ``sinks=None``."""

    def __init__(self, model):
        self.model = model

    def __enter__(self):
        inner = self.model.attention_kwargs
        self.model.attention_kwargs = lambda l, layer: dict(inner(l, layer), sinks=None)

    def __exit__(self, *exc):
        del self.model.attention_kwargs  # the class's method again


class ExpandedMla:
    """Within the block, the DeepSeek model attends in HF's expanded form
    (``modeling_deepseek_v2.py``'s attention) instead of its absorbed
    latent path: from each sequence's latent rows ``[c | k_rope]`` every
    head's K = ``[W_UK c; k_rope]`` and V = ``W_UV c``, in f32, and the
    softmax of ``q_nope . k_nope + q_rope . k_rope`` over the causal prefix;
    the output [T, Hq, dv] in the model dtype. With ``rope=False`` the
    scores leave out ``q_rope . k_rope`` (``ROPE_MOVE``'s yardstick). The
    model's own ``latent_attention`` is restored on exit."""

    QUERY_BLOCK = 1024

    def __init__(self, model, rope: bool = True):
        self.model, self.rope = model, rope

    def __enter__(self):
        self.saved = self.model.__dict__.get("latent_attention")
        self.model.latent_attention = self.attend

    def __exit__(self, *exc):
        if self.saved is None:
            del self.model.latent_attention  # the class's method again
        else:
            self.model.latent_attention = self.saved

    def attend(self, l, layer, q_nope, q_rope, kv, meta, spans):
        import torch

        from scratchpad_tpu_torch.executor.forward_meta import ForwardMode
        from scratchpad_tpu_torch.ops.attention.mla_backend import extend_spans, latent_rows

        cfg = self.model.cfg
        r, dv, scale = cfg.kv_lora_rank, cfg.v_head_dim, self.model.sm_scale
        if meta.mode == ForwardMode.DECODE:
            spans = [(b, b + 1, n) for b, n in enumerate(meta.seq_lens.tolist())]
        elif spans is None:
            spans = extend_spans(meta)
        T, Hq, _ = q_nope.shape
        out = q_nope.new_zeros(T, Hq, dv)
        w_uk, w_uv = layer.w_uk.float(), layer.w_uv.float()
        for s, (a, b, n) in enumerate(spans):
            if a == b or n == 0:
                continue
            lat = latent_rows(kv, l, meta.page_table[s], n).float()
            c, k_rope = lat[:, :r], lat[:, r:]
            k_nope = torch.einsum("sr,hnr->hsn", c, w_uk)  # [Hq, S, dn]
            v = torch.einsum("sr,hrv->hsv", c, w_uv)  # [Hq, S, dv]
            pos = torch.arange(n, device=lat.device)
            for t0 in range(a, b, self.QUERY_BLOCK):
                t1 = min(t0 + self.QUERY_BLOCK, b)
                scores = torch.einsum("thn,hsn->hts", q_nope[t0:t1].float(), k_nope)
                if self.rope:
                    scores = scores + torch.einsum("thd,sd->hts", q_rope[t0:t1].float(), k_rope)
                live = pos[None, :] <= meta.positions[t0:t1, None]
                p = torch.softmax(scores.masked_fill(~live[None], float("-inf")) * scale, dim=-1)
                out[t0:t1] = torch.einsum("hts,hsv->thv", p, v).to(out.dtype)
        return out


# (prompt tokens, new tokens) of the request set, before the two prompts
# that share a 600-token prefix (32 new tokens each); "chunk" is
# chunked_prefill_size
REQUESTS = [(5, 32), (37, 32), (128, 32), (300, 32), (511, 32), ("chunk+952", 32)]
# Mistral-7B's, window 4096: a prompt of three 2048-token chunks, the last
# two past the window, and one whose 16 decode steps cross the window's edge
# (Gemma-2-2B's local layers have the same window)
WINDOW_REQUESTS = [(5, 32), (37, 32), (300, 32), (6000, 32), (4090, 16)]
# Gemma-3-1B's, window 512: prompts past the window, one in a single chunk
# and one of two chunks, and one whose 16 decode steps cross its edge; its
# two prompts that share a prefix share 1,100 tokens, over twice the window
# (the 600 of the other engines cross it by 113 and 128 tokens, which moved
# the logits by 9.4 and 9.8 times the kernel-vs-plain reading, PERF.md §6)
# GPT-OSS-20B's, window 128 on its local layers: every prompt but the first
# two crosses it, and one of 120 tokens decodes 16 across its edge
GPT_OSS_REQUESTS = [(5, 32), (37, 32), (120, 16), (300, 32), (511, 32), ("chunk+952", 32)]
# its W4 engines' (two layers, checked only): a prompt within the window,
# the one that decodes across its edge, one past it
GPT_OSS_W4_REQUESTS = [(5, 16), (120, 16), (300, 16)]
# the other engines that are checked only, whose kernels other engines hold
# too: a short prompt, one of a page and more, one longer than a chunk
UNTIMED_REQUESTS = [(5, 16), (300, 16), ("chunk+952", 16)]
# the toppings engines': REQUESTS's prompts (one a TOPPINGS entry), 16 new
TOPPINGS_REQUESTS = [(n, 16) for n, _ in REQUESTS]
GEMMA3_REQUESTS = [(5, 16), (1500, 16), (3000, 16), (505, 16)]
GEMMA3_SHARED = 1100
# Gemma-3-1B keeps 12 of its 26 layers (ten local, two global;
# its kernels, rows 1d and 3d at G 4 over one kv head, are held by phase 3):
# the cut pays for the gemma-2-2b-int8kv engine
GEMMA3_LAYERS = 12
# Gemma-3-1B's published config.json (huggingface.co/google/gemma-3-1b-pt,
# config.json, the text model), read through ModelConfig.from_hf_config; the
# weights are random, drawn on the card
GEMMA3_1B = {
    "architectures": ["Gemma3ForCausalLM"],
    "vocab_size": 262144,
    "hidden_size": 1152,
    "intermediate_size": 6912,
    "num_hidden_layers": 26,
    "num_attention_heads": 4,
    "num_key_value_heads": 1,
    "head_dim": 256,
    "max_position_embeddings": 32768,
    "rms_norm_eps": 1e-6,
    "rope_theta": 1000000.0,
    "rope_local_base_freq": 10000.0,
    "rope_scaling": None,
    "query_pre_attn_scalar": 256,
    "sliding_window": 512,
    "sliding_window_pattern": 6,
    "attn_logit_softcapping": None,
    "final_logit_softcapping": None,
    "hidden_activation": "gelu_pytorch_tanh",
    "model_type": "gemma3_text",
}
# Qwen3-8B's W4A8 engine keeps this many of its 36 layers (its host-side
# quantization takes about a second a layer); hidden x layers then falls
# under the auto rule's 50,000, so it takes int8 KV as auto gives the full
# depth
QWEN3_W4A8_LAYERS = 4
# Gemma-2-2B on int8 KV (rows 1dq, 3dq): 4 of its 26 layers, two local and
# two global, untimed; the prompts cross the local window's edge (4096)
GEMMA_KV8_LAYERS = 4
# the untimed Gemma-2-2B, GPT-OSS-20B and DeepSeek-V2-Lite engines' depths
# (three local and three global layers; two and two; the dense layer and
# three MoE layers), cut with the spec engines' 8B targets (SPEC_8B_LAYERS)
# to pay for phase_tp's seconds: each ran at full depth until then
GEMMA2_LAYERS = 6
GPT_OSS_LAYERS = 4
DEEPSEEK_LAYERS = 4
GEMMA_KV8_REQUESTS = [(5, 16), (300, 16), (6000, 16), (4090, 16)]
# GPT-OSS-20B W4 keeps one local and one global layer of its 24 (host
# quantization of the experts, about 0.8 G weights a layer)
GPT_OSS_W4_LAYERS = 2
# Qwen3-30B-A3B's published config.json (huggingface.co/Qwen/Qwen3-30B-A3B,
# config.json), read through ModelConfig.from_hf_config and cut to
# QWEN3_MOE_LAYERS of its 48 layers (each 128 experts of 2048 -> 768 -> 2048);
# the weights are random, drawn on the card
QWEN3_30B_A3B = {
    "architectures": ["Qwen3MoeForCausalLM"],
    "vocab_size": 151936,
    "hidden_size": 2048,
    "intermediate_size": 6144,
    "moe_intermediate_size": 768,
    "num_hidden_layers": 48,
    "num_attention_heads": 32,
    "num_key_value_heads": 4,
    "head_dim": 128,
    "num_experts": 128,
    "num_experts_per_tok": 8,
    "norm_topk_prob": True,
    "decoder_sparse_step": 1,
    "mlp_only_layers": [],
    "max_position_embeddings": 40960,
    "rms_norm_eps": 1e-6,
    "rope_theta": 1000000.0,
    "rope_scaling": None,
    "tie_word_embeddings": False,
    "attention_bias": False,
    "hidden_act": "silu",
    "model_type": "qwen3_moe",
}
QWEN3_MOE_LAYERS = 4
# Llama-4 Scout's text decoder: the text_config of its published config.json
# (huggingface.co/meta-llama/Llama-4-Scout-17B-16E-Instruct), which is
# transformers' Llama4TextConfig() defaults, read through
# ModelConfig.from_hf_config and cut to LLAMA4_LAYERS of its 48 layers
# (three chunked rope layers and one global NoPE layer: its no_rope_layers,
# every fourth layer 0, and moe_layers, every layer, are the ones the config
# derives). max_position_embeddings is transformers' default, 131,072 (the
# published 10,485,760 would give each request slot a page table of 655,360
# pages). The weights are random, drawn on the card.
LLAMA4_SCOUT = {
    "architectures": ["Llama4ForCausalLM"],
    "vocab_size": 202048,
    "hidden_size": 5120,
    "intermediate_size": 8192,
    "intermediate_size_mlp": 16384,
    "num_hidden_layers": 48,
    "num_attention_heads": 40,
    "num_key_value_heads": 8,
    "head_dim": 128,
    "num_local_experts": 16,
    "num_experts_per_tok": 1,
    "interleave_moe_layer_step": 1,
    "use_qk_norm": True,
    "attention_chunk_size": 8192,
    "attn_temperature_tuning": True,
    "floor_scale": 8192,
    "attn_scale": 0.1,
    "max_position_embeddings": 131072,
    "rms_norm_eps": 1e-5,
    "rope_theta": 500000.0,
    "rope_scaling": {"rope_type": "llama3", "factor": 16.0, "low_freq_factor": 1.0,
                     "high_freq_factor": 1.0, "original_max_position_embeddings": 8192},
    "tie_word_embeddings": False,
    "attention_bias": False,
    "hidden_act": "silu",
    "model_type": "llama4_text",
}
LLAMA4_LAYERS = 4
# its KV pool: 4 layers of 8 heads at 128 take 16 KB a token; the masked
# experts of a logits check's 8,300-token forward take about 10 GB beside it
LLAMA4_KV_TOKENS = 131072
# Llama-4's requests, chunk 8192: prompts that cross the chunk's edge in
# their prefill (8,300) and end on it (8,192: the logits check's decode step
# is the first token of the second chunk, which sees only itself), one
# whose 32 decode steps cross it (8,180), and two short ones
LLAMA4_REQUESTS = [(5, 32), (300, 32), (8192, 16), (8300, 16), (8180, 32)]
# Apertus-8B's published config.json (huggingface.co/swiss-ai/Apertus-8B-2509,
# config.json), read through ModelConfig.from_hf_config at full width and
# depth; the weights are random, drawn on the card
APERTUS_8B = {
    "architectures": ["ApertusForCausalLM"],
    "vocab_size": 131072,
    "hidden_size": 4096,
    "intermediate_size": 21504,
    "num_hidden_layers": 32,
    "num_attention_heads": 32,
    "num_key_value_heads": 8,
    "hidden_act": "xielu",
    "qk_norm": True,
    "max_position_embeddings": 65536,
    "rms_norm_eps": 1e-5,
    "rope_theta": 12000000.0,
    "rope_scaling": {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
                     "high_freq_factor": 4.0, "original_max_position_embeddings": 8192},
    "tie_word_embeddings": False,
    "attention_bias": False,
    "mlp_bias": False,
    "model_type": "apertus",
}
# Apertus-8B is served at APERTUS_LAYERS of its 32 layers, untimed: its
# attention shapes (G 4 at head_dim 128) are timed in Mistral-7B's run, its
# xIELU MLP is torch, held by its logits (PERF.md keeps its last timing)
APERTUS_LAYERS = 8
# DeepSeek-V2-Lite's published config.json (huggingface.co/deepseek-ai/
# DeepSeek-V2-Lite, config.json), read through ModelConfig.from_hf_config at
# full width and depth (15.7B parameters, 31.4 GB in bf16); the weights are
# random, drawn on the card. Its latent pool holds 27 x (512 + 64) x 2 =
# 31,104 bytes a token.
DEEPSEEK_V2_LITE = {
    "architectures": ["DeepseekV2ForCausalLM"],
    "vocab_size": 102400,
    "hidden_size": 2048,
    "intermediate_size": 10944,
    "moe_intermediate_size": 1408,
    "num_hidden_layers": 27,
    "num_attention_heads": 16,
    "num_key_value_heads": 16,
    "q_lora_rank": None,
    "kv_lora_rank": 512,
    "qk_nope_head_dim": 128,
    "qk_rope_head_dim": 64,
    "v_head_dim": 128,
    "n_routed_experts": 64,
    "num_experts_per_tok": 6,
    "n_shared_experts": 2,
    "first_k_dense_replace": 1,
    "moe_layer_freq": 1,
    "topk_method": "greedy",
    "n_group": 1,
    "topk_group": 1,
    "norm_topk_prob": False,
    "routed_scaling_factor": 1.0,
    "scoring_func": "softmax",
    "hidden_act": "silu",
    "max_position_embeddings": 163840,
    "rms_norm_eps": 1e-6,
    "rope_theta": 10000,
    "rope_scaling": {"type": "yarn", "factor": 40, "original_max_position_embeddings": 4096,
                     "beta_fast": 32, "beta_slow": 1, "mscale": 0.707, "mscale_all_dim": 0.707},
    "tie_word_embeddings": False,
    "attention_bias": False,
    "model_type": "deepseek_v2",
}
DEEPSEEK_KV_BYTES_A_LAYER = 1_152  # (kv_lora_rank 512 + qk_rope_head_dim 64) x 2 B
# the engines that repeat other engines' kernels, cut in depth: Mistral-7B
# under attention_backend="pallas" and Llama-3.2-3B W4A8 with bf16 KV
MISTRAL_PALLAS_LAYERS = 8
BF16KV_LAYERS = 7


def phase_engine(engine, label: str, w4_kernels=(), logits=True, toppings=None,
                 requests=REQUESTS, shared_len: int = 600, sink_move: bool = False,
                 witness: bool = False) -> dict:
    """Serve the request set through ``Engine.generate`` with every launch
    count set to 0 just before and read just after; check each request,
    the radix hit, the launches of both attention kernels of the pool's
    kind (one per layer and forward of their mode; the other kind's never),
    of ``decode_attention_pallas`` (every decode launch under
    ``attention_backend="pallas"``, none under ``auto``) and of
    ``w4_kernels`` (one per quantized matrix and forward: 6 per layer and
    the head), and, with ``logits``, the kernel-path logits against the
    plain path's. The argmax must agree on every row
    but a bf16 tie: the plain path's top-2 logits equal or one bf16 ulp
    apart. Each row whose argmax differs is logged with its gap. A model
    with a sliding window must move the logits of each prompt longer than
    the window by at least ``WINDOW_MOVE`` times the worst reading against
    the plain path without it, and a model with chunks (Llama-4) each row
    whose query sits past the first chunk's edge by ``CHUNK_MOVE`` times it
    against the plain path without them; a model with sinks logs how far dropping them
    moves each prompt's logits, and with ``sink_move`` each prompt within
    the window must move by at least ``SINK_MOVE`` times that reading. A MoE
    model's plain path runs at the kernel path's routing (``SameRouting``).
    ``witness`` logs where the kernel path's distance from the plain path
    grows, layer by layer (``LayerTrace``), beside a control: the plain
    path against itself with one-ulp noise on its attention outputs
    (``UlpNoise``) at the share where the kernel's first layer differs.
    The first layer's attention sees the same q, k and v on both paths, so
    its outputs must agree within one bf16 ulp of their max (2^-7).
    ``toppings``: each request's adapter (see ``TOPPINGS``); the delta
    kernel must then launch once per projection and layer of every forward
    whose batch names an adapter, and never without ``toppings``, and the
    logits are those of ``check_toppings_logits``. A model on a latent pool
    (DeepSeek's MLA) must launch no attention kernel at all, and its plain
    path is HF's expanded form (``ExpandedMla``), against which the logits
    without the rope term must move by ``ROPE_MOVE`` times the reading."""
    import numpy as np
    import torch

    from scratchpad_tpu_torch.executor.forward_meta import ForwardMode
    from scratchpad_tpu_torch.models.common import QuantLinear
    from scratchpad_tpu_torch.ops import KERNEL_WRAPPERS, reset_launch_counts
    from scratchpad_tpu_torch.sampling.sampling_params import SamplingParams

    runner = engine.scheduler.runner
    cfg = runner.model_config
    L = cfg.num_hidden_layers
    model = runner.model
    forwards = {ForwardMode.EXTEND: 0, ForwardMode.DECODE: 0}
    topped = [0]  # forwards whose batch names an adapter
    inner_forward = model.forward  # the timer below wraps counting_forward

    def counting_forward(meta, kv):
        forwards[meta.mode] += 1
        topped[0] += meta.active_adapters is not None
        return inner_forward(meta, kv)

    model.forward = counting_forward

    rng = np.random.default_rng(0)
    V = cfg.vocab_size
    shared = rng.integers(1, V, shared_len).tolist()
    chunk = engine.args.chunked_prefill_size
    lens = [chunk + 952 if n == "chunk+952" else n for n, _ in requests]
    prompts = [rng.integers(1, V, n).tolist() for n in lens] + [shared + rng.integers(1, V, 40).tolist()]
    second = [shared + rng.integers(1, V, 25).tolist()]  # radix hit on `shared`
    new_tokens = [m for _, m in requests] + [32, 32]
    sps = [SamplingParams(temperature=0.0, max_new_tokens=m, ignore_eos=True) for m in new_tokens]
    tops = toppings or [None] * (len(prompts) + 1)

    engine.flush_cache()
    reset_launch_counts()
    with PrefillTimer(model) as prefill:
        outs = engine.generate(input_ids=prompts, sampling_params=sps[:-1], topping=tops[:-1])
        outs += engine.generate(input_ids=second, sampling_params=sps[-1:], topping=tops[-1])
    counts = {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}
    by_group = {fn.__name__: dict(fn.group_launches) for fn in KERNEL_WRAPPERS if hasattr(fn, "group_launches")}
    torch.cuda.synchronize()
    model.forward = inner_forward
    log(
        f"[prefill {label}] requests of {[len(p) for p in prompts + second]} tokens: "
        f"{prefill.forwards} extend forwards, device {prefill.device_ms:.3f} ms, "
        f"wall {prefill.wall_ms:.3f} ms"
    )
    n_ext, n_dec = forwards[ForwardMode.EXTEND], forwards[ForwardMode.DECODE]
    log(
        f"[engine {label}] {len(outs)} requests: {n_ext} extend and {n_dec} decode forwards; "
        f"kernel launches {counts}"
    )
    for o, p, m in zip(outs, prompts + second, new_tokens):
        check(
            o.completion_tokens == m and len(o.output_ids) == m and o.finish_reason == "length",
            f"{label} request {o.rid}: {o.completion_tokens} tokens, finish {o.finish_reason}",
        )
        check(o.prompt_tokens == len(p), f"{label} request {o.rid}: prompt_tokens {o.prompt_tokens} != {len(p)}")
    if tops[-1] == tops[-2]:
        check(outs[-1].cached_tokens >= 512, f"{label}: no radix hit: cached_tokens {outs[-1].cached_tokens}")
    else:  # the shared prefix's KV was computed under another adapter
        check(outs[-1].cached_tokens == 0, f"{label}: KV reused across adapters: {outs[-1].cached_tokens}")
    log(
        f"[engine {label}] shared {shared_len}-token prefix under adapters {tops[-2]} and {tops[-1]}: "
        f"{outs[-1].cached_tokens} cached tokens; prompts of {lens} tokens (chunks of {chunk})"
    )
    pages = runner.kv_cache_dtype if runner.kv_cache.quantized else "bf16"
    # a latent pool (DeepSeek's MLA) attends in torch: no attention kernel
    mla = runner.kv_cache.mla
    need = {} if mla else {EXTEND[pages]: L * n_ext, DECODE[pages]: L * n_dec}
    # one W4 launch per 4-bit matrix and forward (Llama: 6 a layer and the
    # head; GPT-OSS: q, k, v, o and each expert's two), each at its matrix's
    # group size (GPT-OSS: 120 where In is 2880, 128 at o)
    w4_groups = collections.Counter(m.group_size for m in model.modules() if isinstance(m, QuantLinear))
    n_w4 = sum(w4_groups.values())
    for k in w4_kernels:
        need[k] = n_w4 * (n_ext + n_dec)
        if k in by_group:
            want = {g: n * (n_ext + n_dec) for g, n in w4_groups.items()}
            check(by_group[k] == want, f"{label}: {k} launched {by_group[k]} times by group size, not {want}")
    for k, n in need.items():
        check(counts[k] >= n > 0, f"{label}: {k} launched {counts[k]} times, fewer than {n}")
    # one delta launch per projection and layer of each forward with adapters
    n_top = 7 * L * topped[0]
    check(
        counts["delta_matmul_grouped"] == n_top and (n_top > 0) == (toppings is not None),
        f"{label}: delta_matmul_grouped launched {counts['delta_matmul_grouped']} times, not "
        f"{n_top} ({topped[0]} forwards with adapters)",
    )
    other = "bf16" if runner.kv_cache.quantized else "int8"
    idle = [EXTEND[other], DECODE[other]] + ([EXTEND[pages], DECODE[pages]] if mla else [])
    for k in idle:
        check(counts[k] == 0, f"{label}: {k} launched {counts[k]} times on a "
                              f"{'latent' if mla else pages} pool")
    # every served model quantizes with groups of 128 (GPT-OSS also 120):
    # never the mma.sync route
    check(counts["w4a8_matmul_mma"] == 0, f"{label}: w4a8_matmul_mma launched {counts['w4a8_matmul_mma']} times")
    # every decode launch goes through decode_attention_pallas under
    # attention_backend="pallas", and none under auto
    pallas = runner.attention_backend == "pallas"
    check(
        counts["decode_attention_pallas"] == (counts[DECODE[pages]] if pallas else 0),
        f"{label} ({runner.attention_backend}): decode_attention_pallas launched "
        f"{counts['decode_attention_pallas']} times against {counts[DECODE[pages]]} decode launches",
    )
    steps = {
        EXTEND[pages]: n_ext, DECODE[pages]: n_dec,
        **{k: n_ext + n_dec for k in w4_kernels},
        "delta_matmul_grouped": topped[0],
        "decode_attention_pallas": n_dec if pallas else 0,
    }

    result = dict(
        counts=counts, by_group=by_group, steps=steps, worst_logit_rel=None,
        preset=engine.args.preset or cfg.architecture, weights=engine.args.quantization or "bf16",
        kv_cache_dtype=runner.kv_cache_dtype, attention_backend=runner.attention_backend,
        output_ids=[o.output_ids for o in outs],
    )
    if not logits:
        return result
    if toppings:
        result["worst_logit_rel"] = check_toppings_logits(engine, label)
        return result
    # kernel path vs plain path logits for each prompt's first generated
    # token (extend) and the step after it (decode), on the card
    tol = LOGIT_RTOL[label]
    worst = {0: 0.0, 1: 0.0}  # by step: 0 = extend, 1 = decode
    agree = ties = 0
    min_margin = math.inf  # the plain path's top-2 gap over max |logit|
    window = cfg.sliding_window
    moves = []  # (prompt length, step, kernel path against the plain path without the window)
    has_sinks = hasattr(model.layers[0], "sinks")
    sink_moves = []  # the same without the sinks
    chunk = cfg.attention_chunk_size if hasattr(model, "layer_chunks") else None
    chunk_moves = []  # the same without the chunks, of the rows past the first chunk
    moe = hasattr(model, "top_experts")
    own_routing = 0.0  # MoE: the worst reading with each path's own routing
    # MLA: the plain path is HF's expanded form; the same without the rope term
    plain_path = ExpandedMla if mla else PlainPath
    rope_moves = []
    flips = picked = 0
    # witness: per layer, kernel against plain and control against plain
    # (attention outputs, MoE inputs); the control's logits readings
    w_gaps = {"kernel": [[0.0] * L, [0.0] * L], "control": [[0.0] * L, [0.0] * L]}
    w_shares, w_control, w_flips = [], 0.0, []
    trace = LayerTrace if witness else lambda model: contextlib.nullcontext()
    for i, (p, o) in enumerate(zip(prompts + second, outs)):
        # a MoE model's plain path runs at the kernel path's routing
        routing = SameRouting(model) if moe else None
        same = routing.replay if moe else contextlib.nullcontext
        with routing.record() if moe else contextlib.nullcontext(), trace(model) as k_trace:
            kern = batch_logits(runner, [p], [o.output_ids[0]])
        with plain_path(model):
            with same(), trace(model) as p_trace:
                plain = batch_logits(runner, [p], [o.output_ids[0]])
            if moe:
                flips, picked = flips + routing.flips, picked + routing.picked
            if witness:
                share = float((k_trace.attn[0][1] != p_trace.attn[0][1]).float().mean())
                with UlpNoise(model, share, seed=i), same(), trace(model) as c_trace:
                    control = batch_logits(runner, [p], [o.output_ids[0]])
                w_shares.append(share)
                for name, t in (("kernel", k_trace), ("control", c_trace)):
                    for into, g in zip(w_gaps[name], t.gaps(p_trace, L)):
                        into[:] = map(max, into, g)
                del k_trace, p_trace, c_trace
                for step in (0, 1):
                    a, b = control[step][0], plain[step][0]
                    w_control = max(w_control, float((a - b).abs().max()) / float(b.abs().max()))
                    if a.argmax() != b.argmax():
                        top2 = torch.topk(b, 2).values
                        w_flips.append(float(top2[0] - top2[1]) / float(b.abs().max()))
                own = batch_logits(runner, [p], [o.output_ids[0]])
                for step in (0, 1):
                    a, b = kern[step][0], own[step][0]
                    own_routing = max(own_routing, float((a - b).abs().max()) / float(b.abs().max()))
            if window is not None and len(p) > window:
                with NoWindow(model), same():
                    unwindowed = batch_logits(runner, [p], [o.output_ids[0]])
                for step in (0, 1):
                    a, b = kern[step][0], unwindowed[step][0]
                    moves.append((len(p), step, float((a - b).abs().max()) / float(b.abs().max())))
            if chunk is not None and len(p) >= chunk:
                with NoChunk(model), same():
                    unchunked = batch_logits(runner, [p], [o.output_ids[0]])
                for step in (0, 1):
                    if len(p) - 1 + step >= chunk:  # the row's query sits past the first edge
                        a, b = kern[step][0], unchunked[step][0]
                        chunk_moves.append((len(p), step, float((a - b).abs().max()) / float(b.abs().max())))
            if mla:
                with ExpandedMla(model, rope=False), same():
                    unroped = batch_logits(runner, [p], [o.output_ids[0]])
                for step in (0, 1):
                    a, b = kern[step][0], unroped[step][0]
                    rope_moves.append((len(p), step, float((a - b).abs().max()) / float(b.abs().max())))
            if has_sinks:
                with NoSinks(model), same():
                    unsunk = batch_logits(runner, [p], [o.output_ids[0]])
                for step in (0, 1):
                    a, b = kern[step][0], unsunk[step][0]
                    sink_moves.append((len(p), step, float((a - b).abs().max()) / float(b.abs().max())))
        for step in (0, 1):
            a, b = kern[step][0], plain[step][0]
            check(bool(torch.isfinite(a).all() and torch.isfinite(b).all()), f"{label}: non-finite logits")
            scale = float(b.abs().max())
            rel = float((a - b).abs().max()) / scale
            worst[step] = max(worst[step], rel)
            top2 = torch.topk(b, 2).values
            gap = float(top2[0] - top2[1])
            min_margin = min(min_margin, gap / scale)
            # the logits are bf16: a tie is a top-2 gap of at most one bf16
            # ulp of the top logit (equal or adjacent bf16 values); W4A8
            # also excuses gaps under its sound route's floor
            tie = gap <= max(
                math.ldexp(1.0, math.frexp(abs(float(top2[0])))[1] - 8), ARGMAX_FLOOR[label] * scale
            )
            ties += int(tie)
            same = bool(a.argmax() == b.argmax())
            agree += int(same)
            check(rel <= tol, f"{label}: kernel-path logits differ from the plain path by {rel:.3e} of max |logit|")
            if not same:
                log(
                    f"[engine {label}] request {o.rid} step {step}: argmax {int(a.argmax())} "
                    f"(kernel) vs {int(b.argmax())} (plain); plain top-2 {float(top2[0]):.6g}, "
                    f"{float(top2[1]):.6g} (gap {gap / scale:.3e} of max|logit|, tie {tie}); "
                    f"max|diff| {rel:.3e} of max|logit|"
                )
            check(same or tie, f"{label} request {o.rid} step {step}: argmax differs outside a bf16 tie")
    log(
        f"[engine {label}] kernel vs plain logits over {2 * len(outs)} rows: worst "
        f"max|diff|/max|logit| {worst[0]:.3e} after the extend, {worst[1]:.3e} after "
        f"the decode step (tol {tol}); argmax agrees on {agree} of {2 * len(outs)}, "
        f"{ties} rows with a bf16 tie at the top; smallest plain top-2 gap "
        f"{min_margin:.3e} of max|logit|"
    )
    result["worst_logit_rel"] = max(worst.values())
    if witness:
        log(
            f"[engine {label}] witness: the kernel path's first-layer attention outputs differ from "
            f"the plain path's at {min(w_shares):.3f} to {max(w_shares):.3f} of their elements; per "
            f"layer, worst over {2 * len(outs)} rows, max|diff|/max|x| against the plain path: "
            f"kernel attention outputs {fmt_layers(w_gaps['kernel'][0])}, MoE inputs "
            f"{fmt_layers(w_gaps['kernel'][1])}; control attention outputs "
            f"{fmt_layers(w_gaps['control'][0])}, MoE inputs {fmt_layers(w_gaps['control'][1])}"
        )
        log(
            f"[engine {label}] control (the plain path with one-ulp noise on its attention outputs "
            f"at that share, the kernel path's routing) against the plain path: worst "
            f"max|diff|/max|logit| {w_control:.3e} (the kernel path {max(worst.values()):.3e}); "
            f"argmax differs on {len(w_flips)} of {2 * len(outs)} rows, at plain top-2 gaps "
            + (", ".join(f"{g:.3e}" for g in sorted(w_flips)) or "-") + " of max|logit|"
        )
        result["witness_control"] = w_control
        check(
            w_gaps["kernel"][0][0] <= 2**-7,
            f"{label}: the first layer's attention outputs differ from the plain path's by "
            f"{w_gaps['kernel'][0][0]:.3e} of their max, over one bf16 ulp",
        )
    if moe:
        log(
            f"[engine {label}] MoE routing: the plain path ran at the kernel path's routing; at its "
            f"own, its router picked another expert set at {flips} of {picked} (token, layer) "
            f"picks, and max|diff|/max|logit| read {own_routing:.3e} (not gated)"
        )
        result["worst_logit_rel_own_routing"] = own_routing
    if window is not None:
        reading = max(worst.values())
        log(
            f"[engine {label}] window {window}: kernel path against the plain path without the "
            f"window, prompt and step: "
            + ", ".join(f"{n} tokens step {st} {m:.3e}" for n, st, m in moves)
            + f" (at least {WINDOW_MOVE} x {reading:.3e})"
        )
        check(bool(moves), f"{label}: no prompt longer than the window {window}")
        for n, st, m in moves:
            check(
                m >= WINDOW_MOVE * reading,
                f"{label}: the window moves the {n}-token prompt's logits (step {st}) by only "
                f"{m:.3e}, under {WINDOW_MOVE} x the kernel-vs-plain reading {reading:.3e}",
            )
    if chunk is not None:
        reading = max(worst.values())
        log(
            f"[engine {label}] chunk {chunk}: kernel path against the plain path without the "
            f"chunks, prompt and step: "
            + ", ".join(f"{n} tokens step {st} {m:.3e}" for n, st, m in chunk_moves)
            + f" (at least {CHUNK_MOVE} x {reading:.3e})"
        )
        check(bool(chunk_moves), f"{label}: no prompt past the chunk {chunk}")
        result["chunk_move_min"] = min((m for _, _, m in chunk_moves), default=None)
        for n, st, m in chunk_moves:
            check(
                m >= CHUNK_MOVE * reading,
                f"{label}: the chunk moves the {n}-token prompt's logits (step {st}) by only "
                f"{m:.3e}, under {CHUNK_MOVE} x the kernel-vs-plain reading {reading:.3e}",
            )
    if mla:
        reading = max(worst.values())
        log(
            f"[engine {label}] latent attention: kernel path against HF's expanded form without "
            f"the q_rope . k_rope term, prompt and step: "
            + ", ".join(f"{n} tokens step {st} {m:.3e}" for n, st, m in rope_moves)
            + f" (at least {ROPE_MOVE} x {reading:.3e})"
        )
        result["rope_move_min"] = min(m for _, _, m in rope_moves)
        for n, st, m in rope_moves:
            check(
                m >= ROPE_MOVE * reading,
                f"{label}: dropping the rope term moves the {n}-token prompt's logits (step {st}) "
                f"by only {m:.3e}, under {ROPE_MOVE} x the absorbed-vs-expanded reading {reading:.3e}",
            )
    if has_sinks:
        reading = max(worst.values())
        log(
            f"[engine {label}] sinks: kernel path against the plain path without them, prompt and "
            f"step: " + ", ".join(f"{n} tokens step {st} {m:.3e}" for n, st, m in sink_moves)
            + f" (at least {SINK_MOVE} x {reading:.3e})"
        )
        gated = [(n, st, m) for n, st, m in sink_moves if sink_move and n <= (window or n)]
        check(bool(gated) or not sink_move, f"{label}: no prompt within the window to move by the sinks")
        result["sink_move_min"] = min((m for _, _, m in gated), default=None)
        for n, st, m in gated:
            check(
                m >= SINK_MOVE * reading,
                f"{label}: the sinks move the {n}-token prompt's logits (step {st}) by only "
                f"{m:.3e}, under {SINK_MOVE} x the kernel-vs-plain reading {reading:.3e}",
            )
    return result


def log_fp8_bytes(engine) -> None:
    """The fp8 engine's parameter and buffer bytes against the same model
    in bf16 (every fp8 code a bf16 weight, its scales gone)."""
    from scratchpad_tpu_torch.ops.quant.fp8 import Fp8Linear

    runner = engine.scheduler.runner
    fp8 = [m for m in runner.model.modules() if isinstance(m, Fp8Linear)]
    codes = sum(m.w8.numel() for m in fp8)
    scales = sum(m.s.numel() * 4 for m in fp8)
    bf16 = runner.param_bytes - codes - scales + 2 * codes
    log(
        f"[engine llama-3.1-8b-fp8] weights: {runner.param_bytes} B with fp8 projections ({codes} B of "
        f"codes, {scales} B of f32 scales) against {bf16} B in bf16: x{runner.param_bytes / bf16:.4f}"
    )
    check(runner.param_bytes < 0.7 * bf16, "the fp8 engine's weights are not smaller than bf16's")


# ---------------------------------------------------------------- vision

# A different image must move the logits of a request by at least this many
# times the engine's kernel-vs-plain reading; Gemma 3's spans (the same
# batch with mm_spans left out) the logits of its image requests by
# SPAN_MOVE times it: the logits are those of the text row after the image,
# which sees the image rows' change through its own causal attention only
# (8.5e-2, 5.0e-2 and 6.0e-2 against a reading of 4.7e-3 in a first run)
IMAGE_MOVE = 10.0
SPAN_MOVE = 5.0
# Gemma-3-4B-it's published config.json (huggingface.co/google/gemma-3-4b-it,
# config.json: its text_config and vision_config, the Gemma3TextConfig
# defaults it leaves out written in), read through
# ModelConfig.from_hf_config; the SigLIP tower at its full 27 layers and
# 896 px (4,096 patches pooled to 256 tokens an image), the decoder cut to
# GEMMA3_MM_LAYERS of its 34 (five local layers, window 1024, and a global
# one, then two local) to pay for the vision engines
GEMMA3_4B_MM = {
    "architectures": ["Gemma3ForConditionalGeneration"],
    "boi_token_index": 255999,
    "eoi_token_index": 256000,
    "image_token_index": 262144,
    "mm_tokens_per_image": 256,
    "text_config": {
        "vocab_size": 262208,
        "hidden_size": 2560,
        "intermediate_size": 10240,
        "num_hidden_layers": 34,
        "num_attention_heads": 8,
        "num_key_value_heads": 4,
        "head_dim": 256,
        "max_position_embeddings": 131072,
        "rms_norm_eps": 1e-6,
        "rope_theta": 1000000.0,
        "rope_local_base_freq": 10000.0,
        "rope_scaling": {"factor": 8.0, "rope_type": "linear"},
        "query_pre_attn_scalar": 256,
        "sliding_window": 1024,
        "sliding_window_pattern": 6,
        "model_type": "gemma3_text",
    },
    "vision_config": {
        "hidden_size": 1152,
        "image_size": 896,
        "intermediate_size": 4304,
        "num_attention_heads": 16,
        "num_hidden_layers": 27,
        "patch_size": 14,
        "layer_norm_eps": 1e-6,
        "num_channels": 3,
        "model_type": "siglip_vision_model",
    },
}
GEMMA3_MM_LAYERS = 8
# LLaVA-1.5-7B's published config.json (huggingface.co/llava-hf/
# llava-1.5-7b-hf, config.json; its text_config is Vicuna-7B-v1.5's Llama,
# the LlamaConfig defaults it leaves out written in): CLIP ViT-L/14 at 336
# px, the features of layer -2 without the class token (576 an image); the
# decoder cut to LLAVA_LAYERS of its 32, the tower at full depth
LLAVA_15_7B = {
    "architectures": ["LlavaForConditionalGeneration"],
    "image_token_index": 32000,
    "projector_hidden_act": "gelu",
    "vision_feature_layer": -2,
    "vision_feature_select_strategy": "default",
    "text_config": {
        "vocab_size": 32064,
        "hidden_size": 4096,
        "intermediate_size": 11008,
        "num_hidden_layers": 32,
        "num_attention_heads": 32,
        "num_key_value_heads": 32,
        "max_position_embeddings": 4096,
        "rms_norm_eps": 1e-5,
        "rope_theta": 10000.0,
        "tie_word_embeddings": False,
        "model_type": "llama",
    },
    "vision_config": {
        "hidden_size": 1024,
        "image_size": 336,
        "intermediate_size": 4096,
        "num_attention_heads": 16,
        "num_hidden_layers": 24,
        "patch_size": 14,
        "layer_norm_eps": 1e-5,
        "num_channels": 3,
        "model_type": "clip_vision_model",
    },
}
LLAVA_LAYERS = 8
# Llama-3.1-8B with fp8 weights and fp8 KV (BASELINE config 4), cut to
# FP8_LAYERS of its 32 layers
FP8_LAYERS = 8
# Qwen2-VL's special ids (its tokenizer's <|vision_start|>, <|vision_end|>,
# <|image_pad|>, <|video_pad|>)
QWEN2_VL_IDS = dict(vstart=151652, vend=151653, image=151655, video=151656)
VIDEO_FRAMES = 8


def mm_logits(runner, req, next_token: int, spans: bool = True):
    """The model's f32 logits [1, V] after one extend of ``req``'s prompt
    (its vision rows, 3-D rope table and spans as the scheduler hands them
    over; ``spans`` False leaves the spans out) and after one decode step of
    ``next_token``, on pages borrowed from the engine's idle pool; an
    Mllama request's image written, as admission writes it, into the idle
    engine's cross slot ``req.cross_slot``."""
    import numpy as np

    from scratchpad_tpu_torch.core.scheduler import cross_batch_fields
    from scratchpad_tpu_torch.executor.forward_meta import ForwardMode
    from scratchpad_tpu_torch.executor.model_runner import WorkerBatch
    from scratchpad_tpu_torch.sampling.batch_info import SamplingBatchInfo

    ids = np.asarray(req.origin_input_ids)
    n, ps = len(ids), runner.page_size
    pages = runner.page_allocator.alloc(-(-(n + 1) // ps))
    if pages is None:
        fail("no free pages for the logits check")
    try:
        pos = np.arange(n + 1)
        loc = pages[pos // ps] * ps + pos % ps
        mm = {}
        if req.mm_positions is not None:
            emb = np.zeros((n, runner.model_config.hidden_size), np.float32)
            emb[req.mm_positions] = req.mm_features
            mm["input_embeds"] = emb
        if req.mrope_table is not None:
            mm["mrope_positions"] = req.mrope_table
        if spans and req.mm_spans:
            mm["mm_spans"] = np.asarray([req.mm_spans], np.int32)
        cross = {}
        if req.cross_states is not None:
            runner.write_cross(req.cross_slot, req.cross_states)
            cross = cross_batch_fields([req], runner.kv_config.cross_len)
        common = dict(page_table=pages[None, :].astype(np.int32),
                      sampling_info=SamplingBatchInfo.from_reqs([], 1, runner.model_config.vocab_size))
        ext = WorkerBatch(mode=ForwardMode.EXTEND, tokens=ids, positions=pos[:n], out_cache_loc=loc[:n],
                          req_indices=np.zeros(n, np.int64), seq_lens=np.array([n]), extend_lens=np.array([n]),
                          **common, **mm, **cross)
        dec = WorkerBatch(mode=ForwardMode.DECODE, tokens=np.array([next_token]), positions=np.array([n]),
                          out_cache_loc=loc[n:], req_indices=np.zeros(1, np.int64), seq_lens=np.array([n + 1]),
                          extend_lens=np.ones(1, np.int64), **common, **cross,
                          rope_delta=np.array([req.mrope_delta]) if req.mrope_table is not None else None)
        return runner.forward_logits(ext), runner.forward_logits(dec)
    finally:
        runner.page_allocator.free(pages)


def vlm_traffic(engine, label: str):
    """The engine's requests: (prompt ids, images [N, C, S, S] or None, video
    frames [T, C, S, S] or None, new tokens), each image a seeded random
    pixel array in the normalised range: two one-image requests, a request
    with two images, on Qwen2-VL a video of ``VIDEO_FRAMES`` frames, and a
    text request; then the first prompt with another image (the radix and
    image-move checks)."""
    import numpy as np

    model = engine.scheduler.runner.model
    S, V = model.vision.image_size, engine.model_config.vocab_size
    rng = np.random.default_rng(7)
    text = lambda n: rng.integers(1, min(V, 32000), n).tolist()
    px = lambda n: rng.standard_normal((n, 3, S, S)).astype(np.float32)
    if getattr(model, "uses_mrope", False):
        q = QWEN2_VL_IDS
        img = lambda: [q["vstart"], q["image"], q["vend"]]
        traffic = [
            (text(20) + img() + text(30), px(1), None, 16),
            (text(5) + img() + text(200), px(1), None, 16),
            (text(12) + img() + text(7) + img() + text(9), px(2), None, 16),
            (text(10) + [q["vstart"], q["video"], q["vend"]] + text(15), None, px(VIDEO_FRAMES), 16),
            (text(300), None, None, 16),
        ]
    else:
        tok = model.image_token_index
        traffic = [
            (text(20) + [tok] + text(30), px(1), None, 16),
            (text(200) + [tok] + text(5), px(1), None, 16),
            (text(12) + [tok] + text(7) + [tok] + text(9), px(2), None, 16),
            (text(300), None, None, 16),
        ]
    other = px(1)
    return traffic, (traffic[0][0], other, None, 16)


def kernel_vs_plain(runner, label: str, reqs, outs):
    """Each request's kernel-path logits after its extend and one decode
    step (``mm_logits``) against the plain path's, under the text engines'
    gate (``LOGIT_RTOL``) and argmax rule (a bf16 tie or ``ARGMAX_FLOOR``);
    returns (the kernel rows, the worst max |diff| / max |logit|, rows whose
    argmax agrees, rows)."""
    import torch

    tol = LOGIT_RTOL[label]
    worst, agree, rows, kern_rows = 0.0, 0, 0, []
    for req, o in zip(reqs, outs):
        kern = mm_logits(runner, req, o.output_ids[0])
        with PlainPath(runner.model):
            plain = mm_logits(runner, req, o.output_ids[0])
        kern_rows.append(kern)
        for step in (0, 1):
            a, b = kern[step][0], plain[step][0]
            check(bool(torch.isfinite(a).all() and torch.isfinite(b).all()), f"{label}: non-finite logits")
            scale = float(b.abs().max())
            rel = float((a - b).abs().max()) / scale
            worst = max(worst, rel)
            top2 = torch.topk(b, 2).values
            gap = float(top2[0] - top2[1])
            tie = gap <= max(math.ldexp(1.0, math.frexp(abs(float(top2[0])))[1] - 8),
                             ARGMAX_FLOOR[label] * scale)
            same = bool(a.argmax() == b.argmax())
            agree, rows = agree + same, rows + 1
            check(rel <= tol, f"{label}: kernel-path logits differ from the plain path by {rel:.3e} of max |logit|")
            check(same or tie, f"{label} request {o.rid} step {step}: argmax differs outside a bf16 tie")
    return kern_rows, worst, agree, rows


def phase_vlm(engine, label: str, span_move: bool = False) -> dict:
    """A vision engine's traffic (``vlm_traffic``) through ``Engine.generate``
    in one batch, every launch count set to 0 just before and read just
    after: each request's tokens; the extend and decode kernels of the
    pool's kind launched once a layer and forward (Gemma 3: the extend
    launches with spans, rows 3m or 3qm, once a layer and extend forward
    whose batch carries spans); the first prompt with another image reuses
    only the text before its image and answers otherwise. Then for each
    request the kernel-path logits (after the extend and one decode step)
    against the plain path's, with the text engines' gate and argmax rule;
    the other image must move the first request's logits by ``IMAGE_MOVE``
    times the worst reading, and with ``span_move`` leaving the spans out
    must move each image request's by ``SPAN_MOVE`` times it."""
    import torch

    from scratchpad_tpu_torch.executor.forward_meta import ForwardMode
    from scratchpad_tpu_torch.ops import KERNEL_WRAPPERS, reset_launch_counts
    from scratchpad_tpu_torch.ops.attention import paged_extend_attention, paged_extend_attention_quant
    from scratchpad_tpu_torch.sampling.sampling_params import SamplingParams

    runner = engine.scheduler.runner
    model = runner.model
    L = runner.model_config.num_hidden_layers
    traffic, again = vlm_traffic(engine, label)
    forwards = {ForwardMode.EXTEND: 0, ForwardMode.DECODE: 0}
    spanned = [0]  # extend forwards whose batch carries spans
    inner_forward = model.forward

    def counting_forward(meta, kv):
        forwards[meta.mode] += 1
        spanned[0] += meta.mm_spans is not None
        return inner_forward(meta, kv)

    model.forward = counting_forward
    sp = lambda m: SamplingParams(temperature=0.0, max_new_tokens=m, ignore_eos=True)
    engine.flush_cache()
    t = time.monotonic()
    reset_launch_counts()
    try:
        outs = engine.generate(input_ids=[r[0] for r in traffic], image_data=[r[1] for r in traffic],
                               video_data=[r[2] for r in traffic], sampling_params=[sp(r[3]) for r in traffic],
                               return_logprob=True)
        out2 = engine.generate(input_ids=again[0], image_data=again[1], sampling_params=sp(again[3]),
                               return_logprob=True)
        torch.cuda.synchronize()
    finally:
        model.forward = inner_forward
    counts = {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}
    counts[EXTEND_SPANS] = paged_extend_attention.span_launches
    counts[EXTEND_SPANS_8BIT] = paged_extend_attention_quant.span_launches
    wall = time.monotonic() - t
    n_ext, n_dec = forwards[ForwardMode.EXTEND], forwards[ForwardMode.DECODE]
    pages = runner.kv_cache_dtype if runner.kv_cache.quantized else "bf16"
    lens = [len(o.output_ids) for o in outs + [out2]]
    log(
        f"[engine {label}] {len(traffic) + 1} requests ({sum(r[1] is not None for r in traffic)} with "
        f"images, {sum(r[2] is not None for r in traffic)} with a video) in {wall:.1f} s: {n_ext} extend "
        f"and {n_dec} decode forwards, {spanned[0]} with spans; kernel launches {counts}"
    )
    for o, r in zip(outs + [out2], traffic + [again]):
        check(len(o.output_ids) == r[3] and o.finish_reason == "length",
              f"{label} request {o.rid}: {len(o.output_ids)} tokens, finish {o.finish_reason}")
    need = {EXTEND[pages]: L * n_ext, DECODE[pages]: L * n_dec}
    if span_move:
        need[EXTEND_SPANS if pages == "bf16" else EXTEND_SPANS_8BIT] = L * spanned[0]
    for k, n in need.items():
        check(counts[k] >= n > 0, f"{label}: {k} launched {counts[k]} times, fewer than {n}")
    check(span_move or counts[EXTEND_SPANS] + counts[EXTEND_SPANS_8BIT] == 0,
          f"{label}: extend launches with spans on a model without them")
    image_at = traffic[0][0].index(next(t for t in traffic[0][0] if t in (
        getattr(model, "image_token_index", -1), QWEN2_VL_IDS["image"])))
    check(out2.cached_tokens <= image_at, f"{label}: {out2.cached_tokens} cached tokens across another image "
                                          f"(the image starts at row {image_at})")
    # random weights repeat a few tokens: the answers differ in their ids or
    # in the logprobs of their first tokens
    lp_gap = abs(out2.output_token_logprobs[0] - outs[0].output_token_logprobs[0])
    check(out2.output_ids != outs[0].output_ids or lp_gap > 1e-3,
          f"{label}: another image gave the same answer (first logprobs {lp_gap:.3e} apart)")
    log(f"[engine {label}] the first prompt with another image: {out2.cached_tokens} cached tokens (its image "
        f"starts at row {image_at}), tokens {'differ' if out2.output_ids != outs[0].output_ids else 'equal'}, "
        f"the first tokens' logprobs {lp_gap:.3e} apart")
    # kernel path against the plain path, each request's extend and decode
    tol = LOGIT_RTOL[label]
    span_moves = []
    reqs = [engine._make_req(None, r[0], None, image_data=r[1], video_data=r[2]) for r in traffic + [again]]
    kern_rows, worst, agree, rows = kernel_vs_plain(runner, label, reqs[:-1], outs)
    for req, o, kern in zip(reqs[:-1], outs, kern_rows):
        if span_move and req.mm_spans:
            flat = mm_logits(runner, req, o.output_ids[0], spans=False)
            span_moves.append(max(float((a[0] - b[0]).abs().max() / b[0].abs().max())
                                  for a, b in zip(kern, flat)))
    moved = mm_logits(runner, reqs[-1], outs[0].output_ids[0])
    image_move = max(float((a[0] - b[0]).abs().max() / b[0].abs().max()) for a, b in zip(moved, kern_rows[0]))
    log(
        f"[engine {label}] kernel vs plain logits over {rows} rows: worst max|diff|/max|logit| {worst:.3e} "
        f"(tol {tol}); argmax agrees on {agree} of {rows}; another image moves the first request's logits "
        f"by {image_move:.3e} (at least {IMAGE_MOVE} x {worst:.3e})"
        + (f"; leaving the spans out moves the image requests' by "
           + ", ".join(f"{m:.3e}" for m in span_moves) + f" (at least {SPAN_MOVE} x {worst:.3e})"
           if span_move else "")
    )
    check(image_move >= IMAGE_MOVE * worst, f"{label}: another image moves the logits by only {image_move:.3e}")
    for m in span_moves:
        check(m >= SPAN_MOVE * worst, f"{label}: leaving the spans out moves the logits by only {m:.3e}")
    check(not span_move or bool(span_moves), f"{label}: no image request to move by the spans")
    steps = {EXTEND[pages]: n_ext, DECODE[pages]: n_dec, EXTEND_SPANS: spanned[0], EXTEND_SPANS_8BIT: spanned[0]}
    return dict(
        counts=counts, by_group={}, steps=steps, worst_logit_rel=worst, image_move=image_move,
        span_move_min=min(span_moves, default=None), preset=engine.args.preset or runner.model_config.architecture,
        weights=engine.args.quantization or "bf16", kv_cache_dtype=runner.kv_cache_dtype,
        attention_backend=runner.attention_backend,
    )


# Llama-3.2-11B-Vision-Instruct's published config.json (huggingface.co/
# meta-llama/Llama-3.2-11B-Vision-Instruct, config.json: its text_config and
# vision_config, read through ModelConfig.from_hf_config; the 8 extra
# embedding rows are the model's own): the decoder cut to MLLAMA_LAYERS of
# its 40 (self layers 0-2, cross 3, self 4-7, cross 8, self 9), the tower at
# its full 32 local and 8 global layers
LLAMA32_11B_VISION = {
    "architectures": ["MllamaForConditionalGeneration"],
    "image_token_index": 128256,
    "text_config": {
        "vocab_size": 128256,
        "hidden_size": 4096,
        "intermediate_size": 14336,
        "num_hidden_layers": 40,
        "cross_attention_layers": [3, 8, 13, 18, 23, 28, 33, 38],
        "num_attention_heads": 32,
        "num_key_value_heads": 8,
        "max_position_embeddings": 131072,
        "rms_norm_eps": 1e-5,
        "rope_theta": 500000.0,
        "rope_scaling": {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
                         "high_freq_factor": 4.0, "original_max_position_embeddings": 8192},
        "tie_word_embeddings": False,
        "model_type": "mllama_text_model",
    },
    "vision_config": {
        "hidden_size": 1280,
        "attention_heads": 16,
        "num_hidden_layers": 32,
        "num_global_layers": 8,
        "image_size": 560,
        "patch_size": 14,
        "max_num_tiles": 4,
        "intermediate_size": 5120,
        "intermediate_layers_indices": [3, 7, 15, 23, 30],
        "vision_output_dim": 7680,
        "num_channels": 3,
        "norm_eps": 1e-5,
        "supported_aspect_ratios": [[1, 1], [1, 2], [1, 3], [1, 4], [2, 1], [2, 2], [3, 1], [4, 1]],
        "model_type": "mllama_vision_model",
    },
}
MLLAMA_LAYERS = 10
# two cross slots for four image requests: two of them wait for a freed one
MLLAMA_SLOTS = 2
# the cross gates (and the tower's): HF's init leaves them at 0, where
# tanh(0) takes every effect of the image away
MLLAMA_GATE = 0.8
# The other image of the image-move check: its pixels a standard normal
# shifted by this much. Another unshifted draw of white noise moved the chat
# request's logits by only 4.7 times the kernel-vs-plain reading; the phase
# logs that move, and, in the first cross layer, how evenly the chat
# request's rows attend and how far the two noise images' attention outputs
# and mean V rows lie apart (``cross_readings``)
MLLAMA_SHIFT = 1.0
# Llama 3's chat template in its published tokenizer's ids: <|begin_of_text|>
# <|start_header_id|> "system" <|end_header_id|> "\n\n", a system prompt of
# MLLAMA_SYSTEM tokens and <|eot_id|>, then <|start_header_id|> "user"
# <|end_header_id|> "\n\n" before the image, and <|eot_id|>
# <|start_header_id|> "assistant" <|end_header_id|> "\n\n" after the question
LLAMA3_SYSTEM_HEAD = [128000, 128006, 9125, 128007, 271]
LLAMA3_USER_HEAD = [128009, 128006, 882, 128007, 271]
LLAMA3_ASSISTANT_HEAD = [128009, 128006, 78191, 128007, 271]
MLLAMA_SYSTEM = 40


def mllama_traffic(engine):
    """(prompt ids, image, new tokens) of the Mllama phase, each image a
    seeded random tile stack in the normalised range as ``preprocess_image``
    gives it (tiles, aspect-ratio id, live tiles): a chat prompt with the
    image after Llama 3's system and user headers (2 x 2), image-first
    prompts at 1 x 1, 1 x 2 (2 of 4 tiles live) and 2 x 2, and a text
    request; then, one at a time, the chat prompt with another image, its
    pixels shifted by ``MLLAMA_SHIFT`` (the radix and image-move checks),
    the chat prompt's text with no image, and the chat prompt with its own
    image again (the radix checks); and a third image of unshifted noise
    for the chat prompt (its move is logged, not gated)."""
    import numpy as np

    model = engine.scheduler.runner.model
    v, tok = model.vision, model.image_token_index
    rng = np.random.default_rng(7)
    text = lambda n: rng.integers(1, 32000, n).tolist()

    def image(rows, cols, shift=0.0):
        px = np.zeros((v.max_tiles, 3, v.image_size, v.image_size), np.float32)
        px[: rows * cols] = rng.standard_normal((rows * cols, 3, v.image_size, v.image_size)) + shift
        return px, v.supported_aspect_ratios.index((rows, cols)) + 1, rows * cols

    chat = LLAMA3_SYSTEM_HEAD + text(MLLAMA_SYSTEM) + LLAMA3_USER_HEAD + [tok] + text(24) + LLAMA3_ASSISTANT_HEAD
    traffic = [
        (chat, image(2, 2), 16),
        ([tok] + text(30), image(1, 1), 16),
        ([tok] + text(200), image(1, 2), 16),
        ([tok] + text(12), image(2, 2), 16),
        (text(300), None, 16),
    ]
    later = [(chat, image(2, 2, MLLAMA_SHIFT), 16), ([t for t in chat if t != tok], None, 16), traffic[0]]
    return traffic, later, image(2, 2)


# The cross layer (plain torch, blocked under CROSS_SCORE_BYTES) against
# an unblocked reference on the card, max |diff| / max |out|; the blocked
# run's limit forces this many query blocks
CROSS_RTOL = 1e-5
CROSS_BLOCKS = 4


def cross_attention_reference(q, kv_slot, live: int, text_rows: int, scale: float):
    """``models/mllama.py::cross_attention`` written out, in f32, with no
    blocking: rows from ``text_rows`` on attend the first ``live`` cross
    rows, the rows before them every cross row; [n, Hq * D]."""
    import torch

    n, Hq, D = q.shape
    S, Hkv = kv_slot.shape[0], kv_slot.shape[1] // 2
    k = kv_slot[:, 0::2].float().repeat_interleave(Hq // Hkv, dim=1)  # [S, Hq, D]
    v = kv_slot[:, 1::2].float().repeat_interleave(Hq // Hkv, dim=1)
    s = torch.einsum("thd,shd->hts", q.float(), k) * scale
    masked = (torch.arange(n, device=q.device)[:, None] >= text_rows) & (torch.arange(S, device=q.device) >= live)
    a = torch.softmax(s.masked_fill(masked, float("-inf")), dim=-1)
    return torch.einsum("hts,shd->thd", a, v).reshape(n, Hq * D)


def cross_readings(q, kv_ref, kv_other, live: int, text_rows: int, scale: float) -> dict:
    """Why another image moves the logits little, in one cross layer, on the
    rows that attend the live tiles: the mean entropy of their attention
    over its largest, log(live) (1: even), the two images' attention
    outputs apart (|o_other - o_ref| / |o_ref|, Frobenius), and their mean
    V rows apart (the same ratio): if the rows attend almost evenly, the
    outputs are near the mean V rows and part as they do."""
    import torch

    rows = slice(text_rows, q.shape[0])
    qf = q[rows].float()
    Hq, Hkv = q.shape[1], kv_ref.shape[1] // 2
    k = kv_ref[:live, 0::2].float().repeat_interleave(Hq // Hkv, dim=1)
    a = torch.softmax(torch.einsum("thd,shd->hts", qf, k) * scale, dim=-1)
    entropy = float(-(a * a.clamp_min(1e-30).log()).sum(-1).mean()) / math.log(live)
    o_ref = cross_attention_reference(q[rows], kv_ref, live, 0, scale)
    o_other = cross_attention_reference(q[rows], kv_other, live, 0, scale)
    mean_v = lambda kv: kv[:live, 1::2].float().mean(0)
    return dict(
        entropy=entropy,
        out_apart=float((o_other - o_ref).norm() / o_ref.norm()),
        mean_v_apart=float((mean_v(kv_other) - mean_v(kv_ref)).norm() / mean_v(kv_ref).norm()),
    )


def phase_mllama(engine, label: str = "llama-3.2-11b-vision") -> dict:
    """The Mllama engine's traffic (``mllama_traffic``) through
    ``Engine.generate`` in one batch, its gates at ``MLLAMA_GATE``, every
    launch count set to 0 just before and read just after: each request's
    tokens; the extend and decode kernels launched exactly once a self
    layer and forward (the cross layers launch neither); at most
    ``MLLAMA_SLOTS`` images in a forward, four served. Then, one at a time
    in the same count: the chat prompt with another image and its text
    with no image reuse no page of the chat request (every row of it
    attends its image in the cross layers; its image lies past the first
    page) and the first answers otherwise; the chat prompt with its own
    image again reuses its prompt past the image. Then each request's
    kernel-path logits against the plain path's (``kernel_vs_plain``) in a
    free cross slot; the other image must move the chat request's by
    ``IMAGE_MOVE`` times the worst reading; the first cross layer on the
    1 x 2 request and the chat request against ``cross_attention_reference``
    in ``CROSS_BLOCKS`` blocks and in one (``CROSS_RTOL``), and its
    ``cross_readings`` for the unshifted and the shifted image. The tower's
    ms an image (a 2 x 2 stack, device-synchronised, warm), the cross
    buffer's GiB and the KV tokens go on ``[mllama]`` lines beside the
    card's name and power limit."""
    import numpy as np
    import torch

    import scratchpad_tpu_torch.models.mllama as mllama_module
    from scratchpad_tpu_torch.executor.forward_meta import ForwardMode
    from scratchpad_tpu_torch.ops import KERNEL_WRAPPERS, reset_launch_counts
    from scratchpad_tpu_torch.sampling.sampling_params import SamplingParams

    runner = engine.scheduler.runner
    model = runner.model
    L = model.num_kv_layers  # the kernels' layers: the self layers alone
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "gate" in name.split(".")[-1] and p.shape[-1] == 1:
                p.fill_(MLLAMA_GATE)
    traffic, later, noise = mllama_traffic(engine)
    px, ar, nt = traffic[0][1]
    for _ in range(2):  # warm
        runner.encode_images(px[None], [ar], [nt])
    torch.cuda.synchronize()
    t = time.monotonic()
    reps = 3
    for _ in range(reps):
        runner.encode_images(px[None], [ar], [nt])
    torch.cuda.synchronize()
    tower_ms = (time.monotonic() - t) / reps * 1e3
    cross_gib = runner.kv_config.cross_bytes() / 2**30
    card = card_line()
    log(f"[mllama] {label}: tower {tower_ms:.1f} ms an image (4 tiles of {model.vision.num_patches} patches, "
        f"{model.vision.num_layers} + {model.vision.global_layers} layers, with the host copies); cross buffer "
        f"{cross_gib:.3f} GiB ({runner.kv_config.cross_slots} slots x {runner.kv_config.cross_layers} layers x "
        f"{runner.kv_config.cross_len} rows); {runner.max_total_num_tokens} KV tokens over {L} self layers; {card}")

    forwards = {ForwardMode.EXTEND: 0, ForwardMode.DECODE: 0}
    images_at_once = [0]
    inner_forward = model.forward

    def counting_forward(meta, kv):
        forwards[meta.mode] += 1
        images_at_once[0] = max(images_at_once[0], len(meta.cross_requests or ()))
        return inner_forward(meta, kv)

    model.forward = counting_forward
    sp = lambda m: SamplingParams(temperature=0.0, max_new_tokens=m, ignore_eos=True)
    engine.flush_cache()
    t = time.monotonic()
    reset_launch_counts()
    try:
        outs = engine.generate(input_ids=[r[0] for r in traffic], image_data=[r[1] for r in traffic],
                               sampling_params=[sp(r[2]) for r in traffic], return_logprob=True)
        outs_later = [engine.generate(input_ids=r[0], image_data=r[1], sampling_params=sp(r[2]),
                                      return_logprob=True) for r in later]
        torch.cuda.synchronize()
    finally:
        model.forward = inner_forward
    counts = {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}
    wall = time.monotonic() - t
    n_ext, n_dec = forwards[ForwardMode.EXTEND], forwards[ForwardMode.DECODE]
    n_img = sum(r[1] is not None for r in traffic + later)
    log(f"[engine {label}] {len(traffic) + len(later)} requests ({n_img} with an image) in {wall:.1f} s: {n_ext} "
        f"extend and {n_dec} decode forwards over {L} self layers, at most {images_at_once[0]} images in a forward "
        f"({MLLAMA_SLOTS} cross slots); kernel launches {counts}")
    for o, r in zip(outs + outs_later, traffic + later):
        check(len(o.output_ids) == r[2] and o.finish_reason == "length",
              f"{label} request {o.rid}: {len(o.output_ids)} tokens, finish {o.finish_reason}")
    need = {EXTEND["bf16"]: L * n_ext, DECODE["bf16"]: L * n_dec}
    for k, n in need.items():
        check(counts[k] == n > 0, f"{label}: {k} launched {counts[k]} times, not {n} (once a self layer and forward)")
    check(images_at_once[0] <= MLLAMA_SLOTS < sum(r[1] is not None for r in traffic),
          f"{label}: {images_at_once[0]} images in a forward over {MLLAMA_SLOTS} slots")
    image_at, ps = traffic[0][0].index(model.image_token_index), runner.page_size
    check(image_at >= 2 * ps, f"{label}: the chat image at row {image_at} leaves no whole page before it")
    other, text_only, same = outs_later
    for o, what in ((other, "another image"), (text_only, "no image")):
        check(o.cached_tokens == 0, f"{label}: the chat prompt with {what} reused {o.cached_tokens} tokens of "
                                    f"the chat request's (its image at row {image_at})")
    check(same.cached_tokens > image_at, f"{label}: the chat prompt with its own image again reused only "
                                         f"{same.cached_tokens} tokens (its image at row {image_at})")
    lp_gap = abs(other.output_token_logprobs[0] - outs[0].output_token_logprobs[0])
    check(other.output_ids != outs[0].output_ids or lp_gap > 1e-3,
          f"{label}: another image gave the same answer (first logprobs {lp_gap:.3e} apart)")
    engine.scheduler.check_memory_leak()
    reqs = [engine._make_req(None, r[0], None, image_data=r[1]) for r in traffic + later[:1]]
    noise_req = engine._make_req(None, later[0][0], None, image_data=noise)
    slot = engine.scheduler.cross_slot_free[-1]  # the engine is idle: every slot is free
    for r in reqs + [noise_req]:
        r.cross_slot = slot if r.cross_states is not None else None
    kern_rows, worst, agree, rows = kernel_vs_plain(runner, label, reqs[:-1], outs)

    captured = []
    inner_attention = mllama_module.cross_attention

    def capturing(q, kv_slot, live, text_rows, scale):
        captured.append((q.clone(), kv_slot.clone(), live, text_rows, scale))
        return inner_attention(q, kv_slot, live, text_rows, scale)

    def move(req):
        """The logits' move from the chat request's, and its first cross
        layer's inputs on the extend."""
        captured.clear()
        mllama_module.cross_attention = capturing
        try:
            moved = mm_logits(runner, req, outs[0].output_ids[0])
        finally:
            mllama_module.cross_attention = inner_attention
        return max(float((a[0] - b[0]).abs().max() / b[0].abs().max()) for a, b in zip(moved, kern_rows[0])), \
            captured[0]

    _, chat_in = move(reqs[0])
    _, wide_in = move(reqs[2])  # 1 x 2: 2 of 4 tiles live, 201 rows
    image_move, shifted_in = move(reqs[-1])
    noise_move, noise_in = move(noise_req)
    cross_err = 0.0
    limit = mllama_module.CROSS_SCORE_BYTES
    for q, kv_slot, live, text_rows, scale in (chat_in, wide_in):
        ref = cross_attention_reference(q, kv_slot, live, text_rows, scale)
        step = -(-q.shape[0] // CROSS_BLOCKS)
        try:
            mllama_module.CROSS_SCORE_BYTES = step * q.shape[1] * kv_slot.shape[0] * 8
            blocked = inner_attention(q, kv_slot, live, text_rows, scale)
        finally:
            mllama_module.CROSS_SCORE_BYTES = limit
        whole = inner_attention(q, kv_slot, live, text_rows, scale)
        for out in (blocked, whole):
            cross_err = max(cross_err, float((out - ref).abs().max() / ref.abs().max()))
    check(cross_err <= CROSS_RTOL, f"{label}: the cross layer differs from its reference by {cross_err:.3e}")
    q, kv_chat, live, text_rows, scale = chat_in
    readings = {name: cross_readings(q, kv_chat, x[1], live, text_rows, scale)
                for name, x in (("unshifted", noise_in), ("shifted", shifted_in))}
    log(f"[engine {label}] the chat prompt (image at row {image_at}, pages of {ps}) with another image: "
        f"{other.cached_tokens} cached tokens, first logprobs {lp_gap:.3e} apart; with no image "
        f"{text_only.cached_tokens} cached tokens; with its own image again {same.cached_tokens}; kernel vs plain "
        f"logits over {rows} rows: worst max|diff|/max|logit| {worst:.3e} (tol {LOGIT_RTOL[label]}); argmax "
        f"agrees on {agree} of {rows}; another image moves the chat request's logits by {image_move:.3e} (at "
        f"least {IMAGE_MOVE} x {worst:.3e}); unshifted noise by {noise_move:.3e} (not gated); the first cross "
        f"layer against its reference, in {CROSS_BLOCKS} blocks and in one, on the chat and 1 x 2 requests: "
        f"{cross_err:.3e} (tol {CROSS_RTOL})")
    for name, r in readings.items():
        log(f"[engine {label}] first cross layer, chat request, {name} image against its own: attention "
            f"entropy {r['entropy']:.4f} of log(live rows); outputs {r['out_apart']:.3e} apart; mean V rows "
            f"{r['mean_v_apart']:.3e} apart")
    check(image_move >= IMAGE_MOVE * worst, f"{label}: another image moves the logits by only {image_move:.3e}")
    engine.scheduler.check_memory_leak()
    return dict(
        counts=counts, by_group={}, steps={EXTEND["bf16"]: n_ext, DECODE["bf16"]: n_dec},
        worst_logit_rel=worst, image_move=image_move, noise_move=noise_move, cross_err=cross_err,
        cross_readings=readings, cached_tokens=[o.cached_tokens for o in outs_later],
        preset=runner.model_config.architecture, weights="bf16",
        kv_cache_dtype=runner.kv_cache_dtype, attention_backend=runner.attention_backend,
        self_layers=L, launches_per_forward={EXTEND["bf16"]: counts[EXTEND["bf16"]] / max(n_ext, 1),
                                             DECODE["bf16"]: counts[DECODE["bf16"]] / max(n_dec, 1)},
        images_at_once=images_at_once[0], tower_ms=tower_ms, cross_gib=cross_gib,
        kv_tokens=runner.max_total_num_tokens, card=card,
    )


PROFILED_WINDOWS = (2, 5)  # decode windows [2, 5) of the profiled run


class DecodeWindows:
    """Records a runner's decode windows: wraps ``dispatch_decode_window``
    and ``fetch_decode_window``, which the scheduler's pipelined path calls
    and ``run_decode_window`` calls for every batch it may pipeline, so a
    window counts once on either route. ``decode_s`` spans the first
    dispatch to the last fetch since ``reset``: the decode phase's wall, the
    host's work between windows included. ``before_dispatch(n, K)`` and
    ``after_fetch(n)`` hooks see each window's index."""

    def __init__(self, runner):
        self.runner = runner
        self.before_dispatch = self.after_fetch = None
        self.reset()

    def reset(self) -> None:
        self.dispatched = self.fetched = self.tokens = 0
        self.first = self.last = None

    @property
    def decode_s(self) -> float:
        return self.last - self.first

    def __enter__(self):
        runner = self.runner
        self._inner = (runner.dispatch_decode_window, runner.fetch_decode_window)
        dispatch, fetch = self._inner

        def timed_dispatch(wb, K, prev_tokens=None):
            if self.before_dispatch is not None:
                self.before_dispatch(self.dispatched, K)
            if self.first is None:
                self.first = time.perf_counter()
            self.dispatched += 1
            return dispatch(wb, K, prev_tokens)

        def timed_fetch(pending):
            out = fetch(pending)  # waits for the window's ids on the host
            self.last = time.perf_counter()
            self.tokens += out[0].shape[0] * out[0].shape[1]
            self.fetched += 1
            if self.after_fetch is not None:
                self.after_fetch(self.fetched - 1)
            return out

        runner.dispatch_decode_window, runner.fetch_decode_window = timed_dispatch, timed_fetch
        return self

    def __exit__(self, *exc):
        self.runner.dispatch_decode_window, self.runner.fetch_decode_window = self._inner


def bench_run(engine, windows: DecodeWindows, label: str) -> dict:
    """One run of the bench batch (bs 64, 128-token prompts, 128 new greedy
    tokens) from an empty cache: decode tokens/s over the decode span,
    tokens/s end to end, and the output ids. A run that records no decode
    window fails the script: its rates would time nothing."""
    import numpy as np
    import torch

    from scratchpad_tpu_torch.sampling.sampling_params import SamplingParams

    rng = np.random.default_rng(1)
    V = engine.scheduler.runner.model_config.vocab_size
    bench = [rng.integers(1, V, 128).tolist() for _ in range(64)]
    sp = SamplingParams(temperature=0.0, max_new_tokens=128, ignore_eos=True)
    engine.flush_cache()
    torch.cuda.synchronize()
    windows.reset()
    t = time.perf_counter()
    res = engine.generate(input_ids=bench, sampling_params=[sp] * 64)
    wall = time.perf_counter() - t
    if any(len(r.output_ids) != 128 for r in res):
        fail(f"{label}: bench requests did not finish with 128 tokens")
    if windows.fetched == 0:
        fail(f"{label}: the timed run recorded no decode window")
    return dict(
        decode_tok_s=windows.tokens / windows.decode_s, e2e_tok_s=64 * 128 / wall,
        windows=windows.fetched, output_ids=[r.output_ids for r in res],
    )


def profiled_run(engine, windows: DecodeWindows, label: str, step_ms: float, tag: str = "profile"):
    """The bench batch again with ``torch.profiler`` on over decode windows
    ``PROFILED_WINDOWS``: from the dispatch of the first (after a
    synchronize) to the fetch of the last (and a synchronize), so the trace
    holds exactly the windows dispatched in between. The device time is the
    exported trace's (``tools/analyze_trace.py``: kernels, copies and
    memsets; one pass, where ``key_averages`` took tens of seconds an
    engine). Returns (device ms per decode step, busy share against
    ``step_ms``, the trace's rollup), or (None, None, rollup) where the
    profiler saw no device time."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from scratchpad_tpu_torch.tools import analyze_trace

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    span = {"steps": 0, "on": False}

    def before_dispatch(n, K):
        if n == PROFILED_WINDOWS[0]:
            torch.cuda.synchronize()
            prof.start()
            span.update(on=True, t0=time.perf_counter())
        if span["on"]:
            span["steps"] += K

    def after_fetch(n):
        if n == PROFILED_WINDOWS[1] - 1 and span["on"]:
            torch.cuda.synchronize()
            span.update(on=False, wall=time.perf_counter() - span["t0"])
            prof.stop()

    windows.before_dispatch, windows.after_fetch = before_dispatch, after_fetch
    try:
        ran = bench_run(engine, windows, label)
    finally:
        windows.before_dispatch = windows.after_fetch = None
    if "wall" not in span:
        fail(f"{label}: the bench run had {windows.fetched} decode windows, too few to profile")
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "trace.json"
        prof.export_chrome_trace(str(path))
        r = analyze_trace.rollup(analyze_trace.load_events(path))
    r["output_ids"] = ran["output_ids"]
    busy_us = r["busy_us"]
    if busy_us <= 0:
        log(f"[{tag} {label}] the profiler recorded no device time: busy share not measured")
        return None, None, r
    per_step = busy_us / 1e3 / span["steps"]
    log(
        f"[{tag} {label}] bs 64, 128+128 run, decode windows {PROFILED_WINDOWS[0]} to "
        f"{PROFILED_WINDOWS[1] - 1} ({span['steps']} steps dispatched while tracing): device busy "
        f"{busy_us / 1e3:.1f} ms, {per_step:.3f} ms per step, against {step_ms:.3f} ms of wall "
        f"per step in the timed run: busy share {per_step / step_ms:.3f} (the profiled windows' "
        f"own wall {span['wall'] * 1e3:.1f} ms)"
    )
    return per_step, per_step / step_ms, r


def phase_engine_times(engine, eng: dict, label: str) -> None:
    """Decode tokens/s at the bench shape (bs 64, 128 + 128) with the
    engine's own overlap setting (on, the auto rule's choice on the card),
    over the decode span (first window dispatched to last window fetched),
    and the device's busy share of a decode step: the device time per step
    over decode windows ``PROFILED_WINDOWS`` of a profiled run (all 64 rows
    decoding; a trace of the whole run took ``key_averages`` about a minute
    per engine to digest) against the wall per step of the timed run. The
    profiler slows the host several times over, so the profiled windows'
    own wall is logged but not used."""
    from scratchpad_tpu_torch.tools import analyze_trace

    runner = engine.scheduler.runner
    with DecodeWindows(runner) as windows:
        # the warm-up run (it warms the caching allocator and cuBLAS) times
        # its extend forwards; the timed runs below carry no timer
        with PrefillTimer(runner.model) as prefill:
            bench_run(engine, windows, label)
        log(
            f"[prefill {label}] bs 64 x 128-token prompts: {prefill.forwards} extend forwards, "
            f"device {prefill.device_ms:.3f} ms, wall {prefill.wall_ms:.3f} ms"
        )
        r = bench_run(engine, windows, label)
        eng["decode_tok_s"], eng["e2e_tok_s"] = r["decode_tok_s"], r["e2e_tok_s"]
        log(
            f"[engine {label}] bs 64, 128+128, overlap {engine.scheduler.overlap_enabled()}: "
            f"decode {eng['decode_tok_s']:.1f} tok/s (first decode dispatch to last fetch, "
            f"{r['windows']} windows), {eng['e2e_tok_s']:.1f} tok/s end to end"
        )
        step_ms = 64 / eng["decode_tok_s"] * 1e3  # the timed run's wall per decode step
        per_step, share, rollup = profiled_run(engine, windows, label, step_ms)
    eng["device_ms_per_step"], eng["device_busy_share"] = per_step, share
    if per_step is None:
        return
    eng["trace_by_category_ms"] = {c: us / 1e3 for c, us in rollup["by_category"].items()}
    for line in analyze_trace.report(rollup, top=12):
        log(f"[profile {label}] {line}")


def phase_overlap(engine, label: str = "1b-bf16") -> dict:
    """The bench batch with overlap on and off, in turns (on, off), then one
    profiled run each, which must repeat its setting's tokens: decode
    tokens/s, device ms a step and the busy share of each, on one
    ``[overlap <label>]`` line. The equal-length greedy batch must give the
    same tokens both ways. A record, not a target: no speed is claimed."""
    import numpy as np

    sched = engine.scheduler
    saved = sched.args.enable_overlap
    rates = {True: [], False: []}
    ids = {}
    t0 = time.monotonic()
    try:
        with DecodeWindows(sched.runner) as windows:
            for on in (True, False):
                sched.args.enable_overlap = on
                r = bench_run(engine, windows, f"{label} overlap {on}")
                rates[on].append(r["decode_tok_s"])
                ids[on] = r["output_ids"]
            t_runs = time.monotonic() - t0
            prof = {}
            for on in (True, False):
                sched.args.enable_overlap = on
                step_ms = 64 / float(np.mean(rates[on])) * 1e3
                prof[on] = profiled_run(engine, windows, f"{label} overlap {on}", step_ms, "overlap")
                check(prof[on][2]["output_ids"] == ids[on], f"{label}: two runs with overlap {on} differ")
    finally:
        sched.args.enable_overlap = saved
    differ = sum(a != b for a, b in zip(ids[True], ids[False]))
    check(differ == 0, f"{label}: {differ} of 64 greedy rows differ between overlap on and off")

    def part(on):
        ms, share = prof[on][0], prof[on][1]
        return (
            f"overlap {'on' if on else 'off'}: decode {', '.join(f'{x:.1f}' for x in rates[on])} "
            f"tok/s, device {'not measured' if ms is None else f'{ms:.3f} ms'} a step, busy share "
            f"{'not measured' if share is None else f'{share:.3f}'}"
        )

    log(
        f"[overlap {label}] bs 64, 128+128, runs in turns on/off: {part(True)}; "
        f"{part(False)}; greedy tokens equal on {64 - differ} of 64 rows; "
        f"{t_runs:.1f} s timed runs, {time.monotonic() - t0 - t_runs:.1f} s profiled"
    )
    return dict(
        on=dict(decode_tok_s=rates[True], device_ms_per_step=prof[True][0], busy_share=prof[True][1]),
        off=dict(decode_tok_s=rates[False], device_ms_per_step=prof[False][0],
                 busy_share=prof[False][1]),
    )


class BoostByParam:
    """A custom logit processor (the torch contract of
    ``sampling/custom_logit_processor.py``): adds each row's
    ``custom_params["boost"]`` to one token's logit, in place, as the
    contract allows."""

    def __init__(self, token_id: int):
        self.token_id = token_id

    def __call__(self, logits, params):
        logits[:, self.token_id] += params["boost"]
        return logits


# the custom-processor phase's prompts and new tokens: rows 0 and 1 ban their
# own free ids, rows 2 and 3 take a boost of BOOST and of 0, rows 4 and 5
# none; the last two outlive the others, so their windows pipeline after
CUSTOM_REQUESTS = [(5, 16), (300, 16), (37, 16), (128, 16), (511, 48), (40, 48)]
BOOST = 1e4


def phase_custom(engine, label: str = "1b-bf16") -> dict:
    """Custom logit processors through ``Engine.generate``, overlap on: one
    greedy batch whose rows 0 to 3 take a ``BoostByParam`` of 0 (their free
    ids, in the windows the second run takes), then the same batch (cache
    flushed between) with a ``BannedTokensProcessor`` of each of rows 0 and
    1's own free ids, a ``BoostByParam`` shared by rows 2 and 3 (its per-row
    ``custom_params`` boost ``BOOST`` and 0) and none on rows 4 and 5.
    Every request finishes; no banned id appears; row 2 gives the boosted
    token only, rows 3 to 5 their free ids; windows were pipelined, and none
    of them carries a processor row. Then ``sample`` on the card's logits: a
    processor that bans one token in place on every row it is handed, on
    row 0 of three, leaves row 1's id and log-softmax equal to its run alone
    and the caller's logits unchanged (a per-row boost of 0 cannot show a
    write that leaks). One ``[custom]`` line."""
    import types

    import numpy as np
    import torch

    from scratchpad_tpu_torch.sampling.batch_info import SamplingBatchInfo
    from scratchpad_tpu_torch.sampling.custom_logit_processor import BannedTokensProcessor
    from scratchpad_tpu_torch.sampling.sampler import sample
    from scratchpad_tpu_torch.sampling.sampling_params import SamplingParams

    runner = engine.scheduler.runner
    V = runner.model_config.vocab_size
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, V, n).tolist() for n, _ in CUSTOM_REQUESTS]
    new = [m for _, m in CUSTOM_REQUESTS]
    boost_id = V // 3
    check(engine.scheduler.overlap_enabled(), f"{label}: overlap is off for the custom-processor phase")

    def run(procs):
        engine.flush_cache()
        return engine.generate(input_ids=prompts, sampling_params=[
            SamplingParams(temperature=0.0, max_new_tokens=m, ignore_eos=True, **kw)
            for m, kw in zip(new, procs)])

    t0 = time.monotonic()
    boost = BoostByParam(boost_id)
    # the free run keeps rows 0 to 3 on a processor that adds 0, so that both
    # runs take the same windows (a window's page-table width sets the decode
    # kernel's split, and so the last bits of every row's logits)
    free = run([dict(custom_logit_processor=boost, custom_params={"boost": 0.0})] * 4 + [{}, {}])
    procs = [dict(custom_logit_processor=BannedTokensProcessor(free[i].output_ids)) for i in (0, 1)]
    procs += [dict(custom_logit_processor=boost, custom_params={"boost": b}) for b in (BOOST, 0.0)]
    procs += [{}, {}]
    windows = []  # each pipelined window's processors (None: none)
    inner = runner.dispatch_decode_window

    def dispatch(wb, *a, **k):
        windows.append(wb.sampling_info.custom_processors)
        return inner(wb, *a, **k)

    runner.dispatch_decode_window = dispatch
    try:
        outs = run(procs)
    finally:
        runner.dispatch_decode_window = inner
    for o, m in zip(free + outs, new + new):
        check(o.completion_tokens == m and o.finish_reason == "length",
              f"{label} custom: request {o.rid}: {o.completion_tokens} tokens, finish {o.finish_reason}")
    ids = [o.output_ids for o in outs]
    banned = [len(set(ids[i]) & set(free[i].output_ids)) for i in (0, 1)]
    check(banned == [0, 0], f"{label} custom: banned ids appear: {banned}")
    check(ids[2] == [boost_id] * new[2], f"{label} custom: the boosted row gave {ids[2][:8]}")
    same = [ids[i] == free[i].output_ids for i in (3, 4, 5)]
    check(all(same), f"{label} custom: rows 3 to 5 differ from their free ids: {same}")
    carried = sum(w is not None for w in windows)
    check(windows and carried == 0,
          f"{label} custom: {len(windows)} pipelined windows, {carried} of them with processors")

    logits = torch.randn(3, V, generator=torch.Generator().manual_seed(7)).mul_(3).to(runner.device)
    before = logits.clone()
    free_id = int(logits[1].argmax())

    def ban_in_place(x, params):
        x[:, free_id] = -1e30
        return x

    reqs = [types.SimpleNamespace(sampling_params=SamplingParams(temperature=0.0, **kw), output_ids=[],
                                  origin_input_ids=[1])
            for kw in (dict(custom_logit_processor=ban_in_place), {})]
    pair, pair_lp = sample(logits, SamplingBatchInfo.from_reqs(reqs, 3, V).to(runner.device), None)
    solo, solo_lp = sample(logits[1:2].clone(), SamplingBatchInfo.from_reqs(reqs[1:], 1, V).to(runner.device), None)
    isolated = (pair.tolist()[1] == solo.tolist()[0] == free_id and pair.tolist()[0] != free_id
                and torch.equal(pair_lp[1], solo_lp[0]) and torch.equal(logits, before))
    check(isolated, f"{label} custom: an in-place processor reached another row: ids {pair.tolist()}, "
                    f"alone {solo.tolist()}, free id {free_id}")
    log(
        f"[custom] {label}: {len(prompts)} requests of {[len(p) for p in prompts]} tokens, overlap on: "
        f"banned ids in rows 0, 1: {banned}; boost {BOOST:g} row {ids[2][:4]}... (token {boost_id}); "
        f"rows 3 to 5 equal to their free ids: {same}; {len(windows)} pipelined windows, {carried} with "
        f"a processor row; an in-place processor kept to its row: {isolated}; "
        f"{time.monotonic() - t0:.1f} s"
    )
    return dict(banned=banned, rows_equal=same, pipelined_windows=len(windows),
                windows_with_processors=carried, in_place_isolated=isolated)


class IdTokenizer:
    """Token id i as the one character chr(0x10000 + i), so streamed text
    maps back to ids one for one (the random-weight engines have no
    tokenizer)."""

    eos_token_id = None
    chat_template = None

    def encode(self, text):
        return [ord(c) - 0x10000 for c in text]

    def decode(self, ids, **kw):
        return "".join(chr(0x10000 + i) for i in ids)


SERVE_SEQUENTIAL = (16, 100, 300, 700)  # prompt tokens of the sequential greedy requests
SERVE_CONCURRENT = [16, 24, 40, 64, 96, 128, 200, 256, 300, 400, 512, 600, 700, 800, 900, 1024]
# |score(prompt + [t1])[-1] - generate's logprob of t1|: the head's logits are
# bf16 (an ulp is 0.03 at the 1B's top logits, about 5), and the score's
# extend runs one token more; the planted off-by-one reads about 5
ECHO_TOL = 0.1


def _http(url: str, body=None, timeout: float = 120):
    """(status, JSON) of a request to the server under test."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        url, data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            status, raw = r.status, r.read()
    except urllib.error.HTTPError as e:
        status, raw = e.code, e.read()
    try:
        return status, json.loads(raw)
    except ValueError:
        return status, raw


def phase_serve(engine, label: str = "1b-bf16") -> dict:
    """The port's ``ServerApp`` on 127.0.0.1, driven through ``urllib``, on
    the engine of a finished phase with overlap at its default (on): health;
    sequential greedy completions whose ids must equal ``Engine.generate`` of
    each prompt alone (the cache flushed before each, so both prefill the
    whole prompt); 16 concurrent completions of mixed lengths; a streamed
    completion whose deltas join to the non-streamed ids; echo scoring of
    prompt + [t1] against generate's logprob of t1 (``ECHO_TOL``, and the
    neighbouring entry, a planted off-by-one, must fail it); embeddings of
    unit norm, bit-equal on a repeat; ``/metrics`` histograms that are not
    empty; the decode and extend kernels launched over the phase. Prints
    ``[serve]`` lines: requests, wall, the server's own TTFT and ITL p50 and
    p99 (as observed)."""
    import concurrent.futures
    import socket
    import urllib.request

    import numpy as np

    from scratchpad_tpu_torch.ops import KERNEL_WRAPPERS, reset_launch_counts
    from scratchpad_tpu_torch.sampling.sampling_params import SamplingParams
    from scratchpad_tpu_torch.server.http_server import ServerApp, ServerThread
    from scratchpad_tpu_torch.server.metrics import LatencyStats
    from scratchpad_tpu_torch.tokenizer.detokenizer import IncrementalDetokenizer

    check(engine.scheduler.overlap_enabled(), f"{label}: overlap did not resolve on for the card")
    V = engine.model_config.vocab_size
    rng = np.random.default_rng(7)
    seq = [rng.integers(1, V, n).tolist() for n in SERVE_SEQUENTIAL]
    conc = [rng.integers(1, V, n).tolist() for n in SERVE_CONCURRENT]
    sp = SamplingParams(temperature=0.0, max_new_tokens=32, ignore_eos=True)
    alone = []
    for p in seq:
        engine.flush_cache()
        alone.append(engine.generate(input_ids=p, sampling_params=sp, return_logprob=True))
    saved = (engine.tokenizer, engine.detokenizer, engine.args.stream_interval)
    engine.tokenizer = IdTokenizer()
    engine.detokenizer = IncrementalDetokenizer(engine.tokenizer)
    # streams take windows as wide as the rest: the same windows, the same
    # page-table widths, the same decode splits, so the same bits
    engine.args.stream_interval = engine.args.decode_window_size
    engine.latency = LatencyStats()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        engine.args.host, engine.args.port = "127.0.0.1", s.getsockname()[1]
    url = f"http://127.0.0.1:{engine.args.port}"
    reset_launch_counts()
    t0 = time.perf_counter()
    srv = ServerThread(ServerApp(engine, engine.args))
    n_req = 0
    try:
        status, body = _http(url + "/health")
        check(status == 200 and body == {"status": "ok"}, f"{label}: /health answered {status} {body}")
        n_req += 1
        for p, ref in zip(seq, alone):
            check(_http(url + "/flush_cache", {})[0] == 200, f"{label}: /flush_cache refused")
            status, body = _http(url + "/v1/completions", dict(
                model="m", prompt=p, max_tokens=32, temperature=0.0, ignore_eos=True, logprobs=1))
            n_req += 2
            ids = [int(t) for t in body["choices"][0]["logprobs"]["tokens"]] if status == 200 else []
            check(ids == ref.output_ids, f"{label}: the served ids of a {len(p)}-token prompt "
                  f"differ from Engine.generate's: {ids[:8]} against {ref.output_ids[:8]}")
        t_conc = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(len(conc)) as ex:
            answers = list(ex.map(lambda p: _http(url + "/v1/completions", dict(
                model="m", prompt=p, max_tokens=64, temperature=0.0, ignore_eos=True)), conc))
        t_conc = time.perf_counter() - t_conc
        n_req += len(conc)
        for p, (status, body) in zip(conc, answers):
            check(status == 200 and body["usage"]["completion_tokens"] == 64,
                  f"{label}: a concurrent {len(p)}-token request answered {status}")
        # a streamed completion against the same request unstreamed
        body = dict(model="m", prompt=seq[1], max_tokens=32, temperature=0.0, ignore_eos=True)
        _http(url + "/flush_cache", {})
        status, full = _http(url + "/v1/completions", body)
        _http(url + "/flush_cache", {})
        req = urllib.request.Request(url + "/v1/completions",
                                     data=json.dumps(dict(body, stream=True)).encode())
        text, done = "", False
        with urllib.request.urlopen(req, timeout=120) as r:
            for line in r:
                line = line.decode().strip()
                if line == "data: [DONE]":
                    done = True
                elif line.startswith("data: "):
                    text += json.loads(line[6:])["choices"][0]["text"]
        n_req += 4
        streamed = IdTokenizer().encode(text)
        check(done and streamed == IdTokenizer().encode(full["choices"][0]["text"]) == alone[1].output_ids,
              f"{label}: streamed ids {streamed[:8]} differ from the unstreamed answer's")
        # echo scoring: score(prompt + [t1])'s last entry against generate's
        # logprob of t1; the entry before it (a planted off-by-one) must fail
        reads, planted = [], []
        for p, ref in zip(seq, alone):
            status, body = _http(url + "/v1/completions", dict(
                model="m", prompt=p + [ref.output_ids[0]], max_tokens=1, temperature=0.0,
                ignore_eos=True, echo=True, logprobs=1))
            n_req += 1
            lps = body["choices"][0]["logprobs"]["token_logprobs"] if status == 200 else [None] * 3
            want = ref.output_token_logprobs[0]
            reads.append(abs(lps[len(p)] - want))
            planted.append(abs(lps[len(p) - 1] - want))
        check(max(reads) <= ECHO_TOL, f"{label}: echo scores differ from generate's logprob by "
              f"{max(reads):.4f} > {ECHO_TOL}")
        check(min(planted) > ECHO_TOL, f"{label}: the planted off-by-one reads {min(planted):.4f}, "
              f"inside the {ECHO_TOL} tolerance: the echo check cannot see it")
        log(f"[serve {label}] echo: |score - generate logprob| {[f'{x:.4f}' for x in reads]} "
            f"(tol {ECHO_TOL}); planted off-by-one {[f'{x:.3f}' for x in planted]}")
        embs = []
        for _ in range(2):
            _http(url + "/flush_cache", {})
            status, body = _http(url + "/v1/embeddings", dict(model="m", input=seq[2]))
            n_req += 2
            embs.append(body["data"][0]["embedding"] if status == 200 else [])
        norm = float(np.linalg.norm(embs[0])) if embs[0] else 0.0
        check(abs(norm - 1.0) < 1e-3 and embs[0] == embs[1],
              f"{label}: embeddings of norm {norm:.6f}, equal on a repeat: {embs[0] == embs[1]}")
        # the server's own latency samples, read before /metrics drains them
        stats = engine.latency
        ttft = np.asarray(stats.ttft) * 1e3
        itl = np.repeat([g for g, _ in stats.itl], [n for _, n in stats.itl]) * 1e3
        status, metrics = _http(url + "/metrics")
        n_req += 1
        counts = {}
        for line in (metrics.decode() if isinstance(metrics, bytes) else "").splitlines():
            if "_seconds_count " in line and not line.startswith("#"):
                name, value = line.rsplit(" ", 1)
                counts[name.split(":")[1]] = float(value)
        for h in ("time_to_first_token_seconds_count", "inter_token_latency_seconds_count",
                  "e2e_request_latency_seconds_count"):
            check(counts.get(h, 0) > 0, f"{label}: /metrics {h} is {counts.get(h)}")
    finally:
        srv.stop()
        engine.tokenizer, engine.detokenizer, engine.args.stream_interval = saved
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}
    for k in ("paged_decode_attention", "paged_extend_attention"):
        check(launches[k] > 0, f"{label}: {k} launched {launches[k]} times while serving")

    def pct(x, q):
        return f"{np.percentile(x, q):.3f}" if len(x) else "none"

    log(
        f"[serve {label}] {n_req} HTTP requests in {wall:.3f} s (server up to down); "
        f"{len(conc)} concurrent completions ({min(SERVE_CONCURRENT)} to {max(SERVE_CONCURRENT)} "
        f"prompt tokens, 64 new) in {t_conc:.3f} s; kernel launches decode "
        f"{launches['paged_decode_attention']}, extend {launches['paged_extend_attention']}"
    )
    log(
        f"[serve {label}] the server's own samples: TTFT p50 {pct(ttft, 50)} ms, p99 "
        f"{pct(ttft, 99)} ms ({len(ttft)} requests); ITL p50 {pct(itl, 50)} ms, p99 "
        f"{pct(itl, 99)} ms ({len(itl)} tokens, a window's gap spread over its tokens)"
    )
    return dict(requests=n_req, wall_s=wall, launches=launches,
                ttft_ms_p50_p99=[float(np.percentile(ttft, q)) for q in (50, 99)] if len(ttft) else None,
                itl_ms_p50_p99=[float(np.percentile(itl, q)) for q in (50, 99)] if len(itl) else None)


# the grammar phase's grammars. Every grammar's language is finite, or the
# request's logit bias (keys: character token ids) steers the greedy pick to
# a short word of it, so that each output ends inside max new tokens at a
# state where the grammar allows only eos
GRAMMAR_SCHEMA = {"type": "object", "properties": {
    "name": {"type": "string", "maxLength": 6}, "ok": {"type": "boolean"},
    "tag": {"enum": ["red", "green"]}}, "required": ["name", "ok", "tag"]}
# the schema's longest word: twelve places of up to 8 blanks (json_schema.WS)
# beside at most 44 other characters
GRAMMAR_SCHEMA_TOKENS = 160
GRAMMAR_EBNF = 'root ::= cmd " " arg\ncmd ::= "GET" | "PUT" | "DEL"\narg ::= [a-z] [a-z]? [0-9]'
GRAMMAR_PDA = 'root ::= "(" root ")" | "x"'
# the literal-heavy grammar: all but one choice and eos are forced tokens
GRAMMAR_LITERAL = r"The answer is (yes|no)\. Done!"
GRAMMAR_TAG = {"structures": [{"begin": "<", "schema": {"enum": ["a", "b"]}, "end": ">"}],
               "triggers": ["<"]}


def _schema_ok(text: str) -> bool:
    try:
        v = json.loads(text)
    except ValueError:
        return False
    return (isinstance(v, dict) and set(v) == {"name", "ok", "tag"} and isinstance(v["name"], str)
            and len(v["name"]) <= 6 and isinstance(v["ok"], bool) and v["tag"] in ("red", "green"))


def _tag_ok(text: str) -> bool:
    """Free text in which every trigger opens a whole structure: < "a" or
    "b" >."""
    import re

    return all(m is not None for m in
               (re.match(r'<"[ab]">', text[i:]) for i, c in enumerate(text) if c == "<"))


def phase_grammar(engine, label: str = "1b-bf16") -> dict:
    """Constrained decoding on an engine built with ``tokenizer_path="chars"``,
    which loads the port's character tokenizer (``tokenizer/chars.py``: id =
    ord(char) + 1, eos 0, every other id decodes to nothing) and with it the
    grammar backend and its native walks: greedy requests under a regex, a
    JSON schema, an EBNF grammar (DFA), a recursive EBNF grammar (pushdown)
    and a structural tag through
    ``Engine.generate`` in one batch beside a free request, then through the
    HTTP server's chat ``response_format`` (``json_schema``,
    ``json_object``, ``structural_tag``) and completions' ``regex``,
    ``ebnf`` and ``json_schema``. Every output must match or parse; the
    literal-heavy regex must append its forced tokens without model steps
    (fewer forwards than tokens); only the native ``fsm`` and ``pda``
    libraries, built from ``csrc/`` into ``csrc/build/``, may have walked a
    state's mask."""
    import re
    import socket

    from scratchpad_tpu_torch.constrained.backend import WALKS
    from scratchpad_tpu_torch.sampling.sampling_params import SamplingParams
    from scratchpad_tpu_torch.server.http_server import ServerApp, ServerThread
    from scratchpad_tpu_torch.tokenizer.chars import CharTokenizer
    from scratchpad_tpu_torch.utils import native

    tok = engine.tokenizer
    check(isinstance(tok, CharTokenizer) and engine.grammar_backend is not None and engine.grammar_backend.native
          and engine.eos_token_ids == {tok.eos_token_id},
          f"{label}: the engine did not load the character tokenizer and the native grammar backend "
          f"({type(tok).__name__}, {engine.grammar_backend}, eos {sorted(engine.eos_token_ids)})")
    t0 = time.perf_counter()
    WALKS.clear()
    bias_pda = {tok.encode("x")[0]: 100.0}
    bias_tag = {tok.encode("<")[0]: 100.0}
    requests = [
        ("regex", dict(regex=r"(yes|no)!"), 8, lambda t: re.fullmatch(r"(yes|no)!", t) is not None),
        ("json_schema", dict(json_schema=json.dumps(GRAMMAR_SCHEMA)), GRAMMAR_SCHEMA_TOKENS, _schema_ok),
        ("ebnf", dict(ebnf=GRAMMAR_EBNF), 16, lambda t: re.fullmatch(r"(GET|PUT|DEL) [a-z]{1,3}[0-9]", t)
         is not None),
        ("ebnf (pushdown)", dict(ebnf=GRAMMAR_PDA, logit_bias=bias_pda), 16, lambda t: t == "x"),
        ("structural_tag", dict(structural_tag=json.dumps(GRAMMAR_TAG), logit_bias=bias_tag), 40, _tag_ok),
        ("literal regex", dict(regex=GRAMMAR_LITERAL), 48,
         lambda t: re.fullmatch(GRAMMAR_LITERAL, t) is not None),
    ]
    prompt = tok.encode("Q: answer in the format asked. A: ")
    sps = [SamplingParams(temperature=0.0, max_new_tokens=n, **kw) for _, kw, n, _ in requests]
    free = SamplingParams(temperature=0.0, max_new_tokens=24, ignore_eos=True)
    engine.flush_cache()
    outs = engine.generate(input_ids=[prompt] * (len(requests) + 1), sampling_params=sps + [free])
    for (what, _, _, ok), out in zip(requests, outs):
        # the structural tag's free text may run to the length limit: its
        # 5-token structures fill max new tokens exactly
        good = ok(out.text) and (out.finish_reason == "stop" or what == "structural_tag")
        log(f"[grammar {label}] generate {what}: {out.text!r} ({len(out.output_ids)} tokens, "
            f"{out.finish_reason}); valid: {good}")
        check(good, f"{label}: the {what} grammar's output {out.text!r} ({out.finish_reason}) is not valid")
    check(len(outs[-1].output_ids) == 24, f"{label}: the free request beside the grammars gave "
          f"{len(outs[-1].output_ids)} tokens")
    # the literal-heavy grammar alone: its forced tokens come without forwards
    forwards = [0]
    hook = engine.scheduler.runner.model.register_forward_hook(lambda *a: forwards.__setitem__(0, forwards[0] + 1))
    try:
        engine.flush_cache()
        out = engine.generate(input_ids=prompt, sampling_params=sps[-1])
    finally:
        hook.remove()
    good = re.fullmatch(GRAMMAR_LITERAL, out.text) is not None
    log(f"[grammar {label}] literal regex alone: {out.text!r}, {len(out.output_ids)} tokens in "
        f"{forwards[0]} forwards")
    check(good and forwards[0] < len(out.output_ids) // 2,
          f"{label}: the literal-heavy grammar took {forwards[0]} forwards for {len(out.output_ids)} "
          f"tokens (jump-forward appends forced tokens without model steps)")
    # the same grammars over HTTP
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        engine.args.host, engine.args.port = "127.0.0.1", sk.getsockname()[1]
    url = f"http://127.0.0.1:{engine.args.port}"
    srv = ServerThread(ServerApp(engine, engine.args))
    n_http = 0
    try:
        chats = [
            ("response_format json_schema", dict(response_format={
                "type": "json_schema", "json_schema": {"name": "s", "schema": GRAMMAR_SCHEMA}}), _schema_ok),
            ("response_format json_object", dict(
                response_format={"type": "json_object"},
                logit_bias={str(tok.encode(c)[0]): b for c, b in (("{", 40.0), ("}", 30.0))}
                | {str(tok.eos_token_id): 50.0}),
             lambda t: json.loads(t) == {}),
            ("response_format structural_tag", dict(
                response_format={"type": "structural_tag", **GRAMMAR_TAG},
                logit_bias={str(k): v for k, v in bias_tag.items()}, max_tokens=40), _tag_ok),
        ]
        for what, extra, ok in chats:
            body = dict(model="m", messages=[{"role": "user", "content": "answer in the format asked"}],
                        max_tokens=GRAMMAR_SCHEMA_TOKENS, temperature=0.0) | extra
            status, resp = _http(url + "/v1/chat/completions", body)
            n_http += 1
            text = resp["choices"][0]["message"]["content"] if status == 200 else None
            good = status == 200 and text is not None and ok(text)
            log(f"[grammar {label}] chat {what}: status {status}, {text!r}; valid: {good}")
            check(good, f"{label}: chat {what} answered {status} {str(resp)[:200]}")
        comps = [
            ("regex", dict(regex=r"(yes|no)!"), lambda t: re.fullmatch(r"(yes|no)!", t) is not None),
            ("ebnf", dict(ebnf=GRAMMAR_EBNF), lambda t: re.fullmatch(r"(GET|PUT|DEL) [a-z]{1,3}[0-9]", t)
             is not None),
            ("json_schema", dict(json_schema=json.dumps(GRAMMAR_SCHEMA)), _schema_ok),
        ]
        for what, extra, ok in comps:
            status, resp = _http(url + "/v1/completions", dict(
                model="m", prompt="Q: answer in the format asked. A: ", max_tokens=GRAMMAR_SCHEMA_TOKENS,
                temperature=0.0) | extra)
            n_http += 1
            text = resp["choices"][0]["text"] if status == 200 else None
            good = status == 200 and text is not None and ok(text)
            log(f"[grammar {label}] completion {what}: status {status}, {text!r}; valid: {good}")
            check(good, f"{label}: completion {what} answered {status} {str(resp)[:200]}")
    finally:
        srv.stop()
    walks = dict(WALKS)
    libs = {name: native.host_lib_path(name) for name in native.HOST_SOURCES}
    log(f"[grammar {label}] state masks walked: {walks}; libraries "
        f"{ {n: p.name for n, p in libs.items()} }; {time.perf_counter() - t0:.1f} s")
    check(walks.get("fsm native", 0) > 0 and walks.get("pda native", 0) > 0
          and not walks.get("fsm python") and not walks.get("pda python")
          and all(p.exists() for p in libs.values()),
          f"{label}: the grammar masks were not all walked by the native fsm and pda libraries: {walks}")
    return dict(walks=walks, http_requests=n_http, seconds=time.perf_counter() - t0)


# ------------------------------------------------------------------ main


# ------------------------------------------------ speculative decoding


SPEC_K = 4  # speculative_num_draft_tokens, the default
# the spec engines' requests (prompt, new tokens): two prompts that repeat a
# 16-token base (ngram drafts find it), two random ones, one across a page
SPEC_REQUESTS = [("rep 64", 48), ("rep 160", 48), (300, 48), (1000, 32)]
# the W4A8 engine's: its random ids rarely repeat, and an ngram proposal
# is tried only between decode windows, so it serves with windows of one
# token (SPEC_W4A8_WINDOW) and long random prompts, which hold more of the
# ids it emits
SPEC_W4A8_REQUESTS = [(6000, 48), (6000, 48), ("rep 160", 48)]
SPEC_W4A8_WINDOW = 1
# the W4A8 ngram engine's depth (Llama-3.1-8B, int8 KV)
SPEC_W4A8_LAYERS = 4
# the 8B targets of the draft-model and EAGLE engines, cut in depth to pay
# for phase_tp's seconds (full depth, 32 layers, until then)
SPEC_8B_LAYERS = 8


def spec_prompts(V: int, requests, seed: int = 7) -> list:
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for n, _ in requests:
        if isinstance(n, str):  # "rep N": a 16-token base repeated to N tokens
            m = int(n.split()[1])
            out.append((rng.integers(1, V, 16).tolist() * (m // 16 + 1))[:m])
        else:
            out.append(rng.integers(1, V, n).tolist())
    return out


def teacher_forced(runner, tokens: list) -> dict:
    """Each position's argmax, top logit and top-2 gap and the row's max
    |logit| (numpy [T]), from ONE extend forward of ``tokens`` through the
    engine's own kernels, the head 128 rows at a time, on pages borrowed
    from the idle pool."""
    import numpy as np
    import torch

    from scratchpad_tpu_torch.executor.forward_meta import ForwardMode
    from scratchpad_tpu_torch.executor.model_runner import WorkerBatch
    from scratchpad_tpu_torch.sampling.batch_info import SamplingBatchInfo

    ps, n = runner.page_size, len(tokens)
    pages = runner.page_allocator.alloc(-(-n // ps))
    if pages is None:
        fail("no free pages for the teacher-forced pass")
    try:
        pos = np.arange(n)
        wb = WorkerBatch(
            mode=ForwardMode.EXTEND, tokens=np.asarray(tokens), positions=pos,
            out_cache_loc=pages[pos // ps] * ps + pos % ps, req_indices=np.zeros(n, np.int64),
            page_table=pages[None], seq_lens=np.array([n]), extend_lens=np.array([n]),
            sampling_info=SamplingBatchInfo.from_reqs([], 1, runner.model_config.vocab_size),
        )
        out = {k: [] for k in ("argmax", "top1", "gap", "scale")}
        with torch.inference_mode():
            _, _, _, h = runner._hidden(wb)
            for c in range(0, n, 128):
                logits = runner.model.head_logits(h[c : c + 128])
                top2 = torch.topk(logits, 2)
                out["argmax"].append(top2.indices[:, 0])
                out["top1"].append(top2.values[:, 0])
                out["gap"].append(top2.values[:, 0] - top2.values[:, 1])
                out["scale"].append(logits.abs().max(dim=-1).values)
        return {k: torch.cat(v).cpu().numpy() for k, v in out.items()}
    finally:
        runner.page_allocator.free(pages)


def chain_flips(runner, label: str, prompts, outs, floor: float):
    """Teacher-force each prompt plus its output (``teacher_forced``) and
    log each token that is not the argmax there; returns the passes and
    (ties, flips outside a tie, the widest top-2 gap over max |logit| at
    such a token, the share of output positions whose top-2 gap lies
    within the tie rule, where a wrong token would be excused)."""
    ties = flips = under = n = 0
    widest = 0.0
    forced = []
    for i, (p, o) in enumerate(zip(prompts, outs)):
        tf = teacher_forced(runner, p + o.output_ids)
        forced.append(tf)
        for j, tok in enumerate(o.output_ids):
            row = len(p) - 1 + j
            under += bf16_tie(tf, row, floor)
            n += 1
            if int(tf["argmax"][row]) != tok:
                tie = bf16_tie(tf, row, floor)
                rel = float(tf["gap"][row] / tf["scale"][row])
                ties += tie
                flips += not tie
                widest = max(widest, rel)
                log(f"[spec {label}] request {i} token {j}: {tok} against the teacher-forced argmax "
                    f"{int(tf['argmax'][row])}, top-2 gap {float(tf['gap'][row]):.4g} ({rel:.3e} of "
                    f"max|logit|; tie {tie})")
    return forced, (ties, flips, widest, under / max(n, 1))


def bf16_tie(tf: dict, row: int, floor: float) -> bool:
    """``phase_engine``'s rule: a top-2 gap of at most one bf16 ulp of the
    top logit, or ``floor`` of max |logit| (the W4A8 and 8-bit engines')."""
    top1, gap, scale = (float(tf[k][row]) for k in ("top1", "gap", "scale"))
    return gap <= max(math.ldexp(1.0, math.frexp(abs(top1))[1] - 8), floor * scale)


class SpecSpy:
    """Counts a spec engine's verify forwards (greedy and sampled), the
    drafts they check and the attention launches they make; the proposal
    windows (the draft model's or the EAGLE head's) and theirs; and the
    greedy verifications' rejections: (request, position of the corrected
    token, target token, draft token)."""

    def __init__(self, engine):
        from scratchpad_tpu_torch.ops import KERNEL_WRAPPERS

        self.launch = lambda: collections.Counter({fn.__name__: fn.launches for fn in KERNEL_WRAPPERS})
        sched = engine.scheduler
        self.verifies = self.drafts = self.windows = self.window_steps = 0
        self.verify_launches = collections.Counter()
        self.window_launches = collections.Counter()
        self.rejections = []
        self.request = None  # the request running alone, where rejections are mapped
        self.patched = []
        runner = sched.runner
        self._wrap(runner, "run_spec_verify", self._verify)
        self._wrap(runner, "run_spec_verify_sampled", self._verify)
        if sched.draft_runner is not None:
            self._wrap(sched.draft_runner, "run_decode_window", self._window)
        if sched.eagle is not None:
            self._wrap(sched.eagle, "propose", self._window)

    def _wrap(self, obj, name, spy):
        inner = getattr(obj, name)
        self.patched.append((obj, name))
        setattr(obj, name, lambda *a, **kw: spy(inner, *a, **kw))

    def _verify(self, inner, wb, *a, **kw):
        before = self.launch()
        out = inner(wb, *a, **kw)
        self.verify_launches += self.launch() - before
        self.verifies += 1
        self.drafts += len(wb.tokens) - len(wb.seq_lens)
        if inner.__name__ == "run_spec_verify":
            ids, s = out[0], 0
            for n in wb.extend_lens:
                d, got = wb.tokens[s + 1 : s + n], ids[s : s + n]
                miss = [j for j in range(len(d)) if got[j] != d[j]]
                if miss:
                    j = miss[0]
                    self.rejections.append((self.request, int(wb.positions[s]) + j + 1, int(got[j]), int(d[j])))
                s += n
        return out

    def _window(self, inner, *a, **kw):
        k = a[-1]
        before = self.launch()
        out = inner(*a, **kw)
        self.window_launches += self.launch() - before
        self.windows += 1
        self.window_steps += k
        return out

    def restore(self):
        for obj, name in self.patched:
            delattr(obj, name)


def phase_spec(engine, label: str, requests=SPEC_REQUESTS, draft_layers: int = 0,
               self_draft: bool = False, sampled: bool = False) -> dict:
    """Serve ``requests`` through ``Engine.generate`` on a spec engine, every
    launch count set to 0 just before and read just after: each verify
    forward must launch the pool's extend kernel once a layer, each draft
    window the decode kernel once a draft layer and step (the EAGLE head's:
    once a step). Every token must be the target's own greedy choice: prompt
    plus output teacher-forced through ONE extend of the same engine, each
    position's argmax against the emitted token, a difference excused only
    as a bf16 tie (``bf16_tie`` with the engine's ``ARGMAX_FLOOR``), counted.
    ``self_draft`` (the target drafting for itself): requests one at a time,
    and every rejected draft must sit at such a tie. ``sampled``: the same
    requests at temperature 1 and top-k 1 must give the greedy tokens up to
    a tie."""
    from scratchpad_tpu_torch.ops import reset_launch_counts
    from scratchpad_tpu_torch.sampling.sampling_params import SamplingParams

    sched = engine.scheduler
    runner = sched.runner
    L = runner.model_config.num_hidden_layers
    floor = ARGMAX_FLOOR[label]
    prompts = spec_prompts(runner.model_config.vocab_size, requests)
    sps = [SamplingParams(temperature=0.0, max_new_tokens=m, ignore_eos=True) for _, m in requests]
    plain_sps = [SamplingParams(temperature=0.0, max_new_tokens=m, min_new_tokens=m, ignore_eos=True)
                 for _, m in requests]
    engine.flush_cache()
    s0, a0 = sched.num_spec_steps, sched.num_spec_accepted
    spy = SpecSpy(engine)
    reset_launch_counts()
    t = time.monotonic()
    if self_draft:
        outs = []
        for i, (p, sp) in enumerate(zip(prompts, sps)):
            spy.request = i
            outs.append(engine.generate(input_ids=p, sampling_params=sp))
    else:
        outs = engine.generate(input_ids=prompts, sampling_params=sps)
    wall = time.monotonic() - t
    counts = spy.launch()
    spy.restore()
    steps, accepted = sched.num_spec_steps - s0, sched.num_spec_accepted - a0
    pages = runner.kv_cache_dtype if runner.kv_cache.quantized else "bf16"
    ext = EXTEND[pages]
    for o, (_, m) in zip(outs, requests):
        check(len(o.output_ids) == m, f"{label} request {o.rid}: {len(o.output_ids)} tokens, not {m}")
    check(steps > 0 and spy.verifies > 0, f"{label}: no speculative step ({steps} steps)")
    check(spy.verify_launches[ext] == L * spy.verifies > 0,
          f"{label}: {spy.verify_launches[ext]} {ext} launches in {spy.verifies} verify forwards of {L} layers")
    if draft_layers:
        got = spy.window_launches["paged_decode_attention"]
        check(got == draft_layers * spy.window_steps > 0,
              f"{label}: {got} draft decode launches in {spy.window_steps} steps of {draft_layers} layers")
    rate = accepted / max(spy.drafts, 1)
    log(
        f"[spec {label}] {len(outs)} requests in {wall:.2f} s: {steps} verify steps in {spy.verifies} "
        f"forwards, {accepted} of {spy.drafts} drafts accepted (rate {rate:.3f}); {ext} launches in "
        f"verification {spy.verify_launches[ext]}; proposal windows {spy.windows} ({spy.window_steps} "
        f"steps, decode launches {spy.window_launches['paged_decode_attention']}); all launches {dict(counts)}"
    )
    # the target's own greedy chain, teacher-forced; then the control: the
    # same requests on plain decode (min_new_tokens keeps a request off the
    # speculative path), teacher-forced alike
    engine.flush_cache()  # the passes borrow pages from the idle pool
    forced, (ties, flips, widest, under) = chain_flips(runner, label, prompts, outs, floor)
    check(flips == 0, f"{label}: {flips} tokens leave the target's greedy chain outside a bf16 tie")
    s1 = sched.num_spec_steps
    plain = engine.generate(input_ids=prompts, sampling_params=plain_sps)
    check(sched.num_spec_steps == s1, f"{label}: the control speculated")
    engine.flush_cache()
    _, control = chain_flips(runner, label + " control", prompts, plain, floor)
    log(f"[spec {label}] teacher-forced: {ties} tokens at a bf16 tie, {flips} outside one, the widest "
        f"difference at a top-2 gap of {widest:.3e} of max|logit|, {under:.3f} of the output positions "
        f"within the tie rule; the control (plain decode): {control[0]} at a tie, {control[1]} outside "
        f"one (widest {control[2]:.3e}), {control[3]:.3f} of its positions within the rule")
    check(ties <= control[0] + SPEC_TIE_SLACK,
          f"{label}: {ties} tokens excused as ties against the plain-decode control's {control[0]} "
          f"(slack {SPEC_TIE_SLACK})")
    result = dict(label=label, steps=steps, accepted=accepted, drafts=spy.drafts, rate=rate,
                  verifies=spy.verifies, verify_launches=spy.verify_launches[ext], kernel=ext,
                  windows=spy.windows, window_steps=spy.window_steps, ties=ties, widest_gap=widest,
                  under_share=under, control_ties=control[0], control_flips=control[0] + control[1],
                  control_widest_gap=control[2], control_under_share=control[3], wall_s=wall)
    if self_draft:
        rejected_ties = sum(
            bf16_tie(forced[i], pos - 1, floor) for i, pos, _, _ in spy.rejections
        )
        check(rejected_ties == len(spy.rejections),
              f"{label}: {len(spy.rejections) - rejected_ties} drafts rejected outside a bf16 tie "
              f"({spy.rejections})")
        log(f"[spec {label}] the target drafting for itself: {len(spy.rejections)} rejections, "
            f"{rejected_ties} of them at a bf16 tie")
        result["rejections"] = len(spy.rejections)
    if sampled:
        k1 = [SamplingParams(temperature=1.0, top_k=1, max_new_tokens=m, ignore_eos=True) for _, m in requests]
        outs_k1 = engine.generate(input_ids=prompts, sampling_params=k1)
        k1_ties = 0
        for i, (p, a, b) in enumerate(zip(prompts, outs, outs_k1)):
            j = next((j for j, (x, y) in enumerate(zip(a.output_ids, b.output_ids)) if x != y), None)
            if j is not None:  # the chains part at a tie, then go their own ways
                tie = bf16_tie(forced[i], len(p) - 1 + j, floor)
                k1_ties += tie
                check(tie, f"{label}: temperature 1, top-k 1 leaves the greedy tokens at request {i} "
                           f"token {j} outside a bf16 tie")
        log(f"[spec {label}] temperature 1, top-k 1 (sampled verification): the greedy tokens, "
            f"{k1_ties} requests parting at a bf16 tie")
        result["sampled_ties"] = k1_ties
    return result


def phase_specs(p1b) -> dict:
    """The spec engines, all bf16 but the last: the 1B on ngram drafts and
    drafting for itself, Llama-3.1-8B at full width and ``SPEC_8B_LAYERS``
    layers drafted by the 1B and by a seeded EAGLE head (the same 8B
    weights), and the 8B W4A8 on int8 KV at
    ``SPEC_W4A8_LAYERS`` layers on ngram drafts (rows 3q and 4). The target
    and the draft pools share the card: the split is logged and each pool
    checked."""
    import torch

    from scratchpad_tpu_torch.config.model_config import get_preset

    out = {}
    engine = make_engine(params=p1b, speculative_algorithm="ngram")
    out["1b-ngram"] = phase_spec(engine, "1b-ngram", sampled=True)
    del engine
    engine = make_engine(params=p1b, speculative_algorithm="draft", speculative_draft_preset="llama-3.2-1b")
    engine.scheduler.draft_runner.model.load_state_dict(p1b)
    out["1b-draft-self"] = phase_spec(engine, "1b-draft-self", draft_layers=16, self_draft=True)
    del engine
    target_cfg = get_preset("llama-3.1-8b", num_hidden_layers=SPEC_8B_LAYERS)
    engine = make_engine(model_config=target_cfg, speculative_algorithm="draft",
                         speculative_draft_preset="llama-3.2-1b")
    target, drafter = engine.scheduler.runner, engine.scheduler.draft_runner
    free, total = torch.cuda.mem_get_info()
    log(
        f"[spec 8b-draft-1b] pools: target {target.max_total_num_tokens} tokens x "
        f"{target.kv_bytes_per_token()} B, draft {drafter.max_total_num_tokens} tokens x "
        f"{drafter.kv_bytes_per_token()} B beside {drafter.param_bytes / 2**30:.2f} GiB of draft "
        f"parameters; {free / 2**30:.1f} of {total / 2**30:.1f} GiB free"
    )
    check(drafter.page_allocator.num_pages == target.page_allocator.num_pages,
          "the draft pool does not mirror the target's pages")
    out["8b-draft-1b"] = phase_spec(engine, "8b-draft-1b", draft_layers=16)
    p8b = engine.scheduler.runner.model.state_dict()
    del engine, target, drafter
    engine = make_engine(model_config=target_cfg, params=p8b, speculative_algorithm="eagle")
    del p8b
    out["8b-eagle"] = phase_spec(engine, "8b-eagle", draft_layers=1)
    del engine
    engine = make_engine("w4a8", kv_cache_dtype="int8", speculative_algorithm="ngram",
                         decode_window_size=SPEC_W4A8_WINDOW,
                         model_config=get_preset("llama-3.1-8b", num_hidden_layers=SPEC_W4A8_LAYERS))
    out["8b-w4a8-ngram"] = phase_spec(engine, "8b-w4a8-ngram", requests=SPEC_W4A8_REQUESTS)
    del engine
    return out


# ------------------------------------------------------------ memory extras


MEM_KV_TOKENS = 8192  # small pools, so that four 3,000-token prompts evict
# the memory engines' depth: the 1B's first 4 of its 16 layers, cut to pay
# for phase_tp's seconds (the whole 1B until then)
MEM_LAYERS = 4
MEM_HOST_TOKENS = 32768
MEM_PROMPT = 3000


def pool_bytes(runner, pages) -> list:
    """The bytes of ``pages`` of every pool tensor (K, V, scales)."""
    import torch

    idx = torch.as_tensor(pages, dtype=torch.long, device=runner.device)
    return [t.index_select(1, idx).contiguous().view(torch.uint8) for t in runner._pool_tensors()]


def phase_memory(p1b) -> dict:
    """The memory extras on Llama-3.2-1B's first ``MEM_LAYERS`` layers (the
    bf16 engine's weights): on bf16 and on int8 pools, pages
    gathered to the host and scattered back to other page ids come back bit
    for bit, and a prompt served, evicted to the host tier and promoted
    back gives the tokens of a radix hit on the device (the same pages);
    on bf16, a resize down and
    up still serves the same tokens, and ``update_weights`` to another
    seed's weights and back gives bit-equal logits; parameter offload (two
    groups) gives the resident engine's logits bit for bit, with both step
    times."""
    import numpy as np
    import torch

    from scratchpad_tpu_torch.models.llama import LlamaForCausalLM
    from scratchpad_tpu_torch.sampling.sampling_params import SamplingParams

    from scratchpad_tpu_torch.config.model_config import get_preset

    out = {}
    rng = np.random.default_rng(11)
    sp = SamplingParams(temperature=0.0, max_new_tokens=16, ignore_eos=True)
    first = None
    cfg = get_preset("llama-3.2-1b", num_hidden_layers=MEM_LAYERS)
    p1b = {k: t for k, t in p1b.items() if not k.startswith("layers.") or int(k.split(".")[1]) < MEM_LAYERS}
    for kv in ("bfloat16", "int8"):
        engine = make_engine(params=p1b, kv_cache_dtype=kv, max_total_tokens=MEM_KV_TOKENS,
                             host_kv_cache_tokens=MEM_HOST_TOKENS, model_config=cfg)
        runner = engine.scheduler.runner
        V = runner.model_config.vocab_size
        pa = rng.integers(1, V, MEM_PROMPT).tolist()
        a = engine.generate(input_ids=pa, sampling_params=sp)
        # a radix hit on the device: the promoted prompt must give its tokens
        # (the same cached pages, the same tail extend)
        hit = engine.generate(input_ids=pa, sampling_params=sp)
        src = engine.scheduler.tree_cache.get(0).match_prefix(pa).page_ids[:64]
        dst = runner.page_allocator.alloc(len(src))
        host = [t.cpu() for t in runner.gather_pages(src)]
        runner.scatter_pages(dst, host)
        same = all(torch.equal(x, y) for x, y in zip(pool_bytes(runner, src), pool_bytes(runner, dst)))
        runner.page_allocator.free(dst)
        check(same and len(src) > 0, f"memory {kv}: {len(src)} pages gathered and scattered back differ")
        for _ in range(3):
            engine.generate(input_ids=rng.integers(1, V, MEM_PROMPT).tolist(), sampling_params=sp)
        tier = engine.scheduler.host_tier
        again = engine.generate(input_ids=pa, sampling_params=sp)
        check(tier.stored_pages > 0 and tier.restored_pages > 0 and again.cached_tokens == hit.cached_tokens > 0,
              f"memory {kv}: stored {tier.stored_pages}, restored {tier.restored_pages} pages, "
              f"{again.cached_tokens} cached tokens against the device hit's {hit.cached_tokens}")
        check(again.output_ids == hit.output_ids, f"memory {kv}: the promoted prompt's tokens differ from the hit's")
        log(f"[memory {kv}] {len(src)} pages round-trip bit-equal {same}; host tier stored "
            f"{tier.stored_pages}, restored {tier.restored_pages} pages; the promoted prompt: "
            f"{again.cached_tokens} cached tokens, tokens equal to the device hit's "
            f"{again.output_ids == hit.output_ids} (to the full prefill's {again.output_ids == a.output_ids})")
        out[kv] = dict(round_trip=same, stored=tier.stored_pages, restored=tier.restored_pages,
                       cached=again.cached_tokens)
        if kv == "bfloat16":
            first = a.output_ids
            sizes = []
            for tokens in (4096, 65536):
                sizes.append(engine.resize_kv_pool(tokens))
                got = engine.generate(input_ids=pa, sampling_params=sp)
                # the host tier outlives a resize: its pages come back as a hit
                want = hit if got.cached_tokens else a
                check(got.output_ids == want.output_ids and got.cached_tokens in (0, hit.cached_tokens),
                      f"memory: after a resize to {tokens} tokens the tokens differ "
                      f"({got.cached_tokens} cached tokens)")
                sizes.append(got.cached_tokens)
            log(f"[memory] resize down and up: {sizes[0::2]} tokens, {sizes[1::2]} cached tokens (the host "
                f"tier's pages promoted), the tokens of a hit or a full prefill as each had")
            q = rng.integers(1, V, 500).tolist()
            base = batch_logits(runner, [q], [first[0]])
            dense = LlamaForCausalLM(runner.model_config, runner.device, runner.dtype)
            dense.init_random_(torch.Generator(device=runner.device).manual_seed(1))
            ok1, msg1 = engine.update_weights(state=dense.state_dict())
            del dense
            moved = batch_logits(runner, [q], [first[0]])
            ok2, msg2 = engine.update_weights(state=p1b)
            back = batch_logits(runner, [q], [first[0]])
            move = max(float((m[0] - b[0]).abs().max() / b[0].abs().max()) for m, b in zip(moved, base))
            equal = all(torch.equal(x, y) for x, y in zip(back, base))
            check(ok1 and ok2 and equal and move > 0.1,
                  f"memory: update_weights ({msg1}, {msg2}): logits back bit-equal {equal}, moved {move:.3e}")
            log(f"[memory] update_weights to another seed and back: logits moved {move:.3e} of max|logit|, "
                f"then bit-equal {equal}")
            out["update"] = dict(moved=move, equal=equal)
        del engine, runner
    # parameter offload against the resident engine on the same weights
    prompts = [rng.integers(1, V, n).tolist() for n in (100, 300, 700, 1000)]
    spn = SamplingParams(temperature=0.0, max_new_tokens=32, ignore_eos=True)
    res = {}
    for name, kw in (("resident", {}), ("offload", dict(enable_param_offload=True, param_offload_groups=2))):
        engine = make_engine(params=p1b, max_total_tokens=65536, model_config=cfg, **kw)
        runner = engine.scheduler.runner
        logits = [batch_logits(runner, [p], [1]) for p in prompts[:2]]
        engine.generate(input_ids=prompts, sampling_params=spn)  # warm
        torch.cuda.synchronize()
        t = time.monotonic()
        engine.generate(input_ids=prompts, sampling_params=spn)
        torch.cuda.synchronize()
        resident_bytes = sum(x.numel() * x.element_size() for x in runner.model.state_dict().values())
        res[name] = dict(logits=logits, ms_per_token=(time.monotonic() - t) * 1e3 / 32,
                         resident_gib=resident_bytes / 2**30)
        del engine, runner
    # offload moves where the weights live, not the arithmetic: the same
    # kernels on the same shapes give the same bits
    pairs = [(a[0], b[0]) for ra, rb in zip(res["offload"]["logits"], res["resident"]["logits"])
             for a, b in zip(ra, rb)]
    equal = all(torch.equal(a, b) for a, b in pairs)
    rel = max(float((a - b).abs().max() / b.abs().max()) for a, b in pairs)
    check(equal, f"memory: offload logits differ from the resident engine's by {rel:.3e} of max|logit|")
    log(
        f"[memory] param offload, 2 groups: logits bit-equal to the resident engine's {equal} "
        f"({rel:.3e} of max|logit|); {res['offload']['ms_per_token']:.2f} ms of wall a generated token (4 requests, "
        f"prefill included, windows of one) against {res['resident']['ms_per_token']:.2f} ms resident; "
        f"weights on the card "
        f"{res['offload']['resident_gib']:.3f} GiB between forwards against {res['resident']['resident_gib']:.3f} GiB"
    )
    out["offload"] = {k: {kk: vv for kk, vv in v.items() if kk != "logits"} for k, v in res.items()}
    out["offload"]["logit_rel"] = rel
    out["offload"]["logits_equal"] = equal
    return out


# ------------------------------------------------------- tensor parallel


TP_SIZE = 2
TP_PRESET = "llama-3.1-8b"
# the greedy requests of the tp 1 reference and the tp 2 engine, and a
# sampled one that each serves in the same batch
TP_REQUESTS = [(5, 16), (37, 16), (300, 16), (600, 16)]
TP_SAMPLED = dict(temperature=0.8, top_p=0.9, max_new_tokens=16, ignore_eos=True)
TP_KV_TOKENS = 65536  # every engine's pool, explicit: two ranks share the card
# the int8 KV pair's depth (of 32), cut to pay for phase_tp_families
TP_INT8_LAYERS = 8
TP_STEP = (64, 512, 2)  # the timed decode window: rows, cached tokens, steps
# rows 1, 3, 1q and 3q at a tp 2 rank's heads of Llama-3.1-8B (Hkv 4, G 4, D 128)
TP_HEADS = (4, 4, 128)
DECODE_TP = "paged_decode_attention (tp 2 rank: Hkv 4)"
EXTEND_TP = "paged_extend_attention (tp 2 rank: Hkv 4)"
TP_EXTEND_CASES = [([(1000, 1000), (512, 2560), (7, 1031), (1, 300)], 2048)]


def check_tp_heads(errs: dict) -> None:
    """Rows 1, 3, 1q and 3q at a tp 2 rank's heads of Llama-3.1-8B (Hkv 4,
    G 4, D 128; ``TP_HEADS``) over bf16 and int8 pages: decode at B 1, 2 and
    64 and contexts of 1, 17 and 4096 tokens, padding rows (exact zeros) and
    rows a token before, on and after a boundary of the plan's splits (a
    second call bit-equal where the plan splits); extend on mixed chunks
    with padding. The bf16 rows' errors go to ``errs`` (their kernel
    entries); the int8 rows' are logged and gated alike."""
    import torch

    from scratchpad_tpu_torch.ops.attention import (
        paged_decode_attention_plain,
        paged_extend_attention_plain,
    )
    from scratchpad_tpu_torch.ops.attention.gqa_decode import decode_plan

    Hkv, G, D = TP_HEADS
    scale = 1.0 / math.sqrt(D)
    seed = 5000
    for kind in ("bf16", "int8"):
        cases = [(B, ctx) for B in DECODE_CHECK_B for ctx in (1, 17, 4096)] + ["padding", "split edges"]
        for case in cases:
            seed += 1
            gen = seeded(seed)
            if case == "padding":
                lens = torch.tensor([300, 0, 17, 0], dtype=torch.int32, device="cuda")
            elif case == "split edges":
                lens = torch.tensor(split_edge_lens(4096, Hkv, D, G), dtype=torch.int32, device="cuda")
            else:
                lens = decode_lens(case, gen, D, G)
            k, v, pt = make_pool(lens.tolist(), Hkv, D, 16, 1, gen)
            k, v, ks, vs = quant_pages(k[0], v[0], kind)
            q = torch.randn(len(lens), Hkv * G, D, generator=gen, device="cuda").to(torch.bfloat16)
            out = decode_kernel(q, k, v, ks, vs, pt, lens, scale)
            ref = paged_decode_attention_plain(q.float(), k, v, pt, lens, scale, ks, vs)
            plan = decode_plan(len(lens), Hkv, pt.shape[1], D, G)
            same = plan.splits == 1 or torch.equal(out, decode_kernel(q, k, v, ks, vs, pt, lens, scale))
            torch.cuda.synchronize()
            e, ratio = max_err(out, ref)
            zero = bool((out[lens == 0] == 0).all())
            name = DECODE_TP if kind == "bf16" else "paged_decode_attention_quant (tp 2 rank)"
            errs[name] = max(errs.get(name, 0.0), e)
            what = case if isinstance(case, str) else f"B={case[0]} ctx={case[1]}"
            log(f"[check] {name} {what}: max_abs_err {e:.3e}, max err/tol {ratio:.3f}, zero rows exact: "
                f"{zero}" + (f"; {plan.splits} splits, second call bit-equal: {same}" if plan.splits > 1 else ""))
            check(ratio <= 1 and zero and same, f"{name} disagrees with its plain version at {what}")
        for chunks, T_pad in TP_EXTEND_CASES:
            seed += 1
            q, k, v, pt, kv_lens, cu = extend_case(chunks, D, T_pad, seed, G, Hkv)
            k, v, ks, vs = quant_pages(k, v, kind)
            out = extend_kernel(q, k, v, ks, vs, pt, kv_lens, cu, scale)
            ref = paged_extend_attention_plain(q.float(), k, v, pt, kv_lens, cu, scale, ks, vs)
            torch.cuda.synchronize()
            e, ratio = max_err(out, ref)
            zero = bool((out[int(cu[-1]):] == 0).all())
            name = EXTEND_TP if kind == "bf16" else "paged_extend_attention_quant (tp 2 rank)"
            errs[name] = max(errs.get(name, 0.0), e)
            log(f"[check] {name} chunks={chunks} T={q.shape[0]}: max_abs_err {e:.3e}, max err/tol "
                f"{ratio:.3f}, padded tokens zero: {zero}")
            check(ratio <= 1 and zero, f"{name} disagrees with its plain version at chunks={chunks}")


def tp_step_times(engine, label: str) -> dict:
    """One decode window of ``TP_STEP`` (rows, cached tokens, steps) through
    ``run_decode_window`` (relayed to every rank at tp 2), on pages borrowed
    from the idle pool: the wall a step (one window after one to warm up,
    from its call to its ids on the host), and rank 0's
    device busy time a step from a ``torch.profiler`` trace of one more
    window (this process's kernels only; a follower's run beside them). At
    tp 2 on one card each step's 66 collectives go through host memory, so
    the window is short."""
    import tempfile

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from scratchpad_tpu_torch.executor.forward_meta import ForwardMode
    from scratchpad_tpu_torch.executor.model_runner import WorkerBatch
    from scratchpad_tpu_torch.sampling.batch_info import SamplingBatchInfo
    from scratchpad_tpu_torch.tools import analyze_trace

    runner = engine.scheduler.runner
    B, ctx, K = TP_STEP
    ps, V = runner.page_size, runner.model_config.vocab_size
    pages = [runner.page_allocator.alloc(-(-(ctx + K) // ps)) for _ in range(B)]
    if any(p is None for p in pages):
        fail(f"{label}: no free pages for the timed decode window")
    try:
        pt = np.stack(pages).astype(np.int32)
        wb = WorkerBatch(
            mode=ForwardMode.DECODE, tokens=np.random.default_rng(3).integers(1, V, B),
            positions=np.full(B, ctx), out_cache_loc=pt[:, ctx // ps] * ps + ctx % ps,
            req_indices=np.arange(B), page_table=pt, seq_lens=np.full(B, ctx + 1),
            extend_lens=np.ones(B, np.int64), sampling_info=SamplingBatchInfo.from_reqs([], B, V),
        )
        runner.run_decode_window(wb, K)
        torch.cuda.synchronize()
        t = time.perf_counter()
        runner.run_decode_window(wb, K)
        wall_ms = (time.perf_counter() - t) * 1e3 / K
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            runner.run_decode_window(wb, K)
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as d:
            path = Path(d) / "trace.json"
            prof.export_chrome_trace(str(path))
            busy = analyze_trace.rollup(analyze_trace.load_events(path))["busy_us"]
    finally:
        for p in pages:
            if p is not None:
                runner.page_allocator.free(p)
    return dict(wall_ms=wall_ms, device_ms=busy / 1e3 / K if busy > 0 else None)


def tp_traffic(V: int):
    """``TP_REQUESTS`` greedy and one ``TP_SAMPLED`` request in one batch,
    as the tp 1 reference and the tp 2 engine serve them: (the greedy
    prompts, every prompt, every request's sampling parameters)."""
    from scratchpad_tpu_torch.sampling.sampling_params import SamplingParams

    prompts = spec_prompts(V, TP_REQUESTS, seed=11)
    sps = [SamplingParams(temperature=0.0, max_new_tokens=m, ignore_eos=True) for _, m in TP_REQUESTS]
    return prompts, prompts + spec_prompts(V, [(200, 0)], seed=12), sps + [SamplingParams(**TP_SAMPLED)]


class RouterLog:
    """For a MoE model: within ``record()``, each router pick of the
    forwards inside it (``top_experts``, one call a MoE layer and forward),
    on the host (``calls``): the experts [T, k], sorted, and each token's
    margin of its k-th pick over the next score, over the row's max
    |score|; and the picks as made, on the device (``picks``: a
    ``SameRouting``'s to replay)."""

    def __init__(self, model):
        self.model = model
        self.calls = []
        self.picks = []  # the picks as the model made them, on its device

    @contextlib.contextmanager
    def record(self):
        import torch

        inner = self.model.top_experts
        k = self.model.cfg.num_experts_per_tok

        def recording(scores):
            topi = inner(scores)
            top = torch.topk(scores.float(), k + 1, dim=-1).values
            gap = (top[:, k - 1] - top[:, k]) / scores.float().abs().max(dim=-1).values.clamp_min(1e-30)
            self.calls.append((topi.sort(dim=-1).values.cpu(), gap.cpu()))
            self.picks.append(topi)
            return topi

        self.model.top_experts = recording
        try:
            yield self
        finally:
            del self.model.top_experts  # the class's method again


def router_flips(ref_calls, calls, rows) -> list:
    """The (layer, token) picks of the tokens ``rows`` where ``calls``'
    expert set differs from ``ref_calls``' (two ``RouterLog.calls`` of the
    same forward), each with the reference's margin there."""
    out = []
    for l, ((ref_i, ref_gap), (i, _)) in enumerate(zip(ref_calls, calls)):
        for t in rows:
            if not bool((ref_i[t] == i[t]).all()):
                out.append((l, t, float(ref_gap[t])))
    return out


def tp_reference(engine, label: str, timed: bool = False) -> dict:
    """What a tp 2 engine of ``label`` is held to, from the tp 1 ``engine``
    of the same weights: its ids of ``tp_traffic`` (the greedy requests'),
    the logits of the greedy prompts' extend as one batch and of the decode
    step after it (``batch_logits``), each greedy output teacher-forced
    through one extend (``teacher_forced``), with ``timed`` the decode
    step's times (``tp_step_times``); for a MoE model the router's picks in
    those forwards (``RouterLog``); its KV dtype, parameter bytes and
    pool."""
    runner = engine.scheduler.runner
    prompts, served, sps = tp_traffic(runner.model_config.vocab_size)
    outs = engine.generate(input_ids=served, sampling_params=sps)[: len(TP_REQUESTS)]
    moe = hasattr(runner.model, "top_experts")
    picks = RouterLog(runner.model) if moe else None
    with picks.record() if moe else contextlib.nullcontext():
        logits = batch_logits(runner, prompts, [o.output_ids[0] for o in outs])
    forced, forced_picks = [], []
    for p, o in zip(prompts, outs):
        tf_picks = RouterLog(runner.model) if moe else None
        with tf_picks.record() if moe else contextlib.nullcontext():
            forced.append(teacher_forced(runner, p + o.output_ids))
        forced_picks.append(tf_picks and tf_picks.calls)
    return dict(
        ids=[o.output_ids for o in outs], logits=[t.float().cpu() for t in logits], forced=forced,
        picks=picks and picks.calls, forced_picks=forced_picks, kv=runner.kv_cache_dtype,
        param_bytes=runner.param_bytes, kv_tokens=runner.max_total_num_tokens,
        step=tp_step_times(engine, f"{label} tp 1") if timed else None,
    )


def forced_router_picks(runner, tokens: list) -> list:
    """The leader's ``RouterLog.calls`` of one extend of ``tokens`` through
    ``forward_logits`` (every rank runs it), on pages borrowed from the idle
    pool: the tp 2 side of ``teacher_forced``'s routing."""
    import numpy as np

    from scratchpad_tpu_torch.executor.forward_meta import ForwardMode
    from scratchpad_tpu_torch.executor.model_runner import WorkerBatch
    from scratchpad_tpu_torch.sampling.batch_info import SamplingBatchInfo

    ps, n = runner.page_size, len(tokens)
    pages = runner.page_allocator.alloc(-(-n // ps))
    if pages is None:
        fail("no free pages for the teacher-forced routing")
    try:
        pos = np.arange(n)
        wb = WorkerBatch(
            mode=ForwardMode.EXTEND, tokens=np.asarray(tokens), positions=pos,
            out_cache_loc=pages[pos // ps] * ps + pos % ps, req_indices=np.zeros(n, np.int64),
            page_table=pages[None], seq_lens=np.array([n]), extend_lens=np.array([n]),
            sampling_info=SamplingBatchInfo.from_reqs([], 1, runner.model_config.vocab_size),
        )
        log_ = RouterLog(runner.model)
        with log_.record():
            runner.forward_logits(wb)
        return log_.calls
    finally:
        runner.page_allocator.free(pages)


def check_tp_engine(engine, ref: dict, label: str, launches: dict, per_layer: int = 2, kv_heads=None,
                    tp1=None) -> dict:
    """Hold the tp 2 ``engine`` to its tp 1 reference ``ref`` (``tp_reference``)
    on ``tp_traffic`` through ``Engine.generate``, every rank's counts set
    to 0 just before and read just after (each follower reports its own).
    Checks: every request finishes; the greedy ids equal tp 1's until a
    position where tp 1's teacher-forced top-2 gap is a tie (``bf16_tie``
    at ``ARGMAX_FLOOR``; a MoE engine's parting where its own routing of the
    same tokens picks another expert set first is logged with the router's
    margin and not gated; on 8-bit pages, where each engine quantizes its
    own K/V rows, and under W4A8, where it quantizes its own activation
    rows, a parting is logged and not gated); on every rank
    ``launches`` (wrapper -> "decode" or "extend") once a layer in each
    forward of that mode and every other attention kernel never, a pool of
    ``kv_heads`` kv heads, ``per_layer`` collectives a layer plus the
    lookup's and the head's in each forward, and the leader's forwards,
    sampled ids and logprobs, router picks and gathered logits; the
    first-token and next-step logits within ``LOGIT_RTOL`` of tp 1's max
    |logit|, the argmax the same but at a tie. A MoE model's are held at one
    routing: the tp 1 engine ``tp1``, alive beside the ranks, replays tp 2's
    picks (``SameRouting``), as ``phase_engine`` holds the plain path at the
    kernel path's; the reading at tp 1's own routing is logged beside, with
    the rows whose picks part and tp 1's router margins there (one pick
    across a near tie moves a token by a whole expert's share), not
    gated."""
    import torch

    cfg = engine.model_config
    L, floor, tol = cfg.num_hidden_layers, ARGMAX_FLOOR[label], LOGIT_RTOL[label]
    prompts, served, sps = tp_traffic(cfg.vocab_size)
    runner = engine.scheduler.runner
    moe = hasattr(runner.model, "top_experts")
    runner.reset_counts()  # every rank's
    outs = engine.generate(input_ids=served, sampling_params=sps)
    reports = [runner.tp_report()] + runner.follower_reports()
    # the greedy ids against tp 1's, until a tie parts them
    parted = routed_apart = 0
    for i, (p, o, want) in enumerate(zip(prompts, outs, ref["ids"])):
        j = next((j for j, (a, b) in enumerate(zip(o.output_ids, want)) if a != b), None)
        if j is None:
            continue
        tf, row = ref["forced"][i], len(p) - 1 + j
        tie = bf16_tie(tf, row, floor)
        parted += 1
        flips = []
        if moe and not tie:  # its own routing of tp 1's tokens, up to the parting
            flips = router_flips(ref["forced_picks"][i], forced_router_picks(runner, p + want), range(row + 1))
            routed_apart += bool(flips)
        log(f"[tp {label}] request {i} parts from tp 1 at token {j} ({o.output_ids[j]} against {want[j]}); "
            f"tp 1's teacher-forced top-2 gap there {tf['gap'][row] / tf['scale'][row]:.3e} of max|logit|, a "
            f"tie at {floor}: {tie}" + (f"; routing of tp 1's tokens up to there: {len(flips)} other expert "
                                        f"sets, tp 1's router margins {[round(g, 5) for _, _, g in flips[:8]]}"
                                        if moe and not tie else ""))
        if ref["kv"] not in ("int8", "fp8") and runner.args.quantization != "w4a8":
            check(tie or bool(flips), f"{label} request {i}: greedy ids part from tp 1 at token {j} outside a "
                                      "tie and with tp 1's routing")
    for o in outs:
        check(o.finish_reason == "length" and len(o.output_ids) == o.completion_tokens > 0,
              f"{label} request {o.rid}: {o.completion_tokens} tokens, finish {o.finish_reason}")
    for rep in reports:
        n_ext, n_dec = rep["forwards"]["extend"], rep["forwards"]["decode"]
        lc, r = rep["launches"], rep["rank"]
        if kv_heads is not None:
            check(rep["kv_heads"] == kv_heads, f"{label} rank {r}: a pool of {rep['kv_heads']} kv heads")
        for name in ATTENTION_WRAPPERS:
            n = {"decode": n_dec, "extend": n_ext}.get(launches.get(name), 0)
            check(lc[name] == L * n and (n > 0 or name not in launches),
                  f"{label} rank {r}: {name} launched {lc[name]} times in {n_dec} decode and {n_ext} extend "
                  f"forwards, not {L} a {launches.get(name, 'no')} forward")
        check(rep["collectives"] == (per_layer * L + 2) * (n_ext + n_dec),
              f"{label} rank {r}: {rep['collectives']} collectives in {n_ext + n_dec} forwards")
        for key in ("forwards", "token_digest", "tokens_sampled", "router_picks", "router_digest"):
            check(rep[key] == reports[0][key], f"{label} rank {r}: {key} {rep[key]} against the leader's "
                                                f"{reports[0][key]}")
    # the logits against tp 1's, on the same inputs (a MoE model's at tp 2's
    # routing, replayed on tp 1)
    worst, flips, apart, own_worst = 0.0, 0, 0, 0.0
    picks = RouterLog(runner.model) if moe else None
    with picks.record() if moe else contextlib.nullcontext():
        got = batch_logits(runner, prompts, [o[0] for o in ref["ids"]])
    want = ref["logits"]
    if moe:
        same = SameRouting(tp1.scheduler.runner.model)
        same.picks = picks.picks
        with same.replay():
            want = [t.float().cpu() for t in batch_logits(tp1.scheduler.runner, prompts, [o[0] for o in ref["ids"]])]
        log(f"[tp {label}] MoE routing: tp 1 ran at tp 2's routing; at its own, its router picked another "
            f"expert set at {same.flips} of {same.picked} (token, layer) picks")
    starts = [0]
    for p in prompts:
        starts.append(starts[-1] + len(p))
    n_moe = len(picks.calls) // 2 if moe else 0
    for i in range(len(prompts)):
        for step in (0, 1):
            a, b = got[step][i].float().cpu(), want[step][i]
            check(bool(torch.isfinite(a).all()), f"{label}: non-finite logits")
            scale = float(b.abs().max())
            rel = float((a - b).abs().max()) / scale
            if moe:  # at tp 1's own routing: this row's tokens' picks up to this
                # forward (the step reads the extend's KV), logged
                own = ref["logits"][step][i]
                own_rel = float((a - own).abs().max()) / float(own.abs().max())
                own_worst = max(own_worst, own_rel)
                moved = router_flips(ref["picks"][:n_moe], picks.calls[:n_moe], range(starts[i], starts[i + 1]))
                if step == 1:
                    moved += router_flips(ref["picks"][n_moe:], picks.calls[n_moe:], [i])
                apart += bool(moved)
                if moved:
                    log(f"[tp {label}] request {i} step {step}: at tp 1's own routing its picks part at "
                        f"{len(moved)} (layer, token) picks, tp 1's router margins there "
                        f"{[round(g, 5) for _, _, g in moved[:8]]}; logits max|diff| {own_rel:.3e} of "
                        f"max|logit| there, {rel:.3e} at one routing")
            worst = max(worst, rel)
            top2 = torch.topk(b, 2).values
            gap = float(top2[0] - top2[1])
            tie = gap <= max(math.ldexp(1.0, math.frexp(abs(float(top2[0])))[1] - 8), floor * scale)
            if a.argmax() != b.argmax():
                flips += 1
                log(f"[tp {label}] request {i} step {step}: argmax {int(a.argmax())} (tp 2) against "
                    f"{int(b.argmax())} (tp 1), tp 1's top-2 gap {gap / scale:.3e} of max|logit|, tie {tie}")
                check(tie, f"{label} request {i} step {step}: argmax differs from tp 1 outside a tie")
            check(rel <= tol, f"{label}: logits differ from tp 1 by {rel:.3e} of max|logit| (tol {tol})")
    digests = [runner.tp_report()] + runner.follower_reports()
    check(len({d["logits_digest"] for d in digests}) == 1,
          f"{label}: the ranks' gathered logits differ: {[d['logits_digest'] for d in digests]}")
    check(len({d["router_digest"] for d in digests}) == 1,
          f"{label}: the ranks' router picks differ: {[d['router_digest'] for d in digests]}")
    return dict(reports=reports, worst=worst, flips=flips, parted=parted, routed_apart=routed_apart,
                apart=apart, own_worst=own_worst, rows=2 * len(prompts))


def tp_engine_record(reports: list, label: str, launches: dict, weights: str = "bf16", **extra) -> dict:
    """The ``engines`` entry of a tp 2 engine: launches summed over the
    ranks and by rank, each kernel's forwards on every rank."""
    counts = {k: sum(rep["launches"][k] for rep in reports) for k in reports[0]["launches"]}
    return dict(
        counts=counts, steps={k: TP_SIZE * reports[0]["forwards"][mode] for k, mode in launches.items()},
        launches_by_rank={k: [rep["launches"][k] for rep in reports] for k in counts}, weights=weights,
        tp_size=TP_SIZE, **extra,
    )


def phase_tp(errs: dict, engines: dict) -> dict:
    """Tensor parallelism on the one card: ``TP_PRESET`` at full width and
    depth, bf16 weights, at tp 2 (two ranks on cuda:0, gloo: NCCL takes one
    rank a GPU) against the tp 1 engine on the same weights (seed 0; each
    rank draws the tp 1 tensors and keeps its shard), on bf16 and on int8
    pages (the int8 pair at ``TP_INT8_LAYERS`` layers; the tp 1 engine
    freed before the ranks start), through
    ``check_tp_engine``: on every rank one launch a layer of the pool's
    decode kernel (row 1, 1q) in each decode forward and of its extend
    kernel (row 3, 3q) in each extend forward, none of the other kind, over
    4 kv heads; 2 collectives a layer plus the embedding's and the head's in
    each forward. Then the decode step's wall and device time at tp 1 and tp 2
    on one ``[tp]`` line with the card's name and power limit, and rows 1
    and 3 at the rank's shapes, timed."""
    from scratchpad_tpu_torch.config.model_config import get_preset

    t0 = time.monotonic()
    result = {}
    for kv, pages, label in (("bfloat16", "bf16", "llama-3.1-8b-tp2"), ("int8", "int8", "llama-3.1-8b-tp2-int8kv")):
        tol = LOGIT_RTOL[label]
        # the int8 pair at TP_INT8_LAYERS, to pay for phase_tp_families
        cfg = get_preset(TP_PRESET, **({} if pages == "bf16" else {"num_hidden_layers": TP_INT8_LAYERS}))
        L = cfg.num_hidden_layers
        engine = make_engine(model_config=cfg, kv_cache_dtype=kv, max_total_tokens=TP_KV_TOKENS)
        ref = tp_reference(engine, label, timed=pages == "bf16")
        del engine
        t = time.monotonic()
        engine = make_engine(model_config=get_preset(TP_PRESET, num_hidden_layers=L), kv_cache_dtype=kv,
                             max_total_tokens=TP_KV_TOKENS, tp_size=TP_SIZE)
        launches = {DECODE[pages]: "decode", EXTEND[pages]: "extend"}
        try:
            start_s = time.monotonic() - t
            g = engine.tp_group
            out = check_tp_engine(engine, ref, label, launches, kv_heads=cfg.num_kv_heads // TP_SIZE)
            step = tp_step_times(engine, label) if pages == "bf16" else None
        finally:
            engine.shutdown()
            del engine
        reports, worst = out["reports"], out["worst"]
        n_fwd = sum(reports[0]["forwards"].values())
        engines[label] = tp_engine_record(reports, label, launches, preset=TP_PRESET, kv_cache_dtype=kv,
                                          attention_backend="auto", worst_logit_rel=worst)
        log(
            f"[tp {label}] backend {g.backend}, devices {[rep['device'] for rep in reports]}, started in "
            f"{start_s:.1f} s; parameters a rank {[round(rep['param_bytes'] / 2**30, 3) for rep in reports]} "
            f"GiB against {ref['param_bytes'] / 2**30:.3f} GiB at tp 1; KV tokens a rank "
            f"{[rep['kv_tokens'] for rep in reports]} ({ref['kv_tokens']} at tp 1); forwards "
            f"{reports[0]['forwards']}, collectives a forward {reports[0]['collectives'] / max(n_fwd, 1):.1f} "
            f"(2 x {L} layers + 2); launches by rank "
            f"{ {k: v for k, v in engines[label]['launches_by_rank'].items() if any(v)} }; "
            f"{reports[0]['tokens_sampled']} sampled ids and logprobs bit-equal on every rank; logits "
            f"against tp 1: worst max|diff| {worst:.3e} of max|logit| (tol {tol}), argmax differs on "
            f"{out['flips']} of {out['rows']} rows; greedy ids part from tp 1 in {out['parted']} of "
            f"{len(TP_REQUESTS)} requests; follower packages: jax {'jax' in reports[-1]['packages']}, "
            f"scratchpad_tpu {'scratchpad_tpu' in reports[-1]['packages']}"
        )
        result[label] = dict(worst_logit_rel=worst, flips=out["flips"], parted=out["parted"], start_s=start_s,
                             param_gib=[rep["param_bytes"] / 2**30 for rep in reports],
                             kv_tokens=[rep["kv_tokens"] for rep in reports])
        if step is not None:
            result["step"] = {"tp1": ref["step"], "tp2": step}
    timing = {}
    if not FAILURES:  # rows 1 and 3 at the rank's shapes
        Hkv, G, D = TP_HEADS
        timing[DECODE_TP] = [time_decode(64, 4096, D=D, G=G, Hkv=Hkv)]
        timing[EXTEND_TP] = [time_extend([(128, 128)] * 64, D=D, G=G, Hkv=Hkv)]
        for name, rows in timing.items():
            r = rows[0]
            log(f"[time] {name} {r['shape']}: {r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
                f"plain {r['plain_ms']:.3f} ms, SDPA {r['library_ms']:.4f} ms")
    s = result.get("step", {})
    fmt = lambda d, k: "not measured" if not d or d.get(k) is None else f"{d[k]:.3f} ms"
    log(
        f"[tp] {TP_PRESET} tp {TP_SIZE} on one card, {card_line()}: decode step at {TP_STEP[0]} rows x "
        f"{TP_STEP[1]} cached tokens, wall {fmt(s.get('tp1'), 'wall_ms')} at tp 1 and "
        f"{fmt(s.get('tp2'), 'wall_ms')} at tp 2; rank 0's device busy {fmt(s.get('tp1'), 'device_ms')} "
        f"at tp 1 and {fmt(s.get('tp2'), 'device_ms')} at tp 2; phase {time.monotonic() - t0:.1f} s"
    )
    result["seconds"] = time.monotonic() - t0
    return result, timing


# the other text families at tp 2 (phase_tp_families): label -> (the tp 1
# engine it is held to, KV pages, attention backend, collectives a layer).
# Their pools take TP_FAMILY_KV_TOKENS each, and their tp 1 engines'
# TP1_KV_TOKENS (Llama-4 Scout's LLAMA4_KV_TOKENS): those engines stay alive
# beside the ranks. GPT-OSS keeps its experts whole on every rank (one
# collective a layer: o's sum); DeepSeek keeps the whole latent pool on
# every rank and launches no attention kernel; Qwen3-30B-A3B serves through
# attention_backend="pallas" (row 9 on a rank's heads; row 1 on a rank is
# phase_tp's and the other families'), against its tp 1 engine's auto.
TP_FAMILIES = {
    "gemma-2-2b-tp2": ("gemma-2-2b", "bf16", "auto", 2),
    "gemma-2-2b-tp2-int8kv": ("gemma-2-2b-int8kv", "int8", "auto", 2),
    "gpt-oss-20b-tp2": ("gpt-oss-20b", "bf16", "auto", 1),
    "qwen3-30b-a3b-tp2": ("qwen3-30b-a3b", "bf16", "pallas", 2),
    "llama4-scout-tp2": ("llama4-scout", "bf16", "auto", 2),
    "deepseek-v2-lite-tp2": ("deepseek-v2-lite", "bf16", "auto", 2),
}
TP_FAMILY_KV_TOKENS = 32768
TP1_KV_TOKENS = 65536
ATTENTION_WRAPPERS = ("paged_decode_attention", "paged_extend_attention", "paged_decode_attention_quant",
                      "paged_extend_attention_quant", "decode_attention_pallas")


def tp_family_launches(cfg, pages: str, backend: str) -> dict:
    """The attention wrappers a tp 2 engine launches once a layer in each
    forward of their mode: none for MLA (its latent attention is torch);
    the pool's decode and extend kernels; under ``pallas`` row 9's wrapper
    beside the decode kernel it launches."""
    if cfg.is_mla:
        return {}
    out = {DECODE[pages]: "decode", EXTEND[pages]: "extend"}
    if backend == "pallas":
        out["decode_attention_pallas"] = "decode"
    return out


def phase_tp_families(tp1, label: str, engines: dict) -> dict:
    """Tensor parallelism for the other text families on the one card: the
    tp 2 configurations of ``TP_FAMILIES`` held to the tp 1 engine ``tp1``
    of ``label`` (just after its own phase, alive beside the ranks), each at
    full width and that engine's depth, bf16 weights drawn from seed 0 (each
    rank draws the tp 1 tensors and keeps its shard), two ranks on cuda:0
    over gloo, through ``check_tp_engine`` against ``tp1``'s reference
    (``tp_reference``) and, for MoE, ``tp1`` at tp 2's routing. Each
    ``[tp <label>]`` line gives the launches a forward on a rank of each
    attention kernel (rows 1d, 3d, 1dq, 3dq, 1s, 3s, 1c, 3c and 9), the
    collectives a forward, the ranks' parameters and KV tokens."""
    cfg = tp1.model_config
    result = {}
    ref = None
    for tp_label in (k for k, v in TP_FAMILIES.items() if v[0] == label):
        _, pages, backend, per_layer = TP_FAMILIES[tp_label]
        ref = ref or tp_reference(tp1, tp_label)
        launches = tp_family_launches(cfg, pages, backend)
        t = time.monotonic()
        kv = ref["kv"] if ref["kv"] in ("int8", "fp8") else "auto"  # "auto": the model dtype
        engine = make_engine(model_config=cfg, kv_cache_dtype=kv, attention_backend=backend,
                             max_total_tokens=TP_FAMILY_KV_TOKENS, tp_size=TP_SIZE)
        try:
            start_s = time.monotonic() - t
            out = check_tp_engine(engine, ref, tp_label, launches, per_layer,
                                  kv_heads=1 if cfg.is_mla else cfg.num_kv_heads // TP_SIZE, tp1=tp1)
        finally:
            engine.shutdown()
            del engine
        reports = out["reports"]
        n = reports[0]["forwards"]
        engines[tp_label] = tp_engine_record(reports, tp_label, launches, preset=label, kv_cache_dtype=ref["kv"],
                                             attention_backend=backend, worst_logit_rel=out["worst"])
        per_forward = {k: [rep["launches"][k] / max(n[mode], 1) for rep in reports] for k, mode in launches.items()}
        L = cfg.num_hidden_layers
        moe = ref["picks"] is not None
        log(
            f"[tp {tp_label}] {cfg.architecture} at {L} layers, started in {start_s:.1f} s; parameters a rank "
            f"{[round(rep['param_bytes'] / 2**30, 3) for rep in reports]} GiB against "
            f"{ref['param_bytes'] / 2**30:.3f} GiB at tp 1; KV tokens a rank {[rep['kv_tokens'] for rep in reports]} "
            f"of {[rep['kv_heads'] for rep in reports]} kv heads"
            + (" (the whole latent pool on every rank)" if cfg.is_mla else "")
            + f"; forwards {n}, collectives a forward "
            f"{reports[0]['collectives'] / max(sum(n.values()), 1):.1f} ({per_layer} x {L} layers + 2); "
            f"attention launches a forward by rank {per_forward or 'none (MLA in torch)'}; "
            f"{reports[0]['tokens_sampled']} sampled ids and logprobs and "
            f"{reports[0]['router_picks'] or 0} router picks bit-equal on every rank; logits against tp 1"
            + (" at tp 2's routing" if moe else "")
            + f": worst max|diff| {out['worst']:.3e} of max|logit| (tol {LOGIT_RTOL[tp_label]}), argmax "
            f"differs on {out['flips']} of {out['rows']} rows"
            + (f"; at tp 1's own routing {out['own_worst']:.3e}, its picks parting on {out['apart']} rows"
               if moe else "")
            + f"; greedy ids part from tp 1 in {out['parted']} of {len(TP_REQUESTS)} requests "
            f"({out['routed_apart']} after the routing parted)"
        )
        result[tp_label] = dict(worst_logit_rel=out["worst"], flips=out["flips"], parted=out["parted"],
                                own_routing_worst=out["own_worst"] if moe else None, rows_routed_apart=out["apart"],
                                start_s=start_s, launches_per_forward=per_forward,
                                collectives_per_forward=reports[0]["collectives"] / max(sum(n.values()), 1),
                                kv_tokens=[rep["kv_tokens"] for rep in reports])
    return result


# quantized weights at tp 2 (phase_tp_quant): label -> (the tp 1 engine it
# is held to, quantization, KV pages, collectives a layer: W4A8 adds each
# row-parallel projection's row maximum). The Llama-3.1-8B W4A8 pair at
# TP_QUANT_LAYERS layers, its tp 1 twin (no 4-bit head, as no tp 2 engine
# has one) freed before the ranks start; the others held to the engines of
# their own phases, alive beside the ranks (GPT-OSS's at one routing).
TP_QUANT = {
    "llama-3.1-8b-w4a8-tp2": ("llama-3.1-8b-w4a8", "w4a8", "bf16", 4),
    "gpt-oss-20b-w4a8-tp2": ("gpt-oss-w4a8", "w4a8", "int8", 2),
    "gpt-oss-20b-w4a16-tp2": ("gpt-oss-w4a16", "w4a16", "int8", 1),
    "llama-3.1-8b-fp8-tp2": ("llama-3.1-8b-fp8", "fp8", "fp8", 2),
}
TP_QUANT_LAYERS = 8
# a rank's load may peak at its parameters, its largest whole tensor as
# drawn (f32; a weight kept unquantized is copied from the rank's view of
# it, a quantized one is far smaller) and this much besides (a quantized
# weight's model-dtype copy and the quantizer's temporaries, the
# allocator's blocks)
LOAD_SLACK = 512 << 20


def tp_quant_launches(cfg, quantization: str):
    """(the W4 GEMM's wrapper, its launches a forward on a tp 2 rank by
    group size, the row quantizer's launches a forward), predicted from the
    shard shapes: each 4-bit projection once a layer (every expert's, in
    the masked dense loop; GPT-OSS's whole on every rank), at the group of
    its whole input (a row-parallel slice keeps its layer's group); the
    quantizer once a W4A8 projection; the head in bf16. fp8: none."""
    from scratchpad_tpu_torch.ops.quant.w4a16 import stacked_group_size

    if quantization == "fp8":
        return None, {}, 0
    H = cfg.hidden_size
    ins = [H, H, H, cfg.num_attention_heads * cfg.head_dim]  # q, k, v, o
    if cfg.num_experts:  # GPT-OSS: every expert's gate|up and down
        ins += [H, cfg.intermediate_size] * cfg.num_experts
    else:  # the fused gate|up, down
        ins += [H, cfg.intermediate_size]
    groups = collections.Counter(stacked_group_size(w) for w in ins)
    per_forward = {g: n * cfg.num_hidden_layers for g, n in groups.items()}
    wrapper = "w4a8_matmul" if quantization == "w4a8" else "w4a16_matmul"
    return wrapper, per_forward, sum(per_forward.values()) if quantization == "w4a8" else 0


def largest_whole_bytes(cfg) -> int:
    """f32 bytes of the model's largest single-device tensor that a rank
    draws or converts whole: the embedding or head (V x H), or an MLP's
    gate|up (2I x H)."""
    return 4 * max(cfg.vocab_size * cfg.hidden_size, 2 * cfg.intermediate_size * cfg.hidden_size)


def check_quantizer_given_amax(errs: dict) -> None:
    """The row quantizer with a given row maximum (a tensor-parallel rank's
    W4A8 row-parallel projection: its slice of the row, the whole row's
    maximum) bit for bit against its plain version on the same inputs, and
    equal to the whole row's codes at the slice, at the tp 2 shares of
    Llama-3.1-8B's o (2,048 of 4,096) and down (7,168 of 14,336) and M 1,
    64, 300 and 2,048 (row M // 2 zeros)."""
    import torch

    from scratchpad_tpu_torch.ops.quant.w4_matmul import quantize_activations_plain, quantize_rows_int8, row_amax

    g = 128
    for In in (4096, 14336):
        for M in (1, 64, 300, 2048):
            gen = seeded(7000 + In + M)
            x = torch.randn(M, In, generator=gen, device="cuda").to(torch.bfloat16)
            x[M // 2] = 0
            whole = quantize_activations_plain(x, g)
            parts = [p.contiguous() for p in x.chunk(TP_SIZE, dim=1)]
            amax = torch.maximum(*(row_amax(p) for p in parts))
            exact = at_slice = True
            for r, part in enumerate(parts):
                got = quantize_rows_int8(part, g, amax)
                ref = quantize_activations_plain(part, g, amax)
                exact &= all(torch.equal(a, b) for a, b in zip(got, ref))
                n = In // TP_SIZE
                at_slice &= torch.equal(got[0], whole[0][:, r * n : (r + 1) * n]) and torch.equal(got[1], whole[1])
                eq = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, ref))
                errs["quantize_rows_int8"] = max(errs["quantize_rows_int8"], eq)
            log(f"[check] quantizer, given row maximum, a rank's {In // TP_SIZE} of {In} M={M}: bit-equal to "
                f"plain {exact}, the whole row's codes at the slice {at_slice}")
            check(exact and at_slice, f"the quantizer with a given maximum parts at In {In} M {M}")


def phase_tp_quant(tp1, label: str, engines: dict) -> dict:
    """Quantized weights at tp 2 on the one card: the configurations of
    ``TP_QUANT`` held to the tp 1 engine ``tp1`` of ``label`` (None: the
    Llama-3.1-8B W4A8 twin at ``TP_QUANT_LAYERS``, built here and freed
    before the ranks start), each at full width and that engine's depth,
    seed 0 (each rank draws the tp 1 tensors whole, quantizes and cuts
    them), two ranks on cuda:0 over gloo, through ``check_tp_engine``
    (3e-2 of max|logit| on bf16 KV, 1e-1 on 8-bit KV or activations). On
    top of its checks, on every rank: the W4 GEMMs' launches by group size
    and the row quantizer's exactly as ``tp_quant_launches`` predicts, the
    collectives exactly (``TP_QUANT``'s a layer, plus 2), and its load's
    peak within its parameters, its largest whole tensor in f32 and
    ``LOAD_SLACK``. One ``[tp <label>]`` line each."""
    from scratchpad_tpu_torch.config.model_config import get_preset

    result = {}
    for tp_label in (k for k, v in TP_QUANT.items() if v[0] == label):
        _, quantization, pages, per_layer = TP_QUANT[tp_label]
        t = time.monotonic()
        if tp1 is None:  # the tp 1 twin, freed before the ranks start
            cfg = get_preset(TP_PRESET, num_hidden_layers=TP_QUANT_LAYERS)
            twin = make_engine(quantization, model_config=cfg, max_total_tokens=TP_KV_TOKENS, quantize_lm_head=False)
            check(twin.scheduler.runner.model.lm_head_q is None, f"{tp_label}: the tp 1 twin has a 4-bit head")
            ref = tp_reference(twin, tp_label)
            # the twin's own kernel path against its plain path on the same
            # inputs: how far two bf16 paths over these codes part
            prompts, _, _ = tp_traffic(cfg.vocab_size)
            with PlainPath(twin.scheduler.runner.model):
                plain = batch_logits(twin.scheduler.runner, prompts, [o[0] for o in ref["ids"]])
            control = max(float((a.float().cpu() - b.float().cpu()).abs().max()) / float(b.float().abs().max())
                          for step in (0, 1) for a, b in zip(ref["logits"][step], plain[step]))
            del twin, plain
        else:
            cfg, control = tp1.model_config, None
            ref = tp_reference(tp1, tp_label)
        ref_s = time.monotonic() - t
        launches = {DECODE[pages]: "decode", EXTEND[pages]: "extend"}
        kv = ref["kv"] if ref["kv"] in ("int8", "fp8") else "auto"  # "auto": the model dtype at tp 2
        t = time.monotonic()
        engine = make_engine(quantization, model_config=cfg, kv_cache_dtype=kv, max_total_tokens=TP_FAMILY_KV_TOKENS,
                             tp_size=TP_SIZE)
        try:
            start_s = time.monotonic() - t
            check(engine.scheduler.runner.kv_cache_dtype == (pages if pages != "bf16" else "bfloat16"),
                  f"{tp_label}: KV {engine.scheduler.runner.kv_cache_dtype}, not {pages}")
            check(getattr(engine.scheduler.runner.model, "lm_head_q", None) is None, f"{tp_label}: a 4-bit head")
            out = check_tp_engine(engine, ref, tp_label, launches, per_layer,
                                  kv_heads=cfg.num_kv_heads // TP_SIZE, tp1=tp1 if cfg.num_experts else None)
        finally:
            engine.shutdown()
            del engine
        reports, n = out["reports"], out["reports"][0]["forwards"]
        n_fwd = sum(n.values())
        wrapper, w4_per_forward, quant_per_forward = tp_quant_launches(cfg, quantization)
        bound = largest_whole_bytes(cfg)
        for rep in reports:
            r, lc, gl = rep["rank"], rep["launches"], rep["group_launches"]
            for w in ("w4a8_matmul", "w4a16_matmul"):
                want = {g: c * n_fwd for g, c in w4_per_forward.items()} if w == wrapper else {}
                got = {g: c for g, c in gl[w].items() if c}
                check(got == want, f"{tp_label} rank {r}: {w} launched {got} by group in {n_fwd} forwards, not {want}")
            check(lc["w4a8_matmul_mma"] == 0, f"{tp_label} rank {r}: w4a8_matmul_mma launched")
            check(lc["quantize_rows_int8"] == quant_per_forward * n_fwd,
                  f"{tp_label} rank {r}: the quantizer launched {lc['quantize_rows_int8']} times in {n_fwd} "
                  f"forwards, not {quant_per_forward} a forward")
            limit = rep["param_bytes"] + bound + LOAD_SLACK
            check(rep["load_peak_bytes"] <= limit, f"{tp_label} rank {r}: the load peaked at "
                                                   f"{rep['load_peak_bytes']} B, above {limit} B")
        engines[tp_label] = tp_engine_record(reports, tp_label, launches, weights=quantization, preset=label,
                                             kv_cache_dtype=ref["kv"], attention_backend="auto",
                                             worst_logit_rel=out["worst"])
        gib = lambda b: round(b / 2**30, 3)
        per_fwd = lambda k, mode=None: [rep["launches"][k] / max(n[mode] if mode else n_fwd, 1) for rep in reports]
        w4_by_rank = ({g: [rep["group_launches"][wrapper].get(g, 0) / max(n_fwd, 1) for rep in reports]
                       for g in w4_per_forward} if wrapper else {})
        L = cfg.num_hidden_layers
        log(
            f"[tp {tp_label}] {cfg.architecture} {quantization} at {L} layers, {ref['kv']} KV, against "
            f"{label} (reference {ref_s:.1f} s), started in {start_s:.1f} s; parameters a rank "
            f"{[gib(rep['param_bytes']) for rep in reports]} GiB against {gib(ref['param_bytes'])} GiB at tp 1; "
            f"load peak a rank {[gib(rep['load_peak_bytes']) for rep in reports]} GiB (bound: parameters + "
            f"{gib(bound)} GiB + {gib(LOAD_SLACK)} GiB); forwards {n}, collectives a forward "
            f"{reports[0]['collectives'] / max(n_fwd, 1):.1f} ({per_layer} x {L} layers + 2); {wrapper or 'no W4 GEMM'}"
            f" a forward by group and rank {w4_by_rank}; quantize_rows_int8 a forward by rank "
            f"{per_fwd('quantize_rows_int8')}; attention a forward of its mode by rank "
            f"{ {k: per_fwd(k, mode) for k, mode in launches.items()} }; {reports[0]['tokens_sampled']} sampled ids"
            + (f" and {reports[0]['router_picks']} router picks" if cfg.num_experts else "")
            + f" bit-equal on every rank; logits against tp 1" + (" at tp 2's routing" if cfg.num_experts else "")
            + f": worst max|diff| {out['worst']:.3e} of max|logit| (tol {LOGIT_RTOL[tp_label]}), argmax differs on "
            f"{out['flips']} of {out['rows']} rows"
            + (f"; at tp 1's own routing {out['own_worst']:.3e}" if cfg.num_experts else "")
            + (f"; tp 1's own kernel path against its plain path {control:.3e}" if control is not None else "")
            + f"; greedy ids part from tp 1 in {out['parted']} of {len(TP_REQUESTS)} requests"
        )
        result[tp_label] = dict(
            worst_logit_rel=out["worst"], flips=out["flips"], parted=out["parted"], start_s=start_s,
            own_routing_worst=out["own_worst"] if cfg.num_experts else None, tp1_kernel_vs_plain=control,
            param_gib=[gib(rep["param_bytes"]) for rep in reports],
            load_peak_gib=[gib(rep["load_peak_bytes"]) for rep in reports],
            collectives_per_forward=reports[0]["collectives"] / max(n_fwd, 1),
            w4_per_forward_by_group=w4_by_rank, quantizer_per_forward=per_fwd("quantize_rows_int8"),
        )
    return result


KERNELS = {
    "paged_decode_attention": dict(
        route="cuda",
        source="scratchpad_tpu_torch/csrc/paged_decode_attention.cu",
        replaces="scratchpad_tpu/ops/attention/gqa_decode.py:92 (_gqa_decode_kernel) "
        "and :446 (_gqa_decode_grouped_kernel)",
    ),
    "paged_extend_attention": dict(
        route="cuda",
        source="scratchpad_tpu_torch/csrc/paged_extend_attention.cu",
        replaces="scratchpad_tpu/ops/attention/ragged_backend.py:90 "
        "(bundled ragged_paged_attention via _ragged_call)",
    ),
    "paged_decode_attention_quant": dict(
        route="cuda",
        source="scratchpad_tpu_torch/csrc/paged_decode_attention.cu",
        replaces="scratchpad_tpu/ops/attention/gqa_decode.py:92 (_gqa_decode_kernel, "
        "quantized branch :371-405) and :446 (_gqa_decode_grouped_kernel, quantized "
        "branch :606-642)",
    ),
    "paged_extend_attention_quant": dict(
        route="cuda",
        source="scratchpad_tpu_torch/csrc/paged_extend_attention.cu",
        replaces="scratchpad_tpu/ops/attention/ragged_backend.py:90 (bundled "
        "ragged_paged_attention via _ragged_call) on the pages of dequant_pages :175 "
        "(attention_ragged_quant :254)",
    ),
    "quantize_rows_int8": dict(
        route="cuda",
        source="scratchpad_tpu_torch/csrc/w4a8_matmul.cu",
        replaces="scratchpad_tpu/ops/quant/pallas_w4.py:452-461 (the int8 activation "
        "quantization of _w4_q4_call, outside the Pallas kernel)",
    ),
    "w4a8_matmul": dict(
        route="cuda",
        source="scratchpad_tpu_torch/csrc/w4a8_matmul.cu",
        replaces="scratchpad_tpu/ops/quant/pallas_w4.py:363 (_w4a8_kernel_q4) "
        "and :139 (_w4a8_kernel, groups of 32 and more: split steps)",
    ),
    # the groups below a 32-deep k step: the mma.sync kernel
    "w4a8_matmul_mma": dict(
        route="cuda",
        source="scratchpad_tpu_torch/csrc/w4a8_matmul.cu",
        replaces="scratchpad_tpu/ops/quant/pallas_w4.py:139 (_w4a8_kernel, groups below 32)",
    ),
    "w4a16_matmul": dict(
        route="cuda",
        source="scratchpad_tpu_torch/csrc/w4a16_matmul.cu",
        replaces="scratchpad_tpu/ops/quant/pallas_w4.py:394 (_w4_kernel_q4) "
        "and :27 (_w4_kernel)",
    ),
    "delta_matmul_grouped": dict(
        route="cuda",
        source="scratchpad_tpu_torch/csrc/delta_matmul.cu",
        replaces="scratchpad_tpu/ops/ldmm.py:51 (_delta_kernel, launched :121 by delta_matmul :72)",
    ),
    # the decode kernel of row 1, through its own wrapper (with its own count)
    "decode_attention_pallas": dict(
        route="cuda",
        source="scratchpad_tpu_torch/csrc/paged_decode_attention.cu",
        replaces="scratchpad_tpu/ops/attention/pallas_decode.py:34 (_decode_kernel, launched :177)",
    ),
    "decode_ablate": dict(
        route="cuda",
        source="scratchpad_tpu_torch/csrc/decode_ablate.cu",
        replaces="tools/profiling/_ablate.py:11 (make_kernel, launched :106)",
    ),
    # the head_dim 256 branch of rows 1 and 3 with Gemma's per-layer windows,
    # through the bf16 wrappers (their launches: the gemma-2-2b engine's)
    DECODE_256: dict(
        route="cuda",
        source="scratchpad_tpu_torch/csrc/paged_decode_attention.cu",
        replaces="scratchpad_tpu/ops/attention/gqa_decode.py:92 (_gqa_decode_kernel at Dp 256, "
        "dynamic_window :102, 112-117, 169-170)",
    ),
    EXTEND_256: dict(
        route="cuda",
        source="scratchpad_tpu_torch/csrc/paged_extend_attention.cu",
        replaces="scratchpad_tpu/ops/attention/ragged_backend.py:90 (bundled ragged_paged_attention "
        "via _ragged_call; at head_dim 256 the JAX package extends in XLA, "
        "executor/model_runner.py:185)",
    ),
    # the sinks branch of rows 1 and 3 (GPT-OSS), through the bf16 wrappers
    # (their launches: the gpt-oss-20b engine's)
    DECODE_SINKS: dict(
        route="cuda",
        source="scratchpad_tpu_torch/csrc/paged_decode_attention.cu",
        replaces="scratchpad_tpu/ops/attention/gqa_decode.py:92 (_gqa_decode_kernel, with_sinks "
        ":128-133, :421-425) and :446 (_gqa_decode_grouped_kernel, with_sinks :493-496, :637-641)",
    ),
    EXTEND_SINKS: dict(
        route="cuda",
        source="scratchpad_tpu_torch/csrc/paged_extend_attention.cu",
        replaces="scratchpad_tpu/ops/attention/ragged_backend.py:90 (bundled ragged_paged_attention "
        "via _ragged_call; with sinks the JAX package extends in XLA, xla_backend.py:508-515, "
        "models/gpt_oss.py:54)",
    ),
    # the chunk branch of rows 1 and 3 (Llama-4), through the bf16 wrappers
    # (their launches: the llama4-scout engine's)
    DECODE_CHUNK: dict(
        route="cuda",
        source="scratchpad_tpu_torch/csrc/paged_decode_attention.cu",
        replaces="scratchpad_tpu/ops/attention/gqa_decode.py:92 (_gqa_decode_kernel, chunk_size: "
        "mask_start :166-168, first_chunk :175-181)",
    ),
    EXTEND_CHUNK: dict(
        route="cuda",
        source="scratchpad_tpu_torch/csrc/paged_extend_attention.cu",
        replaces="scratchpad_tpu/ops/attention/ragged_backend.py:90 (bundled ragged_paged_attention "
        "via _ragged_call; with a chunk the JAX package extends in XLA, xla_backend.py:479-483, "
        "models/llama4.py:48)",
    ),
    # rows 1dq and 3dq: 8-bit pages at head_dim 256 (Gemma on int8 or fp8
    # KV), through the 8-bit wrappers (their launches: the gemma-2-2b-int8kv
    # engine's)
    DECODE_256_8BIT: dict(
        route="cuda",
        source="scratchpad_tpu_torch/csrc/paged_decode_attention.cu",
        replaces="scratchpad_tpu/ops/attention/gqa_decode.py:92 (_gqa_decode_kernel at Dp 256, "
        "quantized branch :120-142, :281-290, :323-331, :371-405, dynamic_window :102, 112-117)",
    ),
    EXTEND_256_8BIT: dict(
        route="cuda",
        source="scratchpad_tpu_torch/csrc/paged_extend_attention.cu",
        replaces="scratchpad_tpu/ops/attention/ragged_backend.py:90 (bundled ragged_paged_attention "
        "via _ragged_call; on 8-bit pages at head_dim 256 the JAX package extends in XLA, "
        "executor/model_runner.py:456)",
    ),
    # rows 6 and 7 at GPT-OSS's groups of 120, on their served path (the
    # gpt-oss-w4a8 and gpt-oss-w4a16 engines)
    W4A8_G120: dict(
        route="cuda",
        source="scratchpad_tpu_torch/csrc/w4a8_matmul.cu",
        replaces="scratchpad_tpu/ops/quant/pallas_w4.py:139 (_w4a8_kernel, launched :234)",
    ),
    W4A16_G120: dict(
        route="cuda",
        source="scratchpad_tpu_torch/csrc/w4a16_matmul.cu",
        replaces="scratchpad_tpu/ops/quant/pallas_w4.py:27 (_w4_kernel, launched :131)",
    ),
    # rows 3m and 3qm: the span branch (Gemma 3 multimodal), through the
    # bf16 and 8-bit wrappers (their launches with spans: the gemma-3-4b-mm
    # and gemma-3-4b-mm-fp8kv engines')
    EXTEND_SPANS: dict(
        route="cuda",
        source="scratchpad_tpu_torch/csrc/paged_extend_attention.cu",
        replaces="scratchpad_tpu/ops/attention/ragged_backend.py:90 (bundled ragged_paged_attention "
        "via _ragged_call; with image spans the JAX package extends in XLA, xla_backend.py:484-507, "
        "models/gemma.py:326)",
    ),
    EXTEND_SPANS_8BIT: dict(
        route="cuda",
        source="scratchpad_tpu_torch/csrc/paged_extend_attention.cu",
        replaces="scratchpad_tpu/ops/attention/ragged_backend.py:90 (bundled ragged_paged_attention "
        "via _ragged_call; on 8-bit pages with image spans the JAX package extends in XLA, "
        "xla_backend.py:484-507)",
    ),
    # rows 1 and 3 on a tensor-parallel rank's heads (Llama-3.1-8B at tp 2:
    # Hkv 4, G 4, D 128), launched by both ranks (phase_tp)
    DECODE_TP: dict(
        route="cuda",
        source="scratchpad_tpu_torch/csrc/paged_decode_attention.cu",
        replaces="scratchpad_tpu/ops/attention/gqa_decode.py:92 (_gqa_decode_kernel) and :446 "
        "(_gqa_decode_grouped_kernel), on each rank's heads through make_decode_attention_gqa_tp :1114",
    ),
    EXTEND_TP: dict(
        route="cuda",
        source="scratchpad_tpu_torch/csrc/paged_extend_attention.cu",
        replaces="scratchpad_tpu/ops/attention/ragged_backend.py:90 (bundled ragged_paged_attention "
        "via _ragged_call), on each rank's heads through make_attention_ragged_tp :513",
    ),
}
# the wrapper whose launch count a kernel entry reports, where it is not the
# entry's own name, and the group size whose launches it counts, where it
# counts only one (GPT-OSS's W4 engines launch rows 6 and 7 at groups of
# 120, and rows 5 and 4 at o's 128)
KERNEL_GROUP = {W4A8_G120: 120, W4A16_G120: 120}
KERNEL_WRAPPER = {
    DECODE_256: "paged_decode_attention", EXTEND_256: "paged_extend_attention",
    DECODE_SINKS: "paged_decode_attention", EXTEND_SINKS: "paged_extend_attention",
    DECODE_CHUNK: "paged_decode_attention", EXTEND_CHUNK: "paged_extend_attention",
    W4A8_G120: "w4a8_matmul", W4A16_G120: "w4a16_matmul",
    DECODE_256_8BIT: "paged_decode_attention_quant", EXTEND_256_8BIT: "paged_extend_attention_quant",
    DECODE_TP: "paged_decode_attention", EXTEND_TP: "paged_extend_attention",
}
# the engine run whose launches each kernel's entry reports
KERNEL_ENGINE = {
    "paged_decode_attention": "bf16", "paged_extend_attention": "bf16",
    "paged_decode_attention_quant": "3b-w4a8", "paged_extend_attention_quant": "3b-w4a8",
    "quantize_rows_int8": "w4a8", "w4a8_matmul": "w4a8", "w4a16_matmul": "w4a16",
    "delta_matmul_grouped": "1b-toppings", "decode_attention_pallas": "mistral-7b-pallas",
    DECODE_256: "gemma-2-2b", EXTEND_256: "gemma-2-2b",
    DECODE_SINKS: "gpt-oss-20b", EXTEND_SINKS: "gpt-oss-20b",
    DECODE_CHUNK: "llama4-scout", EXTEND_CHUNK: "llama4-scout",
    W4A8_G120: "gpt-oss-w4a8", W4A16_G120: "gpt-oss-w4a16",
    DECODE_256_8BIT: "gemma-2-2b-int8kv", EXTEND_256_8BIT: "gemma-2-2b-int8kv",
    EXTEND_SPANS: "gemma-3-4b-mm", EXTEND_SPANS_8BIT: "gemma-3-4b-mm-fp8kv",
    DECODE_TP: "llama-3.1-8b-tp2", EXTEND_TP: "llama-3.1-8b-tp2",
}


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA device")
    if not (ROOT / "scratchpad_tpu_torch" / "csrc").is_dir():
        fail(f"{ROOT} is not a checkout of the repository (no scratchpad_tpu_torch/)")
    sys.path.insert(0, str(ROOT))
    t0 = time.monotonic()

    def timed(fn, *args):  # a phase, and its seconds on a line of its own
        t = time.monotonic()
        out = fn(*args)
        log(f"[phase] {fn.__name__}: {time.monotonic() - t:.1f} s")
        return out

    device_name, smi_line = phase_device()
    timed(phase_build)
    errs = {k: 0.0 for k in KERNELS}
    for fn in (check_decode, check_extend, check_window_decode, check_window_extend, check_pallas_decode,
               check_decode_256, check_extend_256, check_decode_256_8bit, check_extend_256_8bit,
               check_sinks, check_chunks, check_spans, check_tp_heads):
        timed(fn, errs)
    timed(check_window_sequence_256)
    timed(check_kv_quantizer)
    timed(check_w4, errs)
    timed(check_quantizer_given_amax, errs)
    timed(check_delta, errs)
    timed(check_decode_ablate, errs)
    timed(check_decode_stages)
    # the timed runs follow each engine's checks, and only while every
    # check holds: a faulty tree shows all its readings, quickly
    engines = {}
    w4a8 = ("quantize_rows_int8", "w4a8_matmul")

    def serve(engine, label, w4_kernels=(), logits=True, toppings=None, timed=True,
              requests=REQUESTS, shared_len=600, sink_move=False, witness=False):
        t = time.monotonic()
        engines[label] = phase_engine(engine, label, w4_kernels, logits, toppings, requests, shared_len,
                                      sink_move, witness)
        t_times = time.monotonic()
        if timed and not FAILURES:
            phase_engine_times(engine, engines[label], label)
        log(
            f"[engine {label}] phase wall: {t_times - t:.1f} s serving and checking, "
            f"{time.monotonic() - t_times:.1f} s timing"
        )

    from scratchpad_tpu_torch.config import ModelConfig, ServerArgs
    from scratchpad_tpu_torch.config.model_config import get_preset
    from scratchpad_tpu_torch.executor.model_runner import resolve_kv_cache_dtype

    t_engines = time.monotonic()
    tp_families, tp_seconds = {}, []  # phase_tp_families' results, one call a tp 1 family engine

    def tp_family(engine, label):  # the tp 2 configurations held to this tp 1 engine
        t = time.monotonic()
        tp_families.update(timed(phase_tp_families, engine, label, engines))
        tp_seconds.append(time.monotonic() - t)

    engine = make_engine()
    serve(engine, "bf16")
    # the serving surface on the same engine and weights: the HTTP server
    # over the async runner, overlap at its default (on); then the bench
    # batch with overlap on and off in turns
    served = timed(phase_serve, engine)
    if not FAILURES:
        engines["bf16"]["overlap"] = timed(phase_overlap, engine)
    # custom logit processors on the same engine: banned ids, a per-row
    # boost and free rows in one batch, none of them in a pipelined window
    custom = timed(phase_custom, engine)
    # toppings on the same engine and weights, served and checked but not
    # timed: at its 90 to 130 ms of host a step its timed runs took a fifth
    # to a quarter of the script's wall (PERF.md §5 keeps its last rates)
    states = topping_states(engine.model_config)
    register_toppings(engine, states, "1b-toppings")
    serve(engine, "1b-toppings", toppings=TOPPINGS, timed=False, requests=TOPPINGS_REQUESTS)
    p1b = engine.scheduler.runner.model.state_dict()  # for the spec and memory engines
    del engine  # frees the pool for the next engine
    # constrained decoding, Engine.generate and HTTP, on the same weights
    # drawn again, with the tokenizer a user names: tokenizer_path="chars"
    engine = make_engine(tokenizer_path="chars")
    grammar = timed(phase_grammar, engine)
    del engine
    # speculative decoding (ngram, draft model, EAGLE) and the memory extras
    # (host KV tier, pool resize, weight update, parameter offload)
    specs = timed(phase_specs, p1b)
    memory = timed(phase_memory, p1b)
    del p1b
    # tensor parallelism: Llama-3.1-8B at tp 2, two ranks on the one card
    tp, tp_timing = timed(phase_tp, errs, engines)
    # quantized weights at tp 2 (phase_tp_quant): Llama-3.1-8B W4A8 against
    # its tp 1 twin here; GPT-OSS W4 and Llama-3.1-8B fp8 after their own
    # engines' phases, against them
    tp_quant = timed(phase_tp_quant, None, "llama-3.1-8b-w4a8", engines)
    engine = make_engine("w4a8")
    serve(engine, "w4a8", w4a8)
    # W4A16 on the same engine and codes: every QuantLinear takes the A16 route
    set_w4_route(engine.scheduler.runner.model, a8=False)
    serve(engine, "w4a16", ("w4a16_matmul",))
    engines["w4a16"]["weights"] = "w4a16"
    # the same toppings on W4A8: the fused gate|up split on the card
    set_w4_route(engine.scheduler.runner.model, a8=True)
    register_toppings(engine, states, "w4a8-toppings")
    del states
    serve(engine, "w4a8-toppings", w4a8, toppings=TOPPINGS, timed=False, requests=TOPPINGS_REQUESTS)
    del engine
    # Llama-3.2-3B W4A8: kv_cache_dtype=auto must give int8 KV, as the JAX
    # runner's rule does at hidden x layers = 86,016
    engine = make_engine("w4a8", preset="llama-3.2-3b")
    check(
        engine.scheduler.runner.kv_cache_dtype == "int8",
        f"3B W4A8 auto KV resolved to {engine.scheduler.runner.kv_cache_dtype}, not int8",
    )
    # untimed, to pay for phase_tp_quant's seconds (PERF.md keeps its last
    # timing)
    serve(engine, "3b-w4a8", w4a8, timed=False)
    # the same quantized weights with bf16 KV, the first BF16KV_LAYERS
    # layers (its kernels are held elsewhere: bf16 attention at G = 3 in
    # phase 3 and in the bf16 engine, W4A8 in both W4A8 engines; it is here
    # for its launch counts, so its logits are not checked, and it is no
    # longer timed)
    params = {
        k: t for k, t in engine.scheduler.runner.model.state_dict().items()
        if not k.startswith("layers.") or int(k.split(".")[1]) < BF16KV_LAYERS
    }
    del engine
    engine = make_engine("w4a8", kv_cache_dtype="bfloat16", params=params,
                         model_config=get_preset("llama-3.2-3b", num_hidden_layers=BF16KV_LAYERS))
    del params
    serve(engine, "3b-w4a8-bf16kv", w4a8, logits=False, timed=False, requests=UNTIMED_REQUESTS)
    del engine
    engine = make_engine(kv_cache_dtype="fp8")
    serve(engine, "1b-fp8kv", timed=False)
    del engine
    # Mistral-7B at full width and depth, its window through the decode and
    # extend kernels: attention_backend auto, then pallas on the same
    # weights (drawn again from the same seed)
    # (the pallas engine keeps the first MISTRAL_PALLAS_LAYERS layers: the
    # same weights there, drawn from the same seed)
    fingerprints = []
    for label, backend, layers in (("mistral-7b", "auto", MISTRAL_7B["num_hidden_layers"]),
                                   ("mistral-7b-pallas", "pallas", MISTRAL_PALLAS_LAYERS)):
        engine = make_engine(
            model_config=ModelConfig.from_hf_config(dict(MISTRAL_7B, num_hidden_layers=layers)),
            attention_backend=backend,
        )
        fingerprints.append(weights_fingerprint(engine.scheduler.runner.model, MISTRAL_PALLAS_LAYERS))
        # untimed, to pay for phase_tp_quant's seconds (PERF.md keeps its
        # last timing)
        serve(engine, label, requests=WINDOW_REQUESTS if backend == "auto" else WINDOW_REQUESTS[3:], timed=False)
        del engine
    check(fingerprints[0] == fingerprints[1], f"the Mistral engines' weights differ: {fingerprints}")
    # Qwen3-8B at full width and depth, bf16: qk-norm, an untied head; not
    # timed, to pay for phase_tp_families (PERF.md keeps its last timing)
    engine = make_engine(preset="qwen3-8b")
    serve(engine, "qwen3-8b", timed=False)
    del engine
    # Qwen3-8B W4A8, cut in depth, with the int8 KV that kv_cache_dtype auto
    # gives the full model (logits only; its kernels are held elsewhere)

    auto_kv = resolve_kv_cache_dtype(
        ServerArgs(preset="qwen3-8b", quantization="w4a8").resolve(), get_preset("qwen3-8b"),
        torch.device("cuda"),
    )
    check(auto_kv == "int8", f"Qwen3-8B W4A8 auto KV resolved to {auto_kv}, not int8")
    # ... and at tp 2, the model dtype (the JAX rule's mesh is None)
    auto_kv = resolve_kv_cache_dtype(
        ServerArgs(preset="qwen3-8b", quantization="w4a8", tp_size=TP_SIZE).resolve(), get_preset("qwen3-8b"),
        torch.device("cuda"),
    )
    check(auto_kv == "bfloat16", f"Qwen3-8B W4A8 auto KV at tp {TP_SIZE} resolved to {auto_kv}, not bfloat16")
    engine = make_engine("w4a8", kv_cache_dtype="int8",
                         model_config=get_preset("qwen3-8b", num_hidden_layers=QWEN3_W4A8_LAYERS))
    serve(engine, "qwen3-8b-w4a8", w4a8, timed=False, requests=UNTIMED_REQUESTS)
    del engine
    # Gemma-2-2B at full width and GEMMA2_LAYERS layers, bf16: head_dim 256,
    # local layers (window 4096) and global ones in turn, attention cap 50,
    # final cap 30
    engine = make_engine(model_config=get_preset("gemma-2-2b", num_hidden_layers=GEMMA2_LAYERS),
                         max_total_tokens=TP1_KV_TOKENS)
    serve(engine, "gemma-2-2b", requests=WINDOW_REQUESTS, timed=False)
    tp_family(engine, "gemma-2-2b")
    del engine
    # Gemma-2-2B on int8 KV (rows 1dq and 3dq on a served path), GEMMA_KV8_LAYERS
    # layers: local and global layers in turn, prompts across the window's edge
    engine = make_engine(kv_cache_dtype="int8", max_total_tokens=TP1_KV_TOKENS,
                         model_config=get_preset("gemma-2-2b", num_hidden_layers=GEMMA_KV8_LAYERS))
    serve(engine, "gemma-2-2b-int8kv", timed=False, requests=GEMMA_KV8_REQUESTS)
    tp_family(engine, "gemma-2-2b-int8kv")
    del engine
    # the same on fp8 KV, at the same depth
    engine = make_engine(kv_cache_dtype="fp8",
                         model_config=get_preset("gemma-2-2b", num_hidden_layers=GEMMA_KV8_LAYERS))
    serve(engine, "gemma-2-2b-fp8kv", timed=False, requests=GEMMA_KV8_REQUESTS)
    del engine
    # Gemma-3-1B (its config.json): qk-norm, two rope bases, window 512 on
    # five layers of six, G 4 over one kv head
    engine = make_engine(model_config=ModelConfig.from_hf_config(
        dict(GEMMA3_1B, num_hidden_layers=GEMMA3_LAYERS)))
    serve(engine, "gemma-3-1b", requests=GEMMA3_REQUESTS, timed=False, shared_len=GEMMA3_SHARED)
    del engine
    # GPT-OSS-20B at full width and GPT_OSS_LAYERS layers, bf16: sinks through
    # both attention kernels, a window of 128 on alternate layers, 32 experts
    # (top 4) in the masked loop; dropping the sinks must move its logits
    engine = make_engine(model_config=get_preset("gpt-oss-20b", num_hidden_layers=GPT_OSS_LAYERS),
                         max_total_tokens=TP1_KV_TOKENS)
    serve(engine, "gpt-oss-20b", requests=GPT_OSS_REQUESTS, sink_move=True, witness=True, timed=False)
    tp_family(engine, "gpt-oss-20b")
    del engine
    # W4: kv_cache_dtype auto keeps GPT-OSS-20B's KV in bf16, as the JAX rule
    # does (no kernel backend), and gives Qwen3-30B-A3B int8
    for model_name, cfg, want in (("gpt-oss-20b", get_preset("gpt-oss-20b"), "bfloat16"),
                                  ("Qwen3-30B-A3B", ModelConfig.from_hf_config(QWEN3_30B_A3B), "int8")):
        got = resolve_kv_cache_dtype(ServerArgs(quantization="w4a8").resolve(), cfg, torch.device("cuda"))
        check(got == want, f"{model_name} W4A8 auto KV resolved to {got}, not {want}")
    # GPT-OSS W4, one local and one global layer, int8 KV: W4A8, then W4A16
    # on the same codes (rows 6 and 7 at its groups of 120 on a served path)
    engine = make_engine("w4a8", kv_cache_dtype="int8",
                         model_config=get_preset("gpt-oss-20b", num_hidden_layers=GPT_OSS_W4_LAYERS))
    serve(engine, "gpt-oss-w4a8", w4a8, timed=False, requests=GPT_OSS_W4_REQUESTS)
    tp_quant.update(timed(phase_tp_quant, engine, "gpt-oss-w4a8", engines))
    set_w4_route(engine.scheduler.runner.model, a8=False)
    serve(engine, "gpt-oss-w4a16", ("w4a16_matmul",), timed=False, requests=GPT_OSS_W4_REQUESTS)
    engines["gpt-oss-w4a16"]["weights"] = "w4a16"
    tp_quant.update(timed(phase_tp_quant, engine, "gpt-oss-w4a16", engines))
    del engine
    # Qwen3-30B-A3B (its config.json) at QWEN3_MOE_LAYERS layers, bf16: 128
    # experts (top 8) in the masked loop, qk-norm
    engine = make_engine(model_config=ModelConfig.from_hf_config(
        dict(QWEN3_30B_A3B, num_hidden_layers=QWEN3_MOE_LAYERS)), max_total_tokens=TP1_KV_TOKENS)
    serve(engine, "qwen3-30b-a3b", timed=False, requests=UNTIMED_REQUESTS)
    tp_family(engine, "qwen3-30b-a3b")
    del engine
    # Llama-4 Scout's text decoder (LLAMA4_SCOUT, its config) at
    # LLAMA4_LAYERS layers, bf16: the chunk of 8192 through both attention
    # kernels on its rope layers, a global NoPE layer with the temperature,
    # 16 experts (top 1) masked and dense beside the shared expert, G 5;
    # dropping the chunk must move the logits of the rows past its edge
    engine = make_engine(model_config=ModelConfig.from_hf_config(
        dict(LLAMA4_SCOUT, num_hidden_layers=LLAMA4_LAYERS)), max_total_tokens=LLAMA4_KV_TOKENS)
    chunks = engine.scheduler.runner.model.layer_chunks
    check(chunks == [8192, 8192, 8192, None], f"llama4-scout's layer chunks are {chunks}")
    serve(engine, "llama4-scout", timed=False, requests=LLAMA4_REQUESTS)
    tp_family(engine, "llama4-scout")
    del engine
    # DeepSeek-V2-Lite (its config.json) at full width and DEEPSEEK_LAYERS
    # layers, bf16:
    # multi-head latent attention in torch over the latent pool (one
    # [c_kv | k_rope] row of 576 a token and layer; no attention kernel),
    # YaRN on the rope dims, one dense layer, then 64 routed experts (top 6,
    # softmax greedy) masked and dense beside 2 shared ones; its logits held
    # against HF's expanded form at the kernel path's routing
    engine = make_engine(model_config=ModelConfig.from_hf_config(
        dict(DEEPSEEK_V2_LITE, num_hidden_layers=DEEPSEEK_LAYERS)), max_total_tokens=TP1_KV_TOKENS)
    runner = engine.scheduler.runner
    log(
        f"[engine deepseek-v2-lite] latent pool: {runner.max_total_num_tokens} KV tokens of "
        f"{runner.kv_bytes_per_token()} B (layers x (kv_lora_rank + qk_rope_head_dim) x 2)"
    )
    kv_bytes = DEEPSEEK_KV_BYTES_A_LAYER * DEEPSEEK_LAYERS
    check(runner.kv_cache.mla and runner.kv_bytes_per_token() == kv_bytes,
          f"deepseek-v2-lite: {runner.kv_bytes_per_token()} KV bytes a token, not {kv_bytes}")
    del runner
    serve(engine, "deepseek-v2-lite", timed=False, requests=UNTIMED_REQUESTS, witness=True)
    tp_family(engine, "deepseek-v2-lite")
    del engine
    tp_families["seconds"] = sum(tp_seconds)
    log(f"[tp] the other text families at tp {TP_SIZE} on one card, {card_line()}: "
        f"phase_tp_families {tp_families['seconds']:.1f} s in all")
    # Apertus-8B (its config.json) at APERTUS_LAYERS of its 32 layers, bf16,
    # untimed: weighted qk-norm, the gateless xIELU MLP, G 4 at head_dim 128
    # through both attention kernels
    engine = make_engine(model_config=ModelConfig.from_hf_config(
        dict(APERTUS_8B, num_hidden_layers=APERTUS_LAYERS)))
    serve(engine, "apertus-8b", timed=False, requests=UNTIMED_REQUESTS)
    del engine
    # the vision engines, untimed: images and a video through the towers,
    # the vision rows spliced into the decoders, Qwen2-VL's multimodal rope,
    # Gemma 3's bidirectional spans through rows 3m (bf16 KV) and 3qm (fp8
    # KV, the same weights)
    engine = make_engine(preset="qwen2-vl-2b")
    engines["qwen2-vl-2b"] = timed(phase_vlm, engine, "qwen2-vl-2b")
    del engine
    engine = make_engine(model_config=ModelConfig.from_hf_config(
        dict(GEMMA3_4B_MM, text_config=dict(GEMMA3_4B_MM["text_config"], num_hidden_layers=GEMMA3_MM_LAYERS))))
    engines["gemma-3-4b-mm"] = timed(phase_vlm, engine, "gemma-3-4b-mm", True)
    params = engine.scheduler.runner.model.state_dict()
    cfg = engine.model_config
    del engine
    engine = make_engine(kv_cache_dtype="fp8", params=params, model_config=cfg)
    del params
    engines["gemma-3-4b-mm-fp8kv"] = timed(phase_vlm, engine, "gemma-3-4b-mm-fp8kv", True)
    del engine
    engine = make_engine(model_config=ModelConfig.from_hf_config(
        dict(LLAVA_15_7B, text_config=dict(LLAVA_15_7B["text_config"], num_hidden_layers=LLAVA_LAYERS))))
    engines["llava-1.5-7b"] = timed(phase_vlm, engine, "llava-1.5-7b")
    del engine
    # Mllama: Llama-3.2-11B-Vision's tiled tower at full depth, its decoder
    # cut to MLLAMA_LAYERS (two cross layers), two cross slots
    engine = make_engine(model_config=ModelConfig.from_hf_config(dict(
        LLAMA32_11B_VISION, text_config=dict(LLAMA32_11B_VISION["text_config"], num_hidden_layers=MLLAMA_LAYERS))),
        cross_kv_slots=MLLAMA_SLOTS)
    engines["llama-3.2-11b-vision"] = timed(phase_mllama, engine)
    del engine
    # Llama-3.1-8B with fp8 weights and fp8 KV (BASELINE config 4), cut in
    # depth: its weights' bytes against the same layers in bf16
    engine = make_engine("fp8", kv_cache_dtype="fp8",
                         model_config=get_preset("llama-3.1-8b", num_hidden_layers=FP8_LAYERS))
    log_fp8_bytes(engine)
    serve(engine, "llama-3.1-8b-fp8", timed=False, requests=UNTIMED_REQUESTS)
    tp_quant.update(timed(phase_tp_quant, engine, "llama-3.1-8b-fp8", engines))
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    if FAILURES:
        fail(f"{len(FAILURES)} correctness checks failed; the first: {FAILURES[0]}")
    log(f"[phase] engines: {time.monotonic() - t_engines:.1f} s")
    timing = timed(phase_timing)
    timing.update(tp_timing)
    w4_times = timed(phase_w4_timing)
    timing.update({k: [v] for k, v in w4_times["per_forward"].items()})
    g120 = next(r for r in w4_times["rows"] if r["shape"] == "gpt-oss gate_up 2880->5760 g=120 M=64")
    timing[W4A8_G120] = [dict(g120["w4a8_matmul"], shape=g120["shape"])]
    timing[W4A16_G120] = [dict(g120["w4a16_matmul"], shape=g120["shape"])]
    delta = timed(phase_delta_timing)
    timing["delta_matmul_grouped"] = [delta[1], delta[3]]
    probe = timed(phase_profiling_tools)
    mma_bench = timed(phase_w4a8_mma_bench)
    if FAILURES:
        fail(f"{len(FAILURES)} correctness checks failed; the first: {FAILURES[0]}")
    full = next(r for r in probe["rows"] if r.get("mode") == "full")
    timing["decode_ablate"] = [dict(
        ms=full["ms_per_call"], plain_ms=full["plain_ms"], bound_ms=full["bound_ms"],
        bound_by=full["bound_by"], library_ms=None,  # no one PyTorch call computes the statistic
        shape="full mode, " + full["shape"],
    )]
    kernels = []
    for kname, meta in KERNELS.items():
        main_shape = timing[kname][0]  # the other rows are in the [time] lines
        if kname == "decode_ablate":  # on no serving path: the probe's run
            counts, per_forward = probe["counts"], None
        elif kname == "w4a8_matmul_mma":  # on no serving path: the bench's run
            counts, per_forward = mma_bench["counts"], None
        else:
            eng = engines[KERNEL_ENGINE[kname]]
            wrapper = KERNEL_WRAPPER.get(kname, kname)
            counts = dict(eng["counts"])
            if kname in KERNEL_GROUP:
                counts[wrapper] = eng["by_group"][wrapper].get(KERNEL_GROUP[kname], 0)
            per_forward = counts[wrapper] / max(eng["steps"][wrapper], 1)
        kernels.append(
            dict(
                name=kname,
                **meta,
                launches=counts[KERNEL_WRAPPER.get(kname, kname)],
                launches_per_forward=per_forward,
                max_abs_err=errs[kname],
                ms=main_shape["ms"],
                plain_ms=main_shape["plain_ms"],
                bound_ms=main_shape["bound_ms"],
                bound_by=main_shape["bound_by"],
                library_ms=main_shape["library_ms"],
                shape=main_shape["shape"],
                # a tensor-parallel engine's kernels: each rank's launches
                **({"launches_by_rank": eng["launches_by_rank"][KERNEL_WRAPPER.get(kname, kname)]}
                   if per_forward is not None and "launches_by_rank" in eng else {}),
            )
        )
    log(f"[done] {time.monotonic() - t0:.1f} s")
    log(json.dumps({"kernels": kernels}))
    fields = (
        "preset", "weights", "kv_cache_dtype", "attention_backend", "decode_tok_s", "e2e_tok_s",
        "device_busy_share", "device_ms_per_step", "worst_logit_rel", "overlap",
    )
    log(
        json.dumps(
            {
                "engines": {
                    label: {
                        "shape": "bs 64, 128 prompt + 128 new tokens",
                        **{k: e.get(k) for k in fields},  # untimed: null
                    }
                    for label, e in engines.items()
                }
            }
        )
    )
    log(json.dumps({"serve": {k: v for k, v in served.items() if k != "launches"}, "grammar": grammar,
                    "custom": custom, "spec": specs, "memory": memory, "tp": tp, "tp_families": tp_families,
                    "tp_quant": tp_quant}))
    log(smi_line)
    log(
        json.dumps(
            {
                "ok": True,
                "device": {"platform": "gpu", "kind": device_name, "count": torch.cuda.device_count()},
            }
        )
    )


if __name__ == "__main__":
    main()
